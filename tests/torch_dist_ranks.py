"""Rank functions of the data-parallel tests (tests/test_torch_dist.py and
the card's case in tests/test_torch_cuda.py).

``parallel/dist.py::run_ranks`` spawns each rank, which imports this module
by name: it imports torch and the port only, so a rank starts without JAX.
Inputs come as files the test wrote, results go back as
``{work}/rank{r}.pt``.
"""
import functools
import os

import numpy as np
import torch

from detrpose_tpu_torch.configs import build_model, model_config
from detrpose_tpu_torch.models.layers import BatchNorm
from detrpose_tpu_torch.parallel.train_step import make_train_step
from detrpose_tpu_torch.parallel.dist import gather_lists, merge_detections
from detrpose_tpu_torch.parallel.mesh import shard_batch
from detrpose_tpu_torch.train.cdn import CDNConfig, batch_cdn, build_cdn
from detrpose_tpu_torch.train.optim import make_optimizer

K = 17
torch.set_num_threads(2)


def state(step):
    """A step's parameters, BN statistics and EMA, as CPU tensors."""
    return {"params": {n: p.detach().cpu().clone() for n, p in step.model.named_parameters()},
            "buffers": {n: b.cpu().clone() for n, b in step.model.named_buffers()},
            "ema": ({k: v.cpu().clone() for k, v in step.ema.state_dict().items()}
                    if step.ema is not None else None)}


def new_step(sd, accum, device="cpu", backend="auto", dtype=torch.float32, **kw):
    """N in training from the state_dict ``sd`` and its step, in ``dtype``."""
    model = build_model(model_config("n", msda_backend=backend), device=device)
    model.load_state_dict(sd, strict=True)
    model.to(dtype)
    opt = make_optimizer(model, grad_accum_steps=accum)
    return make_train_step(model.train(), opt, K, device=device,
                           compute_dtype=torch.float32 if dtype == torch.float32 else None,
                           **kw)


def in64(batch):
    """The batch with float64 images."""
    return dict(batch, images=batch["images"].double())


def capture_grads(step):
    """Make the optimiser keep the gradients it steps with in ``step.grads``."""
    opt, real = step.optimizer, step.optimizer.step

    def capture():
        step.grads = {n: p.grad.detach().cpu().clone()
                      for n, p in step.model.named_parameters() if p.grad is not None}
        return real()
    opt.step = capture


def on(batch, device):
    """A batch of CPU tensors (and the CDN block's ints) on ``device``."""
    if isinstance(batch, dict):
        return {k: on(v, device) for k, v in batch.items()}
    return batch.to(device) if torch.is_tensor(batch) else batch


def core(rank, world, work):
    """Every check of tests/test_torch_dist.py that runs inside the ranks,
    on the inputs of ``{work}/inputs.pt``."""
    inp = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)
    out = {}

    # the evaluator's merge and results.json's gather through all_gather_object
    out["merged"] = merge_detections(inp["dets"][rank])
    out["gathered"] = gather_lists(inp["lists"][rank], dedup_key=lambda r: r["image_id"])

    # SyncBN: this rank's slice of the batch, the loss of every rank's slice
    bn = BatchNorm(inp["bn_x"].shape[1])
    bn.load_state_dict(inp["bn_state"])
    n = inp["bn_x"].shape[0] // world
    x = inp["bn_x"][rank * n:(rank + 1) * n].clone().requires_grad_()
    y = bn.train()(x)
    (y * inp["bn_w"][rank * n:(rank + 1) * n]).sum().backward()
    out["bn"] = {"y": y.detach(), "grad": x.grad, "mean": bn.running_mean.clone(),
                 "var": bn.running_var.clone(), "weight_grad": bn.weight.grad,
                 "bias_grad": bn.bias.grad}

    # the CDN group count: this rank's targets, the global batch's groups
    t = inp["cdn_targets"][rank]
    make = functools.partial(build_cdn, t, 60, K, (inp["hw"], inp["hw"]),
                             np.random.default_rng(rank), CDNConfig())
    dn = batch_cdn({"targets": t, "make_cdn": make}, "cpu")
    out["cdn"] = {k: dn[k] for k in ("num_dn_group", "attn_mask")}
    out["cdn"]["num_group"] = dn["dn_match"]["num_group"]

    # one optimiser step of 2 micro-batches, the global batch sharded, in
    # float64 (in float32 AdamW's first step, lr * g / (|g| + eps), turns
    # the rounding of a gradient that cancels to ~0 into a step of +-lr)
    micro = [in64(shard_batch(b, rank, world)) for b in inp["micro"]]
    step = new_step(inp["sd"], 2, dtype=torch.float64, ema_decay=0.9, ema_warmups=2)
    out["losses"] = [{k: v.item() for k, v in step(b).items() if torch.is_tensor(v)}
                     for b in micro]
    out["updates"] = (step.optimizer.updates, step.ema.updates, step.micro)
    out["state"] = state(step)

    # the non-finite skip when the last rank's loss alone is not finite (a
    # NaN image would reach every rank through the global BN statistics), on
    # the micro-batch that would all-reduce the gradients: every rank skips
    # and keeps its state, and the next finite micro-batch completes the
    # second optimiser step as if the skipped one had not been
    import detrpose_tpu_torch.parallel.train_step as train_step
    step(micro[0])
    real = train_step.criterion_fn

    def poisoned(*args, **kwargs):
        terms = real(*args, **kwargs)
        if rank == world - 1:
            first = next(iter(terms))
            terms[first] = terms[first] * float("nan")
        return terms
    before = state(step)
    train_step.criterion_fn = poisoned
    try:
        m = step(micro[1])
    finally:
        train_step.criterion_fn = real
    out["skip"] = {"finite": m["finite"], "loss": m["loss_total"].item(),
                   "kept": all(torch.equal(a, b) for part in ("params", "buffers", "ema")
                               for a, b in zip(before[part].values(),
                                               state(step)[part].values())),
                   "counts": (step.optimizer.updates, step.ema.updates, step.micro)}
    step(micro[1])
    out["after_skip"] = state(step)
    del step

    # the gradients of one step (accumulation 1) on JAX's test batch, in
    # float32 and in float64
    batch = shard_batch(inp["jax_batch"], rank, world)
    for dtype in (torch.float32, torch.float64):
        step = new_step(inp["jax_sd"], 1, dtype=dtype, use_ema=False)
        capture_grads(step)
        m = step(in64(batch) if dtype == torch.float64 else batch)
        out[f"jax_step_{dtype}".replace("torch.", "")] = {"loss": m["loss_total"].item(),
                                                           "grads": step.grads}
    torch.save(out, os.path.join(work, f"rank{rank}.pt"))


def trainer_fit(rank, world, work, data):
    """``Trainer.fit`` of N for one epoch, ``evaluate`` and ``test``, each
    rank on its shards, writing to ``{work}/rank{r}``."""
    from detrpose_tpu_torch.data.coco import CocoKeypointDataset
    from detrpose_tpu_torch.data.loader import KeypointLoader
    from detrpose_tpu_torch.data.transforms import EvalTransforms, TrainTransforms
    from detrpose_tpu_torch.tools.train import val_ground_truth
    from detrpose_tpu_torch.train.trainer import Trainer

    (img_dir, ann), (vdir, vann), hw = data
    tds = CocoKeypointDataset(img_dir, ann, K, train=True, transforms=TrainTransforms(
        out_size=hw, num_keypoints=K, policy_epochs=(99, 100, 101)))
    vds = CocoKeypointDataset(vdir, vann, K, transforms=EvalTransforms(out_size=hw))
    shard = dict(process_index=rank, process_count=world)
    train = KeypointLoader(tds, 2, K, train=True, base_size=hw, **shard)
    val = KeypointLoader(vds, 2, K, with_cdn=False, drop_last=False, **shard)
    cfg = model_config("n")
    # each rank its own weights: DDP starts every rank from rank 0's
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(rank))
    tr = Trainer(model, cfg, train, val, val_ground_truth(vds, K),
                 output_dir=os.path.join(work, f"rank{rank}"), epochs=1,
                 compute_dtype=torch.float32, device="cpu", n_devices=world)
    try:
        tr.fit()
        stats = tr.evaluate()
        tr.test()
    finally:
        tr.close()
    torch.save({"stats": stats, "dets": tr.evaluator.dets, "steps": tr.step.step,
                "state": state(tr.step), "history": tr.history},
               os.path.join(work, f"rank{rank}.pt"))


def card_step(rank, world, work):
    """N's step on the card in float32 with kernel #1 and with the plain
    version, one optimiser step on this rank's share of the batch of
    ``{work}/inputs.pt``: the global loss, the all-reduced gradients and
    kernel #1's launches."""
    from detrpose_tpu_torch.ops.cuda.msda import msda_forward

    # as the test's exact_f32: float32 without TF32, deterministic algorithms
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    inp = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)
    out = {}
    for backend in ("auto", "gather"):
        step = new_step(inp["sd"], 1, device="cuda", backend=backend, use_ema=False)
        capture_grads(step)
        before = msda_forward.launches
        m = step(on(shard_batch(inp["batch"], rank, world), "cuda"))
        torch.cuda.synchronize()
        out[backend] = {"loss": m["loss_total"].item(), "grads": step.grads,
                        "launches": msda_forward.launches - before}
    torch.save(out, os.path.join(work, f"rank{rank}.pt"))

