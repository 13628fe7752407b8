"""Serving in a closed loop: one client hands the serving pipeline a batch
of uint8 frames, waits until its scores, labels and keypoints are on the
host, and hands it the next.

Traffic parameters (``h100_bench/traffic/<name>.json``):
  batch           frames a request (1: one live camera's frame)
  frame_wh        (width, height) of a frame, as a camera or decoder gives it
  pool            distinct requests drawn from the seed, cycled through the
                  window
  check_requests  finished requests the comparison judges, drawn from the
                  seed (reservoir) once the window has closed
  warmup_requests requests of set-up before the window: the first builds
                  kernel #1 and meets each cuDNN and cuBLAS kernel, the
                  second runs as the window's do
  trace_warmup    requests under the profiler's warm-up step (--trace 1)
  trace_requests  requests in the traced window (--trace 1)

The frames are smooth random images (a coarse uniform grid upsampled 16x,
with fine noise), drawn on the device from the seed and copied to host
memory as numpy arrays, as a video decoder yields them. The window drives
the program's ``detrpose_tpu_torch.tools.infer.Pipeline.__call__``, built
from the configuration by ``build_port``; every request's latency is the
host time from the call to its results on the host.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import time

import numpy as np
import torch
import torch.nn.functional as F

from .. import bounds, judge, trace, weights
from ..reference import REQUIRED, VARIANTS
from ..reference.models.postprocess import postprocess as ref_postprocess
from ..reference.pipeline import decode_from, features

NUMBERS = ("enc_score_err", "score_img_rms", "kpt_rms", "decode_mismatch", "energy_kpt_rel")
SPANS = {"bench.model": None, "model.backbone": "backbone", "model.encoder": "encoder",
         "model.transformer": "transformer"}


def smooth_images(g: torch.Generator, n: int, wh, device) -> torch.Tensor:
    """(n, 3, H, W) float32 in [0, 1]: a coarse uniform grid (a cell every
    16 px) upsampled bilinearly, with fine uniform noise of 0.1."""
    W, H = wh
    low = torch.rand((n, 3, math.ceil(H / 16), math.ceil(W / 16)), generator=g, device=device)
    img = F.interpolate(low, size=(H, W), mode="bilinear", align_corners=False)
    return (img + 0.1 * torch.rand((n, 3, H, W), generator=g, device=device)).clamp(0, 1)


def draw_frames(seed: int, n: int, wh, device) -> np.ndarray:
    """(n, H, W, 3) uint8 smooth random frames on the host."""
    g = torch.Generator(device=device).manual_seed(int(seed) * 2 + 1)
    img = smooth_images(g, n, wh, device)
    u8 = (img * 255).round().to(torch.uint8).permute(0, 2, 3, 1).contiguous()
    return u8.cpu().numpy()


def refines(cfg: dict) -> bool:
    """Whether the configuration turns energy refinement on."""
    return bool(cfg["model"].get("use_energy_refinement", False))


def check_block(cfg: dict) -> None:
    """End the run, naming the key, where the configuration's ``model``
    block holds a key that neither the reference nor ``bounds.py`` reads, or
    turns energy refinement on without its step size (``weights.draw``)."""
    unread = sorted(set(cfg["model"]) - set(REQUIRED + VARIANTS + bounds.READS))
    if unread:
        raise SystemExit(f"h100_bench: {cfg['name']}: the reference reads no key {unread}")
    if refines(cfg) and "energy_step_size" not in cfg["model"]:
        raise SystemExit(f"h100_bench: {cfg['name']}: energy refinement without "
                         "energy_step_size, around which the step leaf is drawn")


def build_port(cfg: dict, device):
    """The program's serving pipeline for ``cfg``: its preset, with each key
    of the ``model`` block, and ``msda_backend``, whose value differs from
    the preset's, given to ``model_config``; the model and ``Pipeline`` are
    built as ``tools/infer.py::build_pipeline`` builds them without a
    checkpoint. A key the program's ``ModelConfig`` lacks ends the run."""
    from detrpose_tpu_torch.configs import build_model, model_config
    from detrpose_tpu_torch.tools.infer import Pipeline
    from detrpose_tpu_torch.utils.device import resolve_device

    K = cfg["model"]["num_body_points"]
    preset = model_config(cfg["preset"], num_body_points=K)
    block = {**cfg["model"], "msda_backend": cfg["msda_backend"]}
    known = {f.name for f in dataclasses.fields(preset)}
    missing = sorted(set(block) - known)
    if missing:
        raise SystemExit(f"h100_bench: {cfg['name']}: the program's ModelConfig has no key "
                         f"{missing}")
    overrides = {k: v for k, v in block.items()
                 if (list(getattr(preset, k)) if isinstance(getattr(preset, k), (tuple, list))
                     else getattr(preset, k)) != v}
    overrides.pop("num_body_points", None)
    dtype, dev = getattr(torch, cfg["dtype"]), resolve_device(device)
    port_cfg = model_config(cfg["preset"], num_body_points=K, dtype=dtype, **overrides)
    model = build_model(port_cfg, device=dev, generator=torch.Generator().manual_seed(0))
    return Pipeline(model, cfg["res"], K, dtype, dev)


class Reservoir:
    """A uniform sample of ``k`` items of a stream, drawn from the seed."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.items, self.seen = k, np.random.default_rng(seed), [], 0

    def offer(self, item) -> None:
        if self.seen < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.items[j] = item
        self.seen += 1


def run(ctx) -> dict:
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    B, wh, P = tr["batch"], tuple(tr["frame_wh"]), tr["pool"]
    frames = draw_frames(ctx.seed, P * B, wh, dev)
    pool = [(frames[p] if B == 1 else frames[p * B:(p + 1) * B],
             wh if B == 1 else np.tile(np.asarray(wh, np.float32), (B, 1))) for p in range(P)]
    ctx.note("frames drawn")
    check_block(cfg)
    if ctx.fault == "skip_energy" and not refines(cfg):
        raise SystemExit(f"h100_bench: {cfg['name']} has no energy refinement to skip")
    if ctx.control:
        return judge_control(ctx, pool)

    pipe = build_port(cfg, dev)
    model = pipe.model
    # the leaves' names and shapes are the program's; after the window the
    # reference draws from its own, and a run whose two differ is not correct
    shapes = weights.leaf_shapes(model)
    model.load_state_dict(weights.draw(shapes, ctx.seed, dev, cfg["model"]), strict=True)
    ctx.note("program built, weights drawn")
    captured = {}
    hooks = []
    if refines(cfg):    # what enters the refinement: the last layer's keypoints and logits
        hooks.append(model.transformer.lqe_embed[-1].register_forward_hook(
            lambda m, a, out: captured.update(pre=a[1], pre_logits=out)))
    if ctx.fault == "alter_logit":
        hooks.append(model.register_forward_hook(alter_logit))
    if ctx.fault == "skip_energy":
        hooks.append(model.register_forward_hook(skip_energy(captured)))
    hooks += [model.register_forward_hook(lambda m, a, out: captured.__setitem__("out", out)),
              model.transformer.enc_out_class_embed.register_forward_hook(
                  lambda m, a, out: captured.__setitem__("enc", out))]
    spans = None
    if ctx.trace:
        spans = trace.ModuleSpans({name: model if attr is None else getattr(model, attr)
                                   for name, attr in SPANS.items()})
    sample = Reservoir(tr["check_requests"], ctx.seed)
    record = {"latencies": [], "failed": 0}
    request = trace.span("bench.request") if ctx.trace else contextlib.nullcontext()

    def serve(i: int, keep: bool = True) -> None:
        p = i % P
        frames_p, wh_p = pool[p]
        if ctx.fault == "half_batch" and B > 1:
            frames_p, wh_p = frames_p[:B // 2], wh_p[:B // 2]
        t0 = time.perf_counter()
        with request:
            s, l, k = pipe(frames_p, wh_p)
            if ctx.fault == "alter_answer":       # one answer's keypoints moved
                k = k.clone()
                k[0, 0, :, :2] += 0.1 * max(wh)
            s, l, k = s.cpu(), l.cpu(), k.cpu()
        t1 = time.perf_counter()
        if not keep:
            return
        ok = bool(torch.isfinite(s).all() and torch.isfinite(k).all())
        record["latencies"].append(t1 - t0 if ok else math.inf)
        record["failed"] += not ok
        sample.offer((p, captured["out"], captured["enc"], captured.get("pre"), s, l, k))

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    for i in range(tr["warmup_requests"]):
        serve(i, keep=False)
    ctx.setup_done()

    out = {}
    if ctx.trace:
        warm = tr["trace_warmup"]
        tr_trace = trace.profiled(lambda i: serve(i, keep=i >= warm), warm, tr["trace_requests"])
        out.update(trace=tr_trace, window_s=tr_trace.window_s(),
                   flops_per_image=bounds.serve_flops_per_image(cfg["model"], cfg["res"], B))
        spans.remove()
    else:
        t0 = time.perf_counter()
        i = 0
        while True:
            serve(i)
            i += 1
            if time.perf_counter() - t0 >= ctx.seconds:
                break
        out["window_s"] = time.perf_counter() - t0
    for h in hooks:
        h.remove()
    out.update(attempted=len(record["latencies"]), failed=record["failed"],
               latencies=record["latencies"], images=B * len(record["latencies"]),
               memory_peak_bytes=ctx.memory_peak())
    ctx.window_closed()
    del pipe, model, captured
    ctx.free()
    out["checks"], out["selection"] = judge_sample(ctx, pool, sample.items, shapes)
    return out


def alter_logit(_m, _args, out):
    """A planted fault: the first image's best query answers with its
    class logits negated, where the model's last layer produces them."""
    logits = out["pred_logits"].clone()
    q = logits[0].max(dim=-1).values.argmax()
    logits[0, q] = -logits[0, q]
    return {**out, "pred_logits": logits}


def skip_energy(captured: dict):
    """A planted fault: the model returns the keypoints and logits that
    entered energy refinement (kept in ``captured``), as a program that
    skipped it would."""
    def hook(_m, _args, out):
        return {**out, "pred_logits": captured["pre_logits"],
                "pred_keypoints": captured["pre"].flatten(2)}
    return hook


@contextlib.contextmanager
def no_tf32():
    """float32 arithmetic in full for the reference: no TF32 in cuBLAS or
    cuDNN (cuDNN's convolutions take it by default)."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def refinement_input(net, captured: dict):
    """Keep in ``captured["pre"]`` the keypoints (B, nq, K, 2) that enter
    ``net``'s energy refinement, the argument of its last ``lqe_embed`` head."""
    return net.transformer.lqe_embed[-1].register_forward_hook(
        lambda m, a, out: captured.__setitem__("pre", a[1]))


def refinement_step(out: dict, pre) -> torch.Tensor:
    """Energy refinement's step on the keypoints: those returned less those
    that entered it, (B, nq, K, 2) float32."""
    return out["pred_keypoints"].float().reshape(pre.shape) - pre.float()


def judge_sample(ctx, pool, items, shapes=None):
    """The reference over each sampled request, with the program's query
    selection; the worst reading of each number, and how the program's
    selection and the reference's own differ."""
    cfg, dev, nq = ctx.config, ctx.device, ctx.config["model"]["num_queries"]
    K = cfg["model"]["num_body_points"]
    numbers = NUMBERS if refines(cfg) else NUMBERS[:-1]     # energy_kpt_rel is last
    with no_tf32():
        ref = weights.reference_net(cfg["model"], ctx.seed, dev)
        if shapes is not None and weights.leaf_shapes(ref) != shapes:
            return dict.fromkeys(numbers, math.inf), {}     # not the reference's leaves
        ref_in = {}
        if refines(cfg):
            refinement_input(ref, ref_in)
        feats = {}
        readings, differ = [], []
        for p, out, enc, pre, s, l, k in items:
            if p not in feats:
                feats[p] = features(ref, pool[p][0], cfg["res"], dev)
            chosen = enc.max(dim=-1).values.topk(nq, dim=1).indices
            wh = np.asarray(pool[p][1], np.float32).reshape(-1, 2)
            if chosen.shape[0] != len(wh) or s.shape[0] != len(wh):
                readings.append(dict.fromkeys(numbers, math.inf))   # answers missing
                continue
            r = decode_from(ref, feats[p], chosen)
            differ.append(judge.selection_differ(chosen, r["scores"], nq))
            decoded = ref_postprocess(out, torch.as_tensor(wh, device=dev), num_body_points=K)
            readings.append({
                "enc_score_err": judge.enc_score_err(enc, r["scores"]),
                "score_img_rms": judge.score_img_rms(out["pred_logits"], r["pred_logits"]),
                "kpt_rms": judge.kpt_rms(out["pred_keypoints"], r["pred_keypoints"]),
                "decode_mismatch": judge.decode_mismatch((s, l, k),
                                                         tuple(t.cpu() for t in decoded))})
            if refines(cfg):
                readings[-1]["energy_kpt_rel"] = (
                    math.inf if pre is None else judge.energy_kpt_rel(
                        refinement_step(out, pre), refinement_step(r, ref_in["pre"])))
    sel = {}
    if differ:
        d = torch.cat(differ)
        sel = {"images": int(d.numel()), "images_differing": int((d > 0).sum()),
               "most_differing": int(d.max()), "mean_differing": float(d.float().mean())}
    return judge.worst(readings), sel


def judge_control(ctx, pool) -> dict:
    """The control in the program's place: the reference in float8 serves
    ``check_requests`` requests drawn from the seed, judged as a run's."""
    from ..control import quantize_

    cfg, dev, tr = ctx.config, ctx.device, ctx.traffic
    K = cfg["model"]["num_body_points"]
    ctl = quantize_(weights.reference_net(cfg["model"], ctx.seed, dev))
    ctl_in = {}
    if refines(cfg):
        refinement_input(ctl, ctl_in)
    rng = np.random.default_rng(ctx.seed)
    items = []
    for p in rng.integers(0, len(pool), tr["check_requests"]):
        p = int(p)
        r = decode_from(ctl, features(ctl, pool[p][0], cfg["res"], dev))
        wh = torch.as_tensor(np.asarray(pool[p][1], np.float32).reshape(-1, 2), device=dev)
        s, l, k = ref_postprocess(r, wh, num_body_points=K)
        items.append((p, r, r["scores"], ctl_in.get("pre"), s.cpu(), l.cpu(), k.cpu()))
    del ctl
    ctx.free()
    checks, selection = judge_sample(ctx, pool, items)
    return {"checks": checks, "selection": selection, "attempted": len(items),
            "failed": 0, "latencies": [], "images": 0, "window_s": 0.0,
            "memory_peak_bytes": ctx.memory_peak()}
