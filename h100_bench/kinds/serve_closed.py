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
``detrpose_tpu_torch.tools.infer.build_pipeline(...)`` and its
``Pipeline.__call__``; every request's latency is the host time from the
call to its results on the host.
"""
from __future__ import annotations

import contextlib
import math
import time

import numpy as np
import torch
import torch.nn.functional as F

from .. import bounds, judge, trace, weights
from ..reference.models.postprocess import postprocess as ref_postprocess
from ..reference.pipeline import decode_from, features

NUMBERS = ("enc_score_err", "score_img_rms", "kpt_rms", "decode_mismatch")
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


def build_port(cfg: dict, device):
    """The program's serving pipeline for ``cfg``, its build checked
    against the configuration file."""
    from detrpose_tpu_torch.configs import model_config
    from detrpose_tpu_torch.tools.infer import build_pipeline

    K = cfg["model"]["num_body_points"]
    port_cfg = model_config(cfg["preset"], num_body_points=K)
    differ = {k: (getattr(port_cfg, k), v) for k, v in cfg["model"].items()
              if (list(getattr(port_cfg, k)) if isinstance(getattr(port_cfg, k), (tuple, list))
                  else getattr(port_cfg, k)) != v}
    if differ or port_cfg.msda_backend != cfg["msda_backend"]:
        raise SystemExit(f"the program's preset {cfg['preset']!r} differs from "
                         f"{cfg['name']}: {differ}, msda_backend {port_cfg.msda_backend}")
    return build_pipeline(cfg["preset"], num_body_points=K, res=cfg["res"],
                          dtype=getattr(torch, cfg["dtype"]), device=device,
                          generator=torch.Generator().manual_seed(0))


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
    if ctx.control:
        return judge_control(ctx, pool)

    pipe = build_port(cfg, dev)
    model = pipe.model
    # the leaves' names and shapes are the program's; after the window the
    # reference draws from its own, and a run whose two differ is not correct
    shapes = weights.leaf_shapes(model)
    model.load_state_dict(weights.draw(shapes, ctx.seed, dev), strict=True)
    ctx.note("program built, weights drawn")
    captured = {}
    hooks = []
    if ctx.fault == "alter_logit":
        hooks.append(model.register_forward_hook(alter_logit))
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
        sample.offer((p, captured["out"], captured["enc"], s, l, k))

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


def judge_sample(ctx, pool, items, shapes=None):
    """The reference over each sampled request, with the program's query
    selection; the worst reading of each number, and how the program's
    selection and the reference's own differ."""
    cfg, dev, nq = ctx.config, ctx.device, ctx.config["model"]["num_queries"]
    K = cfg["model"]["num_body_points"]
    with no_tf32():
        ref = weights.reference_net(cfg["model"], ctx.seed, dev)
        if shapes is not None and weights.leaf_shapes(ref) != shapes:
            return dict.fromkeys(NUMBERS, math.inf), {}     # not the reference's leaves
        feats = {}
        readings, differ = [], []
        for p, out, enc, s, l, k in items:
            if p not in feats:
                feats[p] = features(ref, pool[p][0], cfg["res"], dev)
            chosen = enc.max(dim=-1).values.topk(nq, dim=1).indices
            wh = np.asarray(pool[p][1], np.float32).reshape(-1, 2)
            if chosen.shape[0] != len(wh) or s.shape[0] != len(wh):
                readings.append(dict.fromkeys(NUMBERS, math.inf))   # answers missing
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
    rng = np.random.default_rng(ctx.seed)
    items = []
    for p in rng.integers(0, len(pool), tr["check_requests"]):
        p = int(p)
        r = decode_from(ctl, features(ctl, pool[p][0], cfg["res"], dev))
        wh = torch.as_tensor(np.asarray(pool[p][1], np.float32).reshape(-1, 2), device=dev)
        s, l, k = ref_postprocess(r, wh, num_body_points=K)
        items.append((p, r, r["scores"], s.cpu(), l.cpu(), k.cpu()))
    del ctl
    ctx.free()
    checks, selection = judge_sample(ctx, pool, items)
    return {"checks": checks, "selection": selection, "attempted": len(items),
            "failed": 0, "latencies": [], "images": 0, "window_s": 0.0,
            "memory_peak_bytes": ctx.memory_peak()}
