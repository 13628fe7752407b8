"""The port's evaluator and meters against the JAX package's, on the CPU.

``compute_oks`` (area and box normalisation, and the expanded-box distance
of a GT with no visible keypoint) to 1e-12. ``KeypointEvaluator``'s stats
to 1e-12 on synthetic detections: jittered copies of the GTs, missed GTs,
spurious detections, crowd and zero-keypoint GTs, images without GT and
images without detections; COCO (17 keypoints, area normalisation, area
splits) and CrowdPose (14 keypoints, box area, AP easy/medium/hard from
``crowd_index``); the port's native match and its Python loop against the
JAX evaluator's native match and its Python loop; ``merge`` of two halves
equal to the whole. The native match against the Python loop on random OKS
matrices, exactly. The meters print JAX's strings and keep JAX's bests.
"""
import numpy as np
import pytest

from detrpose_tpu.constants import keypoint_sigmas as jax_sigmas
from detrpose_tpu.data import evaluator as jev
from detrpose_tpu.utils import meters as jmeters
from detrpose_tpu.utils import native as jnative

from detrpose_tpu_torch.constants import keypoint_sigmas
from detrpose_tpu_torch.data import evaluator as ev
from detrpose_tpu_torch.utils import meters
from detrpose_tpu_torch.utils.native import get_match_fn, match_image_native, native_error


def synthetic_gts_and_dets(K, n_images=24, seed=0, crowd=False):
    """GTs of 0-4 people an image (one in ten crowd, one in ten without a
    labelled keypoint, some keypoints invisible), and detections: a jittered
    copy of most GTs (jitter scaled by the person's size, from exact to far
    off), spurious poses and no detection at all on some images."""
    rng = np.random.default_rng(seed)
    gts, dets, crowd_index = {}, {}, {}
    for img in range(n_images):
        anns = []
        for _ in range(rng.integers(0, 5)):
            s = rng.uniform(10, 120)
            c = rng.uniform(100, 500, 2)
            kp = np.zeros((K, 3))
            kp[:, :2] = c + rng.normal(0, s / 2, (K, 2))
            kp[:, 2] = np.where(rng.uniform(size=K) < 0.8, 2, 0)
            if rng.uniform() < 0.1:
                kp[:, 2] = 0
            x0, y0 = kp[:, :2].min(0) - 3
            x1, y1 = kp[:, :2].max(0) + 3
            anns.append({"keypoints": kp, "area": float(s * s * rng.uniform(1, 3)),
                         "bbox": [float(x0), float(y0), float(x1 - x0), float(y1 - y0)],
                         "iscrowd": int(rng.uniform() < 0.1),
                         "num_keypoints": int((kp[:, 2] > 0).sum())})
        gts[img] = {"anns": anns}
        crowd_index[img] = float(rng.choice([0.05, 0.3, 0.95]))
        if rng.uniform() < 0.15:
            continue                       # an image with no detection
        d_s, d_k = [], []
        for a in anns:
            if rng.uniform() < 0.2:
                continue                   # a missed GT
            jit = rng.choice([0.0, 0.02, 0.1, 0.4]) * np.sqrt(a["area"])
            k = a["keypoints"].copy()
            k[:, :2] += rng.normal(0, jit + 1e-3, (K, 2))
            k[:, 2] = 1.0
            d_s.append(rng.uniform(0.3, 1.0))
            d_k.append(k)
        for _ in range(rng.integers(0, 4)):  # spurious poses
            k = np.zeros((K, 3))
            k[:, :2] = rng.uniform(0, 600, 2) + rng.normal(0, 30, (K, 2))
            k[:, 2] = 1.0
            d_s.append(rng.uniform(0, 0.8))
            d_k.append(k)
        if d_s:
            dets[img] = (np.asarray(d_s, np.float32), np.stack(d_k).astype(np.float32))
    return gts, dets, (crowd_index if crowd else None)


def test_sigmas_match_jax():
    for K in (17, 14, 3):
        np.testing.assert_array_equal(keypoint_sigmas(K), jax_sigmas(K))


@pytest.mark.parametrize("use_area", [True, False])
def test_compute_oks_matches_jax(use_area):
    rng = np.random.default_rng(1)
    K = 17
    sig = keypoint_sigmas(K).astype(np.float64)
    det = rng.uniform(0, 200, (7, K, 3))
    gt = rng.uniform(0, 200, (5, K, 3))
    gt[:, :, 2] = rng.integers(0, 3, (5, K))
    gt[2, :, 2] = 0                        # no visible keypoint: box distance
    areas = rng.uniform(100, 5000, 5)
    boxes = np.concatenate([rng.uniform(0, 100, (5, 2)), rng.uniform(20, 90, (5, 2))], 1)
    got = ev.compute_oks(det, gt, areas, sig, use_area, boxes)
    want = jev.compute_oks(det, gt, areas, sig, use_area, boxes)
    assert got.shape == (7, 5) and got[:, 2].any()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert ev.compute_oks(det[:0], gt, areas, sig).shape == (0, 5)


def evaluate(module, gts, dets, K, use_area, crowd_index, parts=1, **kw):
    """Stats of ``module``'s evaluator over ``dets``, fed in ``parts``
    evaluators joined with ``merge``."""
    evs = [module.KeypointEvaluator(gts, K, use_area=use_area, crowd_index=crowd_index, **kw)
           for _ in range(parts)]
    for i, (img, (s, k)) in enumerate(sorted(dets.items())):
        evs[i % parts].update(img, s, k)
    evs[0].merge(evs[1:])
    evs[0].accumulate()
    return evs[0], evs[0].summarize()


def assert_stats_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-12, (k, got[k], want[k])


@pytest.mark.parametrize("K,crowd", [(17, False), (14, True)], ids=["coco17", "crowdpose14"])
def test_evaluator_matches_jax(K, crowd, monkeypatch):
    assert get_match_fn() is not None, native_error()
    gts, dets, crowd_index = synthetic_gts_and_dets(K, crowd=crowd)
    use_area = not crowd
    _, want = evaluate(jev, gts, dets, K, use_area, crowd_index)
    assert 0.05 < want["AP"] < 0.95 and want["AP50"] > want["AP75"]
    if crowd:
        assert {"AP_easy", "AP_medium", "AP_hard"} <= want.keys()
        assert min(want[k] for k in ("AP_easy", "AP_medium", "AP_hard")) > 0
    runs = {}
    for native in (True, False):
        for parts in (1, 2):
            e, runs[native, parts] = evaluate(ev, gts, dets, K, use_area, crowd_index,
                                              parts=parts, use_native=native)
            assert e.matched_by == ("native" if native else "python")
            assert_stats_equal(runs[native, parts], want)
    # the JAX evaluator's Python loop gives the same stats too
    monkeypatch.setattr(jnative, "match_image_native", lambda *a: False)
    _, want_py = evaluate(jev, gts, dets, K, use_area, crowd_index)
    assert_stats_equal(runs[False, 1], want_py)


def test_ground_truth_as_detections_gives_ap_1():
    gts, _, _ = synthetic_gts_and_dets(17, seed=2)
    dets = {img: (np.ones(len(g["anns"]), np.float32),
                  np.stack([a["keypoints"] for a in g["anns"]]).astype(np.float32))
            for img, g in gts.items() if g["anns"]}
    _, stats = evaluate(ev, gts, dets, 17, True, None)
    assert stats["AP"] == 1.0 and stats["AR"] == 1.0


def python_match(ious, thrs, gt_ignore, gt_iscrowd, gtm, dtm, dt_ignore):
    """The evaluator's Python loop (pycocotools evaluateImg's match)."""
    for t, thr in enumerate(thrs):
        for d in range(ious.shape[0]):
            iou, m = min(thr, 1 - 1e-10), -1
            for g in range(ious.shape[1]):
                if gtm[t, g] >= 0 and not gt_iscrowd[g]:
                    continue
                if m > -1 and not gt_ignore[m] and gt_ignore[g]:
                    break
                if ious[d, g] < iou:
                    continue
                iou, m = ious[d, g], g
            if m > -1:
                dtm[t, d], gtm[t, m], dt_ignore[t, d] = m, d, gt_ignore[m]


def test_native_match_equals_python_loop():
    rng = np.random.default_rng(7)
    for D, G in ((12, 6), (1, 9), (20, 1), (30, 25)):
        T = 10
        ious = rng.uniform(0, 1, (D, G))
        thrs = np.linspace(0.5, 0.95, T)
        gt_ignore = rng.uniform(size=G) > 0.7
        gt_iscrowd = rng.uniform(size=G) > 0.8
        order = np.argsort(gt_ignore.astype(int), kind="stable")
        ious, gt_ignore, gt_iscrowd = ious[:, order], gt_ignore[order], gt_iscrowd[order]
        out_n = (-np.ones((T, G), np.int64), -np.ones((T, D), np.int64),
                 np.zeros((T, D), np.uint8))
        assert match_image_native(ious, thrs, gt_ignore, gt_iscrowd, *out_n)
        out_p = (-np.ones((T, G), np.int64), -np.ones((T, D), np.int64),
                 np.zeros((T, D), np.uint8))
        python_match(ious, thrs, gt_ignore, gt_iscrowd, *out_p)
        assert (out_p[1] >= 0).any()
        for a, b in zip(out_n, out_p):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="contiguous"):
        match_image_native(ious, thrs, gt_ignore, gt_iscrowd, out_n[0].astype(np.int32),
                           out_n[1], out_n[2])


class FakeClock:
    def __init__(self):
        self.t = 1000.0

    def time(self):
        self.t += 0.25
        return self.t


def test_meters_match_jax(monkeypatch):
    vals = [3.0, 1.5, 2.25, 8.0, 0.5, 4.125]
    pm, jm = meters.SmoothedValue(window_size=4), jmeters.SmoothedValue(window_size=4)
    for v in vals:
        pm.update(v, n=2)
        jm.update(v, n=2)
        assert str(pm) == str(jm)
        for attr in ("median", "avg", "global_avg", "max", "value"):
            assert getattr(pm, attr) == getattr(jm, attr)
    lines = {}
    for name, mod in (("port", meters), ("jax", jmeters)):
        monkeypatch.setattr(mod.time, "time", FakeClock().time)
        logger, out = mod.MetricLogger(), []
        for i, _ in enumerate(logger.log_every(range(7), 3, header="Epoch: [2]",
                                               log_fn=out.append)):
            logger.update(loss=vals[i % len(vals)], loss_vfl=i / 3)
        lines[name] = out + [str(logger)]
    assert lines["port"] == lines["jax"] and len(lines["port"]) == 5
    for use_ema in (False, True):
        ph, jh = meters.BestMetricHolder(use_ema), jmeters.BestMetricHolder(use_ema)
        for ep, (res, is_ema) in enumerate([(0.1, True), (0.3, False), (0.2, True),
                                            (0.25, False), (0.5, True), (0.0, False)]):
            assert ph.update_stream(res, ep, is_ema) == jh.update_stream(res, ep, is_ema)
            assert ph.update(res / 2, ep, not is_ema) == jh.update(res / 2, ep, not is_ema)
            assert ph.summary() == jh.summary()
