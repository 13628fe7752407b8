"""The port's data modules against the JAX package's, on the CPU.

``data/coco.py``, ``data/transforms.py`` and ``data/loader.py`` do host work
in numpy and PIL, as the JAX modules do, so from the same files and the same
seeds they give the same bytes: the dataset's ids, images and targets (17
keypoints, and 14 with ``crowd_index``), ``normalize_target`` and
``pad_targets``, every transform and ``TrainTransforms`` at policy epochs 0,
5, 29 and 48 (mosaic included), ``EvalTransforms``, ``generate_scales``, and
the loader's batches with ``num_workers=0``, in train (shuffle, multi-scale,
CDN) and in eval, bit for bit. The one float step is the multi-scale resize:
the port's ``F.interpolate(antialias=True)`` against JAX's PIL mode-"F"
resize. On [0, 1] values (uniform and 8-bit) over the loader's scales they
differ by at most 1.6e-5 from 160 and 240 px and 8.0e-5 from 640 px (at 736,
up-sampling); the limit is 1e-4, the JAX package's own limit for this resize
against torch (tests/test_data_eval.py). The worker pool gives the JAX
pool's batches bit for bit, and the in-process path's where the items draw
no random numbers. Early exit after
one batch returns, and the loader iterates again, 5 times, each in a thread
joined with a 60 s deadline so the test fails instead of hanging; a stalled
worker raises after ``worker_timeout``; ``Prefetcher`` re-raises a loader
error.
"""
import json
import random
import threading

import numpy as np
import pytest

from detrpose_tpu.data import coco as jcoco
from detrpose_tpu.data import loader as jloader
from detrpose_tpu.data import transforms as jtf

from detrpose_tpu_torch.data import coco, loader, transforms as tf

from synth_data import make_tiny_coco

RESIZE_ATOL = 1e-4


def write_set(root, K, n_images=6, w=320, h=240, seed=0):
    """A synthetic COCO-format set (drawn structured poses, 2 people an
    image) plus what the dataset must filter: a crowd annotation, one with no
    labelled keypoint, an image with only those, one of another category,
    and, for 14 keypoints, CrowdPose's ``crowdIndex`` on every image."""
    img_dir, ann_file = make_tiny_coco(str(root), n_images=n_images, K=K, w=w, h=h,
                                       seed=seed, draw=True, structured=True)
    with open(ann_file) as f:
        d = json.load(f)
    rng = np.random.default_rng(seed + 1)
    aid = max(a["id"] for a in d["annotations"]) + 1
    zero = {"keypoints": [0.0] * (3 * K), "num_keypoints": 0, "iscrowd": 0,
            "category_id": 1, "bbox": [10.0, 10.0, 40.0, 60.0], "area": 2400.0}
    d["annotations"] += [
        dict(zero, id=aid, image_id=0, iscrowd=1, num_keypoints=3),
        dict(zero, id=aid + 1, image_id=1),
        dict(zero, id=aid + 2, image_id=n_images - 1),
        dict(zero, id=aid + 3, image_id=2, category_id=7, num_keypoints=5),
    ]
    # the last image keeps only its zero-keypoint annotation: train drops it
    d["annotations"] = [a for a in d["annotations"]
                        if a["image_id"] != n_images - 1 or a["num_keypoints"] == 0]
    d["categories"].append({"id": 7, "name": "bicycle"})
    if K == 14:
        for im in d["images"]:
            im["crowdIndex"] = float(rng.choice([0.05, 0.5, 0.9]))
    with open(ann_file, "w") as f:
        json.dump(d, f)
    return img_dir, ann_file


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    return {K: write_set(tmp_path_factory.mktemp(f"k{K}"), K) for K in (17, 14)}


def assert_targets_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        va, vb = np.asarray(a[k]), np.asarray(b[k])
        assert va.dtype == vb.dtype and va.shape == vb.shape, k
        np.testing.assert_array_equal(va, vb, err_msg=k)


def assert_samples_equal(a, b):
    (ia, ta), (ib, tb) = a, b
    assert ia.size == ib.size and ia.mode == ib.mode
    np.testing.assert_array_equal(np.asarray(ia), np.asarray(ib))
    assert_targets_equal(ta, tb)


@pytest.mark.parametrize("K", [17, 14])
@pytest.mark.parametrize("train", [True, False])
def test_dataset_matches_jax(sets, K, train):
    img_dir, ann = sets[K]
    pd = coco.CocoKeypointDataset(img_dir, ann, K, train=train)
    jd = jcoco.CocoKeypointDataset(img_dir, ann, K, train=train)
    assert pd.ids == jd.ids and len(pd) == len(jd)
    assert pd.crowd_index == jd.crowd_index
    assert (pd.crowd_index is not None) == (K == 14)
    assert len(pd.ids) == (5 if train else 6)
    for i in range(len(pd)):
        assert_samples_equal(pd.load_raw(i), jd.load_raw(i))
        img, t = pd.load_raw(i)
        w, h = img.size
        assert_targets_equal(coco.normalize_target(t, w, h, K),
                             jcoco.normalize_target(t, w, h, K))
    tgts = [coco.normalize_target(t, *img.size, K)
            for img, t in (pd.load_raw(i) for i in range(len(pd)))]
    for max_gt in (1, 8):
        assert_targets_equal(coco.pad_targets(tgts, max_gt), jcoco.pad_targets(tgts, max_gt))


def _sample(sets, K=17, i=1):
    img_dir, ann = sets[K]
    return coco.CocoKeypointDataset(img_dir, ann, K, train=True).load_raw(i)


@pytest.mark.parametrize("K", [17, 14])
def test_transforms_match_jax(sets, K):
    img, t = _sample(sets, K)
    assert_samples_equal(tf.hflip(img, t, K), jtf.hflip(img, t, K))
    for size, max_size in ((200, None), (160, 180), (240, None)):
        assert_samples_equal(tf.resize_shorter(img, t, size, max_size),
                             jtf.resize_shorter(img, t, size, max_size))
    assert_samples_equal(tf.resize(img, t, (160, 120)), jtf.resize(img, t, (160, 120)))
    for seed in range(3):
        assert_samples_equal(tf.random_zoom_out(img, t, random.Random(seed)),
                             jtf.random_zoom_out(img, t, random.Random(seed)))
        for mode in ("zero", "clamp"):
            assert_samples_equal(tf.random_crop(img, t, random.Random(seed), mode),
                                 jtf.random_crop(img, t, random.Random(seed), mode))
        assert (tf.sample_jitter_params(random.Random(seed))
                == jtf.sample_jitter_params(random.Random(seed)))
        np.testing.assert_array_equal(
            np.asarray(tf.color_jitter(img, random.Random(seed), p=1.0)),
            np.asarray(jtf.color_jitter(img, random.Random(seed), p=1.0)))
    for mode in ("zero", "clamp"):
        assert_samples_equal(tf.crop(img, t, (40, 30, 150, 120), mode),
                             jtf.crop(img, t, (40, 30, 150, 120), mode))
    for hue in (-0.4, 0.1, 0.5):
        np.testing.assert_array_equal(np.asarray(tf.adjust_hue(img, hue)),
                                      np.asarray(jtf.adjust_hue(img, hue)))
    img_dir, ann = sets[K]
    pd = coco.CocoKeypointDataset(img_dir, ann, K, train=True)
    jd = jcoco.CocoKeypointDataset(img_dir, ann, K, train=True)
    for seed in range(2):
        assert_samples_equal(
            tf.mosaic(pd, 1, random.Random(seed), cell_size=96, num_keypoints=K),
            jtf.mosaic(jd, 1, random.Random(seed), cell_size=96, num_keypoints=K))


@pytest.mark.parametrize("epoch", [0, 5, 29, 48])
def test_train_transforms_match_jax(sets, epoch):
    # crop on, so the crop branch runs too (off in the shipped configs)
    img_dir, ann = sets[17]
    kw = dict(out_size=160, num_keypoints=17, policy_epochs=(5, 29, 48), seed=3,
              use_crop=True)
    pd = coco.CocoKeypointDataset(img_dir, ann, 17, train=True,
                                  transforms=tf.TrainTransforms(**kw))
    jd = jcoco.CocoKeypointDataset(img_dir, ann, 17, train=True,
                                   transforms=jtf.TrainTransforms(**kw))
    pd.transforms.set_epoch(epoch)
    jd.transforms.set_epoch(epoch)
    for i in list(range(len(pd))) * 2:
        assert_samples_equal(pd[i], jd[i])
    assert pd.transforms.rng.getstate() == jd.transforms.rng.getstate()


def test_eval_transforms_match_jax(sets):
    img_dir, ann = sets[14]
    pd = coco.CocoKeypointDataset(img_dir, ann, 14, transforms=tf.EvalTransforms(160))
    jd = jcoco.CocoKeypointDataset(img_dir, ann, 14, transforms=jtf.EvalTransforms(160))
    for i in range(len(pd)):
        assert_samples_equal(pd[i], jd[i])


def test_generate_scales_match_jax():
    for base, rep in ((640, 4), (160, 1), (512, 2), (800, 3)):
        assert loader.generate_scales(base, rep) == jloader.generate_scales(base, rep)
    for n, c in ((10, 3), (7, 2), (4, 4)):
        from detrpose_tpu.parallel.dist import shard_indices as jshard

        for p in range(c):
            assert loader.shard_indices(range(n), p, c) == jshard(range(n), p, c)


def assert_batches_equal(got, want, image_atol=0.0):
    assert got.keys() == want.keys()
    if image_atol:
        np.testing.assert_allclose(got["images"], want["images"], rtol=0, atol=image_atol)
    else:
        np.testing.assert_array_equal(got["images"], want["images"])
    assert got["images"].dtype == want["images"].dtype == np.float32
    for k in ("image_ids", "orig_sizes"):
        np.testing.assert_array_equal(got[k], want[k])
    assert_targets_equal(got["targets"], want["targets"])
    if "dn" in want:
        assert got["dn"].keys() == want["dn"].keys()
        for k, v in want["dn"].items():
            if k == "dn_match":
                assert_targets_equal(got["dn"][k], v)
            else:
                np.testing.assert_array_equal(np.asarray(got["dn"][k]), np.asarray(v), err_msg=k)


def make_loaders(sets, K, train, workers=0, transforms="aug", **kw):
    img_dir, ann = sets[K]
    out = []
    for C, T, L in ((coco, tf, loader), (jcoco, jtf, jloader)):
        if transforms == "aug":
            t = (T.TrainTransforms(out_size=160, num_keypoints=K, policy_epochs=(0, 2, 4))
                 if train else T.EvalTransforms(160))
        else:
            t = transforms
        ds = C.CocoKeypointDataset(img_dir, ann, K, train=train, transforms=t)
        out.append(L.KeypointLoader(ds, batch_size=2, num_keypoints=K, train=train,
                                    max_gt=8, base_size=160, num_workers=workers,
                                    with_cdn=train, drop_last=train, **kw))
    return out


@pytest.mark.parametrize("K", [17, 14])
def test_loader_matches_jax_in_process(sets, K):
    # train: shuffle, mosaic / zoom-out epochs, multi-scale (96..192), CDN
    port, jax_ = make_loaders(sets, K, True, base_size_repeat=1)
    resized = 0
    for epoch in (0, 1, 3):
        port.set_epoch(epoch)
        jax_.set_epoch(epoch)
        got, want = list(port), list(jax_)
        assert len(got) == len(want) == len(port) == 2
        for g, w in zip(got, want):
            assert "dn" in w
            resized += g["images"].shape[1] != 160
            assert_batches_equal(g, w, RESIZE_ATOL)
    assert resized, "no batch took the multi-scale resize"
    # eval: in order, the last batch partial, no CDN
    port, jax_ = make_loaders(sets, K, False)
    got, want = list(port), list(jax_)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert_batches_equal(g, w)


def test_resize_batch_matches_jax_pil():
    rng = np.random.default_rng(0)
    worst = 0.0
    for hw, base in ((160, 160), (240, 160), (640, 640)):
        x = rng.uniform(0, 1, (2, hw, hw, 3)).astype(np.float32)
        for size in sorted(set(loader.generate_scales(base, 1))):
            got = loader._resize_batch(x, size)
            want = jloader._resize_batch(x, size)
            assert got.shape == want.shape == (2, size, size, 3) and got.dtype == np.float32
            worst = max(worst, float(np.abs(got - want).max()))
    assert worst <= RESIZE_ATOL, worst


def test_pool_matches_jax_pool(sets):
    # per-item reseeding: the pools give the same items, bit for bit
    port, jax_ = make_loaders(sets, 17, True, workers=2)
    for epoch in (1, 2):
        port.set_epoch(epoch)
        jax_.set_epoch(epoch)
        got, want = list(port), list(jax_)
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert_batches_equal(g, w)


@pytest.mark.parametrize("train", [True, False])
def test_pool_matches_in_process(sets, train):
    # items that draw no random numbers (eval resize; raw train images), so
    # the pool's per-item seeds and the in-process stream agree
    t = None if train else "aug"
    pool, _ = make_loaders(sets, 17, train, workers=2, transforms=t, base_size_repeat=1)
    inproc, _ = make_loaders(sets, 17, train, workers=0, transforms=t, base_size_repeat=1)
    pool.set_epoch(1)
    inproc.set_epoch(1)
    got, want = list(pool), list(inproc)
    assert len(got) == len(want) == (2 if train else 3)
    for g, w in zip(got, want):
        assert_batches_equal(g, w)


def run_with_deadline(fn, seconds=60.0):
    """Run ``fn`` in a thread; fail if it has not returned within
    ``seconds`` (instead of hanging the suite), re-raise what it raised."""
    err = []

    def body():
        try:
            fn()
        except BaseException as e:  # re-raised below, in the test's thread
            err.append(e)

    t = threading.Thread(target=body, daemon=True)
    t.start()
    t.join(seconds)
    assert not t.is_alive(), f"did not return within {seconds} s"
    if err:
        raise err[0]


def test_pool_early_exit_and_reiterate(sets):
    port, _ = make_loaders(sets, 17, True, workers=2)

    def once(epoch):
        port.set_epoch(epoch)
        it = iter(port)
        assert next(it)["images"].shape[0] == 2
        it.close()              # early exit: the pool closes, no terminate
        assert len(list(port)) == 2

    for epoch in range(5):
        run_with_deadline(lambda: once(epoch))


def test_pool_stall_raises(sets):
    port, _ = make_loaders(sets, 17, True, workers=2)
    port.worker_timeout = 0.0

    def stalled():
        with pytest.raises(RuntimeError, match="__main__"):
            list(port)

    run_with_deadline(stalled)


def test_prefetcher_reraises_loader_error(sets):
    class Broken:
        worker_timeout = 1.0

        def __len__(self):
            return 3

        def set_epoch(self, epoch):
            pass

        def __iter__(self):
            yield {"images": np.zeros((1, 4, 4, 3), np.float32)}
            raise ValueError("bad annotation")

    def consume():
        got = []
        with pytest.raises(ValueError, match="bad annotation"):
            for b in loader.Prefetcher(Broken(), depth=1):
                got.append(b)
        assert len(got) == 1

    run_with_deadline(consume)
    port, jax_ = make_loaders(sets, 17, False)
    for g, w in zip(loader.Prefetcher(port), jax_):
        assert_batches_equal(g, w)
