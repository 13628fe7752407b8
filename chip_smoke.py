"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

  python3 chip_smoke.py

Phases (any failure exits non-zero before the last line is printed):
  1. require CUDA; print the card's name and power limit; TF32 off for the
     comparisons;
  2. build the CUDA kernels from detrpose_tpu_torch/csrc (kernel #1's
     backward, csrc/msda_bwd.cu, among them), one nvcc per
     source, all at once, into an emptied build directory; print ptxas's
     registers, stack frame and spills per kernel instantiation, and fail if
     any library has no ptxas report or another count of instantiations
     than its source makes, or any instantiation has a stack frame or
     spills;
  3. hold each kernel against its plain PyTorch version on the card at small
     shapes and at the DETRPose-L/N/X eval shapes, kernel #1 and its op
     (output and gradients) also at the L train shapes of 640 px and of
     main path 5's multi-scale extremes, 480 and 800 px, and at main path
     6's micro-batches (4 images at 640 px; 2 and 4 at 480 and 800 px; the
     eval shapes at 4), at main path 7's L eval shapes (the grid branch's 16
     points, 16 heads of 16 channels, 32 heads of 8), and at main path 8's
     (the overfit's N at 160 px: its train batch of 16 with 64 CDN slots,
     the op too, and its evaluation batches of 16 and 8; L eval at 1 and 2
     images for the tutorial and the import check), float32 (1e-5 of
     max|ref|) and bf16 values (1% of
     max|ref|); kernels #1 and #2 also at
     shapes no 16-byte load fits (dh 12, nP 3, odd level sizes, ragged
     tiles), at 4 levels, and on a value map that starts 2 elements into its
     buffer; the per-point kernels #3-#5 (#3 at tiles 256 and 512, every
     mode of #5 at both of its tiles) at the small and the L shapes, at dh
     12, 4 levels and on maps 2 elements into their buffers, on the same
     packed bf16 values (1e-5 of max|ref|); and check that points outside
     every map give exactly 0, and NaN and +-1e30 coordinates too, from
     kernels #1, #2, #3, #4 and #5's full, stage1_only and no_cexp; and
     kernel #1's backward (the location and weight gradients) against the
     op's plain path at the small, the energy cell's (L eval, bs 32), the
     odd and 4-level shapes and on a shifted map, float32 and bf16 values,
     within 1e-5 of max|ref|, NaN where the plain version's gradients are
     for NaN and +-1e30 points;
  4. DETRPose-L at full width (seeded random weights, the reference's
     zero-initialised leaves perturbed), bs 2 at 640 px in float32: the
     forward with msda_backend "auto" (kernel #1) and "pallas" (kernel #2)
     against "gather", the plain version (1e-4 absolute on logits and
     normalized keypoints), 6 launches of the chosen kernel and 0 of the
     other;
  5. the same L deploy-fused against its train form, float32, 1e-4; and
     the L training step held against itself across backends (bs 2, 640 px,
     float32, one CDN batch, the same weights, deterministic algorithms):
     msda_backend "auto" (kernel #1 forward, plain backward) against
     "gather" (plain both ways), with equal matcher assignments, every loss
     term within 1e-4 relative and every parameter gradient within 1e-3 of
     its leaf's max|g| (of 1e-5 of the largest max|g| where a leaf's
     gradient is 0 up to rounding), a leaf past it held to a float64 step
     of the plain version as in phase 11 (b) and, here, within 1e-2 of its
     float64 max|g| (of the same floor), kernel #1 6 launches and 0;
  6. main path 1, serving: build_pipeline("l") in bf16 answers 4 single
     images of different sizes and one batch of 32 at 640 px;
  7. the tools. Main path 2: tools/benchmark.py's model_info and bench_size
     for n, s, m, l and x at bs 32, 640 px, bf16; tools/pallas_bench.py at
     the L shapes; tools/export.py exports L deploy-fused at bs 32 in bf16,
     reloads it and runs it against the eager deploy model (1e-2 of
     max|ref|). Main path 3, the MSDA variant tools: tools/msda_v2.py
     (kernel #1 and the per-point kernels #3 and #4, each checked against the
     plain gather) and tools/msda_ablate.py (kernel #5, four modes at two
     tiles, each checked against its plain version), at bs 32 and 640 px.
     Main path 4, training: the L training step at bs 8, 640 px, bf16
     autocast, gradient accumulation 2, for 8 micro-steps on a fixed
     synthetic batch: every loss finite, every trainable parameter got a
     gradient and moved (but for those whose gradient is 0 up to rounding,
     below 1e-6, whose steps round away), the backbone's BatchNorm
     statistics untouched and the encoder's moved, one EMA update per
     optimiser step, kernel #1 exactly 6 launches per micro-step and kernel
     #2 none; and a batch with a NaN image leaves the parameters, the AdamW
     state and the EMA bit for bit as they were.
     Before each main path every launch counter is set to 0, and after it
     each kernel the path runs must have launched;
  8. time, with CUDA events after a warm-up: the L forward + postprocess at
     bs 32 in deploy and train form and as the exported program, one bs-1
     request, and each kernel (each mode of #5) against its
     plain version at the L shapes, beside the least time the card could
     take for its own bytes and operations (bound) and the kernels' own
     device time (torch.profiler), #3 also at tile 512, the L2 rate of
     kernels #1, #2, #3 and #5 full's corner-row traffic, the ops of #2-#4
     with their packing (event and device time), the device times of
     no_cexp's two passes, #4's plan and its time by channel groups on the N
     and L shapes and with its taps from device memory, and the library
     yardstick of #3-#5's function: the reference DETRPose's nL
     F.grid_sample calls, a composition, not one call; and the L training
     step (tools/benchmark.py::bench_train_step, bs 8, 640 px, bf16,
     accumulation 2): ms per micro-step and per optimiser step, images/s,
     peak memory, a traced split of two micro-steps (device busy, idle
     share, kernel families, the share of kernel #1's plain-version backward
     by its profiler range, and that backward timed alone; each phase of
     the step, the update's clip, AdamW and EMA among them, by its host and
     device time), kernel #1's backward at the energy cell's shapes against
     the op's plain path and its bound, and the
     matcher's time with the auction and with scipy;
  9. main path 5, the Trainer: synthetic COCO-format sets written as JPEG
     files (32 train and 16 val images of 640x480 and 480x640, 1-6
     17-keypoint poses each; 8 CrowdPose images with 14 keypoints and
     crowdIndex), then tools/train.py's command line trains DETRPose-L at
     full width and depth (configs/coco/detrpose_l.py: 640 px with
     multi-scale, total batch 16 in micro-batches of 8, 4 loader workers,
     bf16) for 2 epochs through the dataset, augmentations, loader, Trainer,
     evaluator and checkpoints, under deterministic algorithms. It fails
     unless log.txt has a line an epoch with finite losses and the AP keys,
     checkpoint, best and config.yaml exist (best_ema and best_regular
     exactly when their stream's AP passed 0), and kernel #1 launched 6
     times a train micro-step and a val batch and kernel #2 never; then
     --eval --resume checkpoint must print epoch 1's EMA stats exactly; the
     same checkpoint evaluated with msda_backend "gather" must give
     detections within 1e-2 of max|ref| of kernel #1's (scores as their
     logits in sorted order, each keypoint set against its nearest
     counterpart, at most MAX_AT_BOUNDARY detections an image let off for a
     logit at the other run's top-k boundary), and within 1e-4 evaluated in
     float32; the evaluator must give AP 1.0 on the ground
     truth and the same stats with its native and its Python match;
     CrowdPose L --eval must report AP easy, medium and hard. It prints the
     seconds an epoch, train and eval images/s, the share of the fit's time
     spent waiting on the loader, the peak device memory, which match ran,
     and the time of one more epoch without deterministic algorithms;
 10. main path 6, data parallelism over ranks (a process group, DDP, the
     global BN statistics, loss normalisers and skip): (a) the L training
     step of main path 4 in 2 spawned ranks on the one card over gloo, 4
     images a rank of the same bs-8 batch with its one CDN block, one
     optimiser step held against one process's (in bf16 the loss within
     1%; in float32, TF32 off, one step of accumulation 1: the loss within
     1e-4, each leaf's all-reduced gradient and its update within 2%, but
     for the leaves that a float64 step finds 0 in exact arithmetic), the
     ranks' parameters, EMA and BN statistics bit for bit equal, kernel #1
     6 launches a micro-step in each rank, a NaN on one rank skipped by
     both; each rank's time a micro-step against one process's at the same
     global batch and without the gradient all-reduce (no_sync), rank 0's
     host self time in the collectives' calls by the profiler against the
     untraced step, peak memory a rank; (b) tools/train.py's command line
     (Trainer.fit, one epoch of an 8-image synthetic set, with its
     evaluations) in 2 ranks over gloo: the same stats on both ranks and
     from one process's --eval --resume of rank 0's checkpoint, files from
     rank 0 alone; (c) the command line under torch.distributed.run
     --nproc_per_node 1 on NCCL, DDP on the card; (d) with two cards or
     more, (a) over NCCL across two. Gloo between two ranks of one card
     exercises the collectives' host path, not NVLink or NCCL: no scaling
     figure. A rank that fails or misses its deadline fails the phase;
 11. main path 7, the reference's model variants (DETRPose-L at full width
     and depth, seeded weights with the constant leaves perturbed as in
     phase 4): (a) bs 2, 640 px, float32, TF32 off, each of modulation,
     region sampling (k 3), global context, grouped offsets (G 2 with
     modulation; G 4, 8-channel heads), grid attention (16 points with
     offsets, fused; 4 points unfused), the FastKAN FFN, energy refinement
     (3 steps, by the gradient and by the raw energy) and the ResNet-50
     backbone, through "auto" (kernel #1) and "pallas" (kernel #2) against
     "gather" (all plain: the script sets the energy layer to "gather" for
     this reference only) within 1e-4 on logits and normalized keypoints,
     with exact launches: the chosen kernel 6 a forward in the main layers,
     12 with the grid branch; the energy layer runs on "auto", as JAX builds
     it, so kernel #1 adds steps (raw energy) or 2 x steps (its gradient)
     under "auto" and under "pallas" alike; "pallas" with grad_energy
     evaluates;
     (b) one L training micro-step (bs 2, float32, one CDN batch,
     deterministic algorithms) per family (grouped with modulation, grid
     with offsets, FastKAN, energy by the gradient in 3 steps, ResNet-50)
     through "auto" against "gather" as in phase 5, a leaf past 1e-3 held
     to a float64 step of the plain version; (c) each
     configuration's forward + postprocess at bs 32, 640 px, bf16, beside
     the default L's, and kernel #1 at the grid branch's 16 points and at
     16 and 8-channel heads beside its bound; (d) the command line over a
     folder of 4 synthetic JPEGs (a process of its own) and a 4-frame mp4
     (or, without cv2, its image path up to the detections, said on a line
     of its own), and bench_data at bs 1 and 32 over synthetic JPEGs;
 12. main path 8, weights from elsewhere and the repo-level programs: (a)
     a seeded L's state_dict saved with torch.save and imported by
     load_pretrained_backbone_encoder into a fresh L of another seed on the
     card, the backbone and encoder bit-equal to it, every transformer leaf
     as initialised, then its forward through kernel #1; (b)
     examples/tutorial_torch.py at L, 640 px, on the card in its own
     process: its overlay written, its first and steady latencies, 12
     launches of kernel #1 in its 2 calls; (e) tools/overfit.py, a short
     run of N at 160 px: its loss must fall, its losses and the evaluator's
     10 stats of each stream be finite, kernel #1 3 launches a step and an
     evaluation batch. Serving's throughput and its split by stage are
     h100_bench/'s, read from the program's spans;
 13. main path 9, where training starts: (a) N and L built by build_model on
     the card, every Linear and conv weight (the packed attention
     in-projection too) held to flax's lecun-normal: within its truncation
     bound 2 / 0.8796 / sqrt(fan_in), std * sqrt(fan_in) within 10% of 1
     where it has 1024 entries or more, or zero where JAX zeroes it; every
     bias zero but for the class prior and the circle-pattern offsets;
     every Gate open at exactly 0.5 and every LQE head the identity on
     random scores; (b) utils/convert.py::optimizer_from_optax on an
     optax-shaped tree this script builds for N's parameters (flax layout,
     the masked leaves None), with accumulation 1 and 2, the latter in the
     middle of an optimiser step: the carried moments bit for bit, then one
     micro-batch of the same gradient on the card and on the CPU from that
     carried state, restored by restore_checkpoint with no warning, every
     parameter and moment within 1e-6 of its leaf's max|x| of the CPU's,
     and not what a fresh optimiser gives; (c) that carried N state resumed
     in a training step on the card (bs 16, 160 px, bf16): its micro-batch
     completes the optimiser step, kernel #1 3 launches;
 14. print the kernel table, the card line and, last, the result line.

Whether it passes or fails, the script ends only after every process it
started has: it adopts its descendants' orphans (a rank's data worker
server outlives its rank), stops the loader's worker server and
multiprocessing's resource tracker, and waits for the rest, signalling any
that does not end (``stop_children``; what it signals goes to stderr).
"""
import contextlib
import ctypes
import gc
import glob
import importlib.util
import io
import itertools
import json
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from PIL import Image, ImageDraw

from h100_bench.bounds_msda_bwd import OPS_PER_TAP_CHANNEL
from detrpose_tpu_torch.configs import build_model, model_config
from detrpose_tpu_torch.data.evaluator import KeypointEvaluator
from detrpose_tpu_torch.models import MSDeformAttn, postprocess
from detrpose_tpu_torch.models.layers import BatchNorm
from detrpose_tpu_torch.ops.cuda import (KERNELS, ms_deform_attn_colsin, ms_deform_attn_fast,
                                         ms_deform_attn_tpose, msda_ablate, msda_colsin,
                                         msda_forward, msda_perquery, msda_tpose)
from detrpose_tpu_torch.ops.cuda.build import BUILD_DIR
from detrpose_tpu_torch.ops.cuda.kan import basis_u, gaussian_basis, kan_basis, kan_basis_plain
from detrpose_tpu_torch.ops.cuda.msda import (BACKWARD_RANGE, SMEM_OPTIN, TPOSE_BARRIER,
                                              backward_plan, gather_plan,
                                              ms_deform_attn_fast_flat, msda_backward)
from detrpose_tpu_torch.ops.cuda.msda_ablate import MODES, TILES, msda_ablate_plain
from detrpose_tpu_torch.ops.cuda.msda_colsin import TILE, msda_colsin_plain
from detrpose_tpu_torch.ops.cuda.msda_perquery import (ms_deform_attn_pallas_flat,
                                                      msda_perquery_plain, pack_points,
                                                      pack_value)
from detrpose_tpu_torch.ops.cuda.msda_tpose import MSDATpose, msda_tpose_plain
from detrpose_tpu_torch.ops.ms_deform_attn import ms_deform_attn_core
from detrpose_tpu_torch.ops.msda_pack import (column_planes, pack_values_tposed,
                                              pack_values_xminor)
from detrpose_tpu_torch.ops.msda_pack import pack_points as pack_point_levels
from detrpose_tpu_torch.parallel.dist import free_port, run_ranks
from detrpose_tpu_torch.parallel.mesh import shard_batch
from detrpose_tpu_torch.parallel.train_step import PHASES, make_train_step
from detrpose_tpu_torch.tools import benchmark, msda_ablate as ablate_tool, msda_v2, pallas_bench
from detrpose_tpu_torch.tools.benchmark import launch_counts, synthetic_train_batch
from detrpose_tpu_torch.tools.export import build_serve, export_model, load_exported
from detrpose_tpu_torch.tools.infer import build_pipeline, detections
from detrpose_tpu_torch.tools.infer import main as infer_main
from detrpose_tpu_torch.tools.overfit import overfit
from detrpose_tpu_torch.tools.phase_times import range_times
from detrpose_tpu_torch.tools.train import main as train_main
from detrpose_tpu_torch.train.matcher import hungarian_match
from detrpose_tpu_torch.models.decoder import LQE
from detrpose_tpu_torch.models.detrpose import TRUNCATED_STD
from detrpose_tpu_torch.models.layers import Gate
from detrpose_tpu_torch.train.optim import label_parameters, make_optimizer
from detrpose_tpu_torch.utils.checkpoint import restore_checkpoint
from detrpose_tpu_torch.utils.convert import (_EMBED_LEAVES, from_jax_variables,
                                              load_pretrained_backbone_encoder,
                                              load_torch_checkpoint, optimizer_from_optax)
from detrpose_tpu_torch.utils.deploy import fuse_for_deploy
from detrpose_tpu_torch.utils.measure import card_power_limit, cuda_time_ms, kernel_times, traced
from detrpose_tpu_torch.utils.native import native_error

SEED = 0
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
BF16_FLOP_PER_S = 989e12       # H100 SXM dense bf16 tensor-core rate
F32_FLOP_PER_S = 67e12         # H100 SXM float32 peak outside the tensor cores

# DETRPose-L eval: 60 queries x 18 tokens, levels at strides 8/16/32 of 640 px
L_SHAPES = dict(B=32, Lq=1080, nH=8, dh=32, nP=4, levels=((80, 80), (40, 40), (20, 20)))
N_SHAPES = dict(B=32, Lq=1080, nH=8, dh=16, nP=6, levels=((40, 40), (20, 20)))
X_SHAPES = dict(B=32, Lq=1080, nH=8, dh=48, nP=4, levels=((80, 80), (40, 40), (20, 20)))
TEST_SHAPES = dict(B=2, Lq=135, nH=8, dh=32, nP=4, levels=((16, 16), (8, 8), (4, 4)))
# no 16-byte load fits a bf16 head of 12 channels (and #4's column rows are
# no multiple of 16 bytes); three points take the generic point loop of #1
# and #2; four levels
ODD_SHAPES = dict(B=1, Lq=37, nH=3, dh=12, nP=3, levels=((7, 9), (5, 3)))
# main path 7's new shapes of kernels #1 and #2 at the L eval geometry:
# the grid branch's 16 points a level (the generic point loop), grouped
# offsets' 16 heads of 16 channels (G=2) and 32 heads of 8 (G=4)
VARIANT_SHAPES = {"grid_nP16": dict(L_SHAPES, nP=16), "heads16x16": dict(L_SHAPES, nH=16, dh=16),
                  "heads32x8": dict(L_SHAPES, nH=32, dh=8)}
NL4_SHAPES = dict(B=2, Lq=135, nH=8, dh=32, nP=4, levels=((16, 16), (8, 8), (4, 4), (2, 2)))
# the L training micro-batch of the reference recipe (configs/_base.py: 16
# images an optimiser step in 2 micro-batches), and main path 4's length
TRAIN_BATCH, TRAIN_ACCUM, TRAIN_STEPS = 8, 2, 8
# kernel #1's calls on main path 4: (64 CDN slots + 60 queries) x 18 tokens
TRAIN_SHAPES = dict(L_SHAPES, B=TRAIN_BATCH, Lq=124 * 18)
# main path 5's multi-scale extremes (generate_scales(640, 4): square batches
# of 480-800 px), levels at strides 8/16/32
TRAIN_MS_SHAPES = {f"ms{px}": dict(TRAIN_SHAPES, levels=tuple((px // s, px // s)
                                                              for s in (8, 16, 32)))
                   for px in (480, 800)}
# main path 6: two ranks (one card's over gloo, two cards' over NCCL); the
# step takes the bs-8 batch in shares of 4; the command line runs on a set of
# DP_SET images, in micro-batches of DP_SET // TRAIN_ACCUM // ranks at the
# multi-scale sizes (2 ranks, and 1 under torch.distributed.run) and
# evaluation batches of DP_EVAL_BATCH
DP_RANKS, DP_SET, DP_EVAL_BATCH = 2, 8, 4
DP_SHAPES = {"dp4": dict(TRAIN_SHAPES, B=TRAIN_BATCH // DP_RANKS),
             **{f"dp{b}{label}": dict(shp, B=b) for b in (DP_SET // TRAIN_ACCUM // DP_RANKS,
                                                          DP_SET // TRAIN_ACCUM)
                for label, shp in TRAIN_MS_SHAPES.items()},
             "Ldp4": dict(L_SHAPES, B=DP_EVAL_BATCH)}
# main path 8: the overfit recipe's N at 160 px (levels at strides 16/32),
# its train batches of 16 with 64 CDN slots and its evaluation batches of 16
# and 8; the tutorial's L request of one image and phase 12 (a)'s two
N160_SHAPES = dict(N_SHAPES, levels=((10, 10), (5, 5)))
PATH8_SHAPES = {"N160t16": dict(N160_SHAPES, B=16, Lq=124 * 18),
                "N160e16": dict(N160_SHAPES, B=16), "N160e8": dict(N160_SHAPES, B=8),
                "L1": dict(L_SHAPES, B=1), "L2": dict(L_SHAPES, B=2)}
# template instantiations of each library: #1 and #2 dtype x load width x
# nP, #3 load width, #4 level count x taps from shared or device memory, #5
# mode x load width and no_cexp's row pass
INSTANTIATIONS = {"msda_fwd": 21, "msda_perquery": 21, "msda_colsin": 4, "msda_tpose": 8,
                  "msda_ablate": 19, "msda_bwd": 21, "kan_basis": 2}
# the libraries phase 2 builds: each kernel's, kernel #1's backward
# (csrc/msda_bwd.cu: dtype x load width x nP, as #1) and the FastKAN basis
# product (csrc/kan_basis.cu: bf16 or float32 output)
LIBRARIES = {**KERNELS, "msda_bwd": msda_backward, "kan_basis": kan_basis}
# what main path 7 counts: the kernels' launches, the backward kernel's and
# the FastKAN basis product's
COUNTED = tuple(LIBRARIES)
# the FastKAN basis product at the KAN cell's shapes (L with use_kan, bs 32:
# 32 x 60 x 18 decoder tokens): kan1 and kan2, (N, D, G, r)
KAN_SHAPES = {"kan1": (32 * 60 * 18, 256, 3, 129), "kan2": (32 * 60 * 18, 1024, 3, 513)}
COLSIN_TILES = (TILE, 512)     # #3's default tile and the TPU kernel's TP
# main path 5, the Trainer: synthetic COCO-format sets (images, 17- and
# 14-keypoint poses) and the L recipe's batches (configs/_base.py: 16 images
# an optimiser step in micro-batches of 8), 2 epochs
TRAINER_SETS = {"train": (32, 17), "val": (16, 17), "crowdpose": (8, 14)}
TRAINER_EPOCHS, TRAINER_EVAL_BATCH = 2, 8
# detections an image whose keypoints may go unmatched in the kernel-against-
# plain comparison because their score sits at the other run's top-k
# boundary (a run of this script on an H100 found none, bf16 and float32)
MAX_AT_BOUNDARY = 2
# published parameter counts and GFLOPs at 640 px (SURVEY.md, README.md:81-85
# of the reference)
PUBLISHED = {"n": (4.1, 9.3), "s": (11.5, 33.1), "m": (20.8, 67.3), "l": (32.8, 107.1),
             "x": (73.3, 239.5)}


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


PR_SET_CHILD_SUBREAPER = 36    # linux/prctl.h


def adopt_orphans():
    """Make this process the parent of its descendants' orphans, so that
    ``stop_children`` finds and waits for them: a spawned rank's data worker
    server, for one, ends only after its rank has."""
    libc = ctypes.CDLL(None, use_errno=True)
    if libc.prctl(PR_SET_CHILD_SUBREAPER, 1, 0, 0, 0) != 0:
        fail(f"prctl(PR_SET_CHILD_SUBREAPER): {os.strerror(ctypes.get_errno())}")


def children():
    """{pid: (state, command line)} of this process's children, from /proc."""
    me, found = os.getpid(), {}
    for path in glob.glob("/proc/[0-9]*/stat"):
        try:
            with open(path) as f:
                state, ppid = f.read().rsplit(")", 1)[1].split()[:2]
            if int(ppid) == me:
                pid = int(path.split("/")[2])
                with open(f"/proc/{pid}/cmdline", "rb") as f:
                    found[pid] = (state, f.read().replace(b"\0", b" ").decode(errors="replace"))
        except (OSError, ValueError):     # it ended meanwhile
            continue
    return found


def stop_children(grace_s=10.0, deadline_s=30.0):
    """Stop every process this script started that still runs, and wait for
    it: the loader's worker server and the resource tracker through their
    own stop (closing the pipe each watches, then waiting; the collection
    first lets the pools' semaphores unregister, so the tracker finds none
    left to unlink), then any other child, an adopted orphan too, given
    ``grace_s`` to end, SIGTERM, and SIGKILL past ``deadline_s``. Returns
    {pid: command line} of those signalled."""
    from multiprocessing import forkserver, resource_tracker

    gc.collect()
    forkserver._forkserver._stop()
    resource_tracker._resource_tracker._stop()
    t0, signalled = time.monotonic(), {}
    while True:
        live = {}
        for pid, (state, cmd) in children().items():
            if state == "Z":
                with contextlib.suppress(ChildProcessError):
                    os.waitpid(pid, 0)
            else:
                live[pid] = cmd
        if not live:
            return signalled
        waited = time.monotonic() - t0
        if waited > grace_s:
            sig = signal.SIGKILL if waited > deadline_s else signal.SIGTERM
            for pid, cmd in live.items():
                with contextlib.suppress(ProcessLookupError):
                    os.kill(pid, sig)
                signalled[pid] = cmd
        time.sleep(0.05)


def card_line():
    card, _ = card_power_limit()
    if card is None:
        fail("nvidia-smi did not give the card's name and power limit")
    return card


def ptxas_report(log):
    """[(kernel, registers, stack frame bytes, spill store bytes, spill load
    bytes)] from an ``nvcc -Xptxas -v`` log; the kernel's mangled name is cut
    after its template arguments."""
    rows, fn, frame = [], None, (0, 0, 0)
    for line in log.splitlines():
        if m := re.search(r"Function properties for (\S+)", line):
            fn, frame = m.group(1), (0, 0, 0)
        elif m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                            r"(\d+) bytes spill loads", line):
            frame = tuple(int(x) for x in m.groups())
        elif (m := re.search(r"Used (\d+) registers", line)) and fn:
            rows.append((fn.split("EEv")[0], int(m.group(1))) + frame)
            fn = None
    return rows


def zero_launch_counts():
    for k in KERNELS.values():
        k.launches = 0
    msda_backward.launches = msda_backward.plain = 0
    kan_basis.launches = 0


def shifted(t, k=2):
    """A contiguous copy of ``t`` that starts ``k`` elements into its buffer,
    as a slice of a wider tensor does."""
    out = torch.empty(t.numel() + k, dtype=t.dtype, device=t.device)[k:].view(t.shape)
    return out.copy_(t)


def msda_inputs(g, dtype, B, Lq, nH, dh, nP, levels, lo=-0.1, hi=1.1):
    S = sum(h * w for h, w in levels)
    nL = len(levels)
    value = torch.randn(B, S, nH * dh, device="cuda", generator=g).to(dtype)
    loc = lo + (hi - lo) * torch.rand(B, Lq, nH, nL, nP, 2, device="cuda", generator=g)
    aw = torch.rand(B, Lq, nH, nL, nP, device="cuda", generator=g)
    aw = aw / aw.sum(dim=(-1, -2), keepdim=True)
    return value, list(levels), loc, aw


def pack(value, loc, aw):
    """Kernel #2's layout of the inputs of kernel #1."""
    return (pack_value(value, loc.shape[2]),) + pack_points(loc, aw)


def level_maps(value, levels, nH):
    """Kernel #1's value (B, S, nH*dh) -> per level (B, H, W, nH, dh), the
    JAX package's per-level signature."""
    B = value.shape[0]
    return [m.reshape(B, H, W, nH, -1)
            for m, (H, W) in zip(value.split([h * w for h, w in levels], 1), levels)]


def per_point(value, levels, loc, aw):
    """The per-point kernels' inputs from those of kernel #1: per level
    (ix, iy, a), the x-minor and the transposed bf16 maps, the column planes."""
    nH = loc.shape[2]
    maps = level_maps(value, levels, nH)
    return (pack_point_levels(loc, aw, levels), pack_values_xminor(maps),
            pack_values_tposed(maps), column_planes(levels, value.shape[-1] // nH,
                                                    value.device))


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def msda_bound_ms(n_bytes, n_ops):
    """Least time for one call: the bytes it must move (each input read once,
    each output written once) at the memory rate, or its float32 operations
    at the float32 peak, whichever is longer."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def per_point_bounds(points, xminor, dh):
    """The bound of each per-point function (kernels #3, #4 and each mode of
    #5) on these inputs: its own bytes, and 10 float32 operations per (point,
    level, channel) for four taps (4 multiply-adds and the weight's), 6 for
    two taps, 1 for io_only's add; no_cexp also adds every value once to form
    its row sums."""
    ixs, iys, a_s = ([p[i] for p in points] for i in range(3))
    B, nH, P = ixs[0].shape
    out_bytes = B * nH * P * dh * 4
    n_taps = sum(ix.numel() for ix in ixs) * dh        # (point, level, channel)
    col0 = sum(v.shape[2] for v in xminor) * B * nH * dh * 2   # column 0, bf16
    full = msda_bound_ms(nbytes(*ixs, *iys, *a_s, *xminor) + out_bytes, 10 * n_taps)
    return {"msda_colsin": full, "msda_tpose": full, "full": full,
            "no_cexp": msda_bound_ms(nbytes(*iys, *a_s, *xminor) + out_bytes,
                                     sum(v.numel() for v in xminor) + 6 * n_taps),
            "stage1_only": msda_bound_ms(nbytes(*iys, *a_s) + col0 + out_bytes, 6 * n_taps),
            "io_only": msda_bound_ms(nbytes(*ixs) + out_bytes, n_taps)}


def grid_sample_yardstick(value, levels, loc, aw):
    """The library yardstick of the per-point function of kernels #3-#5: the
    reference DETRPose's own form, per level one F.grid_sample (bilinear,
    zeros padding, align_corners=False) of the (B*nH, dh, H, W) bf16 map at
    the grid (B*nH, P, 1, 2) = 2*loc - 1, weighted by a and summed over the
    levels -> (B*nH, dh, P, 1). nL calls and their sums, not one call; the
    maps, grids and weights are laid out here, before any timing. The grid
    is bf16 as grid_sample takes it in the maps' type, so its samples are
    rounded where the kernels' are not. Returns the call."""
    B, Lq, nH, nL, nP, _ = loc.shape
    maps = [m.permute(0, 3, 4, 1, 2).reshape(B * nH, -1, H, W).contiguous()
            for m, (H, W) in zip(level_maps(value, levels, nH), levels)]
    grids = [(2 * loc[:, :, :, lvl] - 1).transpose(1, 2).reshape(B * nH, Lq * nP, 1, 2)
             .to(value.dtype).contiguous() for lvl in range(nL)]
    weights = [aw[:, :, :, lvl].transpose(1, 2).reshape(B * nH, 1, Lq * nP, 1)
               .to(value.dtype).contiguous() for lvl in range(nL)]

    def call():
        out = 0
        for m, g, a in zip(maps, grids, weights):
            out = out + F.grid_sample(m, g, mode="bilinear", padding_mode="zeros",
                                      align_corners=False) * a
        return out
    return call


def tpose_smem(levels, dh, groups):
    """Kernel #4's shared memory a block at ``groups`` channel groups: the
    budget that makes its plan take that many."""
    return TPOSE_BARRIER + sum(-(-(W * (dh // groups) * H * 2) // 16) * 16 for H, W in levels)


def perturb_constant_leaves(model, g):
    """Give every parameter or buffer that init leaves constant (zero heads,
    unit norms, BatchNorm statistics, bias priors) seeded noise, and scale
    the two-stage selection head by 50 so the top-60 order is well defined."""
    with torch.no_grad():
        for name, t in list(model.named_parameters()) + list(model.named_buffers()):
            if not t.is_floating_point() or t.numel() == 0 or (t != t.flatten()[0]).any():
                continue
            noise = torch.randn(t.shape, generator=g).to(t.device, t.dtype)
            if name.endswith("running_var"):
                t.mul_(1.0 + 0.5 * torch.rand(t.shape, generator=g).to(t.device, t.dtype))
            else:
                t.add_(0.02 * noise if (t == 0).all() else 0.1 * noise)
        model.transformer.enc_out_class_embed.weight.mul_(50.0)


def compare_outputs(label, got, want, limit):
    for k in ("pred_logits", "pred_keypoints"):
        a, b = got[k].float(), want[k].float()
        err = (a - b).abs().max().item()
        print(f"[{label}] {k}: max|err| {err:.3e} (limit {limit:g}), "
              f"finite {bool(torch.isfinite(a).all())}")
        if not (err <= limit and torch.isfinite(a).all()):
            fail(f"{label}: outputs disagree on {k}")


def check_kernels(g):
    """Phase 3: each kernel against its plain version; returns the max|err|
    at the L, train, multi-scale and main paths 6 and 8's shapes in bf16 per
    kernel."""
    errs = {}
    for label, shp in (("test", TEST_SHAPES), ("L", L_SHAPES), ("train", TRAIN_SHAPES),
                       *TRAIN_MS_SHAPES.items(), *DP_SHAPES.items(), *PATH8_SHAPES.items(),
                       *VARIANT_SHAPES.items(), ("N", N_SHAPES),
                       ("X", X_SHAPES), ("odd", ODD_SHAPES), ("nL4", NL4_SHAPES),
                       ("offset", TEST_SHAPES)):
        for dtype, rel in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
            value, levels, loc, aw = msda_inputs(g, dtype, **shp)
            vflat, locp, awp = pack(value, loc, aw)
            if label == "offset":
                value, vflat = shifted(value), shifted(vflat)
            nH, dh = shp["nH"], shp["dh"]
            vecs = {"msda_fwd": gather_plan(nH, dh, value.element_size(), value.data_ptr(),
                                            1).vec,
                    "msda_perquery": gather_plan(1, dh, vflat.element_size(),
                                                 vflat.data_ptr(), 1).vec}
            pairs = {"msda_fwd": (msda_forward(value, levels, loc, aw),
                                  ms_deform_attn_core(value, levels, loc, aw)),
                     "msda_perquery": (msda_perquery(vflat, levels, locp, awp),
                                       msda_perquery_plain(vflat, levels, locp, awp))}
            torch.cuda.synchronize()
            for name, (got, want) in pairs.items():
                got, want = got.float(), want.float()
                err = (got - want).abs().max().item()
                scale = want.abs().max().item()
                print(f"[3] {name:13s} {label:6s} {str(dtype):14s} {vecs[name]} channels per "
                      f"load, max|err| {err:.3e} max|ref| {scale:.3e} (limit {rel:g} of "
                      f"max|ref|)")
                if not err <= rel * scale:
                    fail(f"{name} disagrees with its plain version at {label} {dtype}")
                if (label in ("L", "train") or label in TRAIN_MS_SHAPES or label in DP_SHAPES
                        or label in PATH8_SHAPES or label in VARIANT_SHAPES) \
                        and dtype == torch.bfloat16:
                    errs[name] = max(err, errs.get(name, 0.0))
    # the per-point kernels take the packed bf16 values the TPU ops cast to
    for label, shp in (("test", TEST_SHAPES), ("L", L_SHAPES), ("odd", ODD_SHAPES),
                       ("nL4", NL4_SHAPES), ("offset", TEST_SHAPES)):
        value, levels, loc, aw = msda_inputs(g, torch.bfloat16, **shp)
        pts, xminor, tposed, cols = per_point(value, levels, loc, aw)
        if label == "offset":     # #4 fills by its threads, #5 loads 2 bytes
            xminor, tposed = [shifted(v) for v in xminor], [shifted(v) for v in tposed]
        plan = MSDATpose.plan(tposed, levels, shp["dh"], pts[0][0].shape[-1])
        pairs = [("msda_tpose", f"{plan.groups} groups", msda_tpose(pts, tposed, levels),
                  msda_tpose_plain(pts, tposed, levels)),
                 ("msda_tpose", "device memory", msda_tpose(pts, tposed, levels, _budget=0),
                  msda_tpose_plain(pts, tposed, levels))]
        want = msda_colsin_plain(pts, xminor, levels)
        pairs += [("msda_colsin", f"tile {tile}", msda_colsin(pts, xminor, cols, levels, tile),
                   want) for tile in COLSIN_TILES]
        for mode in MODES:
            want = msda_ablate_plain(mode, pts, xminor, levels)
            pairs += [("msda_ablate", f"{mode} tile {tile}",
                       msda_ablate(mode, pts, xminor, levels, tile), want) for tile in TILES]
        torch.cuda.synchronize()
        for name, what, got, want in pairs:
            err = (got - want).abs().max().item()
            scale = want.abs().max().item()
            print(f"[3] {name:13s} {what:20s} {label:6s} bf16 values max|err| {err:.3e} "
                  f"max|ref| {scale:.3e} (limit 1e-05 of max|ref|)")
            if not err <= 1e-5 * scale:
                fail(f"{name} {what} disagrees with its plain version at {label}")
            if label == "L":
                errs[name] = max(err, errs.get(name, 0.0))
        del pairs
    value, levels, loc, aw = msda_inputs(g, torch.float32, **TEST_SHAPES, lo=1.5, hi=3.0)
    vflat, locp, awp = pack(value, loc, aw)
    pts, xminor, tposed, cols = per_point(value, levels, loc, aw)
    for name, out in (("msda_fwd", msda_forward(value, levels, loc, aw)),
                      ("msda_perquery", msda_perquery(vflat, levels, locp, awp)),
                      ("msda_colsin", msda_colsin(pts, xminor, cols, levels)),
                      ("msda_tpose", msda_tpose(pts, tposed, levels)),
                      ("msda_ablate full", msda_ablate("full", pts, xminor, levels))):
        if out.abs().max().item() != 0.0:
            fail(f"{name}: points outside every map must give exactly 0")
    print("[3] msda_fwd, msda_perquery, msda_colsin, msda_tpose and msda_ablate full: "
          "points outside the maps give exactly 0")
    for dtype in (torch.float32, torch.bfloat16):
        value, levels, loc, aw = msda_inputs(g, dtype, **TEST_SHAPES, lo=0.0, hi=1.0)
        loc = off_map(g, loc)
        vflat, locp, awp = pack(value, loc, aw)
        outs = [("msda_fwd", msda_forward(value, levels, loc, aw)),
                ("msda_perquery", msda_perquery(vflat, levels, locp, awp))]
        if dtype == torch.bfloat16:
            pts, xminor, tposed, cols = per_point(value, levels, loc, aw)
            outs += [("msda_colsin", msda_colsin(pts, xminor, cols, levels)),
                     ("msda_tpose", msda_tpose(pts, tposed, levels)),
                     ("msda_ablate full", msda_ablate("full", pts, xminor, levels))]
            # stage1_only and no_cexp read only iy: every point's y off the map
            pts = per_point(value, levels, off_map(g, loc, y_only=True), aw)[0]
            outs += [(f"msda_ablate {mode}", msda_ablate(mode, pts, xminor, levels))
                     for mode in ("stage1_only", "no_cexp")]
        for name, out in outs:
            if out.abs().max().item() != 0.0:
                fail(f"{name}: NaN and +-1e30 coordinates must give exactly 0 ({dtype})")
    print("[3] msda_fwd and msda_perquery (float32 and bf16), msda_colsin, msda_tpose and "
          "msda_ablate full (bf16 maps): points with a NaN or +-1e30 coordinate give exactly 0; "
          "msda_ablate stage1_only and no_cexp, which read only y: so do points with a "
          "NaN or +-1e30 y")
    return errs


def off_map(g, loc, y_only=False):
    """``loc`` with one or both coordinates of every point (the y of every
    point, ``y_only``) set to NaN, 1e30 or -1e30, each drawn at random."""
    bad = torch.tensor([float("nan"), 1e30, -1e30], device=loc.device)
    which = torch.randint(0, 3, loc.shape[:-1], device=loc.device, generator=g)
    if y_only:
        which = which.clamp(min=1)
    pick = bad[torch.randint(0, 3, loc.shape, device=loc.device, generator=g)]
    hit = torch.stack([which != 1, which != 0], dim=-1)    # x, y, or both
    return torch.where(hit, pick, loc)


def check_l_model(gen):
    """Phases 4 and 5, float32 with TF32 off; returns the train-form model."""
    models = {}
    for backend in ("gather", "auto", "pallas"):
        gb = torch.Generator().manual_seed(SEED)
        m = build_model(model_config("l", msda_backend=backend), device="cuda", generator=gb)
        perturb_constant_leaves(m, gb)
        models[backend] = m
    x = torch.rand(2, 3, 640, 640, generator=gen).cuda()
    outs = {}
    expect = {"gather": {}, "auto": {"msda_fwd": 6}, "pallas": {"msda_perquery": 6}}
    with torch.no_grad():
        for backend, m in models.items():
            zero_launch_counts()
            outs[backend] = m(x)
            torch.cuda.synchronize()
            want = {name: expect[backend].get(name, 0) for name in KERNELS}
            if launch_counts() != want:
                fail(f"L forward with msda_backend={backend!r} launched {launch_counts()}, "
                     f"expected {want}")
            print(f"[4] L bs2 640 f32, msda_backend={backend!r}: launches {launch_counts()}")
    compare_outputs("4 auto vs gather", outs["auto"], outs["gather"], 1e-4)
    compare_outputs("4 pallas vs gather", outs["pallas"], outs["gather"], 1e-4)

    train = models["auto"]
    deploy = build_model(model_config("l"), deploy=True, device="cuda")
    deploy.load_state_dict(fuse_for_deploy(train.state_dict()), strict=True)
    n_train, n_deploy = (sum(1 for k in m.state_dict()) for m in (train, deploy))
    with torch.no_grad():
        out_d = deploy(x)
    print(f"[5] L deploy-fused: {n_deploy} state_dict entries (train form {n_train})")
    compare_outputs("5 deploy vs train", out_d, outs["auto"], 1e-4)
    return train


def serve(train, rng):
    """Main path 1 (phase 6); returns the pipeline and the first request."""
    run = build_pipeline("l", device="cuda", dtype=torch.bfloat16)
    run.model.load_state_dict(train.state_dict())
    requests = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
                for h, w in ((480, 640), (720, 1280), (500, 333), (640, 640))]
    batch = rng.integers(0, 256, (32, 640, 640, 3), dtype=np.uint8)
    zero_launch_counts()
    answers = [run(img, (img.shape[1], img.shape[0])) for img in requests]
    answers.append(run(batch, np.full((32, 2), 640.0, np.float32)))
    torch.cuda.synchronize()
    counts = launch_counts()
    if counts["msda_fwd"] == 0:
        fail("the serving path never launched kernel msda_fwd")
    for i, (scores, labels, kpts) in enumerate(answers):
        B = 32 if i == len(answers) - 1 else 1
        if (tuple(scores.shape) != (B, 60) or tuple(labels.shape) != (B, 60)
                or tuple(kpts.shape) != (B, 60, 17, 3)):
            fail(f"request {i}: shapes {scores.shape}, {labels.shape}, {kpts.shape}")
        if not (torch.isfinite(scores.float()).all() and torch.isfinite(kpts.float()).all()):
            fail(f"request {i}: non-finite output")
        print(f"[6] request {i} (batch {B}): top scores "
              f"{[round(s, 4) for s in scores[0, :3].float().tolist()]}, "
              f"keypoint range [{kpts[..., :2].min().item():.1f}, "
              f"{kpts[..., :2].max().item():.1f}] px")
    print(f"[6] served {len(answers)} requests; kernel launches {counts}")
    return run, requests[0], counts


def tools(card):
    """Main path 2 (phase 7); returns per-size results, the pallas_bench
    times, the eager deploy and train serve modules, the reloaded exported
    program and the launch counts."""
    zero_launch_counts()
    sizes = {}
    for size in ("n", "s", "m", "l", "x"):
        info = benchmark.model_info(size)
        res = benchmark.bench_size(size, 32, 640, bf16=True, warmup=3, iters=10)
        pub_p, pub_g = PUBLISHED[size]
        print(f"[7] {size}: params {info['params_M']} M (published {pub_p}), "
              f"conv+matmul GFLOPs {info['gflops']} (published {pub_g}, all ops); "
              f"bs32 640 bf16 {res['latency_ms']} ms/batch ({res['images_per_sec']} "
              f"img/s, {res['basis']}); launches {res['launches']} on {card}")
        if not res["launches"]["msda_fwd"] > 0:
            fail(f"bench_size({size!r}) launched no kernel")
        sizes[size] = (info, res)
    bench_ms = pallas_bench.bench(batch=32, res=640, iters=20)
    for name, ms in bench_ms.items():
        print(f"[7] pallas_bench {name:>20}: {ms:8.4f} ms/call ({ms / 32 * 1000:7.1f} "
              f"us/img) on {card}")

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        export_model("l", batch=32, res=640, bf16=True, fuse=True, out_dir=tmp,
                     device="cuda")
        t_export = time.perf_counter() - t0
        t0 = time.perf_counter()
        run = load_exported(tmp)
        t_load = time.perf_counter() - t0
        x = torch.rand(32, 3, 640, 640, device="cuda")
        ts = torch.full((32, 2), 640.0, device="cuda")
        before = msda_forward.launches
        got = run(x, ts)
        torch.cuda.synchronize()
        n_run = msda_forward.launches - before
    eager = {fuse: build_serve("l", bf16=True, fuse=fuse, device="cuda")
             for fuse in (True, False)}
    with torch.no_grad():
        want = eager[True](x, ts)
    for name, a, b in zip(("scores", "labels", "keypoints"), got, want):
        err = (a.float() - b.float()).abs().max().item()
        scale = b.float().abs().max().item()
        print(f"[7] exported L vs eager deploy, {name}: max|err| {err:.3e} "
              f"(limit 1e-2 of max|ref| {scale:.3e})")
        if not err <= 1e-2 * scale:
            fail(f"the exported program disagrees with the eager deploy model on {name}")
    if n_run == 0:
        fail("the exported program did not launch the msda kernel")
    print(f"[7] export L deploy-fused bs32 bf16: export {t_export:.2f} s, load "
          f"{t_load:.2f} s, one run launched msda_fwd {n_run} times")
    counts = launch_counts()
    for name in ("msda_fwd", "msda_perquery"):
        if counts[name] == 0:
            fail(f"the tools path never launched kernel {name}")
    print(f"[7] tools path: kernel launches {counts}")
    return sizes, bench_ms, eager, run, counts


def variant_tools(card):
    """Main path 3 (phase 7): the MSDA variant and ablation tools at bs 32,
    640 px; returns their results and the launch counts."""
    zero_launch_counts()
    v2 = msda_v2.run(batch=32, res=640, iters=10)
    ablate = ablate_tool.run(batch=32, res=640, iters=10)
    torch.cuda.synchronize()
    counts = launch_counts()
    for name in ("msda_fwd", "msda_colsin", "msda_tpose", "msda_ablate"):
        if counts[name] == 0:
            fail(f"the variant tools path never launched kernel {name}")
    for name, r in v2.items():
        if name != "device":
            print(f"[7] msda_v2 {name:>8} (kernel {r['kernel']}): {r['ms']:.4f} ms/call with "
                  f"its packing, max rel err vs the gather {r['max_rel_err']:.3e} on {card}")
    for name, ms in ablate.items():
        if name not in ("device", "device_ms"):
            print(f"[7] msda_ablate {name:>20}: {ms:.4f} ms/call, kernels "
                  f"{ablate['device_ms'][name]:.4f} ms device time, on {card}")
    print(f"[7] variant tools path: kernel launches {counts}")
    return v2, ablate, counts


def l_train_model(backend):
    """DETRPose-L in training on the card: seeded weights, the constant
    leaves perturbed and the selection head scaled by 50 (as phase 4)."""
    gb = torch.Generator().manual_seed(SEED)
    model = build_model(model_config("l", msda_backend=backend), device="cuda", generator=gb)
    perturb_constant_leaves(model, gb)
    return model.train()


def branch_assignments(model, batch):
    """The matcher's assignments of every supervision branch of one train
    forward of ``batch`` (no gradient) -> (M, B, G)."""
    with torch.no_grad():
        out = model(batch["images"], batch["dn"])
    branches = [out] + out["aux_outputs"] + [out["aux_pre_outputs"]] + out["aux_interm_outputs"]
    logits = torch.stack([b["pred_logits"] for b in branches])
    kpts = torch.stack([b["pred_keypoints"] for b in branches])
    return logits, kpts, hungarian_match(logits, kpts, batch["targets"], 17)


def hold_to_float64(label, model, batch, off, ga, gg, cap=None, floor=0.0):
    """An ill-conditioned float32 gradient: each leaf of ``off`` (past 1e-3
    of its max|g| between kernel #1's run, ``ga``, and the plain version's,
    ``gg``) held to one float64 step of ``model`` (set to the plain version),
    no farther from it than twice the plain version's own float32 gradient
    is (or 1e-3 of its max|g|), and with ``cap`` no farther than ``cap`` of
    its float64 max|g| (at least ``floor``) whatever the plain version's
    distance."""
    model.double()
    step = make_train_step(model, make_optimizer(model, grad_accum_steps=2), 17,
                           compute_dtype=torch.float32, use_ema=False)
    step(dict(batch, images=batch["images"].double()))
    gw = {k: model.get_parameter(k).grad for k in off}
    worst, capped = [], []
    for k in off:
        e_auto = (ga[k].double() - gw[k]).abs().max().item()
        e_plain = (gg[k].double() - gw[k]).abs().max().item()
        g64 = max(gw[k].abs().max().item(), floor)
        worst.append((e_auto / max(1e-3 * g64, 2 * e_plain), k, e_auto, e_plain))
        capped.append((e_auto / g64 if g64 else math.inf, k))
    worst.sort(reverse=True)
    capped.sort(reverse=True)
    print(f"{label}: {len(off)} leaves past 1e-3 held to a float64 plain step: worst "
          f"max|auto - f64| / max(1e-3 max|g|, 2 max|gather - f64|) {worst[0][0]:.3f} at "
          f"{worst[0][1]} (auto {worst[0][2]:.3e}, gather {worst[0][3]:.3e} off float64; "
          f"limit 1); worst max|auto - f64| / max|g64| {capped[0][0]:.3e} at {capped[0][1]} "
          f"(limit {'none' if cap is None else cap}; max|g64| at least {floor:.3e})")
    if worst[0][0] > 1.0 or (cap is not None and capped[0][0] > cap):
        fail(f"{label} train step: the gradients differ between 'auto' and 'gather'")
    return worst


def check_train_backends():
    """Main path 4's check: one L training micro-step, bs 2, 640 px, float32
    (TF32 off), through kernel #1 ("auto") and the plain version ("gather"),
    under deterministic algorithms: the gradients that the encoder's
    batch-statistics norms cancel to rounding would otherwise change with
    cuDNN's choice of algorithm from run to run."""
    batch = synthetic_train_batch(2, 640, 17, 60, "cuda", seed=SEED)
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    runs = {}
    for backend in ("auto", "gather"):
        model = l_train_model(backend)
        step = make_train_step(model, make_optimizer(model, grad_accum_steps=2), 17,
                               compute_dtype=torch.float32, use_ema=False)
        zero_launch_counts()
        metrics = step(batch)
        torch.cuda.synchronize()
        counts = launch_counts()
        want = {name: (6 if backend == "auto" and name == "msda_fwd" else 0) for name in KERNELS}
        if counts != want:
            fail(f"L train micro-step with msda_backend={backend!r} launched {counts}, "
                 f"expected {want}")
        grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
                 if p.grad is not None}
        runs[backend] = (metrics, grads, branch_assignments(model, batch)[2])
        print(f"[5] L train micro-step bs2 640 f32, msda_backend={backend!r}: loss "
              f"{metrics['loss_total'].item():.6f}, launches {counts}")
        del model, step
    torch.backends.cudnn.deterministic = False
    torch.use_deterministic_algorithms(False)
    (ma, ga, aa), (mg, gg, ag) = runs["auto"], runs["gather"]
    if not torch.equal(aa, ag):
        fail("L train step: the matcher's assignments differ between 'auto' and 'gather'")
    worst_loss = max(abs(ma[k].item() - v.item()) / max(abs(v.item()), 1e-12)
                     for k, v in mg.items() if torch.is_tensor(v))
    print(f"[5] L train step auto vs gather: {aa.numel()} assignments equal, {len(mg) - 2} "
          f"loss terms, worst relative difference {worst_loss:.3e} (limit 1e-4)")
    if not worst_loss <= 1e-4:
        fail("L train step: the loss terms differ between 'auto' and 'gather'")
    if ga.keys() != gg.keys():
        fail("L train step: the backends give gradients to other leaves")
    # a leaf whose gradient is 0 up to rounding (a bias that the encoder's
    # batch-statistics norms cancel) is held against 1e-5 of the largest |g|
    top = max(g.abs().max().item() for g in gg.values())
    errs = sorted((((ga[n] - g).abs().max().item() / max(g.abs().max().item(), 1e-5 * top),
                    n, g.abs().max().item()) for n, g in gg.items()), reverse=True)
    print(f"[5] L train step auto vs gather: {len(gg)} parameter gradients, worst "
          f"max|diff| / max|g| " + ", ".join(f"{e:.3e} at {n} (max|g| {m:.3e})"
                                             for e, n, m in errs[:3])
          + f" (limit 1e-3; floor 1e-5 of the largest |g| {top:.3e})")
    off = [n for e, n, _ in errs if e > 1e-3]
    if off:
        torch.use_deterministic_algorithms(True, warn_only=True)
        hold_to_float64("[5] L", l_train_model("gather"), batch, off, ga, gg, cap=1e-2,
                        floor=1e-5 * top)
        torch.use_deterministic_algorithms(False)
    torch.cuda.empty_cache()


def train_path():
    """Main path 4 (phase 7): the L training step at bs 8, 640 px, bf16
    autocast, accumulation 2, for TRAIN_STEPS micro-steps on a fixed batch,
    then the non-finite skip; returns the launch counts, the step and batch."""
    model = build_model(model_config("l"), device="cuda",
                        generator=torch.Generator().manual_seed(SEED))
    opt = make_optimizer(model, grad_accum_steps=TRAIN_ACCUM)
    step = make_train_step(model, opt, 17)
    batch = synthetic_train_batch(TRAIN_BATCH, 640, 17, 60, "cuda", seed=SEED)
    labels = label_parameters(model)
    named = dict(model.named_parameters())
    before = {n: p.detach().clone() for n, p in named.items()}
    norms = {n: m for n, m in model.named_modules() if isinstance(m, BatchNorm)}
    stats0 = {n: (m.running_mean.clone(), m.running_var.clone()) for n, m in norms.items()}
    zero_launch_counts()
    t0 = time.perf_counter()
    for i in range(TRAIN_STEPS):
        m = step(batch)
        loss = m["loss_total"].item()
        print(f"[7] L train micro-step {i} (bs {TRAIN_BATCH}, 640 px, bf16, accumulation "
              f"{TRAIN_ACCUM}): loss {loss:.4f}, optimiser steps {opt.updates}")
        if not (m["finite"] and np.isfinite(loss)):
            fail(f"L train micro-step {i}: non-finite loss {loss}")
    torch.cuda.synchronize()
    counts = launch_counts()
    print(f"[7] {TRAIN_STEPS} micro-steps in {time.perf_counter() - t0:.2f} s (host clock, "
          f"first calls included); kernel launches {counts}")
    want = {name: (6 * TRAIN_STEPS if name == "msda_fwd" else 0) for name in KERNELS}
    if counts != want:
        fail(f"the training path launched {counts}, expected {want} (6 a micro-step)")
    # every trainable parameter got a gradient (it has AdamW state). One whose
    # gradient is 0 up to rounding (a norm's scale right before a depthwise
    # conv and a batch-statistics norm, which removes it) takes steps of
    # lr * g / eps, which round away; any other must have moved
    trainable = [n for n in named if labels[n] != "frozen"]
    no_state = [n for n in trainable if named[n] not in opt.adamw.state]
    if no_state:
        fail(f"trainable parameters without a gradient: {no_state[:3]}")
    still = [n for n in trainable if torch.equal(named[n].detach(), before[n])]
    bias2 = 1 - 0.999 ** opt.updates
    tiny = [n for n in still
            if (opt.adamw.state[named[n]]["exp_avg_sq"] / bias2).sqrt().max().item() < 1e-6]
    if len(still) > len(tiny):
        fail(f"trainable parameters did not move: {sorted(set(still) - set(tiny))[:3]}")
    frozen_moved = [n for n, p in named.items() if labels[n] == "frozen"
                    and not torch.equal(p.detach(), before[n])]
    if frozen_moved:
        fail(f"frozen parameters moved: {frozen_moved[:3]}")
    bb_moved = [n for n, m in norms.items() if n.startswith("backbone.") and not (
        torch.equal(m.running_mean, stats0[n][0]) and torch.equal(m.running_var, stats0[n][1]))]
    enc_still = [n for n, m in norms.items() if n.startswith("encoder.") and (
        torch.equal(m.running_mean, stats0[n][0]) or torch.equal(m.running_var, stats0[n][1]))]
    if bb_moved or enc_still:
        fail(f"BatchNorm statistics: backbone moved {bb_moved[:3]}, encoder still {enc_still[:3]}")
    if not step.ema.updates == opt.updates == TRAIN_STEPS // TRAIN_ACCUM:
        fail(f"{opt.updates} optimiser steps and {step.ema.updates} EMA updates in "
             f"{TRAIN_STEPS} micro-steps of accumulation {TRAIN_ACCUM}")
    n_bb = sum(n.startswith("backbone.") for n in norms)
    print(f"[7] training path: {sum(labels[n] != 'frozen' for n in named) - len(still)} of "
          f"{sum(labels[n] != 'frozen' for n in named)} trainable parameters moved, the other "
          f"{len(still)} only gradients below 1e-6 (steps that round away) {tiny[:4]}; "
          f"{sum(labels[n] == 'frozen' for n in named)} frozen ones did not; {n_bb} backbone BatchNorms untouched, {len(norms) - n_bb} encoder ones "
          f"moved; {opt.updates} optimiser steps, {step.ema.updates} EMA updates")
    del before

    # the non-finite skip: a NaN image changes nothing
    bad = dict(batch, images=batch["images"].clone())
    bad["images"][0, :, 100, 100] = float("nan")
    snap = ({n: p.detach().clone() for n, p in named.items()},
            {k: {kk: (vv.clone() if torch.is_tensor(vv) else vv) for kk, vv in v.items()}
             for k, v in opt.adamw.state.items()},
            {k: v.clone() for k, v in step.ema.state_dict().items()},
            (opt.updates, step.ema.updates, step.micro))
    m = step(bad)
    torch.cuda.synchronize()
    same = (all(torch.equal(p.detach(), snap[0][n]) for n, p in named.items())
            and all(torch.equal(vv, snap[1][k][kk]) if torch.is_tensor(vv) else vv == snap[1][k][kk]
                    for k, v in opt.adamw.state.items() for kk, vv in v.items())
            and all(torch.equal(v, snap[2][k]) for k, v in step.ema.state_dict().items())
            and (opt.updates, step.ema.updates, step.micro) == snap[3])
    if m["finite"] or not same:
        fail(f"a NaN image: finite {m['finite']}, state unchanged {same}")
    print(f"[7] a batch with a NaN image: loss {m['loss_total'].item()}, skipped; the "
          f"parameters, AdamW state and EMA are bit for bit as they were")
    del snap
    return counts, step, batch


def train_time_split(step, batch, n=TRAIN_ACCUM):
    """``n`` micro-steps (one optimiser step) timed with CUDA events, then
    ``n`` more traced after ``n`` under the profiler's warm-up: the device's busy time by kernel family, its idle
    share against the untraced time, the device time of the kernels inside
    kernel #1's backward range, and the host's and the device's time in each
    phase of the step (``tools/phase_times.py::range_times``)."""
    from torch.autograd import DeviceType

    wall = cuda_time_ms(lambda: step(batch), iters=n, warmup=n) * n
    prof = traced(lambda: step(batch), n)
    annotation = lambda e: getattr(e, "is_user_annotation", False)
    events = prof.key_averages()
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count) for e in events
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
               and not annotation(e)]
    families = {"conv": ("conv", "fprop", "dgrad", "wgrad", "implicit", "xmma"),
                "layout": ("nchwtonhwc", "nhwctonchw"),
                "matmul": ("gemm", "nvjet", "cutlass", "cublas"),
                "batch_norm": ("batch_norm", "bn_"),
                "msda kernel #1": ("msda_fwd",),
                "gather/scatter/index": ("gather", "scatter", "index"),
                "optimizer/EMA (foreach)": ("multi_tensor", "foreach")}
    split = {}
    for name, ms, _ in kernels:
        fam = next((f for f, keys in families.items() if any(k in name.lower() for k in keys)),
                   "other")
        split[fam] = split.get(fam, 0.0) + ms
    busy = sum(split.values())
    # the kernels inside the backward range's span, and each phase's, on the
    # device (one stream)
    ranges = range_times(prof, (BACKWARD_RANGE,) + tuple(PHASES))
    bwd = ranges.get(BACKWARD_RANGE, {"device_ms": 0.0, "spans": 0})
    if busy > wall:
        fail(f"L train step: the traced kernels' device time {busy:.3f} ms exceeds the "
             f"step's {wall:.3f} ms between CUDA events: kernels miscounted")
    return {"wall_ms": wall, "busy_ms": busy, "idle_share": 1 - busy / wall,
            "launches": sum(k[2] for k in kernels), "families_ms": split,
            "msda_backward_ms": bwd["device_ms"], "msda_backward_calls": bwd["spans"],
            "top_kernels": sorted(kernels, key=lambda k: -k[1])[:8],
            "ms_by_phase": {p: ranges[p] for p in PHASES if p in ranges}}


def check_train_op(g):
    """Phase 3: kernel #1's op (the custom op that main paths 4-6 call) at
    the L train shapes, 640 px and main path 5's multi-scale extremes, at
    main path 6's micro-batches of 4 and 2 images, and at main path 8's N
    overfit batch (160 px, 16 images),
    against the plain version on the same inputs, float32 and
    bf16 values: its output, and the value, location and weight gradients
    of one upstream gradient, each within phase 3's limit of its max|ref|.
    Under deterministic algorithms: the value gradient is a scatter of
    atomic adds, and in bf16 their order alone moves it by 2 units in the
    last place (1.6e-2 at 1.5), past the limit."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        _check_train_op(g)
    finally:
        torch.use_deterministic_algorithms(False)


def _check_train_op(g):
    for (label, shp), (dtype, rel) in itertools.product(
            (("train", TRAIN_SHAPES), *TRAIN_MS_SHAPES.items(),
             *((k, v) for k, v in DP_SHAPES.items() if v["Lq"] == TRAIN_SHAPES["Lq"]),
             ("N160t16", PATH8_SHAPES["N160t16"])),
            ((torch.float32, 1e-5), (torch.bfloat16, 1e-2))):
        value, levels, loc, aw = msda_inputs(g, dtype, **shp)
        ins = [t.requires_grad_() for t in (value, loc, aw)]
        grad = torch.randn(value.shape[0], loc.shape[1], value.shape[2], device="cuda",
                           generator=g).to(dtype)
        results = {}
        for which, fn in (("op", ms_deform_attn_fast_flat), ("plain", ms_deform_attn_core)):
            out = fn(ins[0], levels, ins[1], ins[2])
            results[which] = (out.detach(),) + torch.autograd.grad(out, ins, grad)
        torch.cuda.synchronize()
        for what, got, want in zip(("output", "value grad", "location grad", "weight grad"),
                                   results["op"], results["plain"]):
            got, want = got.float(), want.float()
            err = (got - want).abs().max().item()
            scale = want.abs().max().item()
            print(f"[3] msda_fwd op   {label:6s} {str(dtype):14s} {what:13s} max|err| {err:.3e} "
                  f"max|ref| {scale:.3e} (limit {rel:g} of max|ref|)")
            if not (err <= rel * scale and torch.isfinite(got).all()):
                fail(f"kernel #1's op disagrees with the plain version on its {what} at the "
                     f"{label} train shapes, {dtype}")
        del ins, results


def check_backward_kernel(g):
    """Phase 3: kernel #1's backward (csrc/msda_bwd.cu) against the op's
    plain path, autograd through the plain version for the locations and
    weights, at the small shapes, at the energy cell's (L eval, bs 32), at
    the odd and 4-level shapes and on a map 2 elements into its buffer,
    float32 and bf16 values, each gradient within 1e-5 of its max|ref| (the
    same float32 sums in another order); and where some points are NaN or
    +-1e30, NaN exactly where the plain version's gradients are. Returns the
    max|err| at the energy cell's shapes in bf16."""
    err_l = 0.0
    for label, shp in (("test", TEST_SHAPES), ("L", L_SHAPES), ("odd", ODD_SHAPES),
                       ("nL4", NL4_SHAPES), ("offset", TEST_SHAPES), ("nan", TEST_SHAPES)):
        for dtype in (torch.float32, torch.bfloat16):
            value, levels, loc, aw = msda_inputs(g, dtype, **shp)
            if label == "offset":
                value = shifted(value)
            if label == "nan":
                bad = torch.tensor([float("nan"), 1e30, -1e30], device="cuda")
                pick = torch.randint(0, 6, loc.shape, device="cuda", generator=g)
                loc = torch.where(pick < 3, bad[pick.clamp(max=2)], loc)
            grad = torch.randn(value.shape[0], loc.shape[1], value.shape[2], device="cuda",
                               generator=g).to(dtype)
            got = msda_backward(value, levels, loc, aw, grad)
            ins = [loc.clone().requires_grad_(), aw.clone().requires_grad_()]
            with torch.enable_grad():
                want = torch.autograd.grad(ms_deform_attn_core(value, levels, *ins), ins, grad)
            torch.cuda.synchronize()
            plan = backward_plan(shp["dh"], value.element_size(),
                                 (value.data_ptr(), grad.data_ptr()), 1)
            for what, a, b in zip(("location grad", "weight grad"), got, want):
                same_nan = torch.equal(torch.isnan(a), torch.isnan(b))
                err = (a - b).nan_to_num().abs().max().item()
                scale = b.nan_to_num().abs().max().item()
                print(f"[3] msda_bwd      {label:6s} {str(dtype):14s} {what:13s} {plan.vec} "
                      f"channels per load, {plan.lanes} lanes a head, max|err| {err:.3e} "
                      f"max|ref| {scale:.3e} (limit 1e-05 of max|ref|), NaN where the "
                      f"plain version's: {same_nan}")
                if not (same_nan and err <= 1e-5 * scale):
                    fail(f"kernel #1's backward disagrees with the plain version on its "
                         f"{what} at {label} {dtype}")
                if label == "L" and dtype == torch.bfloat16:
                    err_l = max(err_l, err)
            del value, loc, aw, grad, got, ins, want
    return err_l


def msda_backward_times(g, card):
    """Phase 8: kernel #1's backward alone at the energy cell's shapes (L
    eval, bs 32, 60 x 18 queries, bf16 values, the locations' and weights'
    gradients only), CUDA events: the kernel, the op's plain path (autograd
    through the plain version) and the bound (the bytes of
    h100_bench/bounds_msda_bwd.py: value map and output gradient in bf16,
    the float32 points and their gradients, each once; or its 24 float32
    operations per tap and channel); returns the numbers."""
    value, levels, loc, aw = msda_inputs(g, torch.bfloat16, **L_SHAPES)
    grad = torch.randn(value.shape[0], loc.shape[1], value.shape[2], device="cuda",
                       generator=g).to(value.dtype)
    ins = [loc.clone().requires_grad_(), aw.clone().requires_grad_()]

    def plain():
        with torch.enable_grad():
            return torch.autograd.grad(ms_deform_attn_core(value, levels, *ins), ins, grad)

    kernel = lambda: msda_backward(value, levels, loc, aw, grad)
    k_ms = cuda_time_ms(kernel, iters=50)
    traced = kernel_times(kernel, n=10)
    p_ms = cuda_time_ms(plain, iters=5)
    grads = kernel()
    bound = msda_bound_ms(nbytes(value, grad, loc, aw, *grads),
                          OPS_PER_TAP_CHANNEL * aw.numel() * L_SHAPES["dh"])
    gather_bytes = 4 * aw.numel() * L_SHAPES["dh"] * value.element_size()
    print(f"[8] msda_bwd at the energy cell's shapes (B32 Lq1080 80/40/20 nP4 dh32, bf16 "
          f"values, location and weight gradients): kernel {k_ms:.4f} ms (its device time "
          f"{sum(k[1] for k in traced):.4f} ms over {sum(k[2] for k in traced)} launches a "
          f"call), plain path {p_ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]}, "
          f"{nbytes(value, grad, loc, aw, *grads) / 1e6:.2f} MB), {100 * bound[0] / k_ms:.2f}% "
          f"of it; corner-row traffic {gather_bytes / 1e6:.1f} MB through L2 in "
          f"{k_ms:.4f} ms = {gather_bytes / k_ms / 1e9:.3f} TB/s; on {card}")
    return {"ms": k_ms, "device_ms": sum(k[1] for k in traced), "plain_ms": p_ms,
            "bound_ms": bound[0], "bound_by": bound[1]}


def kan_times(g, card):
    """Phase 8: the FastKAN basis product (csrc/kan_basis.cu) at the KAN
    cell's kan1 and kan2 shapes, bf16. First its output against the plain
    version's on the same inputs: the bf16 values within one bf16 ulp of
    each plus the plain float32 product's largest distance from a float64
    product of the same basis (both round a float32 sum of the same terms,
    in another order), and the kernel's float32 sums at most twice as far
    from that float64 product as cuBLAS's float32 product, in their largest
    and their rms error (TF32 off). Then CUDA events: the kernel, its device
    time, the plain version (the float32 basis and product, cast) and the
    bound (one bf16 pass of the product's 2 N D G r operations at the tensor
    cores' peak; the kernel makes three); returns the numbers."""
    rows = {}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    for name, (N, D, G, r) in KAN_SHAPES.items():
        xn = torch.randn(N, D, generator=g, device="cuda").to(torch.bfloat16)
        coeffs = (torch.randn(r, D, G, generator=g, device="cuda") / (D * G) ** 0.5).to(
            torch.bfloat16)
        torch.backends.cuda.matmul.allow_tf32 = False
        got = kan_basis(xn, coeffs, 1.0)[:, :r].float()
        sums = kan_basis(xn, coeffs, 1.0, out_dtype=torch.float32)[:, :r].double()
        plain32 = kan_basis_plain(xn, coeffs, 1.0)
        basis = gaussian_basis(basis_u(xn, G), G, 1.0).reshape(N, D * G)
        exact = basis.double() @ coeffs.reshape(r, D * G).double().T
        del basis
        err_c = (plain32.double() - exact).abs()
        err_k = (sums - exact).abs()
        rms = lambda e: e.pow(2).mean().sqrt().item()
        ratio = (err_k.max().item() / err_c.max().item(), rms(err_k) / rms(err_c))
        plain = plain32.to(torch.bfloat16).float()
        ulp = torch.pow(2.0, torch.floor(torch.log2(torch.maximum(got.abs(), plain.abs())
                                                    .clamp_min(2.0 ** -126))) - 7)
        diff = (got - plain).abs()
        max_abs_err = diff.max().item()
        over = (diff > ulp + err_c.max().item()).sum().item()
        del sums, plain32, exact, err_c, err_k, plain, ulp, diff, got
        torch.backends.cuda.matmul.allow_tf32 = tf32
        print(f"[8] kan_basis vs its plain version at the KAN cell's {name} shapes: max|diff| "
              f"{max_abs_err:.3e}, {over} values past one bf16 ulp + the float32 product's "
              f"error; its float32 sums' error against a float64 product {ratio[0]:.3f}x "
              f"(largest) and {ratio[1]:.3f}x (rms) cuBLAS FP32's (limit 2x)")
        if over or max(ratio) > 2:
            fail(f"kan_basis at {name}: {over} values off the plain version, float32 error "
                 f"{ratio[0]:.3f}x / {ratio[1]:.3f}x cuBLAS's")
        kernel = lambda: kan_basis(xn, coeffs, 1.0)
        k_ms = cuda_time_ms(kernel, iters=20)
        dev = sum(k[1] for k in kernel_times(kernel, n=10))
        p_ms = cuda_time_ms(lambda: kan_basis_plain(xn, coeffs, 1.0).to(torch.bfloat16), iters=5)
        bound = 2 * N * D * G * r / BF16_FLOP_PER_S * 1e3
        print(f"[8] kan_basis at the KAN cell's {name} shapes (N {N}, D {D}, G {G}, r {r}, "
              f"bf16): kernel {k_ms:.4f} ms (its device time {dev:.4f} ms), plain "
              f"{p_ms:.4f} ms, bound {bound:.4f} ms (one bf16 pass at 989 TFLOP/s; "
              f"{3 * bound:.4f} ms for the three it makes), {100 * bound / k_ms:.2f}% of it; "
              f"on {card}")
        rows[name] = {"ms": k_ms, "device_ms": dev, "plain_ms": p_ms, "bound_ms": bound,
                      "bound_by": "operations", "max_abs_err": max_abs_err,
                      "f32_err_vs_cublas": ratio}
        del xn, coeffs
    return rows


def msda_backward_alone(g):
    """Kernel #1's op at the L train shapes (bs 8, 124 x 18 queries, bf16
    values): forward alone, and forward + its plain-version backward, CUDA
    events over 10 calls; returns (forward ms, backward ms)."""
    value, levels, loc, aw = msda_inputs(g, torch.bfloat16, **TRAIN_SHAPES)
    ins = [t.requires_grad_() for t in (value, loc, aw)]
    grad = torch.randn(value.shape[0], loc.shape[1], value.shape[2], device="cuda",
                       generator=g).to(value.dtype)

    def fwd_bwd():
        out = ms_deform_attn_fast_flat(ins[0], levels, ins[1], ins[2])
        torch.autograd.grad(out, ins, grad)

    with torch.no_grad():
        f_ms = cuda_time_ms(lambda: ms_deform_attn_fast_flat(value, levels, loc, aw), iters=10)
    fb_ms = cuda_time_ms(fwd_bwd, iters=10)
    return f_ms, fb_ms - f_ms


# a COCO-ordered 17-joint stick figure in a unit body frame (y down)
POSE_17 = np.array([
    (0.00, -1.00), (-0.08, -1.08), (0.08, -1.08), (-0.20, -1.02), (0.20, -1.02),
    (-0.36, -0.70), (0.36, -0.70), (-0.52, -0.30), (0.52, -0.30), (-0.58, 0.10),
    (0.58, 0.10), (-0.22, 0.00), (0.22, 0.00), (-0.26, 0.55), (0.26, 0.55),
    (-0.28, 1.05), (0.28, 1.05)])


def write_coco_set(root, n_images, K, rng, crowd=False):
    """A synthetic COCO-format keypoint set under ``root``: ``n_images`` JPEG
    images of 640x480 and 480x640 (noisy grey, per-joint coloured disks), 1-6
    people an image (17 keypoints: the stick figure under a random scale,
    rotation and mirror; 14: scattered joints), with boxes and areas; CrowdPose's
    ``crowdIndex`` when ``crowd``. Returns (image dir, annotation file)."""
    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir)
    palette = [tuple(int(c) for c in rng.integers(40, 256, 3)) for _ in range(K)]
    images, anns = [], []
    for i in range(n_images):
        w, h = (640, 480) if i % 2 == 0 else (480, 640)
        img = Image.fromarray(rng.integers(96, 160, (h, w, 3), dtype=np.uint8))
        draw = ImageDraw.Draw(img)
        for _ in range(int(rng.integers(1, 7))):
            s = rng.uniform(40, 110)
            c = rng.uniform(s * 1.2, (w - s * 1.2, h - s * 1.2))
            if K == 17:
                rot = rng.uniform(-0.45, 0.45)
                pts = POSE_17 * s * (rng.choice([-1.0, 1.0]), 1.0)
                pts = pts @ np.array([[np.cos(rot), -np.sin(rot)], [np.sin(rot), np.cos(rot)]]).T
            else:
                pts = rng.uniform(-s, s, (K, 2))
            xy = np.clip(c + pts + rng.uniform(-2, 2, pts.shape), 0, (w - 1, h - 1))
            vis = np.where(rng.uniform(size=K) < 0.9, 2, 0)
            for k, (x, y) in enumerate(xy):
                draw.ellipse([x - 4, y - 4, x + 4, y + 4], fill=palette[k])
            x0, y0 = xy.min(0)
            bw, bh = xy.max(0) - (x0, y0)
            anns.append({"id": len(anns) + 1, "image_id": i, "category_id": 1, "iscrowd": 0,
                         "keypoints": np.concatenate([xy, vis[:, None]], 1).ravel().tolist(),
                         "num_keypoints": int((vis > 0).sum()),
                         "bbox": [float(x0), float(y0), float(bw), float(bh)],
                         "area": float(bw * bh)})
        img.save(os.path.join(img_dir, f"{i:05d}.jpg"), quality=90)
        info = {"id": i, "file_name": f"{i:05d}.jpg", "width": w, "height": h}
        if crowd:
            info["crowdIndex"] = float(rng.choice([0.05, 0.5, 0.9]))
        images.append(info)
    ann_file = os.path.join(root, "annotations.json")
    with open(ann_file, "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": [{"id": 1, "name": "person"}]}, f)
    return img_dir, ann_file


def run_train_cli(argv):
    """``tools/train.py::main(argv)``, the last lines of its standard output
    echoed; returns (the Trainer, the last JSON line it printed or None)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        trainer = train_main(argv)
    out = buf.getvalue()
    print("\n".join("    | " + line for line in out.splitlines()[-6:]))
    printed = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
    return trainer, (printed[-1] if printed else None)


def compare_detections(got, want, rel):
    """The kernel's detections (``KeypointEvaluator.dets``) against the plain
    version's, image by image -> (scores' error, keypoints' error, the most
    detections of one image let off at the top-k boundary), each error over
    max|ref|.

    Scores compare as the logits they are the sigmoid of (the model's own
    output, whose bf16 last place is 2^-7 of it), in sorted order: the i-th
    best of two sets of logits differ by no more than the logits do, whatever
    near-tied pairs swap or cross the top-k boundary. Each detection's (x, y)
    keypoints compare with the nearest of the other run's detections; one
    with no match within ``rel`` is let off only at the boundary, its logit
    within ``rel`` of max|ref| of the other run's lowest, and only
    MAX_AT_BOUNDARY of them an image."""
    if got.keys() != want.keys():
        fail("the two evaluations saw other images")

    def logits(ds):
        s = np.clip(np.array([d["score"] for d in ds], np.float64), 1e-12, 1 - 1e-12)
        return np.log(s / (1 - s))

    l_ref = max(np.abs(logits(ds)).max() for ds in want.values())
    k_ref = float(max(np.abs(d["keypoints"][:, :2]).max() for ds in want.values() for d in ds))
    worst_l = worst_k = 0.0
    boundary = 0
    for img, wd in want.items():
        at_edge = 0
        gd = got[img]
        if len(gd) != len(wd):
            fail(f"image {img}: {len(gd)} detections against {len(wd)}")
        gl, wl = logits(gd), logits(wd)
        worst_l = max(worst_l, float(np.abs(np.sort(gl) - np.sort(wl)).max()))
        wk = np.stack([e["keypoints"][:, :2] for e in wd])
        for d, lg in zip(gd, gl):
            err = float(np.abs(wk - d["keypoints"][:, :2]).max((1, 2)).min())
            if err > rel * k_ref and lg - wl.min() <= rel * l_ref:
                at_edge += 1
                continue
            worst_k = max(worst_k, err)
        if at_edge > MAX_AT_BOUNDARY:
            fail(f"image {img}: {at_edge} detections at the top-k boundary with no "
                 f"counterpart, more than {MAX_AT_BOUNDARY}")
        boundary = max(boundary, at_edge)
    return float(worst_l / l_ref), worst_k / k_ref, boundary


def trainer_path(card):
    """Main path 5 (phase 9): the training command line on DETRPose-L at
    full width and depth, 640 px, bf16, through the real dataset, augmentations,
    worker pool, loader, Trainer, evaluator and checkpoints; then --eval
    --resume, the plain version's evaluation of the same checkpoint, the
    evaluator's own checks and CrowdPose. Returns the launch counts of the
    training command and the numbers to report."""
    rng = np.random.default_rng(SEED)
    root = tempfile.mkdtemp(prefix="chip_smoke_trainer_")
    try:
        sets = {name: write_coco_set(os.path.join(root, name), n, K, rng,
                                     crowd=(name == "crowdpose"))
                for name, (n, K) in TRAINER_SETS.items()}
        return _trainer_path(card, root, sets)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _trainer_path(card, root, sets):
    out = os.path.join(root, "out")
    (img_dir, ann), (vdir, vann), (cdir, cann) = (sets[k] for k in ("train", "val", "crowdpose"))
    coco_l = ["--config", "configs/coco/detrpose_l.py", "--val-img-dir", vdir,
              "--val-ann", vann, "--output-dir", out, "--options",
              f"training_params.eval_batch_size={TRAINER_EVAL_BATCH}"]
    # every evaluation of this path, in the run that trains too, under
    # deterministic algorithms: the resumed evaluation must repeat epoch 1's
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        torch.cuda.synchronize()
        base_mem = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        zero_launch_counts()
        t0 = time.perf_counter()
        trainer, _ = run_train_cli(["--img-dir", img_dir, "--ann", ann, "--epochs",
                                    str(TRAINER_EPOCHS), "--batch-size", "16"] + coco_l)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        hist = [dict(h) for h in trainer.history]   # the fit's own epochs
        n_train = len(trainer.train_loader)
        n_val = len(trainer.val_loader)
        if trainer.step.step != TRAINER_EPOCHS * n_train or n_train != 4 or n_val != 2:
            fail(f"the trainer took {trainer.step.step} micro-steps ({n_train} an epoch) and "
                 f"{n_val} eval batches")
        # 6 launches a forward: every train micro-step, and every eval batch
        # of the EMA's and the live weights' evaluation each epoch
        want = {k: 0 for k in KERNELS}
        want["msda_fwd"] = 6 * (trainer.step.step + 2 * TRAINER_EPOCHS * n_val)
        print(f"[9] Trainer L (bs 16 = 2 x 8, 640 px base, multi-scale, bf16, {TRAINER_EPOCHS} "
              f"epochs): {trainer.step.step} micro-steps, {trainer.optimizer.updates} optimiser "
              f"steps, {2 * TRAINER_EPOCHS * n_val} eval batches; kernel launches {counts}")
        if counts != want:
            fail(f"main path 5 launched {counts}, expected {want}")
        with open(os.path.join(out, "log.txt")) as f:
            log = [json.loads(line) for line in f]
        if len(log) != TRAINER_EPOCHS or not all(
                np.isfinite(r["train_loss_total"]) and "AP" in r and "regular_AP" in r
                for r in log):
            fail(f"log.txt: {log}")
        for r in log:
            print(f"[9] log.txt epoch {r['epoch']}: train_loss_total {r['train_loss_total']:.4f}, "
                  f"AP {r['AP']}, regular_AP {r['regular_AP']}, lr {r['train_lr']}")
        # best_ema / best_regular follow their stream's best AP, which starts
        # at 0: with AP 0 (random weights after 8 micro-steps) none is written
        files = {name: os.path.exists(os.path.join(out, name))
                 for name in ("checkpoint", "best", "best_ema", "best_regular", "config.yaml")}
        holder = trainer.best_holder
        want_files = {"checkpoint": True, "best": True, "config.yaml": True,
                      "best_ema": holder.best_ema["best_ep"] >= 0,
                      "best_regular": holder.best_regular["best_ep"] >= 0}
        print(f"[9] files written: {files}; stream bests {holder.summary()}")
        if files != want_files:
            fail(f"the run directory holds {files}, expected {want_files}")

        # resume and evaluate: epoch 1's EMA stats, exactly, and the same
        # detections, bit for bit, as the trained Trainer's EMA evaluation
        again = trainer.evaluate(use_ema=True)
        zero_launch_counts()
        resumed, printed = run_train_cli(["--eval", "--resume",
                                          os.path.join(out, "checkpoint")] + coco_l)
        logged = {k: v for k, v in log[-1].items() if k in printed}
        same_dets = (resumed.evaluator.dets.keys() == trainer.evaluator.dets.keys() and all(
            len(a) == len(b) and all(d["score"] == e["score"] and
                                     np.array_equal(d["keypoints"], e["keypoints"])
                                     for d, e in zip(a, b))
            for a, b in ((resumed.evaluator.dets[i], trainer.evaluator.dets[i])
                         for i in trainer.evaluator.dets)))
        print(f"[9] --eval --resume checkpoint printed AP {printed['AP']}, AR {printed['AR']}: "
              f"{'equal to' if printed == logged == again else 'NOT equal to'} the epoch "
              f"{log[-1]['epoch']} EMA stats of log.txt and of the trained Trainer's EMA "
              f"evaluation ({len(printed)} stats); its {sum(map(len, resumed.evaluator.dets.values()))} "
              f"detections {'bit for bit' if same_dets else 'NOT'} those of the latter; launches "
              f"{launch_counts()}")
        if printed != logged or printed != again or not same_dets \
                or launch_counts()["msda_fwd"] != 6 * n_val:
            fail(f"--eval --resume printed {printed}, log.txt has {logged}, the trained "
                 f"Trainer {again}; detections equal {same_dets}")

        # the same checkpoint through the plain version
        plain, _ = run_train_cli(["--eval", "--resume", os.path.join(out, "checkpoint")]
                                 + coco_l + ["model_overrides.msda_backend=gather"])
        if launch_counts()["msda_fwd"] != 6 * n_val:
            fail("the plain version's evaluation launched kernel #1")
        err_l, err_k, n_edge = compare_detections(resumed.evaluator.dets,
                                                  plain.evaluator.dets, 1e-2)
        print(f"[9] detections of kernel #1 against msda_backend='gather' on the checkpoint "
              f"(bf16): score logits {err_l:.3e}, keypoints {err_k:.3e} of max|ref| (limit "
              f"1e-2; at most {n_edge} detections an image at the top-k boundary, limit "
              f"{MAX_AT_BOUNDARY})")
        if not (err_l <= 1e-2 and err_k <= 1e-2):
            fail("kernel #1's detections differ from the plain version's")
        # and in float32 (TF32 off), where they agree to float32 rounding
        tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        f32 = []
        for tr in (resumed, plain):
            tr.compute_dtype = torch.float32
            tr.evaluate()
            f32.append(tr.evaluator.dets)
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
        err32 = compare_detections(*f32, 1e-4)
        print(f"[9] the same in float32: score logits {err32[0]:.3e}, keypoints {err32[1]:.3e} "
              f"of max|ref| (limit 1e-4; at most {err32[2]} an image at the boundary)")
        if not (err32[0] <= 1e-4 and err32[1] <= 1e-4):
            fail("kernel #1's float32 detections differ from the plain version's")
    finally:
        torch.backends.cudnn.deterministic = False
        torch.use_deterministic_algorithms(False)

    # the evaluator: the ground truth as detections; the native match and
    # the Python loop on the checkpoint's detections plus jittered copies of
    # the ground truth (random weights alone match nothing)
    gts = trainer.val_gts
    ev = KeypointEvaluator(gts, 17)
    for img, g in gts.items():
        ev.update(img, np.ones(len(g["anns"])), np.stack([a["keypoints"] for a in g["anns"]]))
    ev.accumulate()
    gt_stats = ev.summarize()
    stats = {}
    for native in (True, False):
        e = KeypointEvaluator(gts, 17, use_native=native)
        e.merge([resumed.evaluator])
        r = np.random.default_rng(SEED + 1)
        for img, g in gts.items():
            k = np.stack([a["keypoints"] for a in g["anns"]]).copy()
            k[:, :, :2] += r.normal(0, 1, (len(k), 1, 1)) * r.uniform(0, 8, (len(k), 17, 2))
            e.update(img, r.uniform(0, 1, len(k)), k)
        e.accumulate()
        stats[native] = (e.summarize(), e.matched_by)
    matched_by = resumed.evaluator.matched_by
    print(f"[9] evaluator: the ground truth as detections gives AP {gt_stats['AP']}, AR "
          f"{gt_stats['AR']}; the checkpoint's detections and jittered ground truth: AP "
          f"{stats[True][0]['AP']:.6f} by the {stats[True][1]} match, {stats[False][0]['AP']:.6f} "
          f"by the {stats[False][1]} loop, all {len(stats[True][0])} stats "
          f"{'identical' if stats[True][0] == stats[False][0] else 'DIFFERENT'}; the trainer's "
          f"evaluations ran the {matched_by} match"
          + (f" (the native one did not build: {native_error()})" if matched_by != "native"
             else ""))
    if gt_stats["AP"] != 1.0 or gt_stats["AR"] != 1.0 or stats[True][0] != stats[False][0] \
            or not 0.0 < stats[True][0]["AP"] < 1.0:
        fail(f"evaluator: ground truth {gt_stats}, native {stats[True]}, Python {stats[False]}")

    # CrowdPose: 14 keypoints, box-area OKS, AP easy / medium / hard
    zero_launch_counts()
    _, crowd = run_train_cli(["--eval", "--config", "configs/crowdpose/detrpose_l.py",
                              "--val-img-dir", cdir, "--val-ann", cann, "--output-dir",
                              os.path.join(root, "crowd"), "--options",
                              f"training_params.eval_batch_size={TRAINER_EVAL_BATCH}"])
    print(f"[9] CrowdPose L --eval (14 keypoints, {TRAINER_SETS['crowdpose'][0]} images): "
          + ", ".join(f"{k} {crowd.get(k)}" for k in ("AP", "AP_easy", "AP_medium", "AP_hard"))
          + f"; launches {launch_counts()}")
    if not {"AP_easy", "AP_medium", "AP_hard"} <= crowd.keys() or launch_counts()["msda_fwd"] != 6:
        fail(f"CrowdPose --eval printed {crowd}")

    train_s = sum(h["epoch_s"] for h in hist)
    eval_s = sum(h["eval_s"] for h in hist)
    numbers = {
        "fit_s": fit_s, "epoch_s": [h["epoch_s"] for h in hist],
        "epoch_with_eval_s": [h["epoch_s"] + h["eval_s"] for h in hist],
        "train_img_per_s": sum(h["train_images"] for h in hist) / train_s,
        "eval_img_per_s": sum(h["eval_images"] for h in hist) / eval_s,
        "loader_wait_share": sum(h["data_wait_s"] for h in hist) / fit_s,
        "peak_mem_bytes": peak, "mem_before_bytes": base_mem, "matched_by": matched_by,
        "detections_err": {"bf16": {"score_logits": err_l, "keypoints": err_k,
                                    "at_boundary": n_edge},
                           "float32": dict(zip(("score_logits", "keypoints", "at_boundary"),
                                               err32))},
        "data_wait_s": [h["data_wait_s"] for h in hist],
        "step_ms": [r.get("train_step_ms") for r in log],
    }
    # one more epoch of the same Trainer without deterministic algorithms:
    # what they cost the step (the comparisons above need them)
    extra = trainer.train_one_epoch(TRAINER_EPOCHS)
    numbers["nondeterministic"] = {k: extra.get(k) for k in ("epoch_s", "step_ms")}
    if not extra["finite"] == 1.0:
        fail(f"the extra epoch: {extra}")
    print(f"[9] Trainer L timing (host clock, deterministic algorithms on): fit "
          f"{fit_s:.2f} s for {TRAINER_EPOCHS} epochs (command, model build and checkpoints "
          f"included); training epochs " + ", ".join(f"{t:.2f}" for t in numbers["epoch_s"])
          + " s (" + ", ".join(f"{t:.2f}" for t in numbers["epoch_with_eval_s"])
          + f" s with both evaluations); train {numbers['train_img_per_s']:.1f} img/s, "
          f"eval {numbers['eval_img_per_s']:.1f} img/s; waiting on the loader "
          f"{100 * numbers['loader_wait_share']:.1f}% of the fit's wall time (by epoch "
          + ", ".join(f"{t:.2f}" for t in numbers["data_wait_s"]) + " s); steady step "
          + ", ".join(f"{t:.3f}" for t in numbers["step_ms"] if t is not None)
          + f" ms; peak device memory {peak / 2**30:.2f} GiB ({base_mem / 2**30:.2f} GiB "
          f"held before); the {matched_by} match; on {card}")
    step = extra.get("step_ms")
    print(f"[9] one more epoch without deterministic algorithms: {extra['epoch_s']:.2f} s, "
          f"steady step {'not measured (every shape new)' if step is None else f'{step:.3f} ms'}"
          f"; on {card}")
    return counts, numbers


# ---- main path 6: data parallelism over ranks --------------------------
DP_DEADLINE_S = 420          # each spawn of ranks, joined or killed
DP_TIMED = 2 * TRAIN_ACCUM   # micro-steps timed after the checked ones, each way
# the 2-rank step against one process on the same bs-8 batch. In bf16 (the
# path as users run it): the global losses within bf16's 1%. In float32 (TF32
# off, deterministic algorithms), one optimiser step of accumulation 1: the
# global loss within 1e-4 relative (one N step's loss against JAX's,
# tests/test_torch_train_step.py); each leaf's all-reduced gradient within
# DP_GRAD_REL of its max|g| (at least 1e-5 of the largest |g|), and its
# update within DP_UPDATE_REL of its L2 norm. Two runs on an H100 read at
# most 6.3e-3 and 5.2e-3, the same to four digits (the encoder's pose head,
# the first decoder layer's sampling offsets: the ranks' convs and matmuls
# run at half the batch, other orders of the same sums); a rank that
# missed a reduction would be off by tens of percent. Left out: the leaves
# whose gradient is 0 in exact arithmetic, below DP_ZERO_REL of the largest
# in a float64 step (the shifts and scales that batch-statistics norms
# cancel: in float32 each is a sum that cancels to its rounding, which any
# other order of the same sums moves by tens)
DP_LOSS_REL, DP_F32_REL, DP_GRAD_REL, DP_UPDATE_REL, DP_ZERO_REL = 1e-2, 1e-4, 2e-2, 2e-2, 1e-9
# profiler events of the collectives (gloo's, NCCL's and torch.distributed's)
COLLECTIVE_KEYS = ("all_reduce", "allreduce", "all_gather", "allgather", "broadcast",
                   "gloo", "nccl", "c10d")


def state_bits(step):
    """The parameters, EMA weights and floating buffers of a step as one
    int32 vector of their bits."""
    ts = ([p.detach() for p in step.model.parameters()]
          + [b for b in step.model.buffers() if b.is_floating_point()]
          + list(step.ema.state_dict().values()))
    return torch.cat([t.reshape(-1).view(torch.int32) for t in ts])


def bit_identical_across_ranks(step):
    """Whether every rank holds the same bits (their max equals their min)."""
    import torch.distributed as dist

    bits = state_bits(step)
    hi, lo = bits.clone(), bits.clone()
    dist.all_reduce(hi, op=dist.ReduceOp.MAX)
    dist.all_reduce(lo, op=dist.ReduceOp.MIN)
    return bool(torch.equal(hi, lo))


def dp_batch():
    """The fixed bs-8 batch of main path 4, every image with its CDN block."""
    return synthetic_train_batch(TRAIN_BATCH, 640, 17, 60, "cuda", seed=SEED)


def dp_train_step(accum=TRAIN_ACCUM, backend="auto", dtype=torch.float32, **kwargs):
    """DETRPose-L from the seed (phase 4's perturbed constant leaves, so no
    two queries tie in the matcher: a tie's assignment would follow the
    rounding, and its gradients with it) with its parameters in ``dtype``,
    and its step (the bs-8 recipe: bf16 and accumulation 2 unless asked),
    which keeps the gradients it steps with in ``step.grads``."""
    model = l_train_model(backend).to(dtype)
    opt = make_optimizer(model, grad_accum_steps=accum)
    step = make_train_step(model, opt, 17, **kwargs)
    real = opt.step

    def keep_grads():
        step.grads = {n: p.grad.detach().float().cpu() for n, p in model.named_parameters()
                      if p.grad is not None}
        return real()
    opt.step = keep_grads
    return step


@contextlib.contextmanager
def exact_float32():
    """Float32 without TF32, and deterministic algorithms; TF32 on after."""
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        torch.backends.cudnn.deterministic = False
        torch.use_deterministic_algorithms(False)


def dp_float32_step(batch):
    """One optimiser step (accumulation 1) of dp_train_step's model on
    ``batch`` under exact_float32: the global loss terms, the (all-reduced)
    gradients it stepped with and each leaf's update, on the CPU."""
    with exact_float32():
        step = dp_train_step(accum=1, compute_dtype=torch.float32, use_ema=False)
        before = {n: p.detach().clone() for n, p in step.model.named_parameters()}
        terms = {k: v.item() for k, v in step(batch).items() if torch.is_tensor(v)}
        update = {n: (p.detach() - before[n]).cpu() for n, p in step.model.named_parameters()}
    return {"terms": terms, "grads": step.grads, "update": update}


def dp_exact_zero_leaves(batch):
    """The leaves whose gradient in one float64 step of the plain-version
    model on ``batch`` is below DP_ZERO_REL of the largest; and the step's
    peak memory."""
    torch.cuda.reset_peak_memory_stats()
    step = dp_train_step(accum=1, backend="gather", dtype=torch.float64,
                         compute_dtype=torch.float32, use_ema=False)
    step(dict(batch, images=batch["images"].double()))
    top = max(g.abs().max().item() for g in step.grads.values())
    zero = {n for n, g in step.grads.items() if g.abs().max().item() <= DP_ZERO_REL * top}
    return zero, torch.cuda.max_memory_allocated()


def dp_one_step(step, batch):
    """One optimiser step (TRAIN_ACCUM micro-steps) -> (global losses, kernel
    launches), the counts set to 0 first."""
    zero_launch_counts()
    losses = []
    for _ in range(TRAIN_ACCUM):
        m = step(batch)
        if not m["finite"]:
            fail(f"data-parallel step: non-finite loss {m['loss_total'].item()}")
        losses.append(m["loss_total"].item())
    torch.cuda.synchronize()
    return losses, launch_counts()


def dp_time(step, batch):
    """The step's ms a micro-step (host clock, synchronised) over DP_TIMED
    micro-steps in whole optimiser steps; across ranks also with the
    gradient all-reduce left out (every micro-step under DDP's no_sync, the
    ranks' weights parting from then on), the two ways alternating by
    optimiser step. Then one traced optimiser step: the host's self time in
    the collectives' calls (their dispatch: waits for another rank, and
    gloo's work on its own threads, fall outside it)."""
    from torch.autograd import DeviceType

    ways = (False, True) if step.net is not step.model else (False,)
    secs = dict.fromkeys(ways, 0.0)
    for _ in range(DP_TIMED // TRAIN_ACCUM):
        for no_sync in ways:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with step.net.no_sync() if no_sync else contextlib.nullcontext():
                for _ in range(TRAIN_ACCUM):
                    step(batch)
            torch.cuda.synchronize()
            secs[no_sync] += time.perf_counter() - t0
    prof = traced(lambda: step(batch), TRAIN_ACCUM)
    coll = [e for e in prof.key_averages() if e.device_type == DeviceType.CPU
            and any(k in e.key.lower() for k in COLLECTIVE_KEYS)]
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
           and any(k in e.key.lower() for k in ("nccl", "memcpy"))]
    return {"ms_per_micro_step": secs[False] * 1e3 / DP_TIMED,
            "no_sync_ms_per_micro_step": secs[True] * 1e3 / DP_TIMED if True in secs else None,
            "collective_dispatch_ms": sum(e.self_cpu_time_total for e in coll) / 1e3,
            "collective_calls": sum(e.count for e in coll),
            "collective_ops": sorted({e.key for e in coll}),
            "nccl_or_copy_device_ms": sum(e.self_device_time_total for e in dev) / 1e3}


def dp_rank_step(rank, world, work):
    """Main path 6 (a) in one rank, on its share of the bs-8 batch: one
    optimiser step in bf16 (its global losses, launches, whether the ranks
    hold the same bits), the skip with a NaN on the last rank, the times and
    peak memory; then dp_float32_step, whose results rank 0 keeps."""
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    step = dp_train_step()
    batch = shard_batch(dp_batch(), rank, world)
    torch.cuda.reset_peak_memory_stats()
    losses, counts = dp_one_step(step, batch)
    same = bit_identical_across_ranks(step)
    # a NaN pixel on the last rank: the global statistics carry it to every
    # rank, every rank skips, nothing waits
    bad = dict(batch, images=batch["images"].clone())
    if rank == world - 1:
        bad["images"][0, :, 100, 100] = float("nan")
    bits = state_bits(step).clone()
    m = step(bad)
    torch.cuda.synchronize()
    skip = {"finite": m["finite"], "kept": bool(torch.equal(state_bits(step), bits)),
            "micro": step.micro}
    del bits, bad
    timing = dp_time(step, batch)
    peak = torch.cuda.max_memory_allocated()
    del step
    torch.cuda.empty_cache()
    f32 = dp_float32_step(batch)
    if rank == 0:
        torch.save(f32, os.path.join(work, "f32.pt"))
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump({"losses": losses, "launches": counts, "same_bits": same, "skip": skip,
                   "timing": timing, "backend": torch.distributed.get_backend(),
                   "peak_mem_bytes": peak}, f)


def dp_rank_cli(rank, world, work, argv, options):
    """Main path 6 (b) in one rank: tools/train.py's command line (Trainer.fit
    of an epoch with its evaluations) in this rank's output directory, then
    one more evaluate; its stats, steps and launches."""
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    zero_launch_counts()
    trainer, _ = run_train_cli(argv + ["--output-dir", os.path.join(work, f"rank{rank}")]
                               + options)
    stats = trainer.evaluate()
    torch.cuda.synchronize()
    if rank == 0:
        torch.save(trainer.evaluator.dets, os.path.join(work, "dets.pt"))
    with open(os.path.join(work, f"cli{rank}.json"), "w") as f:
        json.dump({"stats": stats, "micro_steps": trainer.step.step,
                   "train_batches": len(trainer.train_loader),
                   "val_batches": len(trainer.val_loader), "launches": launch_counts(),
                   "ddp": trainer.step.net is not trainer.step.model}, f)


def cli_rank(out_json, argv):
    """Main path 6 (c): one rank of ``torch.distributed.run``, tools/train.py's
    command line on argv; the backend, whether DDP wrapped the model, and
    the launches go to ``out_json``."""
    import torch.distributed as dist

    zero_launch_counts()
    try:
        trainer = train_main(argv)
        torch.cuda.synchronize()
        with open(out_json, "w") as f:
            json.dump({"backend": dist.get_backend(), "world": dist.get_world_size(),
                       "ddp": trainer.step.net is not trainer.step.model,
                       "micro_steps": trainer.step.step, "launches": launch_counts()}, f)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def dp_compare(ref, got, zero, label):
    """The 2-rank step against one process's: the bf16 losses, then the
    float32 step's loss, gradients and updates, each leaf but those in
    ``zero`` against its limit; fails past them. Returns the worst of each,
    gradients and updates as a share of the leaf's limit."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"]))
    want, have = ref["f32"], got["f32"]
    if want["grads"].keys() != have["grads"].keys() or want["terms"].keys() != have["terms"].keys():
        fail(f"{label}: the ranks' float32 step covers other leaves or terms than one process's")
    f32 = abs(have["terms"]["loss_total"] - want["terms"]["loss_total"]) \
        / abs(want["terms"]["loss_total"])
    term = max((abs(have["terms"][k] - v) / max(abs(v), 1e-12), k)
               for k, v in want["terms"].items())
    top = max(g.abs().max().item() for g in want["grads"].values())
    held = [n for n in want["grads"] if n not in zero]
    grad = sorted(((have["grads"][n] - want["grads"][n]).abs().max().item()
                   / (DP_GRAD_REL * max(want["grads"][n].abs().max().item(), 1e-5 * top)), n)
                  for n in held)[::-1]
    upd = sorted(((have["update"][n] - want["update"][n]).norm().item()
                  / max(DP_UPDATE_REL * want["update"][n].norm().item(), 1e-30), n)
                 for n in held)[::-1]
    print(f"[10] {label} against one process, one optimiser step on the bs-{TRAIN_BATCH} "
          f"batch: bf16 losses {got['losses']} vs {ref['losses']} (worst relative {loss:.3e}, "
          f"limit {DP_LOSS_REL}); float32 (TF32 off, accumulation 1) loss_total "
          f"{have['terms']['loss_total']} vs {want['terms']['loss_total']}, relative "
          f"{f32:.3e} (limit {DP_F32_REL}), of its {len(want['terms']) - 1} terms the most "
          f"apart {term[1]} {term[0]:.3e} relative; {len(held)} of {len(want['grads'])} "
          f"gradients held ({len(zero)} are 0 in float64), worst max|difference| "
          + ", ".join(f"{e:.3e} at {n}" for e, n in grad[:3])
          + f" of each leaf's limit ({DP_GRAD_REL} of its max|g|, at least 1e-5 of the "
          f"largest); updates, worst L2 difference " + ", ".join(
              f"{e:.3e} at {n}" for e, n in upd[:3])
          + f" of the limit ({DP_UPDATE_REL} of the leaf's L2 norm)")
    if not (loss <= DP_LOSS_REL and f32 <= DP_F32_REL and len(held) > 0.6 * len(want["grads"])
            and grad[0][0] <= 1.0 and upd[0][0] <= 1.0):
        fail(f"{label}: the 2-rank step differs from one process's")
    return {"loss_rel": loss, "f32_loss_rel": f32, "f32_worst_term": term,
            "grad_share_of_limit": grad[0][0], "update_share_of_limit": upd[0][0],
            "worst_grad_leaf": grad[0][1], "worst_update_leaf": upd[0][1],
            "leaves_held": len(held), "leaves": len(want["grads"])}


def dp_step_path(card, ref, zero, backend, local_ranks):
    """Main path 6 (a) or (d): the step in DP_RANKS ranks over ``backend``
    on the cards ``local_ranks``, held against one process (``ref``)."""
    label = f"{DP_RANKS} ranks over {backend} on cuda:{','.join(map(str, local_ranks))}"
    work = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    try:
        t0 = time.perf_counter()
        run_ranks(dp_rank_step, DP_RANKS, (work,), deadline_s=DP_DEADLINE_S, device="cuda",
                  backend=backend, local_ranks=local_ranks)
        spawn_s = time.perf_counter() - t0
        ranks = [json.load(open(os.path.join(work, f"rank{r}.json"))) for r in range(DP_RANKS)]
        f32 = torch.load(os.path.join(work, "f32.pt"), weights_only=False)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    want = {k: (6 * TRAIN_ACCUM if k == "msda_fwd" else 0) for k in KERNELS}
    for r, g in enumerate(ranks):
        print(f"[10] {label}, rank {r} ({g['backend']}): kernel launches {g['launches']} in "
              f"{TRAIN_ACCUM} micro-steps; bits equal across the ranks {g['same_bits']}; "
              f"NaN on rank {DP_RANKS - 1}: finite {g['skip']['finite']}, state kept "
              f"{g['skip']['kept']}; peak memory {g['peak_mem_bytes'] / 2**30:.2f} GiB")
        if g["launches"] != want:
            fail(f"{label}: rank {r} launched {g['launches']}, expected {want}")
        if not g["same_bits"] or g["skip"]["finite"] or not g["skip"]["kept"] \
                or g["losses"] != ranks[0]["losses"]:
            fail(f"{label}: rank {r}: ranks differ or the skip failed: {g}")
    worst = dp_compare(ref, dict(ranks[0], f32=f32), zero, label)
    tm = [g["timing"] for g in ranks]
    ms = max(t["ms_per_micro_step"] for t in tm)
    free = max(t["no_sync_ms_per_micro_step"] for t in tm)
    step_ms = TRAIN_ACCUM * tm[0]["ms_per_micro_step"]
    print(f"[10] {label}: {ms:.3f} ms a micro-step of the global bs {TRAIN_BATCH} (the slower "
          f"rank; host clock, synchronised; ranks "
          f"{[round(t['ms_per_micro_step'], 3) for t in tm]}) against one process's "
          f"{ref['ms_per_micro_step']:.3f} ms; without the gradient all-reduce (no_sync) "
          f"{free:.3f} ms, so the all-reduce takes {TRAIN_ACCUM * (ms - free):.3f} ms of an "
          f"optimiser step ({100 * (ms - free) / ms:.1f}%, waits included); rank 0's host "
          f"self time in the collectives' calls (dispatch; waits and gloo's threads outside "
          f"it) {tm[0]['collective_dispatch_ms']:.3f} ms over {tm[0]['collective_calls']} calls "
          f"in a traced optimiser step = {100 * tm[0]['collective_dispatch_ms'] / step_ms:.1f}% "
          f"of its untraced one ({step_ms:.3f} ms); device time in NCCL kernels and copies "
          f"{tm[0]['nccl_or_copy_device_ms']:.3f} ms; spawn and run {spawn_s:.1f} s; on {card}")
    return ({k: sum(g["launches"][k] for g in ranks) for k in KERNELS},
            {"label": label, "ms_per_micro_step": ms, "no_sync_ms_per_micro_step": free,
             "grad_all_reduce_share": (ms - free) / ms,
             "collective_dispatch_share": tm[0]["collective_dispatch_ms"] / step_ms,
             "ranks": ranks, "compare": worst,
             "one_process_ms_per_micro_step": ref["ms_per_micro_step"],
             "one_process_peak_mem_bytes": ref["peak_mem_bytes"]})


def dp_cli_paths(card, root):
    """Main path 6 (b) and (c) on an 8-image synthetic COCO set: the command
    line (Trainer.fit, one epoch, with its evaluations) in 2 ranks over gloo
    on one card, held against one process's evaluation of rank 0's
    checkpoint; then under ``torch.distributed.run --nproc_per_node 1`` on
    NCCL. Returns the launch counts and the numbers."""
    img_dir, ann = write_coco_set(os.path.join(root, "set"), DP_SET, 17,
                                  np.random.default_rng(SEED + 10))
    coco_l = ["--config", "configs/coco/detrpose_l.py", "--img-dir", img_dir, "--ann", ann,
              "--val-img-dir", img_dir, "--val-ann", ann, "--epochs", "1", "--batch-size",
              str(DP_SET)]
    options = ["--options", f"training_params.eval_batch_size={DP_EVAL_BATCH}"]
    work = os.path.join(root, "b")
    os.makedirs(work)
    t0 = time.perf_counter()
    run_ranks(dp_rank_cli, DP_RANKS, (work, coco_l, options), deadline_s=DP_DEADLINE_S,
              device="cuda", backend="gloo", local_ranks=[0] * DP_RANKS)
    b_s = time.perf_counter() - t0
    ranks = [json.load(open(os.path.join(work, f"cli{r}.json"))) for r in range(DP_RANKS)]
    written = {r: sorted(os.listdir(os.path.join(work, f"rank{r}"))) for r in range(DP_RANKS)}
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        alone, one = run_train_cli(coco_l + ["--eval", "--resume",
                                         os.path.join(work, "rank0", "checkpoint"),
                                         "--output-dir", os.path.join(root, "one")] + options)
    finally:
        torch.backends.cudnn.deterministic = False
        torch.use_deterministic_algorithms(False)
    for r, g in enumerate(ranks):
        # 2 micro-steps a rank, then the fit's two evaluations and one more
        want = 6 * (g["micro_steps"] + 3 * g["val_batches"])
        print(f"[10] (b) Trainer.fit, {DP_RANKS} ranks over gloo, rank {r}: DDP {g['ddp']}, "
              f"{g['micro_steps']} micro-steps, {g['val_batches']} val batches an evaluation, "
              f"kernel launches {g['launches']}, AP {g['stats']['AP']}, AR {g['stats']['AR']}; "
              f"wrote {written[r]}")
        if not g["ddp"] or g["launches"]["msda_fwd"] != want or g["launches"]["msda_fwd"] == 0:
            fail(f"(b) rank {r}: DDP {g['ddp']}, launches {g['launches']}, expected {want} of #1")
    if not {"log.txt", "checkpoint", "config.yaml", "eval"} <= set(written[0]) or written[1]:
        fail(f"(b) files: rank 0 wrote {written[0]}, rank 1 {written[1]}")
    same = all(g["stats"] == ranks[0]["stats"] for g in ranks)
    # the merged detections against one process's: AP is 0 from random weights
    dets = torch.load(os.path.join(work, "dets.pt"), weights_only=False)
    one_dets = alone.evaluator.dets
    bits = dets.keys() == one_dets.keys() and all(
        len(a) == len(b) and all(d["score"] == e["score"] and
                                 np.array_equal(d["keypoints"], e["keypoints"])
                                 for d, e in zip(a, b))
        for a, b in ((dets[i], one_dets[i]) for i in one_dets))
    err_l, err_k, n_edge = compare_detections(dets, one_dets, 1e-2)
    print(f"[10] (b) the ranks' stats {'identical' if same else 'DIFFERENT'}; one process's "
          f"--eval --resume of rank 0's checkpoint "
          f"{'equal' if one == ranks[0]['stats'] else 'NOT equal'} ({len(one)} stats); the "
          f"ranks' merged detections of {len(dets)} images "
          f"{'bit for bit' if bits else 'NOT bit for bit'} one process's (score logits {err_l:.3e}, keypoints {err_k:.3e} of max|ref|, limit "
          f"1e-2; {n_edge} at the boundary); {b_s:.1f} s for the spawn, the fit and the "
          f"evaluations")
    if not same or one != ranks[0]["stats"] or len(dets) != DP_SET \
            or not (err_l <= 1e-2 and err_k <= 1e-2):
        fail(f"(b) stats: ranks {[g['stats'] for g in ranks]}, one process {one}")

    # (c) the command line as users launch it, one rank on NCCL
    out_json = os.path.join(root, "c.json")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "1",
           "--master_addr", "127.0.0.1", "--master_port", str(free_port()),
           os.path.abspath(__file__), "--cli-rank", out_json, "--"] + coco_l + [
           "--output-dir", os.path.join(root, "c")] + options
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        log, _ = proc.communicate(timeout=DP_DEADLINE_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        fail(f"(c) torch.distributed.run did not end within {DP_DEADLINE_S} s")
    c_s = time.perf_counter() - t0
    print("\n".join("    | " + line for line in log.splitlines()[-6:]))
    if proc.returncode != 0:
        fail(f"(c) torch.distributed.run exited {proc.returncode}")
    c = json.load(open(out_json))
    with open(os.path.join(root, "c", "log.txt")) as f:
        c_log = [json.loads(line) for line in f]
    print(f"[10] (c) torch.distributed.run --nproc_per_node 1: backend {c['backend']}, world "
          f"{c['world']}, DDP {c['ddp']}, {c['micro_steps']} micro-steps, kernel launches "
          f"{c['launches']}, log.txt epoch 0 train_loss_total {c_log[0]['train_loss_total']:.4f} "
          f"AP {c_log[0]['AP']}; {c_s:.1f} s")
    if c["backend"] != "nccl" or not c["ddp"] or c["launches"]["msda_fwd"] == 0 \
            or len(c_log) != 1 or not np.isfinite(c_log[0]["train_loss_total"]):
        fail(f"(c) {c}, log {c_log}")
    counts = {k: sum(g["launches"][k] for g in ranks) + c["launches"][k] for k in KERNELS}
    return counts, {"b_s": b_s, "b_stats": ranks[0]["stats"], "c_s": c_s,
                    "c_launches": c["launches"]}


def data_parallel_path(card):
    """Main path 6 (phase 10): the L step in 2 ranks, then the Trainer and
    the command line in ranks; returns the launch counts and the numbers."""
    step, batch = dp_train_step(), dp_batch()
    torch.cuda.reset_peak_memory_stats()
    losses, _ = dp_one_step(step, batch)
    timing = dp_time(step, batch)
    ref = {"losses": losses, "ms_per_micro_step": timing["ms_per_micro_step"],
           "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    del step
    torch.cuda.empty_cache()
    ref["f32"] = dp_float32_step(batch)
    torch.cuda.empty_cache()
    zero, f64_peak = dp_exact_zero_leaves(batch)
    print(f"[10] one process, one optimiser step of the bs-{TRAIN_BATCH} batch: bf16 losses "
          f"{losses}, {timing['ms_per_micro_step']:.3f} ms a micro-step, peak memory "
          f"{ref['peak_mem_bytes'] / 2**30:.2f} GiB; float32 loss_total "
          f"{ref['f32']['terms']['loss_total']}; float64 (plain version, peak "
          f"{f64_peak / 2**30:.2f} GiB): {len(zero)} leaves with a gradient below "
          f"{DP_ZERO_REL:g} of the largest: " + ", ".join(sorted(zero)[:4])
          + f"{', ...' if len(zero) > 4 else ''}; on {card}")
    del batch
    torch.cuda.empty_cache()
    # the counts of the ranks' main path, read in the ranks
    counts, numbers = dp_step_path(card, ref, zero, "gloo", [0] * DP_RANKS)
    numbers["one_process_losses"], numbers["exact_zero_leaves"] = losses, sorted(zero)
    runs = [f"(a) {numbers['label']}"]
    if torch.cuda.device_count() >= DP_RANKS:
        c2, n2 = dp_step_path(card, ref, zero, "nccl", list(range(DP_RANKS)))
        counts = {k: counts[k] + c2[k] for k in KERNELS}
        numbers["nccl"] = n2
        runs.append(f"(d) {n2['label']}")
    else:
        print(f"[10] (d) not run: {torch.cuda.device_count()} card; NCCL refuses two ranks on one")
    root = tempfile.mkdtemp(prefix="chip_smoke_dp_cli_")
    try:
        c3, numbers["cli"] = dp_cli_paths(card, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    runs += ["(b) Trainer.fit in 2 ranks over gloo", "(c) torch.distributed.run, 1 rank, NCCL"]
    counts = {k: counts[k] + c3[k] for k in KERNELS}
    print(f"[10] main path 6 ran: {'; '.join(runs)}; kernel #1 launches {counts['msda_fwd']}")
    return counts, numbers


# ---- main path 7: the reference's model variants -----------------------
# phase 11's configurations of DETRPose-L (JAX decoder.py:138-280, 391-413,
# 743-823; models/resnet.py), each run under kernel #1 ("auto") and #2
# ("pallas") against "gather"
VARIANTS = {
    "modulation": dict(use_modulation=True),
    "region3": dict(use_region_sampling=True, region_kernel_size=3),
    "global": dict(use_global_context=True),
    "grouped2_mod": dict(use_grouped_offsets=True, num_groups=2, use_modulation=True),
    "grouped4": dict(use_grouped_offsets=True, num_groups=4),
    "grid16_offsets": dict(use_grid_attention=True, grid_num_points=16, use_grid_offsets=True),
    "grid4_unfused": dict(use_grid_attention=True, grid_num_points=4, use_grid_fusion=False),
    "kan": dict(use_kan=True, kan_grid=3),
    "energy_grad": dict(use_energy_refinement=True, energy_steps=3, grad_energy=True),
    "energy_raw": dict(use_energy_refinement=True, energy_steps=3, grad_energy=False),
    "resnet50": dict(backbone_name="resnet50"),
}
# one training step per family (phase 11 b); energy refinement's three
# differentiated steps make its regulariser live
TRAIN_VARIANTS = {
    "grouped2_mod": VARIANTS["grouped2_mod"],
    "grid16_offsets": VARIANTS["grid16_offsets"],
    "kan": VARIANTS["kan"],
    "energy_grad": dict(VARIANTS["energy_grad"], energy_decrease_weight=0.01),
    "resnet50": VARIANTS["resnet50"],
}


def variant_launches(flags, backend, train=False):
    """Kernel launches of one L forward (or, with ``train``, train
    micro-step) under ``backend``: one MSDA call a main decoder layer (6), a
    second one a layer with the grid branch (12), on the backend's kernel;
    energy refinement adds one a step on kernel #1 (the energy layer runs on
    "auto", as JAX builds it), two with grad_energy (the energy and its
    gradient's forward). The gradient's backward (``msda_bwd``) launches
    kernel #1's backward kernel once a step in a forward, where it is not
    recorded and the value wants no gradient; a train micro-step records it
    and takes the plain path. "gather" is the all-plain reference
    (``set_energy_backend``): no launch."""
    cfg = model_config("l", **flags)
    main = cfg.num_decoder_layers * (2 if flags.get("use_grid_attention") else 1)
    energy = grads = 0
    if flags.get("use_energy_refinement"):
        energy = flags["energy_steps"] * (2 if flags.get("grad_energy") else 1)
        grads = flags["energy_steps"] if flags.get("grad_energy") and not train else 0
    want = {k: 0 for k in COUNTED}
    want["msda_bwd"] = 0 if backend == "gather" else grads
    if backend == "auto":
        want["msda_fwd"] = main + energy
    elif backend == "pallas":
        want["msda_perquery"], want["msda_fwd"] = main, energy
    return want


def variant_counts():
    """The kernels' launches, kernel #1's backward's and the FastKAN basis
    product's since ``zero_launch_counts``, as ``variant_launches`` gives
    them."""
    return {**launch_counts(), "msda_bwd": msda_backward.launches,
            "kan_basis": kan_basis.launches}


def energy_attn(model):
    """The energy layer's MSDA module, in a list (empty without one)."""
    layer = getattr(model.transformer.decoder, "energy_layer", None)
    return [] if layer is None else [m for m in layer.modules() if isinstance(m, MSDeformAttn)]


def set_backend(model, backend):
    """The main decoder layers' MSDA backend; the energy layer keeps the
    backend the model built it with ("auto", as JAX)."""
    energy = {id(m) for m in energy_attn(model)}
    for m in model.modules():
        if isinstance(m, MSDeformAttn) and id(m) not in energy:
            m.msda_backend = backend


def set_energy_backend(model, backend):
    """The energy layer's MSDA backend: "gather" only for the all-plain
    reference the kernels are held against, "auto" otherwise."""
    for m in energy_attn(model):
        m.msda_backend = backend


def variant_model(flags, backend="gather"):
    """DETRPose-L with ``flags`` from the seed, the constant leaves perturbed
    and the selection head scaled by 50 (as phase 4)."""
    gb = torch.Generator().manual_seed(SEED)
    model = build_model(model_config("l", msda_backend=backend, **flags), device="cuda",
                        generator=gb)
    perturb_constant_leaves(model, gb)
    return model


def check_variant(name, flags, x):
    """Phase 11 (a) for one configuration (float32, TF32 off): the forward
    through "gather" (all plain, the energy layer's too), "auto" and "pallas"
    (the energy layer on "auto" under both), the kernels' outputs within 1e-4
    of the plain version's, exact launch counts; returns the model (backend
    "auto") and the launches of the kernels' runs."""
    model = variant_model(flags)
    outs, total = {}, {k: 0 for k in COUNTED}
    for backend in ("gather", "auto", "pallas"):
        set_backend(model, backend)
        set_energy_backend(model, "gather" if backend == "gather" else "auto")
        zero_launch_counts()
        with torch.no_grad():
            outs[backend] = model(x)
        torch.cuda.synchronize()
        counts = variant_counts()
        want = variant_launches(flags, backend)
        if counts != want or msda_backward.plain:
            fail(f"{name} L forward with msda_backend={backend!r} launched {counts} and took "
                 f"the plain backward {msda_backward.plain} times, expected {want} and 0")
        total = {k: total[k] + counts[k] for k in COUNTED}
    for backend in outs:
        if backend != "gather":
            compare_outputs(f"11 {name} {backend} vs gather", outs[backend], outs["gather"],
                            1e-4)
    print(f"[11] {name} L bs2 640 f32: launches a forward under 'auto' "
          f"{variant_launches(flags, 'auto')}, under 'pallas' "
          f"{variant_launches(flags, 'pallas')}")
    set_backend(model, "auto")
    return model, total


def serve_ms(model, x, ts):
    """Forward + postprocess at bs 32, bf16 (bench_size's protocol)."""
    with torch.no_grad():
        return cuda_time_ms(lambda: postprocess(model(x), ts), iters=10)


def kan_serve_launches(name, flags, model, x):
    """One bf16 forward of a variant without a gradient: the FastKAN basis
    product's launches, 2 a decoder layer with ``use_kan`` (its kan1 and
    kan2) and none without; returns the count."""
    want = 2 * model_config("l", **flags).num_decoder_layers if flags.get("use_kan") else 0
    zero_launch_counts()
    with torch.no_grad():
        model(x)
    torch.cuda.synchronize()
    if kan_basis.launches != want:
        fail(f"{name} L bf16 forward launched kan_basis {kan_basis.launches} times, expected "
             f"{want}")
    return kan_basis.launches


def check_train_variant(name, flags, batch):
    """Phase 11 (b) for one family: one L micro-step (bs 2, float32, one CDN
    batch, deterministic algorithms) through "auto" and through "gather" on
    the same weights, as phase 5; returns kernel #1's launches."""
    model = variant_model(flags).train()
    runs, launched, peak, plain = {}, {k: 0 for k in COUNTED}, {}, {}
    n = variant_launches(flags, "auto", train=True)["msda_fwd"]
    for backend in ("auto", "gather"):
        set_backend(model, backend)
        set_energy_backend(model, backend)
        step = make_train_step(model, make_optimizer(model, grad_accum_steps=2), 17,
                               compute_dtype=torch.float32, use_ema=False)
        zero_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        metrics = step(batch)
        torch.cuda.synchronize()
        counts = variant_counts()
        want = variant_launches(flags, backend, train=True)
        plain[backend] = msda_backward.plain
        # the op's backward takes the plain path wherever the op ran
        if counts != want or (plain[backend] > 0) != (backend == "auto"):
            fail(f"{name} L train micro-step with msda_backend={backend!r} launched {counts} "
                 f"and took the plain backward {plain[backend]} times, expected {want} and "
                 f"{'some' if backend == 'auto' else 0}")
        peak[backend] = torch.cuda.max_memory_allocated() / 2**30
        launched = {k: launched[k] + counts[k] for k in COUNTED}
        grads = {p_name: p.grad.detach().clone() for p_name, p in model.named_parameters()
                 if p.grad is not None}
        model.zero_grad(set_to_none=True)
        runs[backend] = (metrics, grads, branch_assignments(model, batch)[2])
        del step
    (ma, ga, aa), (mg, gg, ag) = runs["auto"], runs["gather"]
    if not torch.equal(aa, ag):
        fail(f"{name} train step: the matcher's assignments differ between the backends")
    terms = [k for k, v in mg.items() if torch.is_tensor(v)]
    if name.startswith("energy") and "energy_reg_loss" not in terms:
        fail(f"{name} train step: no energy_reg_loss among the logged terms")
    worst_loss = max(abs(ma[k].item() - mg[k].item()) / max(abs(mg[k].item()), 1e-12)
                     for k in terms)
    if ga.keys() != gg.keys():
        fail(f"{name} train step: the backends give gradients to other leaves")
    # each leaf within 1e-3 of its max|g|; a leaf whose gradient is 0 up to
    # rounding (below 1e-5 of the largest |g|: a shift that the encoder's
    # batch-statistics norms cancel) must stay below 1e-5 of the largest in
    # both runs: the energy step's second derivative sums the same terms in
    # another order, which moves such a leaf by its rounding
    top = max(g.abs().max().item() for g in gg.values())
    zero = sorted(k for k, g in gg.items() if g.abs().max().item() < 1e-5 * top)
    errs = sorted((((ga[k] - g).abs().max().item() / g.abs().max().item(), k)
                   for k, g in gg.items() if k not in zero), reverse=True)
    zero_err = max([(ga[k] - gg[k]).abs().max().item() / top for k in zero] + [0.0])
    print(f"[11] {name} L train micro-step bs2 640 f32, auto vs gather: loss "
          f"{mg['loss_total'].item():.6f}, {aa.numel()} assignments equal, {len(terms)} loss "
          f"terms, worst relative difference {worst_loss:.3e} (limit 1e-4); {len(gg)} "
          f"gradients, worst max|diff| / max|g| {errs[0][0]:.3e} at {errs[0][1]} (limit "
          f"1e-3); {len(zero)} leaves 0 up to rounding, worst max|diff| {zero_err:.3e} of the "
          f"largest |g| {top:.3e} (limit 1e-5); kernel #1 {n} launches, its backward "
          f"{plain['auto']} plain and 0 by kernel; peak memory "
          f"{peak['auto']:.2f} / {peak['gather']:.2f} GiB")
    if not worst_loss <= 1e-4:
        fail(f"{name} train step: the loss terms differ between 'auto' and 'gather'")
    if zero_err > 1e-5:
        fail(f"{name} train step: the gradients differ between 'auto' and 'gather'")
    off = [k for e, k in errs if e > 1e-3]
    if off:
        set_backend(model, "gather")
        set_energy_backend(model, "gather")
        hold_to_float64(f"[11] {name}", model, batch, off, ga, gg)
    return launched


def cli_and_bench_data(card, root):
    """Phase 11 (d): the command line over a folder of 4 JPEGs (a process of
    its own) and a 4-frame mp4, then bench_data at bs 1 and 32; returns the
    results."""
    try:
        import cv2
    except ImportError:
        cv2 = None
    orbax = importlib.util.find_spec("orbax") is not None
    print(f"[11] cv2 on this machine: {cv2.__version__ if cv2 else 'not installed'}; orbax "
          f"(the JAX package's checkpoint format): {'found' if orbax else 'not installed'}")
    src, out = os.path.join(root, "jpegs"), os.path.join(root, "out")
    os.makedirs(src)
    benchmark.write_synthetic_jpegs(src, 4, seed=SEED)
    result = {"cv2": cv2.__version__ if cv2 else None, "orbax": orbax}
    if cv2 is not None:
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "detrpose_tpu_torch.tools.infer", "--size",
                            "l", "--input", src, "--output", out], capture_output=True,
                           text=True, timeout=300)
        lines = r.stdout.strip().splitlines()
        print("\n".join(f"[11] infer: {line}" for line in lines))
        if r.returncode != 0 or len(lines) != 4 or sorted(os.listdir(out)) != sorted(
                os.listdir(src)):
            fail(f"the command line over a folder: rc {r.returncode}, {r.stderr[-2000:]}")
        result["folder_s"] = time.perf_counter() - t0
        video, video_out = os.path.join(root, "in.mp4"), os.path.join(root, "out.mp4")
        vw = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"mp4v"), 5, (640, 480))
        for i in range(4):
            vw.write(np.random.default_rng(i).integers(0, 256, (480, 640, 3), np.uint8))
        vw.release()
        t0 = time.perf_counter()
        infer_main(["--size", "l", "--input", video, "--output", video_out])
        cap = cv2.VideoCapture(video_out)
        frames = 0
        while cap.read()[0]:
            frames += 1
        cap.release()
        if frames != 4:
            fail(f"the command line over a 4-frame mp4 wrote {frames} frames")
        result["video_s"] = time.perf_counter() - t0
        print(f"[11] the command line: a folder of 4 JPEGs in {result['folder_s']:.2f} s (a "
              f"process of its own, model build included), a 4-frame mp4 in "
              f"{result['video_s']:.2f} s, {frames} frames written; on {card}")
    else:
        print("[11] without cv2 the command line cannot draw or read video: its image "
              "path runs through PIL decoding up to its detections instead")
        run = build_pipeline("l", device="cuda")
        for f in sorted(os.listdir(src)):
            scores, kpts = detections(run, np.array(Image.open(os.path.join(src, f))))
            if scores.shape != (60,) or not (np.isfinite(scores).all()
                                             and np.isfinite(kpts).all()):
                fail(f"the command line's image path on {f}: bad detections")
        print("[11] the command line's image path gave finite detections for 4 JPEGs")
    for b in (1, 32):
        res = benchmark.bench_data("l", None, b)
        print(f"[11] bench_data('l', None, {b}) over {res['images']} synthetic JPEGs: "
              f"latency_ms {res['latency_ms']}, fastest_ms {res['fastest_ms']}, "
              f"{res['images_per_sec']} images/s ({res['basis']}); on {card}")
        result[f"bench_data_bs{b}"] = res
    return result


def variants_path(card, gen, g):
    """Main path 7 (phase 11): returns the launches and the numbers."""
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    x = torch.rand(2, 3, 640, 640, generator=gen).cuda()
    xb = torch.rand(32, 3, 640, 640, generator=gen).cuda().to(torch.bfloat16)
    ts = torch.full((32, 2), 640.0, device="cuda")
    total = {k: 0 for k in COUNTED}
    serve = {}
    for name, flags in VARIANTS.items():
        model, launched = check_variant(name, flags, x)
        total = {k: total[k] + launched[k] for k in COUNTED}
        model.to(torch.bfloat16)
        total["kan_basis"] += kan_serve_launches(name, flags, model, xb)
        serve[name] = serve_ms(model, xb, ts)
        del model
        torch.cuda.empty_cache()
    default = variant_model({}, "auto").to(torch.bfloat16)
    serve["default"] = serve_ms(default, xb, ts)
    del default
    torch.cuda.empty_cache()
    for name, ms in serve.items():
        print(f"[11] L {name} forward+postprocess bs32 640 bf16: {ms:.3f} ms/batch "
              f"({ms / serve['default']:.3f}x the default L's {serve['default']:.3f}); on {card}")

    batch = synthetic_train_batch(2, 640, 17, 60, "cuda", seed=SEED)
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for name, flags in TRAIN_VARIANTS.items():
            launched = check_train_variant(name, flags, batch)
            total = {k: total[k] + launched[k] for k in COUNTED}
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = False
        torch.use_deterministic_algorithms(False)

    # kernel #1 at the shapes the variants give it, beside its bound
    kernel_ms = {}
    for label, shp in VARIANT_SHAPES.items():
        value, levels, loc, aw = msda_inputs(g, torch.bfloat16, **shp)
        out_bytes = value.numel() // value.shape[1] * loc.shape[1] * value.element_size()
        bound = msda_bound_ms(nbytes(value, loc, aw) + out_bytes, 10 * aw.numel() * shp["dh"])
        ms = cuda_time_ms(lambda: msda_forward(value, levels, loc, aw), iters=50)
        kernel_ms[label] = {"ms": ms, "bound_ms": bound[0], "bound_by": bound[1]}
        print(f"[11] msda_fwd at {label} (B{shp['B']} Lq{shp['Lq']} nH{shp['nH']} dh{shp['dh']} "
              f"nP{shp['nP']}, L levels, bf16 values): {ms:.4f} ms/call, bound {bound[0]:.4f} "
              f"ms ({bound[1]}); on {card}")
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True

    zero_launch_counts()
    with tempfile.TemporaryDirectory() as root:
        tools_out = cli_and_bench_data(card, root)
    torch.cuda.synchronize()
    counts = variant_counts()
    if counts["msda_fwd"] == 0:
        fail("the command line and bench_data never launched kernel msda_fwd")
    total = {k: total[k] + counts[k] for k in COUNTED}
    seconds = time.perf_counter() - t_phase
    print(f"[11] main path 7: kernel launches {total}; {seconds:.1f} s")
    return total, {"serve_ms": serve, "kernel_ms": kernel_ms, "tools": tools_out,
                   "seconds": seconds}


# ---- main path 8: weights from elsewhere, the tutorial, the overfit run ---
# the short overfit run of phase 12 (e): N at 160 px on the drawn set, its
# loss sampled 4 times; sized to about a minute on an H100
OVERFIT_SMOKE = dict(steps=200, n_images=32, stage_epochs=1, sample_every=50, holdout=16)
L_LAYERS = model_config("l").num_decoder_layers
N_LAYERS = model_config("n").num_decoder_layers


def expect_launches(label, counts, msda_fwd):
    """Fail unless kernel #1 launched ``msda_fwd`` times and no other kernel."""
    want = {k: (msda_fwd if k == "msda_fwd" else 0) for k in KERNELS}
    if counts != want:
        fail(f"{label} launched {counts}, expected {want}")


def pretrain_import_path():
    """Phase 12 (a): a seeded L's state_dict (its constant leaves perturbed)
    through torch.save into a fresh L of another seed on the card; returns
    the launches."""
    gen = torch.Generator().manual_seed(SEED)
    src = build_model(model_config("l"), device="cuda", generator=gen)
    perturb_constant_leaves(src, gen)    # no leaf the same as a fresh L's
    dst = build_model(model_config("l"), device="cuda",
                      generator=torch.Generator().manual_seed(SEED + 1))
    with tempfile.TemporaryDirectory() as root:
        path = os.path.join(root, "detrpose_l.pth")
        torch.save(src.state_dict(), path)
        sd = load_torch_checkpoint(path)
    del src
    before = {k: v.clone() for k, v in dst.state_dict().items()}
    loaded = load_pretrained_backbone_encoder(sd, dst)
    after = dst.state_dict()
    parts = ("backbone.", "encoder.")
    if set(loaded) != {k for k in after if k.startswith(parts)}:
        fail("the backbone/encoder import did not load every backbone and encoder leaf")
    for k, v in after.items():
        same = torch.equal(v.cpu(), sd[k]) if k.startswith(parts) else torch.equal(v, before[k])
        if not same:
            fail(f"the backbone/encoder import: {k} is not what it must be "
                 f"({'the state_dict' if k.startswith(parts) else 'as initialised'})")
    moved = sum(not torch.equal(after[k], before[k]) for k in loaded)
    x = torch.rand(2, 3, 640, 640, generator=torch.Generator().manual_seed(SEED)).cuda()
    zero_launch_counts()
    with torch.no_grad():
        out = dst(x)
    torch.cuda.synchronize()
    counts = launch_counts()
    expect_launches("the imported L forward", counts, L_LAYERS)
    if not all(torch.isfinite(v).all() for v in out.values()):
        fail("the imported L forward gave non-finite outputs")
    n_dec = sum(k.startswith("transformer.") for k in after)
    print(f"[12] (a) backbone/encoder import into L on the card: {len(loaded)} leaves "
          f"bit-equal to the saved state_dict ({moved} differed from the fresh L's), "
          f"{n_dec} transformer leaves as initialised; the forward (bs 2, 640 px, float32) "
          f"finite, kernel #1 {counts['msda_fwd']} launches")
    return counts


def tutorial_path(card, root):
    """Phase 12 (b): examples/tutorial_torch.py at L, 640 px, on the card, in
    its own process; returns its latencies and launches."""
    out = os.path.join(root, "tutorial_overlay.jpg")
    script = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples",
                          "tutorial_torch.py")
    r = subprocess.run([sys.executable, script,
                        "--size", "l", "--res", "640", "--device", "cuda", "--output", out],
                       capture_output=True, text=True, timeout=300)
    print("\n".join(f"[12] tutorial: {line}" for line in r.stdout.strip().splitlines()))
    if r.returncode != 0 or not os.path.exists(out) or os.path.getsize(out) < 1000:
        fail(f"the tutorial: rc {r.returncode}, overlay written "
             f"{os.path.exists(out)}; {r.stderr[-2000:]}")
    ms = {k: float(re.search(rf"^{k} call: ([0-9.]+) ms", r.stdout, re.M).group(1))
          for k in ("first", "steady")}
    counts = json.loads(re.search(r"^kernel launches in the 2 calls: (.*)$", r.stdout,
                                  re.M).group(1))
    expect_launches("the tutorial's 2 calls", counts, 2 * L_LAYERS)
    print(f"[12] (b) the tutorial at L, 640 px: first call {ms['first']:.3f} ms, steady call "
          f"{ms['steady']:.3f} ms (host clock to synchronize); on {card}")
    return counts, ms


def overfit_path(card):
    """Phase 12 (e): a short overfit run of N at 160 px on the card."""
    zero_launch_counts()
    r = overfit(device="cuda", log=lambda m: print(f"[12] overfit: {m}"), **OVERFIT_SMOKE)
    torch.cuda.synchronize()
    counts = launch_counts()
    curve = [v for _, v in r["curve"]]
    if not r["finite"] or not curve[-1] < curve[0]:
        fail(f"the short overfit run's loss did not fall: {r['curve']}")
    for name, stats in r["stats"].items():
        if len(stats) != 10 or not all(np.isfinite(v) for v in stats.values()):
            fail(f"the short overfit run's evaluator ({name}) gave {stats}")
    expect_launches("the short overfit run", counts,
                    N_LAYERS * (OVERFIT_SMOKE["steps"] + r["eval_batches"]))
    print(f"[12] (e) overfit N 160 px, bs 16, {OVERFIT_SMOKE['steps']} steps on "
          f"{OVERFIT_SMOKE['n_images']} drawn images: {r['step_ms']:.3f} ms a step (host clock), "
          f"loss {curve[0]:.3f} -> {curve[-1]:.3f}, train AP {r['stats']['regular']['AP']:.4f} "
          f"/ EMA {r['stats']['ema']['AP']:.4f}, set-up {r['setup_s']:.1f} s, evaluation "
          f"{r['eval_s']:.1f} s; kernel #1 {counts['msda_fwd']} launches; on {card}")
    return counts, r


def weights_programs_path(card):
    """Main path 8 (phase 12): returns the launches and the numbers."""
    t_phase = time.perf_counter()
    total = {k: 0 for k in KERNELS}
    numbers = {}
    counts = pretrain_import_path()
    total = {k: total[k] + counts[k] for k in KERNELS}
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as root:
        counts, numbers["tutorial_ms"] = tutorial_path(card, root)
    total = {k: total[k] + counts[k] for k in KERNELS}
    torch.cuda.empty_cache()
    counts, numbers["overfit"] = overfit_path(card)
    total = {k: total[k] + counts[k] for k in KERNELS}
    numbers["seconds"] = time.perf_counter() - t_phase
    print(f"[12] main path 8: kernel launches {total}; {numbers['seconds']:.1f} s")
    return total, numbers


# ---- main path 9: where training starts -----------------------------------
# the heads JAX inits to zero kernels (decoder.py:152-201, 300, 524, 639;
# layers.py:364; transformer.py:121) and the biases it inits to constants
# (the class prior, decoder.py:532 and transformer.py:106-108; the circle
# pattern, decoder.py:45-68); every other Linear and conv is flax's default
ZERO_KERNELS = re.compile(r"(gateway\.gate|cross_attn\.(sampling_offsets|attention_weights)"
                          r"|reg_conf\.layers\.1|enc_pose_embed\.layers\.3"
                          r"|pre_pose_embed\.layers\.2|pose_embed\.\d+\.layers\.2)$")
SET_BIASES = re.compile(r"(enc_out_class_embed|class_embed\.\d+|cross_attn\.sampling_offsets)$")
CARRY_COUNT = 7           # the carried optax state's optimiser steps
RESUME_BATCH = 16         # kernel #1 at PATH8_SHAPES["N160t16"], which phase 3 holds


def init_path(size, card):
    """Phase 13 (a): ``size`` built on the card, its leaves against flax's
    initializers, the Gate and LQE invariants; returns a summary."""
    model = build_model(model_config(size))
    layers, bad = [], []
    for name, m in model.named_modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            layers.append((name, m.weight, m.weight[0].numel(), m.bias))
        elif isinstance(m, nn.MultiheadAttention):
            layers.append((f"{name}.in_proj", m.in_proj_weight, m.embed_dim, m.in_proj_bias))
    zero = drawn = 0
    for name, w, fan_in, bias in layers:
        w = w.detach().double()
        if ZERO_KERNELS.search(name):
            zero += 1
            if w.abs().max() != 0:
                bad.append(f"{name}: a kernel JAX zeroes is not zero")
        else:
            drawn += 1
            bound = 2.0 / TRUNCATED_STD / math.sqrt(fan_in)
            if w.abs().max() > bound * (1 + 1e-6):
                bad.append(f"{name}: max|w| {w.abs().max():.4g} past {bound:.4g}")
            if w.numel() >= 1024 and not 0.9 <= w.std().item() * math.sqrt(fan_in) <= 1.1:
                bad.append(f"{name}: std * sqrt(fan_in) {w.std().item() * math.sqrt(fan_in):.4f}")
        if bias is not None and not SET_BIASES.search(name) and bias.abs().max() != 0:
            bad.append(f"{name}: bias not zero")
    g = torch.Generator(device="cuda").manual_seed(SEED)
    gates = [m for m in model.modules() if isinstance(m, Gate)]
    lqes = [m for m in model.modules() if isinstance(m, LQE)]
    d, K = gates[0].norm.normalized_shape[0], model_config(size).num_body_points
    x = torch.randn(2, 9, 2 * d, device="cuda", generator=g)
    scores = torch.randn(2, 9, 2, device="cuda", generator=g)
    poses = torch.rand(2, 9, K, 2, device="cuda", generator=g)
    feat = torch.randn(2, 256, 20, 20, device="cuda", generator=g)
    with torch.no_grad():
        for m in gates:
            if not (torch.sigmoid(m.gate(x)) == 0.5).all():
                bad.append("a Gate does not open at 0.5")
        for m in lqes:
            if not torch.equal(m(scores, poses, feat), scores):
                bad.append("an LQE head is not the identity on the scores")
    if bad:
        fail(f"the {size.upper()} init on the card: {bad[:8]}")
    print(f"[13] (a) {size.upper()} built on the card: {drawn} Linear/conv weights within "
          f"lecun-normal's bound and scale, {zero} zero kernels where JAX zeroes them, every "
          f"bias zero but the class prior and the offsets; {len(gates)} Gates open at 0.5, "
          f"{len(lqes)} LQE heads the identity; on {card}")
    return {"drawn": drawn, "zero": zero, "gates": len(gates), "lqe": len(lqes)}


def flax_leaves(name, t):
    """(flax-style path, array in flax's layout) pairs that
    ``from_jax_variables`` maps back onto the port's leaf ``name``."""
    *mods, leaf = name.split(".")
    arr = t.detach().cpu().numpy()
    if leaf in ("in_proj_weight", "in_proj_bias"):
        return [(tuple(mods) + (proj, "kernel" if leaf == "in_proj_weight" else "bias"),
                 part.T if leaf == "in_proj_weight" else part)
                for proj, part in zip(("q_proj", "k_proj", "v_proj"), np.split(arr, 3))]
    if mods and mods[-1] == "lab":
        return [(tuple(mods[:-1]) + ("lab_" + leaf,), arr)]
    if leaf == "weight" and mods[-1] in _EMBED_LEAVES:
        return [(tuple(mods), arr)]
    if leaf == "weight":
        if arr.ndim == 4:
            return [(tuple(mods) + ("kernel",), arr.transpose(2, 3, 1, 0))]
        return [(tuple(mods) + ("kernel" if arr.ndim == 2 else "scale",),
                 arr.T if arr.ndim == 2 else arr)]
    return [(tuple(mods) + (leaf,), arr)]



def flax_tree(tensors, keep=lambda name: True):
    """{port name: tensor} as a nested flax-layout tree; leaves of the names
    ``keep`` refuses are None, as a restore gives optax's masked nodes."""
    tree = {}
    for name, t in tensors.items():
        for path, arr in flax_leaves(name, t):
            node = tree
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = arr if keep(name) else None
    return tree


def optax_state(model, accum, rng):
    """An optax state of JAX make_optimizer's transform for ``model``'s
    parameters as ``PyTreeCheckpointer().restore`` gives it (no template):
    CARRY_COUNT optimiser steps, and with ``accum`` 2 one micro-batch more.
    Returns (state, {port name: (mu, nu)}, the accumulated gradients)."""
    labels = label_parameters(model)
    named = dict(model.named_parameters())
    moments = {n: (torch.from_numpy(rng.normal(0, 1e-3, p.shape).astype(np.float32)),
                   torch.from_numpy(rng.uniform(1e-8, 1e-6, p.shape).astype(np.float32)))
               for n, p in named.items() if labels[n] != "frozen"}

    def label_state(label):
        mine = lambda n: labels[n] == label
        zeros = {n: torch.zeros(p.shape) for n, p in named.items()}
        mu = flax_tree({**zeros, **{n: m[0] for n, m in moments.items()}}, mine)
        nu = flax_tree({**zeros, **{n: m[1] for n, m in moments.items()}}, mine)
        return {"inner_state": [{"count": np.int32(CARRY_COUNT), "mu": mu, "nu": nu}, None,
                                {"count": np.int32(CARRY_COUNT)}]}

    part = {"inner_states": {"main": label_state("main"), "backbone": label_state("backbone"),
                             "frozen": {"inner_state": None}}}
    if accum == 1:
        return [None, part], moments, None
    acc = {n: torch.from_numpy(rng.normal(0, 1, p.shape).astype(np.float32))
           for n, p in named.items()}
    return ({"mini_step": np.int32(1), "gradient_step": np.int32(CARRY_COUNT),
             "inner_opt_state": [None, None, part], "acc_grads": flax_tree(acc),
             "skip_state": []}, moments, acc)


def carried_step(device, ckpt_path, accum, grad=None, fresh=False):
    """N from the seed on ``device``, restored from ``ckpt_path`` (no warning)
    or with a fresh optimiser; with ``grad``, one micro-batch of it, which
    completes an optimiser step. Returns the TrainStep."""
    model = build_model(model_config("n"), device=device,
                        generator=torch.Generator().manual_seed(SEED))
    step = make_train_step(model, make_optimizer(model, grad_accum_steps=accum), 17,
                           device=device)
    if not fresh:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            restore_checkpoint(ckpt_path, step)
        if [w for w in caught if "optimizer" in str(w.message)]:
            fail(f"the carried optax state (accumulation {accum}) did not fit: "
                 f"{[str(w.message) for w in caught]}")
    if grad is not None:
        for n, p in step.model.named_parameters():
            g = grad[n].to(device)
            p.grad = g.clone() if p.grad is None else p.grad + g
        step.micro += 1
        if step.micro == accum:
            step.optimizer.step()
            step.micro = 0
    return step


def carry_path(card, root):
    """Phase 13 (b), (c): optax's state carried onto the card; returns the
    launches and a summary."""
    rng = np.random.default_rng(SEED)
    cpu_model = build_model(model_config("n"), device="cpu",
                            generator=torch.Generator().manual_seed(SEED))
    params = dict(cpu_model.named_parameters())
    back = from_jax_variables({"params": flax_tree(params)})
    if set(back) != set(params) or any(not torch.equal(back[n], p.detach())
                                       for n, p in params.items()):
        fail("the script's flax-layout tree of N's parameters does not map back onto them")
    out, paths = {}, {}
    for accum in (1, 2):
        state, moments, acc = optax_state(cpu_model, accum, rng)
        fields = optimizer_from_optax(state)
        sd = fields["optimizer"]
        carried = {name: (sd["state"][i]["exp_avg"], sd["state"][i]["exp_avg_sq"],
                          sd["state"][i]["step"].item())
                   for grp in sd["param_groups"]
                   for i, name in zip(grp["params"], grp["param_names"])}
        if set(carried) != set(moments) or any(
                not (torch.equal(c[0], moments[n][0]) and torch.equal(c[1], moments[n][1])
                     and c[2] == CARRY_COUNT) for n, c in carried.items()):
            fail(f"optimizer_from_optax (accumulation {accum}) did not carry the moments")
        if fields["optimizer_updates"] != CARRY_COUNT or fields["micro"] != accum - 1 or (
                accum > 1 and any(not torch.equal(fields["grads"][n], acc[n]) for n in acc)):
            fail(f"optimizer_from_optax (accumulation {accum}): counts {fields['optimizer_updates']}"
                 f", micro {fields['micro']}")
        path = os.path.join(root, f"carried_accum{accum}.pth")
        torch.save({"model": cpu_model.state_dict(), "ema": None, "step": CARRY_COUNT * accum,
                    "epoch": 0, **fields}, path)
        paths[accum] = path
        grad = {n: torch.from_numpy(rng.normal(0, 1, p.shape).astype(np.float32))
                for n, p in params.items()}
        on_card = carried_step("cuda", path, accum, grad)
        on_cpu = carried_step("cpu", path, accum, grad)
        fresh = carried_step("cuda", path, accum, grad, fresh=True)
        worst, apart = 0.0, 0
        card_state = {n: on_card.optimizer.adamw.state[p]
                      for n, p in on_card.model.named_parameters()
                      if p in on_card.optimizer.adamw.state}
        cpu_state = {n: on_cpu.optimizer.adamw.state[p]
                     for n, p in on_cpu.model.named_parameters()
                     if p in on_cpu.optimizer.adamw.state}
        fresh_p = dict(fresh.model.named_parameters())
        card_p = dict(on_card.model.named_parameters())
        for n, p in on_cpu.model.named_parameters():
            pairs = [(card_p[n], p)]
            if n in cpu_state:
                pairs += [(card_state[n][k], cpu_state[n][k]) for k in ("exp_avg", "exp_avg_sq")]
                apart += not torch.equal(fresh_p[n].detach().cpu(), p.detach())
            for a, b in pairs:
                b = b.detach()
                err = (a.detach().cpu() - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
                worst = max(worst, err)
        if worst > 1e-6 or apart < len(cpu_state) // 2 or set(card_state) != set(carried) \
                or on_card.optimizer.updates != CARRY_COUNT + 1:
            fail(f"the carried step (accumulation {accum}): card against CPU {worst:.3e} of "
                 f"max|x| (limit 1e-6); {apart} of {len(cpu_state)} parameters apart from a "
                 f"fresh optimiser's step; updates {on_card.optimizer.updates}")
        out[accum] = {"max_rel_err": worst, "apart_from_fresh": apart, "carried": len(cpu_state)}
        print(f"[13] (b) optax state carried into N's AdamW (accumulation {accum}, "
              f"{len(cpu_state)} parameters with state, {CARRY_COUNT} steps"
              f"{', one micro-batch into the next' if accum > 1 else ''}): moments bit for bit; "
              f"one more micro-batch on the card against the CPU: parameters and moments within "
              f"{worst:.3e} of max|x| (limit 1e-6), {apart} parameters apart from a fresh "
              f"optimiser's step; on {card}")
        del on_card, on_cpu, fresh
    # (c) the mid-step state resumed in a training step on the card
    step = carried_step("cuda", paths[2], 2)
    batch = synthetic_train_batch(RESUME_BATCH, 160, 17, 60, "cuda", seed=SEED)
    zero_launch_counts()
    m = step(batch)
    torch.cuda.synchronize()
    counts = launch_counts()
    if not m["finite"] or step.micro != 0 or step.optimizer.updates != CARRY_COUNT + 1:
        fail(f"the resumed step: finite {m['finite']}, micro {step.micro}, updates "
             f"{step.optimizer.updates}")
    expect_launches("the resumed N training step", counts, N_LAYERS)
    print(f"[13] (c) the carried mid-step state resumed on the card: one N micro-batch (bs "
          f"{RESUME_BATCH}, 160 px, bf16) completed optimiser step {CARRY_COUNT + 1}, loss "
          f"{m['loss_total'].item():.3f}; kernel #1 {counts['msda_fwd']} launches; on {card}")
    out["resumed_loss"] = m["loss_total"].item()
    return counts, out


def training_start_path(card):
    """Main path 9 (phase 13): returns the launches and the numbers."""
    t_phase = time.perf_counter()
    numbers = {"init": {size: init_path(size, card) for size in ("n", "l")}}
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as root:
        counts, numbers["carry"] = carry_path(card, root)
    numbers["seconds"] = time.perf_counter() - t_phase
    print(f"[13] main path 9: kernel launches {counts}; {numbers['seconds']:.1f} s")
    return counts, numbers


def main():
    # ---- 1. the card
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False; this script needs an NVIDIA GPU")
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("comparisons run with TF32 off (cuda.matmul.allow_tf32=False, "
          "cudnn.allow_tf32=False)")

    # ---- 2. build
    # an emptied build directory: every library is built here, so ptxas reports
    shutil.rmtree(BUILD_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(LIBRARIES)) as pool:
        logs = dict(zip(LIBRARIES, pool.map(lambda k: k.build(), LIBRARIES.values())))
    print(f"[2] built {len(LIBRARIES)} libraries in {time.perf_counter() - t0:.2f} s")
    n_inst = 0
    for name, log in logs.items():
        report = ptxas_report(log)
        if not report:
            fail(f"{name}: no ptxas report; the library was not built in this run")
        if len(report) != INSTANTIATIONS[name]:
            fail(f"{name}: ptxas reports {len(report)} instantiations, the source makes "
                 f"{INSTANTIATIONS[name]}")
        for fn, regs, frame, spill_st, spill_ld in report:
            print(f"    ptxas {name}: {fn}: {regs} registers, {frame} bytes stack frame, "
                  f"{spill_st} bytes spill stores, {spill_ld} bytes spill loads")
            n_inst += 1
            if frame or spill_st or spill_ld:
                fail(f"{name}: {fn} has a stack frame or spills")
    print(f"[2] {n_inst} kernel instantiations, none with a stack frame or spills")

    # ---- 3. kernels vs plain
    g = torch.Generator(device="cuda").manual_seed(SEED)
    max_abs_err = check_kernels(g)
    check_train_op(g)
    max_abs_err["msda_bwd"] = check_backward_kernel(g)

    # ---- 4, 5. the L model: kernels vs plain MSDA, deploy vs train form
    gen = torch.Generator().manual_seed(SEED)
    train = check_l_model(gen)
    check_train_backends()

    # ---- 6. main path 1: serve
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    run, img, counts_serve = serve(train, np.random.default_rng(SEED))

    # ---- 7. main paths 2 and 3: the tools, the MSDA variant tools
    sizes, bench_ms, eager, exported, counts_tools = tools(card)
    v2, ablate, counts_variants = variant_tools(card)

    # ---- 7. main path 4: training
    counts_train, tstep, tbatch = train_path()
    total = {k: counts_serve[k] + counts_tools[k] + counts_variants[k] + counts_train[k]
             for k in KERNELS}

    # ---- 8. timing
    xb = torch.rand(32, 3, 640, 640, generator=gen).cuda()
    wh = torch.full((32, 2), 640.0, device="cuda")
    with torch.no_grad():
        fwd_ms = {fuse: cuda_time_ms(lambda m=m: m(xb, wh), iters=10)
                  for fuse, m in eager.items()}
        fwd_ms[True] = cuda_time_ms(lambda: eager[True](xb, wh), iters=10)
    export_ms = cuda_time_ms(lambda: exported(xb, wh), iters=10)
    print(f"[8] L forward+postprocess bs32 640 bf16: deploy-fused {fwd_ms[True]:.3f} "
          f"ms/batch, train form {fwd_ms[False]:.3f} ms/batch "
          f"(deploy, train, deploy), the exported deploy program {export_ms:.3f} "
          f"ms/batch; on {card}")
    lat = []
    for i in range(23):
        t0 = time.perf_counter()
        run(img, (img.shape[1], img.shape[0]))
        torch.cuda.synchronize()
        if i >= 3:
            lat.append((time.perf_counter() - t0) * 1e3)
    print(f"[8] one 480x640 request end to end (upload, resize, forward, decode; host "
          f"clock, synchronised): median {np.median(lat):.3f} ms, min {min(lat):.3f} ms "
          f"over {len(lat)} on {card}")

    value, levels, loc, aw = msda_inputs(g, torch.bfloat16, **L_SHAPES)
    vflat, locp, awp = pack(value, loc, aw)
    pts, xminor, tposed, cols = per_point(value, levels, loc, aw)
    dh = L_SHAPES["dh"]
    out_bytes = value.numel() // value.shape[1] * loc.shape[1] * value.element_size()
    gather_bound = msda_bound_ms(nbytes(value, loc, aw) + out_bytes, 10 * aw.numel() * dh)
    bounds = dict(per_point_bounds(pts, xminor, dh), msda_fwd=gather_bound,
                  msda_perquery=gather_bound)
    timed = [("msda_fwd", "msda_fwd", lambda: msda_forward(value, levels, loc, aw),
              lambda: ms_deform_attn_core(value, levels, loc, aw)),
             ("msda_perquery", "msda_perquery",
              lambda: msda_perquery(vflat, levels, locp, awp),
              lambda: msda_perquery_plain(vflat, levels, locp, awp)),
             ("msda_colsin", "msda_colsin", lambda: msda_colsin(pts, xminor, cols, levels),
              lambda: msda_colsin_plain(pts, xminor, levels)),
             (f"msda_colsin tile {COLSIN_TILES[1]}", "msda_colsin",
              lambda: msda_colsin(pts, xminor, cols, levels, COLSIN_TILES[1]),
              lambda: msda_colsin_plain(pts, xminor, levels)),
             ("msda_tpose", "msda_tpose", lambda: msda_tpose(pts, tposed, levels),
              lambda: msda_tpose_plain(pts, tposed, levels))]
    for mode in MODES:
        timed += [(f"msda_ablate {mode} tile {tile}", mode,
                   lambda mode=mode, tile=tile: msda_ablate(mode, pts, xminor, levels, tile),
                   lambda mode=mode: msda_ablate_plain(mode, pts, xminor, levels))
                  for tile in TILES]
    rows, modes, plain_ms, device_ms = {}, {}, {}, {}
    with torch.no_grad():
        for label, key, kernel, plain in timed:
            k_ms = cuda_time_ms(kernel, iters=50)
            traced = kernel_times(kernel, n=10)
            device_ms[label] = sum(k[1] for k in traced)
            if key not in plain_ms:      # a function's plain version is timed once
                plain_ms[key] = cuda_time_ms(plain, iters=10)
            row = (k_ms, plain_ms[key]) + bounds[key]
            print(f"[8] {label} at L shapes (B32 Lq1080 80/40/20 nP4 dh32, bf16 values): "
                  f"kernel {k_ms:.4f} ms (its kernels' device time {device_ms[label]:.4f} "
                  f"ms over {sum(k[2] for k in traced)} launches a call), plain {row[1]:.4f} ms, bound {row[2]:.4f} ms ({row[3]}); on {card}")
            (modes if label.startswith("msda_ablate") else rows)[label] = row
        rows["msda_ablate"] = modes[f"msda_ablate full tile {TILES[0]}"]
        # kernel #1 at each load width: the map placed 1, 2 and 4 elements
        # into its buffer takes 2-, 4- and 8-byte loads
        by_width = {16: rows["msda_fwd"][0]}
        for k in (1, 2, 4):
            v = shifted(value, k)
            nb = 2 * gather_plan(L_SHAPES["nH"], dh, 2, v.data_ptr(), 1).vec
            by_width[nb] = cuda_time_ms(lambda v=v: msda_forward(v, levels, loc, aw), iters=50)
            del v
        print("[8] msda_fwd at L shapes by bytes per load: " + ", ".join(
            f"{nb} B {ms:.4f} ms" for nb, ms in sorted(by_width.items())) + f"; on {card}")
        # kernels #1, #2 and #3 read one dh-wide head row per corner
        gather_bytes = 4 * aw.numel() * dh * value.element_size()
        for name in ("msda_fwd", "msda_perquery", "msda_colsin"):
            print(f"[8] {name}: corner-row traffic {gather_bytes / 1e6:.1f} MB through L2 "
                  f"in {rows[name][0]:.4f} ms = {gather_bytes / rows[name][0] / 1e9:.3f} "
                  f"TB/s; on {card}")
        # kernel #5: full reads the same corner rows; no_cexp's point pass two
        # 128-byte float rows per point and level, the same bytes
        full_ms = modes[f"msda_ablate full tile {TILES[0]}"][0]
        print(f"[8] msda_ablate full tile {TILES[0]}: corner-row traffic "
              f"{gather_bytes / 1e6:.1f} MB through L2 in {full_ms:.4f} ms = "
              f"{gather_bytes / full_ms / 1e9:.3f} TB/s; on {card}")
        passes = {tile: {name.split("(")[0].replace("void ", ""): ms for name, ms, _ in
                         kernel_times(lambda t=tile: msda_ablate("no_cexp", pts, xminor,
                                                                 levels, t), n=10)}
                  for tile in TILES}
        for tile, by_name in passes.items():
            print(f"[8] msda_ablate no_cexp tile {tile}, device time per call by kernel "
                  f"(torch.profiler): " + (", ".join(f"{k} {ms:.4f} ms" for k, ms in
                                                      by_name.items()) or "not measured")
                  + f"; on {card}")
        # kernel #4: its plan at L, and its time by channel groups at the N
        # and L shapes (a smaller shared-memory budget forces more groups) and
        # with its taps from device memory (budget 0)
        by_groups = {}
        for label, shp, groups in (("N", N_SHAPES, (1, 2, 4, 8)),
                                   ("L", L_SHAPES, (4, 8, 16, None))):
            if label == "L":
                npts, ntposed, nlevels = pts, tposed, levels
            else:
                nv, nlevels, nloc, naw = msda_inputs(g, torch.bfloat16, **shp)
                npts, _, ntposed, _ = per_point(nv, nlevels, nloc, naw)
            P = npts[0][0].shape[-1]
            for n in groups:
                budget = tpose_smem(nlevels, shp["dh"], n) if n else 0
                plan = MSDATpose.plan(ntposed, nlevels, shp["dh"], P, budget)
                if (plan.groups if plan.staged else None) != n:
                    fail(f"msda_tpose: a budget of {budget} bytes gave {plan}")
                call = (lambda b=budget, q=npts, t=ntposed, v=nlevels:
                        msda_tpose(q, t, v, _budget=b))
                ms = cuda_time_ms(call, iters=50)
                dev = sum(k[1] for k in kernel_times(call, n=10))
                what = f"{n} groups" if n else "taps from device memory"
                by_groups[f"{label} {what}"] = {"ms": ms, "device_ms": dev}
                print(f"[8] msda_tpose at {label} shapes, {what}: {plan.threads} threads, "
                      f"{plan.blocks} blocks along the points and {plan.smem} bytes of shared "
                      f"memory a block, bulk fill {plan.bulk}: {ms:.4f} ms (device time "
                      f"{dev:.4f} ms); on {card}")
        l_plan = MSDATpose.plan(tposed, levels, dh, pts[0][0].shape[-1])
        print(f"[8] msda_tpose at L shapes takes {l_plan.groups} groups of {l_plan.chans} "
              f"channels by its plan ({l_plan.smem} bytes a block; {SMEM_OPTIN} gives "
              f"{MSDATpose.plan(tposed, levels, dh, pts[0][0].shape[-1], SMEM_OPTIN).groups}); "
              f"on {card}")
        maps = level_maps(value, levels, L_SHAPES["nH"])
        ops = {"msda_perquery": lambda: ms_deform_attn_pallas_flat(value, levels, loc, aw),
               "msda_fwd per-level": lambda: ms_deform_attn_fast(maps, loc, aw),
               "msda_colsin": lambda: ms_deform_attn_colsin(maps, loc, aw),
               "msda_tpose": lambda: ms_deform_attn_tpose(maps, loc, aw)}
        op_ms = {name: cuda_time_ms(fn, iters=50) for name, fn in ops.items()}
        # the device's share of an op's time: its packing is many small kernels
        op_device_ms = {name: sum(k[1] for k in kernel_times(fn, n=10))
                        for name, fn in ops.items()}
        yardstick = grid_sample_yardstick(value, levels, loc, aw)
        ys_ms = cuda_time_ms(yardstick, iters=50)
        ys_dev = sum(k[1] for k in kernel_times(yardstick, n=10))
        want = msda_colsin_plain(pts, xminor, levels)
        got = yardstick().float().reshape(want.shape[:2] + (dh, -1)).transpose(2, 3)
        ys_err = ((got - want).abs().max() / want.abs().max()).item()
        del want, got
    print(f"[8] the ops with their packing: msda_perquery from the (B, S, nH*dh) memory "
          f"(the model's call) {op_ms['msda_perquery']:.4f} ms; from per-level maps (the "
          f"tools' call) kernel #1 {op_ms['msda_fwd per-level']:.4f} ms, msda_colsin "
          f"{op_ms['msda_colsin']:.4f} ms, msda_tpose {op_ms['msda_tpose']:.4f} ms; 6 calls "
          f"of kernel #1 = {100 * 6 * rows['msda_fwd'][0] / fwd_ms[False]:.1f}% of the "
          f"train-form forward; on {card}")
    print("[8] the ops' device time (torch.profiler, every kernel of a call summed): " +
          ", ".join(f"{name} {ms:.4f} ms" for name, ms in op_device_ms.items()) +
          f"; on {card}")
    print(f"[8] library yardstick of #3-#5's per-point function at L shapes: "
          f"{len(levels)} F.grid_sample calls, not one call (the reference DETRPose's form, "
          f"bf16 maps and grid): {ys_ms:.4f} ms (device time {ys_dev:.4f} ms), max|err| "
          f"{ys_err:.3e} of max|ref| against the plain version (its bf16 grid); msda_colsin "
          f"{rows['msda_colsin'][0]:.4f} ms; on {card}")

    # the L training step: its trace, kernel #1's backward alone, the
    # matcher, then tools/benchmark.py's timing
    split = train_time_split(tstep, tbatch)
    print(f"[8] L train, {TRAIN_ACCUM} micro-steps (bs {TRAIN_BATCH}, 640 px, bf16, one optimiser "
          f"step): {split['wall_ms']:.3f} ms by CUDA events; traced: device busy "
          f"{split['busy_ms']:.3f} ms over {split['launches']} kernel launches (idle share "
          f"{split['idle_share']:.3f}); kernel #1's plain-version backward "
          f"({split['msda_backward_calls']} calls, profiler range {BACKWARD_RANGE}) "
          f"{split['msda_backward_ms']:.3f} ms = "
          f"{100 * split['msda_backward_ms'] / max(split['busy_ms'], 1e-9):.1f}% of busy; by "
          f"family: " + ", ".join(f"{f} {ms:.3f} ms ({100 * ms / split['busy_ms']:.1f}%)"
                                  for f, ms in sorted(split["families_ms"].items(),
                                                      key=lambda kv: -kv[1])) + f"; on {card}")
    for name, ms, count in split["top_kernels"]:
        print(f"[8]   {ms:8.3f} ms  x{count:<5d} {name[:90]}")
    print(f"[8] the traced micro-steps by phase, host / device time: " + ", ".join(
        f"{name} {t['host_ms']:.3f} / {t['device_ms']:.3f} ms" for name, t in
        split["ms_by_phase"].items()) + f"; on {card}")
    bwd_alone = msda_backward_alone(g)
    print(f"[8] kernel #1's op at the L train shapes (bs {TRAIN_BATCH}, 124 x 18 queries, bf16): "
          f"forward {bwd_alone[0]:.4f} ms, its plain-version backward {bwd_alone[1]:.4f} ms a "
          f"call (x6 = {6 * bwd_alone[1]:.3f} ms a micro-step); on {card}")
    bwd_kernel = msda_backward_times(g, card)
    kan = kan_times(g, card)
    logits, kpts, _ = branch_assignments(tstep.model, tbatch)
    matcher_ms = {b: cuda_time_ms(lambda b=b: hungarian_match(logits, kpts, tbatch["targets"], 17,
                                                              backend=b), iters=5)
                  for b in ("auction", "scipy")}
    print(f"[8] matcher, {logits.shape[0]} branches x bs {TRAIN_BATCH} x 60 queries x 8 poses: "
          f"auction {matcher_ms['auction']:.3f} ms, scipy {matcher_ms['scipy']:.3f} ms a call; "
          f"on {card}")
    del tstep, tbatch, logits, kpts
    torch.cuda.empty_cache()
    bench_train = benchmark.bench_train_step("l", TRAIN_BATCH, 640, warmup=3, iters=10,
                                             grad_accum_steps=TRAIN_ACCUM)
    print(f"[8] bench_train_step('l'), bs {TRAIN_BATCH}, 640 px, bf16, accumulation "
          f"{TRAIN_ACCUM}: {bench_train['step_ms']:.3f} ms a micro-step, "
          f"{bench_train['opt_step_ms']:.3f} ms an optimiser step, "
          f"{bench_train['images_per_sec']} img/s, peak memory "
          f"{bench_train['peak_mem_bytes'] / 2**30:.2f} GiB, launches "
          f"{bench_train['launches']} over {bench_train['iters']} micro-steps; on {card}")
    if not bench_train["finite"] or bench_train["launches"]["msda_fwd"] != 6 * bench_train["iters"]:
        fail(f"bench_train_step: finite {bench_train['finite']}, launches "
             f"{bench_train['launches']}")

    # ---- 9. main path 5: the Trainer
    torch.cuda.empty_cache()
    counts_trainer, trainer_numbers = trainer_path(card)
    total = {k: total[k] + counts_trainer[k] for k in KERNELS}

    # ---- 10. main path 6: data parallelism over ranks
    torch.cuda.empty_cache()
    counts_dp, dp_numbers = data_parallel_path(card)
    total = {k: total[k] + counts_dp[k] for k in KERNELS}

    # ---- 11. main path 7: the model variants, the command line, bench_data
    torch.cuda.empty_cache()
    counts_variants7, variant_numbers = variants_path(card, gen, g)
    total = {k: total[k] + counts_variants7[k] for k in KERNELS}

    # ---- 12. main path 8: weights from elsewhere, the tutorial, the
    # overfit run
    torch.cuda.empty_cache()
    counts_path8, path8_numbers = weights_programs_path(card)
    total = {k: total[k] + counts_path8[k] for k in KERNELS}

    # ---- 13. main path 9: the init and the carried optax state
    torch.cuda.empty_cache()
    counts_path9, path9_numbers = training_start_path(card)
    total = {k: total[k] + counts_path9[k] for k in KERNELS}
    # kernel #1's backward kernel runs only in a forward with energy
    # refinement's gradient, the FastKAN basis product only in the KAN
    # variant's bf16 forward: main path 7's, which counts them
    total["msda_bwd"] = counts_variants7["msda_bwd"]
    total["kan_basis"] = counts_variants7["kan_basis"]

    # ---- 14. report
    sources = {"msda_fwd": ("detrpose_tpu_torch/csrc/msda_fwd.cu",
                            "detrpose_tpu/ops/pallas/msda_sep.py:59"),
               "msda_perquery": ("detrpose_tpu_torch/csrc/msda_perquery.cu",
                                 "detrpose_tpu/ops/pallas/msda.py:34"),
               "msda_colsin": ("detrpose_tpu_torch/csrc/msda_colsin.cu",
                               "tools_local_msda_v2.py:93"),
               "msda_tpose": ("detrpose_tpu_torch/csrc/msda_tpose.cu",
                              "tools_local_msda_v2.py:152"),
               "msda_ablate": ("detrpose_tpu_torch/csrc/msda_ablate.cu",
                               "tools_local_msda_ablate.py:48")}
    print(json.dumps({"sizes": {s: {"params_M": i["params_M"], "gflops": i["gflops"],
                                    "latency_ms": r["latency_ms"],
                                    "images_per_sec": r["images_per_sec"]}
                                for s, (i, r) in sizes.items()},
                      "l_deploy_ms": fwd_ms[True], "l_train_ms": fwd_ms[False],
                      "l_exported_ms": export_ms, "pallas_bench_ms": bench_ms,
                      "op_with_packing_ms": op_ms, "op_with_packing_device_ms": op_device_ms,
                      "msda_fwd_ms_by_load_bytes": by_width,
                      "grid_sample_composition_ms": {"ms": ys_ms, "device_ms": ys_dev,
                                                     "max_rel_err": ys_err},
                      "msda_v2": v2, "msda_ablate_tool": ablate,
                      "msda_ablate_modes": {k: dict(zip(("ms", "plain_ms", "bound_ms",
                                                         "bound_by"), r))
                                            for k, r in modes.items()},
                      "msda_ablate_no_cexp_passes_ms": passes,
                      "kernel_device_ms": device_ms,
                      "msda_tpose_by_groups": by_groups,
                      "train": {"bench": bench_train, "trace": split,
                                "msda_op_train_shapes_ms": {"forward": bwd_alone[0],
                                                            "backward": bwd_alone[1]},
                                "msda_bwd_energy_shapes_ms": bwd_kernel,
                                "matcher_ms": matcher_ms},
                      "trainer": trainer_numbers, "data_parallel": dp_numbers,
                      "variants": variant_numbers, "path8": path8_numbers,
                      "path9": path9_numbers}))
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": sources[name][0],
        "replaces": sources[name][1], "launches": total[name],
        "max_abs_err": max_abs_err[name], "ms": rows[name][0], "plain_ms": rows[name][1],
        "bound_ms": rows[name][2], "bound_by": rows[name][3], "library_ms": None}
        for name in KERNELS] + [{
        "name": "msda_bwd", "route": "cuda", "source": "detrpose_tpu_torch/csrc/msda_bwd.cu",
        "replaces": None, "launches": total["msda_bwd"],
        "max_abs_err": max_abs_err["msda_bwd"], "ms": bwd_kernel["ms"],
        "plain_ms": bwd_kernel["plain_ms"], "bound_ms": bwd_kernel["bound_ms"],
        "bound_by": bwd_kernel["bound_by"], "library_ms": None}] + [{
        "name": f"kan_basis {name}", "route": "cuda", "source": "detrpose_tpu_torch/csrc/kan_basis.cu",
        "replaces": None, "launches": total["kan_basis"], "max_abs_err": row["max_abs_err"],
        "ms": row["ms"],
        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": None} for name, row in kan.items()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    adopt_orphans()
    try:
        if sys.argv[1:2] == ["--cli-rank"]:     # a rank of main path 6 (c)
            cli_rank(sys.argv[2], sys.argv[4:])
        else:
            main()
    finally:
        for pid, cmd in stop_children().items():
            print(f"chip_smoke: stopped process {pid} that had not ended: {cmd[:200]}",
                  file=sys.stderr)
