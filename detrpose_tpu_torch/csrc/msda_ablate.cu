// Stage ablations of the per-point MSDA kernel, sm_90a.
//
// Replaces the TPU kernel tools_local_msda_ablate.py::build (kernel :48,
// pallas_call :129), which times the separable MSDA kernel with its stages
// dropped to locate its cost, over the modes and the point tiles TP 512 and
// 1024 (:143-144). Its modes, and the function each computes here, with
// hat(t) = max(1-|t|, 0) and the sums over the map's rows y and columns x:
//   full         sum_l a_l sum_{y,x} hat(iy_l-y) hat(ix_l-x) V_l[y,x,:]
//                (bilinear sampling, as csrc/msda_colsin.cu)
//   no_cexp      sum_l a_l sum_y hat(iy_l-y) sum_x V_l[y,x,:]   (whole rows)
//   stage1_only  sum_l a_l sum_y hat(iy_l-y) V_l[y,0,:]         (column 0)
//   io_only      sum_l ix_l over every channel; the values are not read
// As in the other per-point kernels the hats become direct taps at floor and
// floor+1 with a tap outside the map dropped, in float32 (the TPU rounds R
// and T*Cexp to bf16 as MXU inputs). The TPU kernel folds the column groups
// with a one-hot (W*dh, dh) matrix Sel; summing a channel over the columns
// is what that product does, so this kernel takes no Sel. Held to
// detrpose_tpu_torch/ops/cuda/msda_ablate.py::msda_ablate_plain.
//
// Layout, as csrc/msda_colsin.cu:
//   per level l:  ix, iy, a  (B*nH, P) float, pixel coordinates
//                 v          (B*nH, H, W*dh) bf16, x-minor
//   out           (B*nH, P, dh) float
//   rows          no_cexp's scratch, (B*nH, sum_l H_l, dh) float
//
// Design, one for every mode, on the taps of msda_gather.cuh. A block takes
// `tile` points of one (image, head) (a launch argument, the counterpart of
// TP). A thread owns V consecutive channels of one point: V = 8 for the bf16
// maps and 4 for the float row sums, so a corner or a row tap is one 16-byte
// load (8-, 4- or 2-byte where dh or a level's address rules 16 out;
// ops/cuda/msda.py::point_plan takes the widest that every level allows).
// dh/V threads share a point (4 at dh 32, so a warp holds 8 points), and the
// threads of a warp write whole contiguous output rows, each as V/4 16-byte
// stores. The point scalars are read by __ldg, the threads of a point
// reading the same words, and a level's taps are loaded before the first is
// used, branchless (gather_px, taps_px). One point a thread keeps full at 56
// registers, so 4 blocks fit an SM; two took 94 registers and ran 13-25%
// slower on an H100, four spilled (PERF.md). full takes the four corners,
// stage1_only the two row taps of column 0. no_cexp is two kernels: a row
// pass that sums each row of each (image, head)'s maps over x once per call
// (one warp per row, 16-byte loads along it, the lanes that hold the same
// channels summed by shuffles) into `rows`, then the point pass, two taps per
// level from those rows. io_only writes each point's sum of ix to its V
// channels.
//
// What bounds it on an H100, at DETRPose-L eval shapes (B 32, nH 8, P 4320,
// levels 80/40/20, dh 32), each mode by bytes: full 137.6 MB of values,
// 39.8 MB of points and the 141.6 MB output, 0.095 ms at 3.35 TB/s; no_cexp
// the values, iy, a and the output; stage1_only iy, a, column 0 and the
// output; io_only ix and the output. Beyond those, full moves 849.3 MB of
// 64-byte corner rows through L2 (as kernel #1) and no_cexp's point pass
// 849.3 MB of 128-byte float rows from its 4.6 MB table.

#include "msda_gather.cuh"

enum AblateMode { FULL = 0, NO_CEXP = 1, STAGE1_ONLY = 2, IO_ONLY = 3 };

// The point pass of every mode. T is what a tap reads: the bf16 maps, or
// no_cexp's float rows.
template <int MODE, int V>
__global__ void __launch_bounds__(MSDA_THREADS, MSDA_MIN_BLOCKS)
msda_ablate_kernel(PointLevels lv, const float* __restrict__ rows, float* __restrict__ out,
                   int P, int nL, int dh, int tile) {
  using T = std::conditional_t<MODE == NO_CEXP, float, __nv_bfloat16>;
  const int lanes = dh / V;  // threads per point
  const int slots = MSDA_THREADS / lanes;
  const int slot = threadIdx.x / lanes;
  if (slot >= slots) return;  // past the block's last whole point
  const int c = (threadIdx.x - slot * lanes) * V;
  const long long bh = blockIdx.y;
  const int p_end = min(P, ((int)blockIdx.x + 1) * tile);
  int sum_h = 0;  // rows of one (image, head) in `rows`
#pragma unroll
  for (int l = 0; l < MSDA_MAX_LEVELS; ++l)
    if (l < nL) sum_h += lv.h[l];

  for (int p = (int)blockIdx.x * tile + slot; p < p_end; p += slots) {
    const long long pt = bh * P + p;
    float acc[V] = {};
    int start = 0;  // the level's first row in `rows`
#pragma unroll
    for (int l = 0; l < MSDA_MAX_LEVELS; ++l) {
      if (l < nL) {
        const int H = lv.h[l];
        const int W = lv.w[l];
        if constexpr (MODE == FULL) {
          msda::gather_px<T, V>(lv.v[l] + bh * H * W * dh + c, H, W, dh, __ldg(lv.ix[l] + pt),
                                __ldg(lv.iy[l] + pt), __ldg(lv.a[l] + pt), acc);
        } else if constexpr (MODE == STAGE1_ONLY) {
          msda::taps_px<T, V>(lv.v[l] + bh * H * W * dh + c, H, W * dh, __ldg(lv.iy[l] + pt),
                              __ldg(lv.a[l] + pt), acc);
        } else if constexpr (MODE == NO_CEXP) {
          msda::taps_px<T, V>(rows + (bh * sum_h + start) * dh + c, H, dh,
                              __ldg(lv.iy[l] + pt), __ldg(lv.a[l] + pt), acc);
        } else {
          const float ix = __ldg(lv.ix[l] + pt);
#pragma unroll
          for (int i = 0; i < V; ++i) acc[i] += ix;
        }
        start += H;
      }
    }
    msda::store_f32<V>(out + pt * dh + c, acc);
  }
}

// no_cexp's row pass: rows[bh, start_l + y, :] = sum_x V_l[bh, y, x, :],
// one warp per row. A row of W*dh values is W*lanes vectors of V channels,
// vector k holding channel group k % lanes. The warp takes the groups in
// windows of up to 32: a lane keeps one group and strides over the pixels
// by span/width, so every vector it loads is of its group; then the lanes
// of a group are summed by shuffles.
template <int V>
__global__ void __launch_bounds__(MSDA_THREADS)
msda_rowsum_kernel(PointLevels lv, float* __restrict__ rows, long long n_rows, int nL,
                   int dh) {
  using T = __nv_bfloat16;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (MSDA_THREADS / 32) + (threadIdx.x >> 5);
  if (row >= n_rows) return;  // a whole warp: the shuffles below see all 32 lanes
  int sum_h = 0;
#pragma unroll
  for (int l = 0; l < MSDA_MAX_LEVELS; ++l)
    if (l < nL) sum_h += lv.h[l];
  const long long bh = row / sum_h;
  const T* src = lv.v[0];
  int W = 0;
  int r = (int)(row - bh * sum_h);
#pragma unroll
  for (int l = 0; l < MSDA_MAX_LEVELS; ++l) {
    if (l < nL) {
      if (r >= 0 && r < lv.h[l]) {
        src = lv.v[l] + (bh * lv.h[l] + r) * lv.w[l] * dh;
        W = lv.w[l];
      }
      r -= lv.h[l];
    }
  }
  const int lanes = dh / V;
  for (int g0 = 0; g0 < lanes; g0 += 32) {
    const int width = min(32, lanes - g0);  // groups in this window
    const int span = 32 / width * width;    // lanes that load
    const int group = g0 + lane % width;
    float s[V] = {};
    if (lane < span) {
#pragma unroll 4
      for (int x = lane / width; x < W; x += span / width)
        msda::fma_row<T, V>(msda::load<T, V>(src + ((long long)x * lanes + group) * V), 1.f,
                            s);
    }
#pragma unroll
    for (int i = 0; i < V; ++i) {
      if ((width & (width - 1)) == 0) {  // span is 32: a butterfly
        for (int off = width; off < 32; off <<= 1)
          s[i] += __shfl_xor_sync(0xffffffffu, s[i], off);
      } else {  // lane j < width adds lanes j + k*width < span, as loaded
        const float own = s[i];
        for (int k = 1; k < span / width; ++k)
          s[i] += __shfl_down_sync(0xffffffffu, own, k * width);
      }
    }
    if (lane < width) msda::store_f32<V>(rows + row * dh + group * V, s);
  }
}

template <int MODE>
static int launch(PointLevels lv, void* out, void* rows, int BH, int P, int nL, int dh,
                  int tile, int vec, int row_vec, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if constexpr (MODE == NO_CEXP) {
    int sum_h = 0;
    for (int l = 0; l < nL; ++l) sum_h += lv.h[l];
    const long long n_rows = (long long)BH * sum_h;
    const int warps = MSDA_THREADS / 32;
    const int err = msda::dispatch_vec<__nv_bfloat16>(row_vec, [&](auto v) {
      msda_rowsum_kernel<decltype(v)::value>
          <<<(unsigned)((n_rows + warps - 1) / warps), MSDA_THREADS, 0, s>>>(
              lv, (float*)rows, n_rows, nL, dh);
      return (int)cudaGetLastError();
    });
    if (err) return err;
  }
  using T = std::conditional_t<MODE == NO_CEXP, float, __nv_bfloat16>;
  const dim3 grid((P + tile - 1) / tile, BH);
  return msda::dispatch_vec<T>(vec, [&](auto v) {
    msda_ablate_kernel<MODE, decltype(v)::value><<<grid, MSDA_THREADS, 0, s>>>(
        lv, (const float*)rows, (float*)out, P, nL, dh, tile);
    return (int)cudaGetLastError();
  });
}

// The entry points: the point table, out, B*nH, P, nL, dh, no_cexp's row
// scratch (else NULL), the tile, the point pass's channels per thread, the
// row pass's (no_cexp, else 0), the stream; they return cudaGetLastError().
#define MSDA_ABLATE_ENTRY(NAME, MODE)                                           \
  extern "C" int NAME(PointLevels lv, void* out, int BH, int P, int nL, int dh, \
                      void* rows, int tile, int vec, int row_vec, void* stream) {  \
    return launch<MODE>(lv, out, rows, BH, P, nL, dh, tile, vec, row_vec, stream); \
  }

MSDA_ABLATE_ENTRY(msda_ablate_full, FULL)
MSDA_ABLATE_ENTRY(msda_ablate_no_cexp, NO_CEXP)
MSDA_ABLATE_ENTRY(msda_ablate_stage1_only, STAGE1_ONLY)
MSDA_ABLATE_ENTRY(msda_ablate_io_only, IO_ONLY)
