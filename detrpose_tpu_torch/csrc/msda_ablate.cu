// Stage ablations of the per-point MSDA kernel, one template per mode, sm_90a.
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
//
// Design: a block covers one (image, head) and `tile` points (a launch
// argument, the counterpart of TP), eight warps, each warp one point at a
// time with lanes over the channels (lane c owns c and c+32). no_cexp first
// forms the row sums of its (image, head)'s maps in shared memory (the same
// function, sum_l H_l*dh floats), reading every value of that pair once per
// block, then takes two taps per point and level from them: the smaller the
// tile, the more blocks read the same maps again.
//
// What bounds it on an H100, at DETRPose-L eval shapes (B 32, nH 8, P 4320,
// levels 80/40/20, dh 32), each mode by bytes: full 137.6 MB of values,
// 39.8 MB of points and the 141.6 MB output, 0.095 ms at 3.35 TB/s; no_cexp
// the values, iy, a and the output; stage1_only iy, a, column 0 and the
// output; io_only ix and the output.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#define MSDA_MAX_LEVELS 4
#define WARPS 8

enum AblateMode { FULL = 0, NO_CEXP = 1, STAGE1_ONLY = 2, IO_ONLY = 3 };

struct PointLevels {
  const float* ix[MSDA_MAX_LEVELS];
  const float* iy[MSDA_MAX_LEVELS];
  const float* a[MSDA_MAX_LEVELS];
  const __nv_bfloat16* v[MSDA_MAX_LEVELS];
  int h[MSDA_MAX_LEVELS];
  int w[MSDA_MAX_LEVELS];
};

template <int MODE>
__global__ void __launch_bounds__(WARPS * 32)
msda_ablate_kernel(PointLevels lv, float* __restrict__ out, int P, int nL, int dh,
                   int tile) {
  extern __shared__ float rowsum[];  // no_cexp: per level (H, dh), levels in turn
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long bh = blockIdx.y;

  if (MODE == NO_CEXP) {
    int start = 0;
#pragma unroll
    for (int l = 0; l < MSDA_MAX_LEVELS; ++l) {
      if (l < nL) {
        const int H = lv.h[l];
        const int W = lv.w[l];
        const __nv_bfloat16* v = lv.v[l] + bh * H * W * dh;
        // thread i sums channel d of row y over the columns; neighbouring
        // threads read neighbouring channels
        for (int i = threadIdx.x; i < H * dh; i += blockDim.x) {
          const int y = i / dh;
          const int d = i - y * dh;
          const __nv_bfloat16* r = v + (long long)y * W * dh + d;
          float s = 0.f;
#pragma unroll 8
          for (int x = 0; x < W; ++x) s += __bfloat162float(r[x * dh]);
          rowsum[start + i] = s;
        }
        start += H * dh;
      }
    }
    __syncthreads();
  }

  const int c0 = lane;
  const int c1 = lane + 32;
  const bool has0 = c0 < dh;
  const bool has1 = c1 < dh;
  const int p_end = min(P, (int)(blockIdx.x + 1) * tile);
  for (int p = (int)blockIdx.x * tile + warp; p < p_end; p += WARPS) {
    const long long pt = bh * P + p;
    float acc0 = 0.f;
    float acc1 = 0.f;
    int start = 0;  // no_cexp: the level's first row sum
#pragma unroll
    for (int l = 0; l < MSDA_MAX_LEVELS; ++l) {
      if (l < nL) {
        const int H = lv.h[l];
        const int W = lv.w[l];
        const float Hf = (float)H;
        const float Wf = (float)W;
        const __nv_bfloat16* v = lv.v[l] + bh * H * W * dh;
        if (MODE == IO_ONLY) {
          const float ix = __ldg(lv.ix[l] + pt);
          acc0 += ix;
          acc1 += ix;
        } else if (MODE == FULL) {
          const float ix = __ldg(lv.ix[l] + pt);
          const float iy = __ldg(lv.iy[l] + pt);
          const float a = __ldg(lv.a[l] + pt);
          const float x0 = floorf(ix);
          const float y0 = floorf(iy);
          const float x1 = x0 + 1.f;
          const float y1 = y0 + 1.f;
          const bool vx0 = x0 >= 0.f && x0 <= Wf - 1.f;
          const bool vx1 = x1 >= 0.f && x1 <= Wf - 1.f;
          const bool vy0 = y0 >= 0.f && y0 <= Hf - 1.f;
          const bool vy1 = y1 >= 0.f && y1 <= Hf - 1.f;
          const float wx0 = x1 - ix;
          const float wx1 = ix - x0;
          const float wy0 = y1 - iy;
          const float wy1 = iy - y0;
#define MSDA_CORNER(VX, VY, XC, YC, WX, WY)                                   \
          if (VX && VY) {                                                     \
            const __nv_bfloat16* r = v + ((long long)YC * W + (long long)XC) * dh; \
            const float w = a * (WX * WY);                                    \
            if (has0) acc0 += w * __bfloat162float(r[c0]);                    \
            if (has1) acc1 += w * __bfloat162float(r[c1]);                    \
          }
          MSDA_CORNER(vx0, vy0, x0, y0, wx0, wy0)
          MSDA_CORNER(vx0, vy1, x0, y1, wx0, wy1)
          MSDA_CORNER(vx1, vy0, x1, y0, wx1, wy0)
          MSDA_CORNER(vx1, vy1, x1, y1, wx1, wy1)
#undef MSDA_CORNER
        } else {
          // two y-taps of a row source: the row sums, or column 0 of the map
          const float iy = __ldg(lv.iy[l] + pt);
          const float a = __ldg(lv.a[l] + pt);
          const float y0 = floorf(iy);
          const float y1 = y0 + 1.f;
          const bool vy0 = y0 >= 0.f && y0 <= Hf - 1.f;
          const bool vy1 = y1 >= 0.f && y1 <= Hf - 1.f;
#define MSDA_ROW_TAP(VY, YC, WY)                                              \
          if (VY) {                                                           \
            const int y = (int)YC;                                            \
            const float w = a * (WY);                                         \
            if (MODE == NO_CEXP) {                                            \
              const float* r = rowsum + start + y * dh;                       \
              if (has0) acc0 += w * r[c0];                                    \
              if (has1) acc1 += w * r[c1];                                    \
            } else {                                                          \
              const __nv_bfloat16* r = v + (long long)y * W * dh;             \
              if (has0) acc0 += w * __bfloat162float(r[c0]);                  \
              if (has1) acc1 += w * __bfloat162float(r[c1]);                  \
            }                                                                 \
          }
          MSDA_ROW_TAP(vy0, y0, y1 - iy)
          MSDA_ROW_TAP(vy1, y1, iy - y0)
#undef MSDA_ROW_TAP
        }
        start += H * dh;
      }
    }
    float* o = out + pt * dh;
    if (has0) o[c0] = acc0;
    if (has1) o[c1] = acc1;
  }
}

template <int MODE>
static int launch(PointLevels lv, void* out, int BH, int P, int nL, int dh, int tile,
                  void* stream) {
  size_t smem = 0;
  if (MODE == NO_CEXP)
    for (int l = 0; l < nL; ++l) smem += (size_t)lv.h[l] * dh * sizeof(float);
  const dim3 grid((P + tile - 1) / tile, BH);
  msda_ablate_kernel<MODE><<<grid, WARPS * 32, smem, (cudaStream_t)stream>>>(
      lv, (float*)out, P, nL, dh, tile);
  return (int)cudaGetLastError();
}

#define MSDA_ABLATE_ENTRY(NAME, MODE)                                         \
  extern "C" int NAME(PointLevels lv, void* out, int BH, int P, int nL, int dh, \
                      int tile, void* stream) {                               \
    return launch<MODE>(lv, out, BH, P, nL, dh, tile, stream);                \
  }

MSDA_ABLATE_ENTRY(msda_ablate_full, FULL)
MSDA_ABLATE_ENTRY(msda_ablate_no_cexp, NO_CEXP)
MSDA_ABLATE_ENTRY(msda_ablate_stage1_only, STAGE1_ONLY)
MSDA_ABLATE_ENTRY(msda_ablate_io_only, IO_ONLY)
