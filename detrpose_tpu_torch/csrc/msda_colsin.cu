// MSDA per sampling point on x-minor value rows, lanes over channels, sm_90a.
//
// Replaces the TPU kernel tools_local_msda_v2.py::build_colsin (kernel :93,
// pallas_call :133), the "colsin" variant of the separable MSDA kernel. Per
// tile of points that kernel builds the row hat R = bf16(max(1-|iy-y|,0)*a),
// multiplies it with the level's value rows on the MXU (T = R.V, (TP, W*dh)),
// weights T by the column hat max(1-|ix-col|,0), whose column index comes
// from a precomputed (1, W*dh) input plane (entry j = j // dh), folds the W
// column groups and sums the levels. That separable form exists because TPU
// gathers are bound by descriptor rate; summed over all rows and columns the
// two hats are bilinear sampling with zeros padding. So this kernel computes
// the same function by direct taps: per point and level the four corners at
// floor and floor+1, a corner outside the map dropped, weights in float32
// (the TPU rounds R to bf16, an MXU input type). The column index the plane
// encodes is j // dh, which a direct-tap kernel takes from ix itself: the
// op builds the planes and the wrapper checks them, but this kernel does not
// read them. Held to detrpose_tpu_torch/ops/cuda/msda_colsin.py::
// msda_colsin_plain.
//
// Layout (the TPU op's packing without its Mosaic padding of P to 512):
//   per level l:  ix, iy, a  (B*nH, P) float, pixel coordinates x*W-0.5, y*H-0.5
//                 v          (B*nH, H, W*dh) bf16, x-minor: row y holds the
//                            channels of x = 0, 1, ... in turn
//   out           (B*nH, P, dh) float: one sample per point, summed over
//                 levels, not over the nP points of a query
//
// Design: a block covers one (image, head) and POINTS_PER_BLOCK points, each
// warp one point at a time. Lanes run over the channels (lane c owns c and
// c+32, so dh up to 64): a corner is one dh-wide row segment (64 bytes for
// bf16 dh 32) and a point's output row one 128-byte store. The lanes read
// the point's three scalars per level as one broadcast load each. The level
// loop is unrolled to MSDA_MAX_LEVELS, so the level table is read with
// constant indices and needs no stack frame.
//
// What bounds it on an H100: bytes. At DETRPose-L eval shapes (B 32, nH 8,
// P = 1080*4 = 4320, levels 80/40/20, dh 32) one call must read the values
// once (137.6 MB), the points (39.8 MB) and write the per-point output
// (141.6 MB): 0.095 ms at 3.35 TB/s. The output, 8x kernel #1's, is what the
// per-point form adds; the corner reads are scattered 64-byte segments
// through L2, as in kernels #1 and #2.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#define MSDA_MAX_LEVELS 4
#define WARPS 8
#define POINTS_PER_BLOCK 32

struct PointLevels {
  const float* ix[MSDA_MAX_LEVELS];
  const float* iy[MSDA_MAX_LEVELS];
  const float* a[MSDA_MAX_LEVELS];
  const __nv_bfloat16* v[MSDA_MAX_LEVELS];
  int h[MSDA_MAX_LEVELS];
  int w[MSDA_MAX_LEVELS];
};

__global__ void __launch_bounds__(WARPS * 32)
msda_colsin_kernel(PointLevels lv, float* __restrict__ out, int P, int nL, int dh) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long bh = blockIdx.y;
  const int c0 = lane;
  const int c1 = lane + 32;
  const bool has0 = c0 < dh;
  const bool has1 = c1 < dh;
  const int p_end = min(P, (int)(blockIdx.x + 1) * POINTS_PER_BLOCK);
  for (int p = (int)blockIdx.x * POINTS_PER_BLOCK + warp; p < p_end; p += WARPS) {
    const long long pt = bh * P + p;
    float acc0 = 0.f;
    float acc1 = 0.f;
#pragma unroll
    for (int l = 0; l < MSDA_MAX_LEVELS; ++l) {
      if (l < nL) {
        const int H = lv.h[l];
        const int W = lv.w[l];
        const float Hf = (float)H;
        const float Wf = (float)W;
        const __nv_bfloat16* v = lv.v[l] + bh * H * W * dh;
        const float ix = __ldg(lv.ix[l] + pt);
        const float iy = __ldg(lv.iy[l] + pt);
        const float a = __ldg(lv.a[l] + pt);
        const float x0 = floorf(ix);
        const float y0 = floorf(iy);
        const float x1 = x0 + 1.f;
        const float y1 = y0 + 1.f;
        // validity in float, so NaN or far-out points drop the corner
        const bool vx0 = x0 >= 0.f && x0 <= Wf - 1.f;
        const bool vx1 = x1 >= 0.f && x1 <= Wf - 1.f;
        const bool vy0 = y0 >= 0.f && y0 <= Hf - 1.f;
        const bool vy1 = y1 >= 0.f && y1 <= Hf - 1.f;
        const float wx0 = x1 - ix;
        const float wx1 = ix - x0;
        const float wy0 = y1 - iy;
        const float wy1 = iy - y0;
#define MSDA_CORNER(VX, VY, XC, YC, WX, WY)                                   \
        if (VX && VY) {                                                       \
          const __nv_bfloat16* r = v + ((long long)YC * W + (long long)XC) * dh; \
          const float w = a * (WX * WY);                                      \
          if (has0) acc0 += w * __bfloat162float(r[c0]);                      \
          if (has1) acc1 += w * __bfloat162float(r[c1]);                      \
        }
        MSDA_CORNER(vx0, vy0, x0, y0, wx0, wy0)
        MSDA_CORNER(vx0, vy1, x0, y1, wx0, wy1)
        MSDA_CORNER(vx1, vy0, x1, y0, wx1, wy0)
        MSDA_CORNER(vx1, vy1, x1, y1, wx1, wy1)
#undef MSDA_CORNER
      }
    }
    float* o = out + pt * dh;
    if (has0) o[c0] = acc0;
    if (has1) o[c1] = acc1;
  }
}

extern "C" int msda_colsin(PointLevels lv, void* out, int BH, int P, int nL, int dh,
                           void* stream) {
  const dim3 grid((P + POINTS_PER_BLOCK - 1) / POINTS_PER_BLOCK, BH);
  msda_colsin_kernel<<<grid, WARPS * 32, 0, (cudaStream_t)stream>>>(lv, (float*)out, P,
                                                                      nL, dh);
  return (int)cudaGetLastError();
}
