// MSDA per sampling point on transposed value maps, points on lanes, sm_90a.
//
// Replaces the TPU kernel tools_local_msda_v2.py::build_tpose (kernel :152,
// pallas_call :199; "tpose_ck" is the same site with the column loop cut
// into chunks of 16 to cap VMEM). That kernel is the separable MSDA kernel in
// transposed layout: points on the 128 lanes, channels on sublanes,
// T^T = V^T . R^T per level, the column hat built once at (W, TP) and
// broadcast along sublanes, a sublane fold over the W column groups. As for
// csrc/msda_colsin.cu, the separable form is a TPU answer to its gather
// rate; this kernel computes the same per-point function by direct taps
// (four corners at floor and floor+1, a corner outside the map dropped,
// float32 weights where the TPU rounds R to bf16) on the TPU kernel's input
// and output layout. Held to detrpose_tpu_torch/ops/cuda/msda_tpose.py::
// msda_tpose_plain.
//
// Layout:
//   per level l:  ix, iy, a  (B*nH, P) float, pixel coordinates x*W-0.5, y*H-0.5
//                 v          (B*nH, W*dh, H) bf16: row x*dh + d holds channel d
//                            of column x over y, so the two y-taps of one
//                            (x, channel) lie next to each other
//   out           (B*nH, dh, P) float: one sample per point, summed over
//                 levels, not over the nP points of a query
//
// Design, the GPU reading of "points on lanes": one thread per point. The
// thread computes its four corners per level once, as element offsets into
// V^T at channel 0 with the validity folded into a zero weight (and the
// offset clamped into the map), then loops over the channels: per channel
// 4*nL two-byte loads, the y-pairs adjacent, and one float store. The stores
// out[d, p] are coalesced across the warp. The loads are not: neighbouring
// lanes hold unrelated points, so each load is its own 32-byte sector, where
// the channels-on-lanes kernels (csrc/msda_fwd.cu, msda_perquery.cu,
// msda_colsin.cu) read a corner's dh channels as one 64-byte segment.
//
// What bounds it on an H100: bytes, as csrc/msda_colsin.cu (the same values,
// points and output bytes: 0.095 ms at 3.35 TB/s at the DETRPose-L eval
// shapes). The sector traffic of the scattered two-byte loads, up to 16x the
// useful bytes through L2, is what this layout costs on a GPU.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#define MSDA_MAX_LEVELS 4
#define THREADS 128

struct PointLevels {
  const float* ix[MSDA_MAX_LEVELS];
  const float* iy[MSDA_MAX_LEVELS];
  const float* a[MSDA_MAX_LEVELS];
  const __nv_bfloat16* v[MSDA_MAX_LEVELS];
  int h[MSDA_MAX_LEVELS];
  int w[MSDA_MAX_LEVELS];
};

__global__ void __launch_bounds__(THREADS)
msda_tpose_kernel(PointLevels lv, float* __restrict__ out, int P, int nL, int dh) {
  const int p = (int)blockIdx.x * THREADS + threadIdx.x;
  if (p >= P) return;
  const long long bh = blockIdx.y;
  const long long pt = bh * P + p;

  const __nv_bfloat16* base[MSDA_MAX_LEVELS];
  int off[MSDA_MAX_LEVELS][4];
  float wt[MSDA_MAX_LEVELS][4];
  int stride[MSDA_MAX_LEVELS];  // elements between two channels of one (x, y)
#pragma unroll
  for (int l = 0; l < MSDA_MAX_LEVELS; ++l) {
    base[l] = lv.v[0];
    stride[l] = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      off[l][k] = 0;
      wt[l][k] = 0.f;
    }
    if (l < nL) {
      const int H = lv.h[l];
      const int W = lv.w[l];
      const float Hf = (float)H;
      const float Wf = (float)W;
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
      // in-map coordinates for the loads; fmaxf maps NaN to 0
      const int xi0 = (int)fminf(fmaxf(x0, 0.f), Wf - 1.f);
      const int xi1 = (int)fminf(fmaxf(x1, 0.f), Wf - 1.f);
      const int yi0 = (int)fminf(fmaxf(y0, 0.f), Hf - 1.f);
      const int yi1 = (int)fminf(fmaxf(y1, 0.f), Hf - 1.f);
      base[l] = lv.v[l] + bh * W * dh * H;
      stride[l] = H;
      // element (x*dh + d, y) of V^T lies at (x*dh + d)*H + y
      off[l][0] = xi0 * dh * H + yi0;
      off[l][1] = xi0 * dh * H + yi1;
      off[l][2] = xi1 * dh * H + yi0;
      off[l][3] = xi1 * dh * H + yi1;
      wt[l][0] = (vx0 && vy0) ? a * ((x1 - ix) * (y1 - iy)) : 0.f;
      wt[l][1] = (vx0 && vy1) ? a * ((x1 - ix) * (iy - y0)) : 0.f;
      wt[l][2] = (vx1 && vy0) ? a * ((ix - x0) * (y1 - iy)) : 0.f;
      wt[l][3] = (vx1 && vy1) ? a * ((ix - x0) * (iy - y0)) : 0.f;
    }
  }

  float* o = out + bh * dh * P + p;
  for (int d = 0; d < dh; ++d) {
    float acc = 0.f;
#pragma unroll
    for (int l = 0; l < MSDA_MAX_LEVELS; ++l) {
      if (l < nL) {
        const __nv_bfloat16* r = base[l] + (long long)d * stride[l];
#pragma unroll
        for (int k = 0; k < 4; ++k) acc += wt[l][k] * __bfloat162float(r[off[l][k]]);
      }
    }
    o[(long long)d * P] = acc;
  }
}

extern "C" int msda_tpose(PointLevels lv, void* out, int BH, int P, int nL, int dh,
                          void* stream) {
  const dim3 grid((P + THREADS - 1) / THREADS, BH);
  msda_tpose_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(lv, (float*)out, P, nL,
                                                                dh);
  return (int)cudaGetLastError();
}
