// MSDA per sampling point on x-minor value rows, on the taps of
// msda_gather.cuh, sm_90a.
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
// floor and floor+1, a corner outside the map weighted 0, weights in float32
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
// Design, that of kernel #5's `full` mode (csrc/msda_ablate.cu) with its own
// library and entry point. A block takes `tile` points of one (image, head)
// (a launch argument, the counterpart of TP). A thread owns V consecutive
// channels of one point: V = 8, so a corner is one 16-byte load (8-, 4- or
// 2-byte where dh or a level's address rules 16 out;
// ops/cuda/msda.py::point_plan takes the widest that every level allows).
// dh/V threads share a point (4 at dh 32, so a warp holds 8 points), and the
// threads of a warp write whole contiguous output rows, each as V/4 16-byte
// stores. The point scalars are read by __ldg, the threads of a point
// reading the same words. Per level gather_px issues the four corner loads
// before the first is used, with no branch: corners are clamped into the map
// in float and their weights selected, so a corner off the map, or of a NaN
// or +-1e30 coordinate, adds exactly 0. The level loop is unrolled to
// MSDA_MAX_LEVELS, so the level table is read with constant indices and
// needs no stack frame.
//
// What bounds it on an H100: bytes. At DETRPose-L eval shapes (B 32, nH 8,
// P = 1080*4 = 4320, levels 80/40/20, dh 32) one call must read the values
// once (137.6 MB), the points (39.8 MB) and write the per-point output
// (141.6 MB): 0.095 ms at 3.35 TB/s. Beyond those it moves 849.3 MB of
// 64-byte corner rows through L2, as kernels #1 and #5 `full` do.

#include "msda_gather.cuh"

template <int V>
__global__ void __launch_bounds__(MSDA_THREADS, MSDA_MIN_BLOCKS)
msda_colsin_kernel(PointLevels lv, float* __restrict__ out, int P, int nL, int dh, int tile) {
  using T = __nv_bfloat16;
  const int lanes = dh / V;  // threads per point
  const int slots = MSDA_THREADS / lanes;
  const int slot = threadIdx.x / lanes;
  if (slot >= slots) return;  // past the block's last whole point
  const int c = (threadIdx.x - slot * lanes) * V;
  const long long bh = blockIdx.y;
  const int p_end = min(P, ((int)blockIdx.x + 1) * tile);
  for (int p = (int)blockIdx.x * tile + slot; p < p_end; p += slots) {
    const long long pt = bh * P + p;
    float acc[V] = {};
#pragma unroll
    for (int l = 0; l < MSDA_MAX_LEVELS; ++l) {
      if (l < nL) {
        const int H = lv.h[l];
        const int W = lv.w[l];
        msda::gather_px<T, V>(lv.v[l] + bh * H * W * dh + c, H, W, dh, __ldg(lv.ix[l] + pt),
                              __ldg(lv.iy[l] + pt), __ldg(lv.a[l] + pt), acc);
      }
    }
    msda::store_f32<V>(out + pt * dh + c, acc);
  }
}

// The entry point: the point table, out, B*nH, P, nL, dh, the tile, the
// channels per thread, the stream; it returns cudaGetLastError().
extern "C" int msda_colsin(PointLevels lv, void* out, int BH, int P, int nL, int dh, int tile,
                           int vec, void* stream) {
  const dim3 grid((P + tile - 1) / tile, BH);
  return msda::dispatch_vec<__nv_bfloat16>(vec, [&](auto v) {
    msda_colsin_kernel<decltype(v)::value>
        <<<grid, MSDA_THREADS, 0, (cudaStream_t)stream>>>(lv, (float*)out, P, nL, dh, tile);
    return (int)cudaGetLastError();
  });
}
