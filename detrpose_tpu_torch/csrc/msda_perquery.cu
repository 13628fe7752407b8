// Multi-scale deformable attention forward on the per-head layout, sm_90a.
//
// Replaces the TPU kernel detrpose_tpu/ops/pallas/msda.py::_msda_kernel
// (launched by ms_deform_attn_pallas, the opt-in msda_backend="pallas"). That
// kernel holds one (batch, head)'s flattened pyramid in VMEM and runs a
// scalar loop per query over levels x points x 4 corners, reading the
// query's locations and weights as SMEM scalars. This kernel computes the
// same function on the same per-head layout: the plain version it is held
// to is detrpose_tpu_torch/ops/cuda/msda_perquery.py::msda_perquery_plain.
//
// Layout (the JAX wrapper's packing, without its Mosaic padding):
//   value (B, nH, S, dh)             float or bf16, levels concatenated along S
//   loc   (B, nH, Lq, nL*nP*2)       float, normalized (x, y), level-major
//   aw    (B, nH, Lq, nL*nP)         float, softmaxed attention weights
//   out   (B, nH, Lq, dh)            value dtype
//
// What bounds it on an H100: the same as csrc/msda_fwd.cu. At DETRPose-L
// eval shapes one call must read the per-head value map once (138 MB in
// bf16), the locations (27 MB) and weights (13 MB), and write the output
// (18 MB): 0.058 ms at 3.35 TB/s; the gather moves 849 MB of 64-byte head
// rows from L2 to the SMs. The per-head layout costs a transpose of the
// value map before the call, which the wrapper does and which
// csrc/msda_fwd.cu, reading the (B, S, nH*dh) memory directly, avoids.
//
// Design: the threads run over ((b, head, query), channel vector) pairs,
// MSDA_THREADS to a block. A thread owns V consecutive channels of one
// query (V = 8 for bf16 when dh*2 bytes and the map's address are multiples
// of 16), so a query takes dh/V threads and a warp 32*V/dh consecutive
// queries of one head (8 at L), whose outputs are contiguous: one coalesced
// store. Each thread reads its query's points by __ldg and samples them with
// msda::sum_levels from msda_gather.cuh, as kernel #1 does, with the row
// stride dh in place of nH*dh.

#include "msda_gather.cuh"

template <typename T, int V, int NP>
__global__ void __launch_bounds__(MSDA_THREADS, MSDA_MIN_BLOCKS)
msda_perquery_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                     const float* __restrict__ aw, T* __restrict__ out, MsdaLevels lv,
                     int S, int Lq, int nL, int nP, int dh, long long n_threads) {
  const long long t = (long long)blockIdx.x * MSDA_THREADS + threadIdx.x;
  if (t >= n_threads) return;
  const int lanes = dh / V;          // threads per query
  const long long row = t / lanes;   // (b * nH + h) * Lq + q
  const int c = (int)(t - row * lanes) * V;
  const long long bh = row / Lq;
  const long long k = row * nL * nP;  // the query's first point
  float acc[V] = {};
  msda::sum_levels<T, V, NP>(value + bh * S * dh + c, dh, lv, nL, nP, loc + 2 * k, aw + k,
                             acc);
  msda::store<T, V>(out + row * dh + c, acc);
}

template <typename T>
static int launch(const void* value, const void* loc, const void* aw, void* out,
                  MsdaLevels lv, int B, int nH, int S, int Lq, int nL, int nP, int dh,
                  int vec, int blocks, void* stream) {
  const long long n_threads = (long long)B * nH * Lq * (dh / vec);
  return msda::dispatch<T>(vec, nP, [&](auto v, auto np) {
    msda_perquery_kernel<T, decltype(v)::value, decltype(np)::value>
        <<<blocks, MSDA_THREADS, 0, (cudaStream_t)stream>>>(
            (const T*)value, (const float*)loc, (const float*)aw, (T*)out, lv, S, Lq, nL,
            nP, dh, n_threads);
    return (int)cudaGetLastError();
  });
}

extern "C" int msda_perquery_f32(const void* value, const void* loc, const void* aw,
                                 void* out, MsdaLevels lv, int B, int nH, int S,
                                 int Lq, int nL, int nP, int dh, int vec, int blocks,
                                 void* stream) {
  return launch<float>(value, loc, aw, out, lv, B, nH, S, Lq, nL, nP, dh, vec, blocks,
                       stream);
}

extern "C" int msda_perquery_bf16(const void* value, const void* loc, const void* aw,
                                  void* out, MsdaLevels lv, int B, int nH, int S,
                                  int Lq, int nL, int nP, int dh, int vec, int blocks,
                                  void* stream) {
  return launch<__nv_bfloat16>(value, loc, aw, out, lv, B, nH, S, Lq, nL, nP, dh, vec,
                               blocks, stream);
}
