// Multi-scale deformable attention forward, direct 4-corner gather, sm_90a.
//
// Replaces the TPU kernel detrpose_tpu/ops/pallas/msda_sep.py::_kernel
// (launched by ms_deform_attn_sep, wrapped by ms_deform_attn_fast). That
// kernel evaluates bilinear sampling as separable "hat" weights times a
// matmul over the value map, because TPU gathers are bound by descriptor
// rate. A GPU gathers well, so this is the plain gather form: the same
// function as detrpose_tpu_torch/ops/ms_deform_attn.py::ms_deform_attn_core,
// which it is held to.
//
// Layout:
//   value (B, S, nH*dh)             float or bf16, levels concatenated along S
//   loc   (B, Lq, nH, nL, nP, 2)    float, normalized (x, y)
//   aw    (B, Lq, nH, nL, nP)       float, softmaxed attention weights
//   out   (B, Lq, nH*dh)            value dtype
//
// What bounds it on an H100. DRAM bytes: at DETRPose-L eval shapes (B 32,
// Lq 1080, levels 80/40/20, nH 8, dh 32, nP 4, bf16) one call must read the
// value map once (138 MB), the locations (27 MB) and weights (13 MB) and
// write the output (18 MB), 0.058 ms at 3.35 TB/s; the arithmetic is far
// below the float32 peak. The gather itself moves more: 3.3 M samples x 4
// corners x one 64-byte head row = 849 MB from L2 to the SMs. One image's
// map (4.3 MB) stays in the 50 MB L2 while its queries run, so without
// reuse in L1 the call ends near that traffic at the L2's rate.
//
// Design: the threads run over (query, channel vector) pairs, MSDA_THREADS
// to a block. A thread owns V consecutive channels of one head (V = 8 for
// bf16 when dh*2 bytes and the map's address are multiples of 16), so a
// query takes nH*dh/V threads: one warp at L, whose 512-byte output row is
// one coalesced store. Each thread reads its head's points by __ldg (the
// dh/V threads of a head read the same words) and samples them with
// msda::sum_levels from msda_gather.cuh: one 16-byte load per corner, all
// corners of a level in flight together, no branch at the corners. So a
// warp-wide load moves 512 bytes, and the coordinate arithmetic runs once
// per V channels.

#include "msda_gather.cuh"

template <typename T, int V, int NP>
__global__ void __launch_bounds__(MSDA_THREADS, MSDA_MIN_BLOCKS)
msda_fwd_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                const float* __restrict__ aw, T* __restrict__ out, MsdaLevels lv,
                int S, int Lq, int nH, int nL, int nP, int dh, long long n_threads) {
  const long long t = (long long)blockIdx.x * MSDA_THREADS + threadIdx.x;
  if (t >= n_threads) return;
  const int C = nH * dh;
  const int lanes = C / V;           // threads per query
  const long long bq = t / lanes;    // b * Lq + q
  const int c = (int)(t - bq * lanes) * V;
  const int h = c / dh;
  const long long b = bq / Lq;
  const long long k = (bq * nH + h) * nL * nP;  // the head's first point
  float acc[V] = {};
  msda::sum_levels<T, V, NP>(value + b * S * C + c, C, lv, nL, nP, loc + 2 * k, aw + k,
                             acc);
  msda::store<T, V>(out + bq * C + c, acc);
}

template <typename T>
static int launch(const void* value, const void* loc, const void* aw, void* out,
                  MsdaLevels lv, int B, int S, int Lq, int nH, int nL, int nP, int dh,
                  int vec, int blocks, void* stream) {
  const long long n_threads = (long long)B * Lq * (nH * dh / vec);
  return msda::dispatch<T>(vec, nP, [&](auto v, auto np) {
    msda_fwd_kernel<T, decltype(v)::value, decltype(np)::value>
        <<<blocks, MSDA_THREADS, 0, (cudaStream_t)stream>>>(
            (const T*)value, (const float*)loc, (const float*)aw, (T*)out, lv, S, Lq, nH,
            nL, nP, dh, n_threads);
    return (int)cudaGetLastError();
  });
}

extern "C" int msda_fwd_f32(const void* value, const void* loc, const void* aw,
                            void* out, MsdaLevels lv, int B, int S, int Lq,
                            int nH, int nL, int nP, int dh, int vec, int blocks,
                            void* stream) {
  return launch<float>(value, loc, aw, out, lv, B, S, Lq, nH, nL, nP, dh, vec, blocks,
                       stream);
}

extern "C" int msda_fwd_bf16(const void* value, const void* loc, const void* aw,
                             void* out, MsdaLevels lv, int B, int S, int Lq,
                             int nH, int nL, int nP, int dh, int vec, int blocks,
                             void* stream) {
  return launch<__nv_bfloat16>(value, loc, aw, out, lv, B, S, Lq, nH, nL, nP, dh, vec,
                               blocks, stream);
}
