// Backward of kernel #1's op for the sampling locations and attention
// weights, sm_90a.
//
// Replaces no TPU kernel: the TPU kernel (detrpose_tpu/ops/pallas/
// msda_sep.py::_kernel) has no backward, and JAX's custom_vjp
// (_fast_bwd) differentiates its XLA gather path. It was added for the
// gradient that energy refinement takes in serving: the gradient of the
// energy layer's MSDA with respect to its locations and weights, the value
// map needing none (it comes from the encoder under torch.no_grad()). The
// plain version recomputes the 4-corner gather of
// detrpose_tpu_torch/ops/ms_deform_attn.py::bilinear_sample_px and
// differentiates it by autograd: some 500 launches a call, each
// intermediate a float32 tensor of (B*nH, Lq*nP, dh).
//
// What it computes, for each (image, query, head, level, point), with
// ix = x*W - 0.5, iy = y*H - 0.5, (x0, y0) their floors held constant,
// each corner c weighed by its hat product w_c and zeroed on its own off
// the map, and G_c = sum over the head's channels of grad_out * corner row:
//   grad_aw       = sum_c w_c * G_c
//   grad_loc.x    = W * a * ((y1-iy) (G_(x1,y0) - G_(x0,y0)) + (iy-y0) (G_(x1,y1) - G_(x0,y1)))
//   grad_loc.y    = H * a * ((x1-ix) (G_(x0,y1) - G_(x0,y0)) + (ix-x0) (G_(x1,y1) - G_(x1,y0)))
// which is what autograd gives through the plain version, a NaN location's
// NaNs included (a corner off the map multiplies its terms by 0.f, as the
// plain version's mask does). No value gradient is written.
//
// Layout:
//   value    (B, S, nH*dh)             float or bf16, levels concatenated along S
//   loc      (B, Lq, nH, nL, nP, 2)    float, normalized (x, y)
//   aw       (B, Lq, nH, nL, nP)       float
//   grad_out (B, Lq, nH*dh)            value dtype
//   grad_loc (B, Lq, nH, nL, nP, 2)    float, written
//   grad_aw  (B, Lq, nH, nL, nP)       float, written
//
// What bounds it on an H100. DRAM bytes: at DETRPose-L eval shapes (B 32,
// Lq 1080, levels 80/40/20, nH 8, dh 32, nP 4, bf16) the value map and the
// output's gradient in bf16, the locations and weights and their gradients
// in float32, each once: 234.95 MB, 0.0701 ms at 3.35 TB/s
// (h100_bench/bounds_msda_bwd.py). Its 24 float32 operations per tap and
// channel take 0.038 ms at 67 TFLOP/s. Like the forward it must also fetch
// every tap's 4 corner rows of one head, the forward's 849 MB from L2 to
// the SMs (csrc/msda_fwd.cu), so it ends near the forward's time and not
// near the DRAM bound.
//
// Design: kernel #1's forward with the channel sum turned around. The
// threads run over (query, head, channel vector); a thread owns V
// consecutive channels of one head (V = 8 for bf16 on the 16-byte path), a
// head's threads are `lanes` consecutive lanes of one warp (the head's
// dh/V rounded up to a power of two, at most 32; idle lanes take no
// channels): 4 lanes to a head and one warp to a query at L. A thread loads
// its V channels of grad_out once, then takes a level's points two at a
// time: it fetches the 4 corner rows of each with the 16-byte loads of
// msda_gather.cuh (corner_rows_px, the forward's fetch), all 8 in flight
// before the first is used, and forms each tap's three partial sums
// (weight, x, y) over its channels. (The forward keeps a level's 4 points
// in flight; here, beside the sums and grad_out, their 64 registers of rows
// spill under the 128 a thread has at two blocks an SM, and one backward
// at the energy cell's shapes took 0.240 ms against 0.208 in pairs, H100.) The head's lanes add them up with
// __shfl_xor_sync, and one lane (a tap's index modulo lanes, so the stores
// of a level spread over the lanes) writes the tap's 12 bytes. Each tap has
// one owner: no atomics, and the result does not depend on the run. A head
// wider than 32 lanes takes its channels in chunks of 32 * V, which every
// lane walks in turn. The pixel coordinates are formed without contraction
// (__fmul_rn, __fsub_rn) as the plain version forms them, so a point close
// to a pixel edge takes the same corners: the gradient jumps there.

#include "msda_gather.cuh"

// f[i] = the i-th value of r, in float
template <typename T, int V>
__device__ __forceinline__ void unpack(const typename msda::Vec<T, V>::Raw& r, float (&f)[V]) {
  if constexpr (std::is_same_v<T, float>) {
    const float* p = reinterpret_cast<const float*>(&r);
#pragma unroll
    for (int i = 0; i < V; ++i) f[i] = p[i];
  } else if constexpr (V == 1) {
    f[0] = __uint_as_float((unsigned int)r << 16);
  } else {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < V / 2; ++i) {
      const float2 x = __bfloat1622float2(h[i]);
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
  }
}

// sum over i of g[i] * (the i-th value of r)
template <typename T, int V>
__device__ __forceinline__ float dot_row(const typename msda::Vec<T, V>::Raw& r,
                                         const float (&g)[V]) {
  float f[V];
  unpack<T, V>(r, f);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) s = fmaf(g[i], f[i], s);
  return s;
}

// A thread's partial sums over its channels for G points of one level at
// pixel coordinates (ix, iy): s[g] = (weight, x, y) as in the note above,
// before the factor a and the level's scale. `level` and `go_row` point at
// the head's channel 0 in the level's first pixel and in grad_out; the
// thread's channels are c0 + j * step for j < chunks, those at dh or past
// it taking none; go0 holds chunk 0's grad_out.
template <typename T, int V, int G>
__device__ __forceinline__ void tap_sums(const T* __restrict__ level, int H, int W, int stride,
                                         const T* __restrict__ go_row, const float (&go0)[V],
                                         int c0, int step, int chunks, int dh,
                                         const float (&ix)[G], const float (&iy)[G],
                                         float (&s)[G][3]) {
  float x0[G], y0[G], dot[G][4] = {};
  bool in[G][4];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    x0[g] = floorf(ix[g]);
    y0[g] = floorf(iy[g]);
  }
  // the corner rows of channels cc, all loads in flight before the first
  // is used, dotted with those channels of grad_out
  auto fetch = [&](int cc, const float (&go)[V]) {
    typename msda::Vec<T, V>::Raw r[G][4];
#pragma unroll
    for (int g = 0; g < G; ++g)
      msda::corner_rows_px<T, V>(level + cc, H, W, stride, x0[g], y0[g], r[g], in[g]);
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int k = 0; k < 4; ++k) dot[g][k] += dot_row<T, V>(r[g][k], go);
    }
  };
  fetch(c0 < dh ? c0 : 0, go0);
  for (int j = 1; j < chunks; ++j) {
    const int c = c0 + j * step;
    const int cc = c < dh ? c : 0;       // a lane past the head reads channel 0 ...
    float go[V];
    unpack<T, V>(msda::load<T, V>(go_row + cc), go);
#pragma unroll
    for (int i = 0; i < V; ++i) go[i] = c < dh ? go[i] : 0.f;   // ... and weighs it 0
    fetch(cc, go);
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float fx0 = (x0[g] + 1.f) - ix[g];
    const float fx1 = ix[g] - x0[g];
    const float fy0 = (y0[g] + 1.f) - iy[g];
    const float fy1 = iy[g] - y0[g];
    float m[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) m[k] = dot[g][k] * (in[g][k] ? 1.f : 0.f);
    s[g][0] = (fx0 * fy0) * m[0] + (fx0 * fy1) * m[1] + (fx1 * fy0) * m[2] + (fx1 * fy1) * m[3];
    s[g][1] = fy0 * (m[2] - m[0]) + fy1 * (m[3] - m[1]);
    s[g][2] = fx0 * (m[1] - m[0]) + fx1 * (m[3] - m[2]);
  }
}

// Adds s up over the head's lanes (every lane ends with the sums) and lets
// lane k % lanes write tap k: its location's gradient (W, H scaled) and
// its weight's.
__device__ __forceinline__ void write_tap(float (&s)[3], float a, float Wf, float Hf, int k,
                                          int lane, int lanes, unsigned int mask,
                                          float* __restrict__ grad_loc,
                                          float* __restrict__ grad_aw) {
  for (int o = lanes >> 1; o > 0; o >>= 1) {
#pragma unroll
    for (int i = 0; i < 3; ++i) s[i] += __shfl_xor_sync(mask, s[i], o);
  }
  if (lane == (k & (lanes - 1))) {
    *reinterpret_cast<float2*>(grad_loc + 2 * k) = make_float2(Wf * (a * s[1]), Hf * (a * s[2]));
    grad_aw[k] = s[0];
  }
}

// ix = x*W - 0.5 rounded twice, as the plain version computes it
__device__ __forceinline__ float pixel(float x, float size) {
  return __fsub_rn(__fmul_rn(x, size), 0.5f);
}

template <typename T, int V, int NP>
__global__ void __launch_bounds__(MSDA_THREADS, MSDA_MIN_BLOCKS)
msda_bwd_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                const float* __restrict__ aw, const T* __restrict__ grad_out,
                float* __restrict__ grad_loc, float* __restrict__ grad_aw, MsdaLevels lv,
                int S, int Lq, int nH, int nL, int nP, int dh, int lanes, int chunks,
                long long n_threads) {
  constexpr int G = 2;   // points whose corner rows are in flight together
  const long long t = (long long)blockIdx.x * MSDA_THREADS + threadIdx.x;
  // n_threads is a multiple of lanes, which divides 32: a head's lanes lie
  // in one warp and leave together
  if (t >= n_threads) return;
  const long long head = t / lanes;   // (b * Lq + q) * nH + h
  const int lane = (int)(t - head * lanes);
  const long long bq = head / nH;
  const int h = (int)(head - bq * nH);
  const long long b = bq / Lq;
  const int C = nH * dh;
  const unsigned int mask =
      lanes == 32 ? 0xffffffffu
                  : ((1u << lanes) - 1u) << ((threadIdx.x & 31) & ~(unsigned int)(lanes - 1));
  const int c0 = lane * V;
  const T* go_row = grad_out + bq * C + h * dh;
  float go0[V];
  unpack<T, V>(msda::load<T, V>(go_row + (c0 < dh ? c0 : 0)), go0);
#pragma unroll
  for (int i = 0; i < V; ++i) go0[i] = c0 < dh ? go0[i] : 0.f;
  const T* base = value + b * S * C + h * dh;
  const long long k0 = head * nL * nP;   // the head's first tap
  const float* hl = loc + 2 * k0;
  const float* ha = aw + k0;
  float* gl = grad_loc + 2 * k0;
  float* ga = grad_aw + k0;
#pragma unroll
  for (int l = 0; l < MSDA_MAX_LEVELS; ++l) {
    if (l < nL) {
      const T* level = base + (size_t)lv.start[l] * C;
      const float Wf = (float)lv.w[l];
      const float Hf = (float)lv.h[l];
      if constexpr (NP > 0) {
#pragma unroll
        for (int p0 = 0; p0 < NP; p0 += G) {
          float ix[G], iy[G], a[G], s[G][3];
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const int k = l * NP + p0 + g;
            ix[g] = pixel(__ldg(hl + 2 * k), Wf);
            iy[g] = pixel(__ldg(hl + 2 * k + 1), Hf);
            a[g] = __ldg(ha + k);
          }
          tap_sums<T, V, G>(level, lv.h[l], lv.w[l], C, go_row, go0, c0, lanes * V, chunks,
                            dh, ix, iy, s);
#pragma unroll
          for (int g = 0; g < G; ++g)
            write_tap(s[g], a[g], Wf, Hf, l * NP + p0 + g, lane, lanes, mask, gl, ga);
        }
      } else {
        // points in pairs, the last pair of an odd count repeating its
        // point, whose second copy is not written
#pragma unroll 1
        for (int p = 0; p < nP; p += 2) {
          float ix[2], iy[2], a[2], s[2][3];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int k = l * nP + min(p + j, nP - 1);
            ix[j] = pixel(__ldg(hl + 2 * k), Wf);
            iy[j] = pixel(__ldg(hl + 2 * k + 1), Hf);
            a[j] = __ldg(ha + k);
          }
          tap_sums<T, V, 2>(level, lv.h[l], lv.w[l], C, go_row, go0, c0, lanes * V, chunks,
                            dh, ix, iy, s);
          write_tap(s[0], a[0], Wf, Hf, l * nP + p, lane, lanes, mask, gl, ga);
          if (p + 1 < nP)   // uniform across the head: its shuffles stay together
            write_tap(s[1], a[1], Wf, Hf, l * nP + p + 1, lane, lanes, mask, gl, ga);
        }
      }
    }
  }
}

template <typename T>
static int launch(const void* value, const void* loc, const void* aw, const void* grad_out,
           void* grad_loc, void* grad_aw, MsdaLevels lv, int B, int S, int Lq, int nH, int nL,
           int nP, int dh, int vec, int lanes, int blocks, void* stream) {
  const long long n_threads = (long long)B * Lq * nH * lanes;
  const int chunks = (dh + lanes * vec - 1) / (lanes * vec);
  return msda::dispatch<T>(vec, nP, [&](auto v, auto np) {
    msda_bwd_kernel<T, decltype(v)::value, decltype(np)::value>
        <<<blocks, MSDA_THREADS, 0, (cudaStream_t)stream>>>(
            (const T*)value, (const float*)loc, (const float*)aw, (const T*)grad_out,
            (float*)grad_loc, (float*)grad_aw, lv, S, Lq, nH, nL, nP, dh, lanes, chunks,
            n_threads);
    return (int)cudaGetLastError();
  });
}

extern "C" int msda_bwd_f32(const void* value, const void* loc, const void* aw,
                            const void* grad_out, void* grad_loc, void* grad_aw, MsdaLevels lv,
                            int B, int S, int Lq, int nH, int nL, int nP, int dh, int vec,
                            int lanes, int blocks, void* stream) {
  return launch<float>(value, loc, aw, grad_out, grad_loc, grad_aw, lv, B, S, Lq, nH, nL, nP,
                       dh, vec, lanes, blocks, stream);
}

extern "C" int msda_bwd_bf16(const void* value, const void* loc, const void* aw,
                             const void* grad_out, void* grad_loc, void* grad_aw, MsdaLevels lv,
                             int B, int S, int Lq, int nH, int nL, int nP, int dh, int vec,
                             int lanes, int blocks, void* stream) {
  return launch<__nv_bfloat16>(value, loc, aw, grad_out, grad_loc, grad_aw, lv, B, S, Lq, nH,
                               nL, nP, dh, vec, lanes, blocks, stream);
}
