// Multi-scale deformable attention forward, one warp per query, sm_90a.
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
// Design: a block covers one (b, head) and QUERIES_PER_BLOCK queries, one
// warp per query; the ragged last tile is masked by whole warps. Lane i
// holds location scalars i and i+32 and weight scalar i of its query and
// hands them out with __shfl_sync, the counterpart of the TPU's SMEM
// scalars. Lanes run over the head's channels: lane c owns channels c and
// c+32, so dh up to 64 (dh 48: lanes 0-15 take a second channel). Each
// corner is zeroed on its own when it lies outside the map (grid_sample zeros
// padding, align_corners=False: ix = x*W - 0.5), tested in float so that NaN
// or far-out points give exactly 0. Sums are kept in float and stored once.
//
// What bounds it on an H100: bytes, as for csrc/msda_fwd.cu. At DETRPose-L
// eval shapes (B 32, Lq 1080, levels 80/40/20, nH 8, dh 32, nP 4) one call
// must read the per-head value map once (138 MB in bf16), the locations
// (27 MB) and weights (13 MB), and write the output (18 MB): 0.06 ms at
// 3.35 TB/s. Each corner read is one dh-wide row (64 bytes for bf16 dh 32)
// read by one warp, so the gather's L2 request rate, not DRAM, is what this
// simple form spends its time on. The per-head layout costs a transpose of
// the value map before the call, which the wrapper does and which
// csrc/msda_fwd.cu, reading the (B, S, nH*dh) memory directly, avoids.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#define MSDA_MAX_LEVELS 4
#define QUERIES_PER_BLOCK 8
#define FULL_MASK 0xffffffffu

struct MsdaLevels {
  int h[MSDA_MAX_LEVELS];
  int w[MSDA_MAX_LEVELS];
  int start[MSDA_MAX_LEVELS];
};

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(QUERIES_PER_BLOCK * 32)
msda_perquery_kernel(const T* __restrict__ value,
                     const float* __restrict__ loc,
                     const float* __restrict__ aw,
                     T* __restrict__ out,
                     MsdaLevels lv, int S, int Lq, int nL, int nP, int dh) {
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * QUERIES_PER_BLOCK + (threadIdx.x >> 5);
  if (q >= Lq) return;  // q is the same for the whole warp
  const long long bh = (long long)blockIdx.z * gridDim.y + blockIdx.y;  // b*nH + h
  const long long row = bh * Lq + q;
  const int n_pts = nL * nP;  // at most 32, checked by the wrapper

  const float* loc_q = loc + row * 2 * n_pts;
  const float* aw_q = aw + row * n_pts;
  const float loc_lo = lane < 2 * n_pts ? loc_q[lane] : 0.f;
  const float loc_hi = lane + 32 < 2 * n_pts ? loc_q[lane + 32] : 0.f;
  const float aw_me = lane < n_pts ? aw_q[lane] : 0.f;

  const T* v_bh = value + bh * (long long)S * dh;
  const int c0 = lane;
  const int c1 = lane + 32;
  const bool has0 = c0 < dh;
  const bool has1 = c1 < dh;
  float acc0 = 0.f;
  float acc1 = 0.f;

  for (int l = 0; l < nL; ++l) {
    const int H = lv.h[l];
    const int W = lv.w[l];
    const float Hf = (float)H;
    const float Wf = (float)W;
    const T* v_l = v_bh + (long long)lv.start[l] * dh;
    for (int p = 0; p < nP; ++p) {
      const int k = l * nP + p;  // warp-uniform, so the source choice is too
      const int kx = 2 * k;
      const int ky = 2 * k + 1;
      const float x = __shfl_sync(FULL_MASK, kx < 32 ? loc_lo : loc_hi, kx & 31);
      const float y = __shfl_sync(FULL_MASK, ky < 32 ? loc_lo : loc_hi, ky & 31);
      const float a = __shfl_sync(FULL_MASK, aw_me, k);
      const float ix = x * Wf - 0.5f;
      const float iy = y * Hf - 0.5f;
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
      if (VX && VY) {                                                         \
        const T* r = v_l + ((long long)YC * W + (long long)XC) * dh;          \
        const float w = a * (WX * WY);                                        \
        if (has0) acc0 += w * load_f32(r + c0);                               \
        if (has1) acc1 += w * load_f32(r + c1);                               \
      }
      MSDA_CORNER(vx0, vy0, x0, y0, wx0, wy0)
      MSDA_CORNER(vx0, vy1, x0, y1, wx0, wy1)
      MSDA_CORNER(vx1, vy0, x1, y0, wx1, wy0)
      MSDA_CORNER(vx1, vy1, x1, y1, wx1, wy1)
#undef MSDA_CORNER
    }
  }
  T* o = out + row * dh;
  if (has0) store_from_f32(o + c0, acc0);
  if (has1) store_from_f32(o + c1, acc1);
}

template <typename T>
static int launch(const void* value, const void* loc, const void* aw, void* out,
                  MsdaLevels lv, int B, int nH, int S, int Lq, int nL, int nP,
                  int dh, void* stream) {
  const dim3 grid((Lq + QUERIES_PER_BLOCK - 1) / QUERIES_PER_BLOCK, nH, B);
  msda_perquery_kernel<T><<<grid, QUERIES_PER_BLOCK * 32, 0, (cudaStream_t)stream>>>(
      (const T*)value, (const float*)loc, (const float*)aw, (T*)out, lv, S, Lq,
      nL, nP, dh);
  return (int)cudaGetLastError();
}

extern "C" int msda_perquery_f32(const void* value, const void* loc, const void* aw,
                                 void* out, MsdaLevels lv, int B, int nH, int S,
                                 int Lq, int nL, int nP, int dh, void* stream) {
  return launch<float>(value, loc, aw, out, lv, B, nH, S, Lq, nL, nP, dh, stream);
}

extern "C" int msda_perquery_bf16(const void* value, const void* loc, const void* aw,
                                  void* out, MsdaLevels lv, int B, int nH, int S,
                                  int Lq, int nL, int nP, int dh, void* stream) {
  return launch<__nv_bfloat16>(value, loc, aw, out, lv, B, nH, S, Lq, nL, nP, dh,
                               stream);
}
