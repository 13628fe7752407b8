// MSDA per sampling point on transposed value maps, from shared memory
// filled by bulk asynchronous copies, sm_90a.
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
// What bounds it on an H100: bytes, as csrc/msda_colsin.cu (the same values,
// points and output: 0.095 ms at 3.35 TB/s at the DETRPose-L eval shapes).
// The layout is what costs: a corner's dh channels lie H elements apart, so
// no wide load reaches more than the y pair of one channel, and reading the
// taps from device memory moves a 32-byte sector per 2-byte tap.
//
// Design: the taps come from shared memory, every one from the block's own.
// One (image, head) is split by channels into `groups` blocks
// (ops/cuda/msda.py::tpose_plan: the fewest groups, a divisor of dh, whose
// maps fit the shared memory of a block when two share an SM; 8 groups of 4
// channels, 67.2 KB, at L). A group's channels of one column are one run of
// chans*H values of V^T, so block g holds, per level, W runs, each filled by
// one bulk asynchronous copy (cp.async.bulk, completion on an mbarrier)
// where its address and size are multiples of 16, else by the block's
// threads. So device memory reads each value once per call. Every block of a
// group takes every point of its (image, head), one point per thread; lanes
// stay on points, so a warp's out[d, p] stores are one 128-byte row. A
// thread computes its corners and selected weights once per level (indices
// clamped in float, weights 0 off the map, so NaN and huge points give
// exactly 0), then reads 4*nL taps per channel of its group. The blocks of a
// group need nothing of each other, so there is no cluster: a first form
// that split the maps by columns across a cluster read three taps in four
// from another block's shared memory, at 8-11x a local tap (PERF.md).
//
// Where one channel's maps do not fit a block (a pyramid of more than ~57 K
// pixels, about 1670 px at strides 8/16/32), the plan takes no shared memory
// and the same loop reads its taps from device memory, one block per range
// of points.

#include "msda_gather.cuh"

#define TPOSE_THREADS 512  // TPOSE_THREADS in ops/cuda/msda.py

// ops/cuda/msda_tpose.py::_TposePlan; ops/cuda/msda.py::tpose_plan makes it
struct TposePlan {
  int groups;                   // blocks per (image, head), one per channel group
  int chans;                    // channels of a group (blockIdx.y)
  int staged;                   // taps from shared memory, else from device memory
  int threads;                  // per block
  int blocks;                   // blocks along the points (1 when staged)
  int smem;                     // dynamic shared memory per block, bytes
  int bulk;                     // bit l: level l's runs are bulk copies
  int offset[MSDA_MAX_LEVELS];  // byte offset of a level's maps in shared memory
};

// This block's channels of every level into shared memory: column x's run
// of `chans` rows at offset[l] + x * chans * H * 2, its rows H values each.
template <int NL>
__device__ __forceinline__ void fill(const PointLevels& lv, int dh, long long bh, int c0,
                                     const TposePlan& plan, unsigned char* smem) {
  const unsigned int base = (unsigned int)__cvta_generic_to_shared(smem);
  const unsigned int bar = base;  // the mbarrier: the first 8 bytes
  if (threadIdx.x == 0) {
    unsigned int bytes = 0;
#pragma unroll
    for (int l = 0; l < NL; ++l)
      if (plan.bulk >> l & 1) bytes += (unsigned int)(lv.w[l] * plan.chans * lv.h[l] * 2);
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
                 : "memory");
  }
  __syncthreads();  // the barrier is armed before any copy completes on it
#pragma unroll
  for (int l = 0; l < NL; ++l) {
    const int H = lv.h[l];
    const int W = lv.w[l];
    const int run = plan.chans * H;  // values
    const __nv_bfloat16* src = lv.v[l] + (bh * W * dh + c0) * H;
    if (plan.bulk >> l & 1) {
      if (threadIdx.x < 32) {  // one warp issues the level's W copies
        for (int x = threadIdx.x; x < W; x += 32)
          asm volatile(
              "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
              "[%0], [%1], %2, [%3];" ::"r"(base + plan.offset[l] + x * run * 2),
              "l"(src + (long long)x * dh * H), "r"(run * 2), "r"(bar)
              : "memory");
      }
    } else {  // a run off the 16-byte rule
      unsigned short* dst = reinterpret_cast<unsigned short*>(smem + plan.offset[l]);
      const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
      for (int i = threadIdx.x; i < W * run; i += blockDim.x) {
        const int x = i / run;
        dst[i] = __ldg(s + (long long)x * dh * H + (i - x * run));
      }
    }
  }
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], 0;\n"
      "@!P1 bra LAB_WAIT;\n"
      "}" ::"r"(bar)
      : "memory");
  __syncthreads();  // and the threads' copies
}

// NL levels: a template argument, so a thread keeps the corner state of
// only the levels there are. STAGED: the taps come from shared memory (two
// blocks an SM), else from device memory (one: 64-bit addresses take more
// registers than two blocks leave).
template <int NL, bool STAGED>
__global__ void __launch_bounds__(TPOSE_THREADS, STAGED ? 2 : 1)
msda_tpose_kernel(PointLevels lv, float* __restrict__ out, int P, int dh, TposePlan plan) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long bh = blockIdx.z;
  const int c0 = (int)blockIdx.y * plan.chans;  // the group's first channel
  if constexpr (STAGED) fill<NL>(lv, dh, bh, c0, plan, smem);

  // per level, channel c0 of column 0 at y 0, and the values between two
  // columns: chans * H in shared memory, dh * H in V^T
  const __nv_bfloat16* lvl[NL];
  int cols[NL];
#pragma unroll
  for (int l = 0; l < NL; ++l) {
    if constexpr (STAGED) {
      lvl[l] = reinterpret_cast<const __nv_bfloat16*>(smem + plan.offset[l]);
      cols[l] = plan.chans * lv.h[l];
    } else {
      lvl[l] = lv.v[l] + (bh * lv.w[l] * dh + c0) * lv.h[l];
      cols[l] = dh * lv.h[l];
    }
  }

  for (int p = (int)(blockIdx.x * blockDim.x + threadIdx.x); p < P;
       p += (int)(gridDim.x * blockDim.x)) {
    const long long pt = bh * P + p;
    int o0[NL], o1[NL], dy[NL];  // the corners' columns at y0, from lvl
    float w[NL][4];
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      const int H = lv.h[l];
      const float Hf = (float)H;
      const float Wf = (float)lv.w[l];
      const float ix = __ldg(lv.ix[l] + pt);
      const float iy = __ldg(lv.iy[l] + pt);
      const float a = __ldg(lv.a[l] + pt);
      const float x0 = floorf(ix);
      const float y0 = floorf(iy);
      const float x1 = x0 + 1.f;
      const float y1 = y0 + 1.f;
      // tested in float: NaN fails every comparison
      const bool vx0 = x0 >= 0.f && x0 <= Wf - 1.f;
      const bool vx1 = x1 >= 0.f && x1 <= Wf - 1.f;
      const bool vy0 = y0 >= 0.f && y0 <= Hf - 1.f;
      const bool vy1 = y1 >= 0.f && y1 <= Hf - 1.f;
      // clamped in float (fmaxf takes 0 over a NaN): every tap lies in the map
      const int xi0 = (int)fminf(fmaxf(x0, 0.f), Wf - 1.f);
      const int xi1 = (int)fminf(fmaxf(x1, 0.f), Wf - 1.f);
      const int yi0 = (int)fminf(fmaxf(y0, 0.f), Hf - 1.f);
      const int yi1 = (int)fminf(fmaxf(y1, 0.f), Hf - 1.f);
      w[l][0] = (vx0 && vy0) ? a * ((x1 - ix) * (y1 - iy)) : 0.f;
      w[l][1] = (vx0 && vy1) ? a * ((x1 - ix) * (iy - y0)) : 0.f;
      w[l][2] = (vx1 && vy0) ? a * ((ix - x0) * (y1 - iy)) : 0.f;
      w[l][3] = (vx1 && vy1) ? a * ((ix - x0) * (iy - y0)) : 0.f;
      o0[l] = xi0 * cols[l] + yi0;
      o1[l] = xi1 * cols[l] + yi0;
      dy[l] = yi1 - yi0;
    }
    float* o = out + (bh * dh + c0) * P + p;
#pragma unroll 2
    for (int d = 0; d < plan.chans; ++d) {
      float acc = 0.f;
#pragma unroll
      for (int l = 0; l < NL; ++l) {
        const __nv_bfloat16* r0 = lvl[l] + (o0[l] + d * lv.h[l]);
        const __nv_bfloat16* r1 = lvl[l] + (o1[l] + d * lv.h[l]);
        acc = fmaf(w[l][0], __bfloat162float(r0[0]), acc);
        acc = fmaf(w[l][1], __bfloat162float(r0[dy[l]]), acc);
        acc = fmaf(w[l][2], __bfloat162float(r1[0]), acc);
        acc = fmaf(w[l][3], __bfloat162float(r1[dy[l]]), acc);
      }
      o[(long long)d * P] = acc;
    }
  }
}

template <int NL>
static int launch(PointLevels lv, float* out, int BH, int P, int dh, const TposePlan& plan,
                  cudaStream_t stream) {
  const dim3 grid(plan.blocks, plan.groups, BH);
  if (!plan.staged) {
    msda_tpose_kernel<NL, false><<<grid, plan.threads, 0, stream>>>(lv, out, P, dh, plan);
    return (int)cudaGetLastError();
  }
  const cudaError_t err = cudaFuncSetAttribute(
      msda_tpose_kernel<NL, true>, cudaFuncAttributeMaxDynamicSharedMemorySize, plan.smem);
  if (err != cudaSuccess) return (int)err;
  msda_tpose_kernel<NL, true><<<grid, plan.threads, plan.smem, stream>>>(lv, out, P, dh, plan);
  return (int)cudaGetLastError();
}

// The entry point: the point table, out, B*nH, P, nL, dh, the plan, the
// stream; it returns cudaGetLastError().
extern "C" int msda_tpose(PointLevels lv, void* out, int BH, int P, int nL, int dh,
                          TposePlan plan, void* stream) {
  float* o = (float*)out;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (nL) {
    case 1: return launch<1>(lv, o, BH, P, dh, plan, s);
    case 2: return launch<2>(lv, o, BH, P, dh, plan, s);
    case 3: return launch<3>(lv, o, BH, P, dh, plan, s);
    case 4: return launch<4>(lv, o, BH, P, dh, plan, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
