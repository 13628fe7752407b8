// FastKAN's Gaussian basis and its product with the coefficients in one
// kernel, sm_90a: s = basis(u(xn)) @ coeffs.reshape(r, D*G).T, written in
// bf16 (or float32).
//
// Replaces no TPU kernel: the JAX package leaves this einsum
// (detrpose_tpu/models/layers.py:373-403, "bdg,rdg->br") to XLA. The plain
// version is detrpose_tpu_torch/ops/cuda/kan.py::kan_basis_plain, which the
// kernel is held to; for a bf16 LayerNorm output xn (N, D) it computes
//   u = bf16 steps of (tanh(x) + 1) * 0.5 * (G - 1),
//   b[n, d*G + g] = exp(-((u - g) / sigma)^2) in float32,
// and the float32 product of b (N, D*G) with the coefficients (r, D*G).
//
// What bounds it on an H100: the tensor cores. At DETRPose-L's kan2 (N
// 34,560 tokens, D 1024, G 3, r 513) the product is 108.9 GFLOP: 0.110 ms at
// the bf16 peak of 989 TFLOP/s for one pass, and the kernel makes three. The
// bytes (the bf16 input once, the coefficients, the bf16 output) are 109 MB:
// 0.033 ms at 3.35 TB/s. The plain path writes the (N, D*G) float32 basis,
// 425 MB, through five elementwise passes and multiplies it in float32
// without the tensor cores.
//
// Design: the basis is never written to device memory. A block of three
// warpgroups takes tiles of 128 rows by 176 columns (513 = 3 x 176 - 15),
// persistent over the tiles, and walks K in chunks of 64.
// - The producer warpgroup (threads 256-383). One thread keeps TMA loads of
//   the coefficients' tile (176 x 64, 128-byte swizzle, rows past r
//   zero-filled) two chunks ahead in a ring of 4 stages, and of the input's
//   (128 rows x xdim inputs from the multiple of 8 at or below k0 / G: a box
//   starts on 16 bytes) one chunk ahead in a ring of 2. Every thread then
//   makes one row of the chunk: the u of each input the chunk reaches, from
//   `utab` (ops/cuda/kan.py::u_table: the plain version's own bf16 ops on
//   all 65536 bf16 values, so u is the plain path's bit for bit), then for
//   each column b = expf(-((u - g) * inv)^2) as the plain path computes it,
//   split into three bf16 pieces, hi = bf16(b), mid = bf16(b - hi), lo =
//   bf16(b - hi - mid), whose sum is b exactly over the basis's range
//   [exp(-(G-1)^2), 1] (tests/test_torch_kan_fused_cpu.py checks it for
//   every bf16 u and centre). The pieces go to a ring of 2 stages in the
//   128-byte swizzled layout that wgmma reads.
// - The two consumer warpgroups (64 rows each) run, per chunk, 3 pieces x 4
//   k-steps of wgmma m64n176k16 against the same coefficient tile. bf16 times
//   bf16 is exact in float32, so each term is the one the float32 product
//   multiplies. The tensor cores add with truncation, so each chunk's sum
//   starts from zero, takes the pieces from the smallest (lo, mid, hi: only
//   the hi pass's 4 adds meet the chunk's large partial sums), and is added
//   into a float32 total in registers, as the float32 product would add it;
//   only the order of the sum differs.
// The epilogue writes the total of each tile while the producer makes the
// next tile's chunks. On the card the producer bounds it (PERF.md): at kan2
// the products alone, without the basis, take 0.49 ms of the kernel's 1.26.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define KAN_THREADS 384   // three warpgroups: two consumers, one producer
#define KAN_ROWS 128      // KAN_ROWS: rows of a tile, 64 a consumer warpgroup
#define KAN_COLS 176      // KAN_COLS: columns of a tile, the wgmma's N
#define KAN_DEPTH 64      // KAN_DEPTH: k of a chunk, one 128-byte swizzle row
#define KAN_A_STAGES 2
#define KAN_B_STAGES 4
#define KAN_X_STAGES 2

constexpr int kPiece = KAN_ROWS * 128;                   // one bf16 piece of a chunk
constexpr int kAStage = 3 * kPiece;
constexpr int kBStage = KAN_COLS * 128;
constexpr int kBOff = KAN_A_STAGES * kAStage;
constexpr int kXOff = kBOff + KAN_B_STAGES * kBStage;  // then the input's stages, u, barriers

struct Barriers {
  uint64_t full_a[KAN_A_STAGES];   // the producer's 128 threads made the chunk's basis
  uint64_t empty_a[KAN_A_STAGES];  // the 8 consumer warps are done with it
  uint64_t full_b[KAN_B_STAGES];   // the coefficients' tile arrived
  uint64_t empty_b[KAN_B_STAGES];  // the 8 consumer warps are done with it
  uint64_t full_x[KAN_X_STAGES];   // the input's tile arrived
};

__device__ __forceinline__ uint32_t bar_addr(const uint64_t& b) {
  return (uint32_t)__cvta_generic_to_shared(&b);
}

__device__ __forceinline__ void bar_init(const uint64_t& b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar_addr(b)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(const uint64_t& b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar_addr(b)) : "memory");
}

__device__ __forceinline__ void bar_expect(const uint64_t& b, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar_addr(b)),
               "r"(bytes)
               : "memory");
}

// Wait for the completion of the barrier's phase of this parity.
__device__ __forceinline__ void bar_wait(const uint64_t& b, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar_addr(b)), "r"(parity)
        : "memory");
  } while (!done);
}

// A 2D tile by TMA; `map` is the address of a tensor map kernel parameter.
__device__ __forceinline__ void tma_load(uint32_t dst, uint64_t map, const uint64_t& bar, int c0,
                                         int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(map), "r"(bar_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// A wgmma operand of rows of 128 bytes (64 bf16 of K) in the 128-byte
// swizzle, 8-row groups 1024 bytes apart, starting at `addr`.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keeps the compiler from moving reads and writes of the accumulators
// across the wgmma's fence and wait.
__device__ __forceinline__ void fence_operands(float (&d)[KAN_COLS / 2]) {
#pragma unroll
  for (int i = 0; i < KAN_COLS / 2; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x 176, float32, in registers) = A (64 x 16, bf16, shared memory) x
// B (16 x 176, bf16, shared memory, K-major) + D if `accumulate`.
__device__ __forceinline__ void wgmma_m64n176k16(float (&d)[88], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %90, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n176k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, "
      "%11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, "
      "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, "
      "%33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, "
      "%55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
      "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, "
      "%77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87"
      "}, %88, %89, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87])
      : "l"(a), "l"(b), "r"(accumulate));
}

struct KanShape {
  int N, D, G, r;
  int ldo;         // the output's row stride: r rounded up to 8, the columns past r zeros
  unsigned magic;  // ceil(2^32 / G): k / G is __umulhi(k, magic) for (k + 1) * G < 2^32
  float inv;       // 1 / sigma as the plain version rounds it
  int xdim;        // input columns of a chunk's tile (ops/cuda/kan.py::kan_plan)
  int ucount;      // inputs a chunk reaches at most: 63 / G + 2
  int nk;          // chunks of K
  int ncol;        // column tiles
  int ntiles;
};

__device__ __forceinline__ int div_g(int k, const KanShape& s) {
  return (int)__umulhi((unsigned)k, s.magic);
}

// Chunk after chunk of this block: its tile's row and column tiles and k0,
// with a division only where the tile changes.
struct ChunkWalk {
  int kc, tile, row0, col0;
  __device__ __forceinline__ void at_tile(int t, const KanShape& s) {
    kc = 0;
    tile = t;
    const int rt = t / s.ncol;
    row0 = rt * KAN_ROWS;
    col0 = (t - rt * s.ncol) * KAN_COLS;
  }
  __device__ __forceinline__ void next(const KanShape& s) {
    if (++kc == s.nk) at_tile(tile + gridDim.x, s);
  }
};

// Two float32 values as three bf16x2 pieces whose sums are the values:
// hi = bf16(b), mid = bf16(b - hi), lo = bf16(b - hi - mid), each rounded to
// nearest; the subtractions are exact.
__device__ __forceinline__ void split(float b0, float b1, uint32_t& hi, uint32_t& mid,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(b0, b1);
  const float2 hf = __bfloat1622float2(h);
  const float r0 = b0 - hf.x, r1 = b1 - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(m);
  const __nv_bfloat162 l = __floats2bfloat162_rn(r0 - mf.x, r1 - mf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  mid = *reinterpret_cast<const uint32_t*>(&m);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// Row `t` of a chunk of the basis, columns k0 .. k0 + 63 (column k = d * G
// + g is centre g of input d; zeros past the last input), as three bf16
// pieces in the swizzled layout of `a`. First the u of each input the chunk
// reaches, `utab`'s entry for its bf16 bits, from this row of the input's
// tile `xs` (which starts at the multiple of 8 at or below k0 / G) into
// this thread's column of `us`: neighbouring threads, neighbouring values,
// no bank conflict. Then the columns: every index is worked out from the
// column alone and nothing branches, so the compiler interleaves the
// columns of two 16-byte groups.
__device__ __forceinline__ void make_row(const unsigned short* __restrict__ xs,
                                         unsigned short* __restrict__ us,
                                         const unsigned short* __restrict__ utab,
                                         unsigned char* __restrict__ a, int t, int k0,
                                         const KanShape& s) {
  const int dlo = div_g(k0, s), xlo = dlo & ~7;
  const int n = div_g(k0 + KAN_DEPTH - 1, s) - dlo + 1;
  const unsigned short* xrow = xs + dlo - xlo;
  unsigned short* ucol = us + t;
  // 16 lookups in flight at a time; reads past the row's n inputs stay in
  // shared memory and are not stored
  for (int i0 = 0; i0 < n; i0 += 16) {
    unsigned short x[16], u[16];
#pragma unroll
    for (int q = 0; q < 16; ++q) x[q] = xrow[i0 + q];
#pragma unroll
    for (int q = 0; q < 16; ++q) u[q] = __ldg(utab + x[q]);
#pragma unroll
    for (int q = 0; q < 16; ++q)
      if (i0 + q < n) ucol[(i0 + q) * KAN_ROWS] = u[q];
  }
  unsigned char* row = a + t * 128;
#pragma unroll 2
  for (int j = 0; j < KAN_DEPTH / 8; ++j) {
    uint32_t hi[4], mid[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float b[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = k0 + 8 * j + 2 * e + h;
        const int d = div_g(k, s);
        const float u = __uint_as_float((uint32_t)us[(d - dlo) * KAN_ROWS + t] << 16);
        // the centre as a float without a conversion: 2^23 + g, less 2^23
        const float g = __uint_as_float(0x4B000000u | (uint32_t)(k - d * s.G)) - 8388608.0f;
        const float dd = (u - g) * s.inv;
        b[h] = expf(-(dd * dd)) * (d < s.D ? 1.0f : 0.0f);
      }
      split(b[0], b[1], hi[e], mid[e], lo[e]);
    }
    const int off = (j ^ (t & 7)) << 4;  // the 128-byte swizzle
    *reinterpret_cast<uint4*>(row + off) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(row + kPiece + off) = make_uint4(mid[0], mid[1], mid[2], mid[3]);
    *reinterpret_cast<uint4*>(row + 2 * kPiece + off) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T>
__global__ void __launch_bounds__(KAN_THREADS, 1)
kan_basis_kernel(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_b,
                 const unsigned short* __restrict__ utab, T* __restrict__ out,
                 const KanShape s) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // the swizzle needs 1024-byte alignment
  unsigned char* smem = smem_raw + (base - raw);
  const int x_stage = KAN_ROWS * s.xdim * 2;
  const int u_off = kXOff + KAN_X_STAGES * x_stage;
  Barriers& bars = *reinterpret_cast<Barriers*>(smem + u_off + KAN_ROWS * s.ucount * 2);
  if (threadIdx.x == 0) {
    for (int i = 0; i < KAN_A_STAGES; ++i) {
      bar_init(bars.full_a[i], 128);
      bar_init(bars.empty_a[i], 8);
    }
    for (int i = 0; i < KAN_B_STAGES; ++i) {
      bar_init(bars.full_b[i], 1);
      bar_init(bars.empty_b[i], 8);
    }
    for (int i = 0; i < KAN_X_STAGES; ++i) bar_init(bars.full_x[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int mine = (s.ntiles - blockIdx.x + gridDim.x - 1) / gridDim.x;  // tiles of this block
  const int total = mine * s.nk;                                         // its chunks

  if (threadIdx.x >= 256) {
    // ---- producer: TMA loads, and the basis
    asm volatile("setmaxnreg.dec.sync.aligned.u32 88;");
    const int t = threadIdx.x - 256;
    const uint64_t tmap_x = reinterpret_cast<uint64_t>(&map_x);
    const uint64_t tmap_b = reinterpret_cast<uint64_t>(&map_b);
    if (t == 0) {
      asm volatile("prefetch.tensormap [%0];" ::"l"(tmap_x) : "memory");
      asm volatile("prefetch.tensormap [%0];" ::"l"(tmap_b) : "memory");
    }
    ChunkWalk wb, wx, wc;  // the coefficients' loads, the input's loads, the basis
    wb.at_tile(blockIdx.x, s);
    wx.at_tile(blockIdx.x, s);
    wc.at_tile(blockIdx.x, s);
    // chunk j's coefficient tile, two ahead: its stage was last read by
    // chunk j - 4, which the consumers release
    auto load_b = [&](int j) {
      const int st = j % KAN_B_STAGES;
      bar_wait(bars.empty_b[st], ((j / KAN_B_STAGES) & 1) ^ 1);
      bar_expect(bars.full_b[st], kBStage);
      tma_load(base + kBOff + st * kBStage, tmap_b, bars.full_b[st], wb.kc * KAN_DEPTH, wb.col0);
      wb.next(s);
    };
    // chunk j's input tile, one ahead: its stage was last read by chunk j -
    // 2, which every producer thread has passed (the named barrier). The box
    // starts at a multiple of 8 inputs: TMA's 16-byte rule
    auto load_x = [&](int j) {
      const int st = j % KAN_X_STAGES;
      bar_expect(bars.full_x[st], x_stage);
      tma_load(base + kXOff + st * x_stage, tmap_x, bars.full_x[st],
               div_g(wx.kc * KAN_DEPTH, s) & ~7, wx.row0);
      wx.next(s);
    };
    if (t == 0 && total > 0) {
      load_b(0);
      load_x(0);
      if (total > 1) load_b(1);
    }
    for (int c = 0; c < total; ++c) {
      if (t == 0) {
        if (c + 2 < total) load_b(c + 2);
        if (c + 1 < total) load_x(c + 1);
      }
      const int sa = c % KAN_A_STAGES, sx = c % KAN_X_STAGES;
      bar_wait(bars.empty_a[sa], ((c / KAN_A_STAGES) & 1) ^ 1);
      bar_wait(bars.full_x[sx], (c / KAN_X_STAGES) & 1);
      make_row(reinterpret_cast<const unsigned short*>(smem + kXOff + sx * x_stage) + t * s.xdim,
               reinterpret_cast<unsigned short*>(smem + u_off), utab, smem + sa * kAStage, t,
               wc.kc * KAN_DEPTH, s);
      wc.next(s);
      // the pieces were written by the threads, the wgmma reads them
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      bar_arrive(bars.full_a[sa]);
      // every row of this chunk's input is read before its stage is refilled
      asm volatile("bar.sync 1, 128;" ::: "memory");
    }
  } else {
    // ---- consumers: 64 rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 208;");
    const int w = threadIdx.x >> 7, tw = threadIdx.x & 127;
    float acc[KAN_COLS / 2], sum[KAN_COLS / 2];
#pragma unroll
    for (int i = 0; i < KAN_COLS / 2; ++i) acc[i] = 0.0f;
    int c = 0;
    for (int it = 0; it < mine; ++it) {
      const int tile = blockIdx.x + it * gridDim.x;
#pragma unroll
      for (int i = 0; i < KAN_COLS / 2; ++i) sum[i] = 0.0f;
      for (int kc = 0; kc < s.nk; ++kc, ++c) {
        const int sa = c % KAN_A_STAGES, sb = c % KAN_B_STAGES;
        bar_wait(bars.full_a[sa], (c / KAN_A_STAGES) & 1);
        bar_wait(bars.full_b[sb], (c / KAN_B_STAGES) & 1);
        const uint32_t a = base + sa * kAStage + w * 64 * 128;
        const uint32_t b = base + kBOff + sb * kBStage;
        fence_operands(acc);
        wg_fence();
        // the pieces from the smallest, lo, mid, then hi: the truncating
        // adds of the lo and mid passes meet only their own small sums, and
        // those of the chunk's large partial sums are the hi pass's 4
#pragma unroll
        for (int p = 2; p >= 0; --p)
#pragma unroll
          for (int kk = 0; kk < KAN_DEPTH / 16; ++kk)
            wgmma_m64n176k16(acc, desc_sw128(a + p * kPiece + kk * 32), desc_sw128(b + kk * 32),
                             p != 2 || kk != 0);
        wg_commit();
        wg_wait_all();
        fence_operands(acc);
        if ((tw & 31) == 0) {
          bar_arrive(bars.empty_a[sa]);
          bar_arrive(bars.empty_b[sb]);
        }
#pragma unroll
        for (int i = 0; i < KAN_COLS / 2; ++i) sum[i] += acc[i];
      }
      // the accumulator layout of wgmma: warp q of the warpgroup holds rows
      // 16q .. 16q + 15; value 4i + 2h + v is row lane / 4 + 8h, column
      // 8i + 2 (lane % 4) + v
      const long long row = (long long)(tile / s.ncol) * KAN_ROWS + w * 64 + (tw >> 5) * 16 +
                            ((tw & 31) >> 2);
      const int col = (tile % s.ncol) * KAN_COLS + 2 * (tw & 3);
#pragma unroll
      for (int i = 0; i < KAN_COLS / 8; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int v = 0; v < 2; ++v) {
            const long long n = row + 8 * h;
            const int k = col + 8 * i + v;
            if (n < s.N && k < s.ldo) store(out + n * s.ldo + k, sum[4 * i + 2 * h + v]);
          }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's entry-point lookup: the
// library links no libcuda of its own.
static EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// A 2D bf16 tensor map over rows of `cols` values `stride` values apart.
static int tensor_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, long long rows, int cols,
                      int stride, int box_cols, int box_rows, CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)stride * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return (int)enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides,
                  box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// xn (N, D) bf16, rows `xstride` values apart; coeffs (r, D * G) bf16, rows
// `kstride` values apart (both strides multiples of 8, both addresses of 16
// bytes); utab (65536) the bf16 u of each bf16 input, by its bits; inv the
// float32 1 / sigma; out (N, r rounded up to 8), the columns past r zeros.
// Returns cudaGetLastError(), or -1 where no cuTensorMapEncodeTiled is
// found, -2 / -3 where it refuses the input's / the coefficients' map.
template <typename T>
static int launch(const void* xn, const void* coeffs, const void* utab, void* out, int N, int D,
                  int xstride, int G, int r, int kstride, float inv, int xdim, int smem, int grid,
                  void* stream) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return -1;
  CUtensorMap map_x, map_b;
  if (tensor_map(enc, &map_x, xn, N, D, xstride, xdim, KAN_ROWS, CU_TENSOR_MAP_SWIZZLE_NONE))
    return -2;
  if (tensor_map(enc, &map_b, coeffs, r, D * G, kstride, KAN_DEPTH, KAN_COLS,
                 CU_TENSOR_MAP_SWIZZLE_128B))
    return -3;
  KanShape s;
  s.N = N;
  s.D = D;
  s.G = G;
  s.r = r;
  s.ldo = (r + 7) / 8 * 8;
  s.magic = (unsigned)(0xFFFFFFFFu / (unsigned)G + 1u);
  s.inv = inv;
  s.xdim = xdim;
  s.ucount = 63 / G + 2;
  s.nk = (D * G + KAN_DEPTH - 1) / KAN_DEPTH;
  s.ncol = (r + KAN_COLS - 1) / KAN_COLS;
  s.ntiles = ((N + KAN_ROWS - 1) / KAN_ROWS) * s.ncol;
  cudaFuncSetAttribute(kan_basis_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  kan_basis_kernel<T><<<grid, KAN_THREADS, smem, (cudaStream_t)stream>>>(
      map_x, map_b, (const unsigned short*)utab, (T*)out, s);
  return (int)cudaGetLastError();
}

extern "C" int kan_basis_bf16(const void* xn, const void* coeffs, const void* utab, void* out,
                              int N, int D, int xstride, int G, int r, int kstride, float inv,
                              int xdim, int smem, int grid, void* stream) {
  return launch<__nv_bfloat16>(xn, coeffs, utab, out, N, D, xstride, G, r, kstride, inv, xdim,
                               smem, grid, stream);
}

extern "C" int kan_basis_f32(const void* xn, const void* coeffs, const void* utab, void* out,
                             int N, int D, int xstride, int G, int r, int kstride, float inv,
                             int xdim, int smem, int grid, void* stream) {
  return launch<float>(xn, coeffs, utab, out, N, D, xstride, G, r, kstride, inv, xdim, smem,
                       grid, stream);
}
