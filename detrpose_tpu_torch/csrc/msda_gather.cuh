// The bilinear taps shared by the MSDA kernels of csrc/, sm_90a: the
// forward kernels csrc/msda_fwd.cu (kernel #1) and csrc/msda_perquery.cu
// (kernel #2), and the per-point kernels csrc/msda_ablate.cu (kernel #5, all
// four modes) and csrc/msda_tpose.cu (kernel #4, which takes only the
// level tables from here), and the backward of kernel #1's op,
// csrc/msda_bwd.cu, which fetches its corners through corner_rows_px.
//
// Kernels #1 and #2 compute, for each row (a query of one image, or a query
// of one (image, head)) and each head in that row, the sum over levels and
// points of a * bilinear(value_level, x, y): grid_sample with zeros padding
// and align_corners=False, ix = x*W - 0.5, iy = y*H - 0.5, every corner
// zeroed on its own when it lies outside the map, the sum kept in float.
// They differ only in where a head's value rows and points lie, so each
// kernel maps its threads to (row, head, channels) and this header does the
// rest. The taps of one point at pixel coordinates (ix, iy) are corners_px:
// gather calls it after the conversion; kernel #5 takes its points already
// in pixels and keeps one sum per point, through gather_px (corners) and
// taps_px (the two row taps of a one-column source).
//
// A thread owns V consecutive channels of one head and reads them with one
// 16-byte load (V = 8 bf16 or 4 float) through the read-only path; 8-, 4-
// or 2-byte loads where the head width or the map's address does not allow
// 16. A level's points are taken together: their corner indices are clamped
// into the map in float and their weights chosen by select (exactly 0.f off
// the map, also for a NaN or huge coordinate), so there is no branch and all
// 4*NP corner loads of a level are issued before the first is used. The
// level loop is unrolled to MSDA_MAX_LEVELS and guarded by l < nL, so every
// index into the level table is a constant and the kernels keep no stack
// frame.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <type_traits>

#define MSDA_MAX_LEVELS 4
#define MSDA_THREADS 256  // threads per block (BLOCK_THREADS in ops/cuda/msda.py)
// Blocks per SM the kernels ask ptxas to fit (__launch_bounds__), which
// lets it use up to 128 registers a thread: enough to keep a level's corner
// rows in flight. Left to itself, ptxas keeps about half that and issues the
// loads one or two at a time.
#define MSDA_MIN_BLOCKS 2

struct MsdaLevels {
  int h[MSDA_MAX_LEVELS];
  int w[MSDA_MAX_LEVELS];
  int start[MSDA_MAX_LEVELS];  // first row of the level in the flattened map
};

// The per-point kernels' levels: per level the (ix, iy, a) point arrays, the
// value map, its height and width (ops/cuda/msda.py::_PointLevels).
struct PointLevels {
  const float* ix[MSDA_MAX_LEVELS];
  const float* iy[MSDA_MAX_LEVELS];
  const float* a[MSDA_MAX_LEVELS];
  const __nv_bfloat16* v[MSDA_MAX_LEVELS];
  int h[MSDA_MAX_LEVELS];
  int w[MSDA_MAX_LEVELS];
};

namespace msda {

// V values of T as one load: 16, 8, 4 or 2 bytes.
template <typename T, int V>
struct Vec {
  static constexpr int kBytes = V * (int)sizeof(T);
  static_assert(kBytes == 16 || kBytes == 8 || kBytes == 4 || kBytes == 2,
                "a thread loads 16, 8, 4 or 2 bytes");
  using Raw = std::conditional_t<
      kBytes == 16, uint4,
      std::conditional_t<kBytes == 8, uint2,
                         std::conditional_t<kBytes == 4, unsigned int, unsigned short>>>;
};

template <typename T, int V>
__device__ __forceinline__ typename Vec<T, V>::Raw load(const T* p) {
  return __ldg(reinterpret_cast<const typename Vec<T, V>::Raw*>(p));
}

// acc[i] += w * (the i-th value of r)
template <typename T, int V>
__device__ __forceinline__ void fma_row(const typename Vec<T, V>::Raw& r, float w,
                                        float (&acc)[V]) {
  if constexpr (std::is_same_v<T, float>) {
    const float* f = reinterpret_cast<const float*>(&r);
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = fmaf(w, f[i], acc[i]);
  } else if constexpr (V == 1) {
    acc[0] = fmaf(w, __uint_as_float((unsigned int)r << 16), acc[0]);
  } else {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < V / 2; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      acc[2 * i] = fmaf(w, f.x, acc[2 * i]);
      acc[2 * i + 1] = fmaf(w, f.y, acc[2 * i + 1]);
    }
  }
}

// p[i] = acc[i], rounded to T, as one store
template <typename T, int V>
__device__ __forceinline__ void store(T* p, const float (&acc)[V]) {
  typename Vec<T, V>::Raw r;
  if constexpr (std::is_same_v<T, float>) {
    float* f = reinterpret_cast<float*>(&r);
#pragma unroll
    for (int i = 0; i < V; ++i) f[i] = acc[i];
  } else if constexpr (V == 1) {
    r = __bfloat16_as_ushort(__float2bfloat16(acc[0]));
  } else {
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < V / 2; ++i) h[i] = __floats2bfloat162_rn(acc[2 * i], acc[2 * i + 1]);
  }
  *reinterpret_cast<typename Vec<T, V>::Raw*>(p) = r;
}

// p[i] = acc[i] for V floats, as V/4 16-byte stores (V 8 or 4), else one
template <int V>
__device__ __forceinline__ void store_f32(float* p, const float (&acc)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int i = 0; i < V; i += 4)
      *reinterpret_cast<float4*>(p + i) = make_float4(acc[i], acc[i + 1], acc[i + 2], acc[i + 3]);
  } else {
    store<float, V>(p, acc);
  }
}

// The four corners of one point whose top-left corner is (x0, y0) =
// (floor(ix), floor(iy)), for V channels of one head, in the order (x0, y0),
// (x0, y1), (x1, y0), (x1, y1): loads their rows into r and says in `in`
// whether each lies in the map. `level` points at the thread's channels in
// the level's first pixel; pixel i's are at level + i * stride. Corner
// indices are clamped into the map in float, so a corner off the map, or of
// a NaN or huge coordinate, loads an in-map row and is not `in`. The
// forward (corners_px) weighs the rows; the backward (csrc/msda_bwd.cu)
// takes their products with the output's gradient.
template <typename T, int V>
__device__ __forceinline__ void corner_rows_px(const T* __restrict__ level, int H, int W,
                                               int stride, float x0, float y0,
                                               typename Vec<T, V>::Raw (&r)[4],
                                               bool (&in)[4]) {
  const float Wf = (float)W;
  const float Hf = (float)H;
  const float x1 = x0 + 1.f;
  const float y1 = y0 + 1.f;
  // tested in float: NaN fails every comparison
  const bool vx0 = x0 >= 0.f && x0 <= Wf - 1.f;
  const bool vx1 = x1 >= 0.f && x1 <= Wf - 1.f;
  const bool vy0 = y0 >= 0.f && y0 <= Hf - 1.f;
  const bool vy1 = y1 >= 0.f && y1 <= Hf - 1.f;
  in[0] = vx0 && vy0;
  in[1] = vx0 && vy1;
  in[2] = vx1 && vy0;
  in[3] = vx1 && vy1;
  // clamped in float before the conversion (fmaxf takes 0 over a NaN), so
  // every corner address lies in the map
  const int xi0 = (int)fminf(fmaxf(x0, 0.f), Wf - 1.f);
  const int xi1 = (int)fminf(fmaxf(x1, 0.f), Wf - 1.f);
  const int yi0 = (int)fminf(fmaxf(y0, 0.f), Hf - 1.f);
  const int yi1 = (int)fminf(fmaxf(y1, 0.f), Hf - 1.f);
  const unsigned int s = (unsigned int)stride;
  r[0] = load<T, V>(level + (size_t)(unsigned int)(yi0 * W + xi0) * s);
  r[1] = load<T, V>(level + (size_t)(unsigned int)(yi1 * W + xi0) * s);
  r[2] = load<T, V>(level + (size_t)(unsigned int)(yi0 * W + xi1) * s);
  r[3] = load<T, V>(level + (size_t)(unsigned int)(yi1 * W + xi1) * s);
}

// One point's four corners at pixel coordinates (ix, iy) for V channels of
// one head: loads their rows into r (corner_rows_px) and their weights
// a * hat * hat into w, exactly 0.f for a corner that is not in the map.
template <typename T, int V>
__device__ __forceinline__ void corners_px(const T* __restrict__ level, int H, int W,
                                           int stride, float ix, float iy, float a,
                                           typename Vec<T, V>::Raw (&r)[4], float (&w)[4]) {
  const float x0 = floorf(ix);
  const float y0 = floorf(iy);
  bool in[4];
  corner_rows_px<T, V>(level, H, W, stride, x0, y0, r, in);
  const float wx0 = (x0 + 1.f) - ix;
  const float wx1 = ix - x0;
  const float wy0 = (y0 + 1.f) - iy;
  const float wy1 = iy - y0;
  w[0] = in[0] ? a * (wx0 * wy0) : 0.f;
  w[1] = in[1] ? a * (wx0 * wy1) : 0.f;
  w[2] = in[2] ? a * (wx1 * wy0) : 0.f;
  w[3] = in[3] ? a * (wx1 * wy1) : 0.f;
}

// Samples one point of one level at pixel coordinates (ix, iy) and adds
// a * bilinear(ix, iy) to acc. All 4 corner loads are issued before the
// first is used.
template <typename T, int V>
__device__ __forceinline__ void gather_px(const T* __restrict__ level, int H, int W,
                                          int stride, float ix, float iy, float a,
                                          float (&acc)[V]) {
  typename Vec<T, V>::Raw r[4];
  float w[4];
  corners_px<T, V>(level, H, W, stride, ix, iy, a, r, w);
#pragma unroll
  for (int c = 0; c < 4; ++c) fma_row<T, V>(r[c], w[c], acc);
}

// Samples G points of one level at normalized coordinates,
// ix = x*W - 0.5, iy = y*H - 0.5, and adds every point's a * bilinear to
// acc: corners_px with each point's conversion just before its corners.
template <typename T, int V, int G>
__device__ __forceinline__ void gather(const T* __restrict__ level, int H, int W, int stride,
                                       const float (&x)[G], const float (&y)[G],
                                       const float (&a)[G], float (&acc)[V]) {
  const float Wf = (float)W;
  const float Hf = (float)H;
  typename Vec<T, V>::Raw r[G][4];
  float w[G][4];
#pragma unroll
  for (int g = 0; g < G; ++g)
    corners_px<T, V>(level, H, W, stride, x[g] * Wf - 0.5f, y[g] * Hf - 0.5f, a[g], r[g], w[g]);
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int c = 0; c < 4; ++c) fma_row<T, V>(r[g][c], w[g][c], acc);
  }
}

// The two row taps of one point on a one-column source: adds
// a * (1-|iy-y|) * row y to acc for y = floor(iy) and floor(iy)+1 where it
// lies in [0, H) (the column weight 1-|x| is 1 at x = 0). `col` points at
// the thread's channels of row 0; row y's are at col + y * stride. Rows are
// clamped in float and the weights selected as in corners_px, and both
// loads are issued before the first is used.
template <typename T, int V>
__device__ __forceinline__ void taps_px(const T* __restrict__ col, int H, int stride,
                                        float iy, float a, float (&acc)[V]) {
  const float Hf = (float)H;
  const float y0 = floorf(iy);
  const float y1 = y0 + 1.f;
  const bool vy0 = y0 >= 0.f && y0 <= Hf - 1.f;
  const bool vy1 = y1 >= 0.f && y1 <= Hf - 1.f;
  const int yi0 = (int)fminf(fmaxf(y0, 0.f), Hf - 1.f);
  const int yi1 = (int)fminf(fmaxf(y1, 0.f), Hf - 1.f);
  const float w0 = vy0 ? a * (y1 - iy) : 0.f;
  const float w1 = vy1 ? a * (iy - y0) : 0.f;
  const unsigned int s = (unsigned int)stride;
  const typename Vec<T, V>::Raw r0 = load<T, V>(col + (size_t)(unsigned int)yi0 * s);
  const typename Vec<T, V>::Raw r1 = load<T, V>(col + (size_t)(unsigned int)yi1 * s);
  fma_row<T, V>(r0, w0, acc);
  fma_row<T, V>(r1, w1, acc);
}

// One head of one row, all levels: `base` points at the thread's channels
// in the first pixel of level 0; `loc` at the head's nL*nP (x, y) pairs and
// `aw` at its nL*nP weights, level-major. NP is nP when it is 4 or 6 (a
// level's points are one group), else 0: groups of two, the last one padded
// with a point of weight 0.
template <typename T, int V, int NP>
__device__ __forceinline__ void sum_levels(const T* __restrict__ base, int stride,
                                           const MsdaLevels& lv, int nL, int nP,
                                           const float* __restrict__ loc,
                                           const float* __restrict__ aw, float (&acc)[V]) {
#pragma unroll
  for (int l = 0; l < MSDA_MAX_LEVELS; ++l) {
    if (l < nL) {
      const T* level = base + (size_t)lv.start[l] * stride;
      if constexpr (NP > 0) {
        float x[NP], y[NP], a[NP];
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          const int k = l * NP + p;
          x[p] = __ldg(loc + 2 * k);
          y[p] = __ldg(loc + 2 * k + 1);
          a[p] = __ldg(aw + k);
        }
        gather<T, V, NP>(level, lv.h[l], lv.w[l], stride, x, y, a, acc);
      } else {
#pragma unroll 1
        for (int p = 0; p < nP; p += 2) {
          float x[2], y[2], a[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int k = l * nP + min(p + j, nP - 1);
            x[j] = __ldg(loc + 2 * k);
            y[j] = __ldg(loc + 2 * k + 1);
            a[j] = p + j < nP ? __ldg(aw + k) : 0.f;
          }
          gather<T, V, 2>(level, lv.h[l], lv.w[l], stride, x, y, a, acc);
        }
      }
    }
  }
}

// Calls launch(std::integral_constant<int, V>, std::integral_constant<int, NP>)
// for the vector width `vec` (channels per thread) and the point count, and
// returns what it returns; cudaErrorInvalidValue for a width T cannot load.
template <typename T, typename F>
int dispatch(int vec, int nP, F&& launch) {
  auto with_points = [&](auto v) {
    if (nP == 4) return launch(v, std::integral_constant<int, 4>());
    if (nP == 6) return launch(v, std::integral_constant<int, 6>());
    return launch(v, std::integral_constant<int, 0>());
  };
  switch (vec * (int)sizeof(T)) {
    case 16:
      return with_points(std::integral_constant<int, (int)(16 / sizeof(T))>());
    case 8:
      return with_points(std::integral_constant<int, (int)(8 / sizeof(T))>());
    case 4:
      return with_points(std::integral_constant<int, (int)(4 / sizeof(T))>());
    case 2:
      if constexpr (sizeof(T) == 2) return with_points(std::integral_constant<int, 1>());
      [[fallthrough]];
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Calls launch(std::integral_constant<int, V>) for the vector width `vec`
// and returns what it returns; cudaErrorInvalidValue for a width T cannot
// load.
template <typename T, typename F>
int dispatch_vec(int vec, F&& launch) {
  switch (vec * (int)sizeof(T)) {
    case 16:
      return launch(std::integral_constant<int, (int)(16 / sizeof(T))>());
    case 8:
      return launch(std::integral_constant<int, (int)(8 / sizeof(T))>());
    case 4:
      return launch(std::integral_constant<int, (int)(4 / sizeof(T))>());
    case 2:
      if constexpr (sizeof(T) == 2) return launch(std::integral_constant<int, 1>());
      [[fallthrough]];
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace msda
