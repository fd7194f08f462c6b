// Stochastic quantization kernels over a (R, 128) payload, for sm_90a: the
// QDFedRW wire round trip Q^-1(Q(w)) of paper Eq. 12-14 and the int8 wire
// format (indices, s, norm) of paper §IV-B.
//
// Replaces the eight Pallas TPU kernels of src/repro/kernels/quantize/
// quantize.py, each by one entry point below:
//   qdq_delta_rows_rng  <- :156 `_qdq_delta_rows_rng_kernel` (Eq. 13 hop
//                          hand-off, out = base + deq(Q(w)), counter RNG)
//   qdq_rows_rng        <- :171 `_qdq_rows_rng_kernel` (Eq. 14 aggregation
//                          payload, out = deq(Q(w)), counter RNG)
//   qdq_delta_rows      <- :115 `_qdq_delta_rows_kernel` (as :156, given u)
//   qdq_rows            <- :99  `_qdq_rows_kernel` (as :171, given u)
//   quantize_rows       <- :81  `_quantize_rows_kernel` (int8 idx*sign(w),
//                          per-row s and norm, given u)
//   dequantize_rows     <- :94  `_dequantize_rows_kernel` (q*s*norm per row)
//   quantize            <- :41  `_quantize_kernel` (int8, one norm, fixed s)
//   dequantize          <- :53  `_dequantize_kernel` (one norm, fixed s)
// The first six share one template over three choices: where u comes from
// (the counter hash or an operand), whether base is added, and what is
// written (float32, bfloat16 or the int8 index). `quantize` is the int8
// instance with one norm and a fixed s; the two dequantize kernels are one
// template over per-row or fixed (s, norm).
//
// Bound: memory. Per element a kernel reads w (and base and u, or the int8
// index) once and writes its result once, plus one (s, norm) pair per
// 128-element row; the arithmetic is at most ~40 integer and float
// operations per element, far below the card's rate. So the design keeps
// everything else out of memory:
//   * one pass; each thread owns 4 contiguous elements of one row, moved as
//     one float4 (a char4 for int8, 8 bytes for bfloat16; the wrapper
//     guarantees the alignment);
//   * the counter-RNG kernels hash the element's global index row*128+col,
//     salted by two 32-bit seed words (`_counter_uniforms` at
//     quantize.py:131), so they read no uniforms operand;
//   * the grid index never reaches memory in the qdq kernels;
//   * a float32 qdq result is written in place over w, as the TPU kernel
//     aliases its payload to its output (quantize.py:274): the caller's
//     diff payload is a temporary it hands over.
//
// Bit-exactness against the reference (its Pallas kernels in interpret mode,
// i.e. as XLA compiles them on the CPU) hangs on what this file pins:
//   * IEEE division for x = |w|/safe and, with a per-row s, q = x/s (no
//     fast-math, no __fdividef): an approximate quotient moves floor()
//     across grid lines;
//   * with the fixed s of `_quantize_kernel`, XLA rewrites x/s into
//     x * (1/s), the reciprocal rounded once in float32: q = __fmul_rn(x, rs)
//     with rs = float32(1) / float32(s) from the host;
//   * the base fusion is one FMA, __fmaf_rn(idx*sgn*s, norm, base), as XLA
//     contracts base + idx*sign*s*norm; the other products are __fmul_rn so
//     the compiler contracts nothing else;
//   * dequantize with a per-row s multiplies (q*s)*norm; with the fixed s,
//     XLA folds the constant into the scalar first: q * (s*norm);
//   * a bfloat16 result is the float32 one rounded once, to nearest even.
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;
constexpr int kThreads = 256;

__device__ __forceinline__ float counter_uniform(uint32_t e, uint32_t seed0,
                                                 uint32_t seed1) {
  uint32_t x = e + seed0;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  x += seed1;
  x ^= x >> 16;
  x *= 0x27D4EB2Fu;
  x ^= x >> 15;
  // 24-bit mantissa resolution: exact in float.
  return __fmul_rn(static_cast<float>(x >> 8), 1.0f / 16777216.0f);
}

// The signed grid index idx*sign(w) as a float (exact: |idx| <= 127).
// kRecip: q = x * s_or_rs (the fixed-s reciprocal); else q = x / s_or_rs.
template <bool kRecip>
__device__ __forceinline__ float signed_index(float w, float u, float s_or_rs,
                                              float safe, float levels) {
  const float x = fabsf(w) / safe;
  const float q = kRecip ? __fmul_rn(x, s_or_rs) : x / s_or_rs;
  const float ell = floorf(q);
  const float phi = q - ell;
  float idx = ell + (u < phi ? 1.0f : 0.0f);
  idx = fminf(fmaxf(idx, 0.0f), levels);
  const float sgn = w > 0.0f ? 1.0f : (w < 0.0f ? -1.0f : 0.0f);
  return __fmul_rn(idx, sgn);
}

__device__ __forceinline__ void store4(float* out, long long i, float4 v) {
  reinterpret_cast<float4*>(out)[i] = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* out, long long i,
                                       float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 packed;
  packed.x = *reinterpret_cast<uint32_t*>(&lo);
  packed.y = *reinterpret_cast<uint32_t*>(&hi);
  reinterpret_cast<uint2*>(out)[i] = packed;
}

__device__ __forceinline__ void store4(int8_t* out, long long i, float4 v) {
  reinterpret_cast<char4*>(out)[i] =
      make_char4(static_cast<signed char>(v.x), static_cast<signed char>(v.y),
                 static_cast<signed char>(v.z), static_cast<signed char>(v.w));
}

// One template for the quantize side. kHashU: uniforms from the counter
// hash, else from the u operand. kDelta: out = base + deq. OutT float or
// __nv_bfloat16: out = deq(Q(w)) (+ base); OutT int8_t: out = idx*sign(w).
// kScalar: one norm at norm_rows[0] and q = x * rs (the fixed-s kernel);
// else per-row s_rows[row], norm_rows[row] and q = x / s.
// `out` may be `w` itself (the float32 in-place case), so neither pointer
// is __restrict__: each thread reads its own four elements before it
// writes them.
template <bool kHashU, bool kDelta, bool kScalar, typename OutT>
__global__ void __launch_bounds__(kThreads)
quantize_rows_kernel(const float* w, const float* __restrict__ base,
                     const float* __restrict__ u,
                     const float* __restrict__ s_rows,
                     const float* __restrict__ norm_rows, float rs,
                     OutT* out, long long n_vec4, uint32_t seed0,
                     uint32_t seed1, float levels) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_vec4) return;
  const long long row = kScalar ? 0 : i / (kLanes / 4);
  const float norm = norm_rows[row];
  const float s = kScalar ? 0.0f : s_rows[row];
  const float safe = norm > 0.0f ? norm : 1.0f;
  const float grid = kScalar ? rs : s;
  const float4 v = reinterpret_cast<const float4*>(w)[i];
  float4 uu;
  if (kHashU) {
    // Global element index; uint32 wraparound as in the reference hash.
    const uint32_t e = static_cast<uint32_t>(i * 4);
    uu = make_float4(counter_uniform(e + 0u, seed0, seed1),
                     counter_uniform(e + 1u, seed0, seed1),
                     counter_uniform(e + 2u, seed0, seed1),
                     counter_uniform(e + 3u, seed0, seed1));
  } else {
    uu = reinterpret_cast<const float4*>(u)[i];
  }
  float4 r = make_float4(signed_index<kScalar>(v.x, uu.x, grid, safe, levels),
                         signed_index<kScalar>(v.y, uu.y, grid, safe, levels),
                         signed_index<kScalar>(v.z, uu.z, grid, safe, levels),
                         signed_index<kScalar>(v.w, uu.w, grid, safe, levels));
  if constexpr (!std::is_same<OutT, int8_t>::value) {
    r = make_float4(__fmul_rn(r.x, s), __fmul_rn(r.y, s), __fmul_rn(r.z, s),
                    __fmul_rn(r.w, s));
    if (kDelta) {
      const float4 b = reinterpret_cast<const float4*>(base)[i];
      r = make_float4(__fmaf_rn(r.x, norm, b.x), __fmaf_rn(r.y, norm, b.y),
                      __fmaf_rn(r.z, norm, b.z), __fmaf_rn(r.w, norm, b.w));
    } else {
      r = make_float4(__fmul_rn(r.x, norm), __fmul_rn(r.y, norm),
                      __fmul_rn(r.z, norm), __fmul_rn(r.w, norm));
    }
  }
  store4(out, i, r);
}

// q * s * norm. kScalar: one norm at norm_rows[0] and the fixed s,
// q * (s*norm); else (q * s_rows[row]) * norm_rows[row].
template <bool kScalar, typename OutT>
__global__ void __launch_bounds__(kThreads)
dequantize_rows_kernel(const int8_t* __restrict__ q,
                       const float* __restrict__ s_rows,
                       const float* __restrict__ norm_rows, float s_fixed,
                       OutT* __restrict__ out, long long n_vec4) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_vec4) return;
  const char4 c = reinterpret_cast<const char4*>(q)[i];
  float4 r = make_float4(static_cast<float>(c.x), static_cast<float>(c.y),
                         static_cast<float>(c.z), static_cast<float>(c.w));
  if (kScalar) {
    const float sn = __fmul_rn(s_fixed, norm_rows[0]);
    r = make_float4(__fmul_rn(r.x, sn), __fmul_rn(r.y, sn),
                    __fmul_rn(r.z, sn), __fmul_rn(r.w, sn));
  } else {
    const long long row = i / (kLanes / 4);
    const float s = s_rows[row];
    const float norm = norm_rows[row];
    r = make_float4(__fmul_rn(__fmul_rn(r.x, s), norm),
                    __fmul_rn(__fmul_rn(r.y, s), norm),
                    __fmul_rn(__fmul_rn(r.z, s), norm),
                    __fmul_rn(__fmul_rn(r.w, s), norm));
  }
  store4(out, i, r);
}

unsigned blocks_for(long long n_vec4) {
  return static_cast<unsigned>((n_vec4 + kThreads - 1) / kThreads);
}

template <bool kHashU, bool kDelta, bool kScalar, typename OutT>
int launch_quantize(const float* w, const float* base, const float* u,
                    const float* s_rows, const float* norm_rows, float rs,
                    void* out, long long rows, uint32_t seed0, uint32_t seed1,
                    int levels, void* stream) {
  const long long n_vec4 = rows * (kLanes / 4);
  if (n_vec4 > 0) {
    quantize_rows_kernel<kHashU, kDelta, kScalar, OutT>
        <<<blocks_for(n_vec4), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
            w, base, u, s_rows, norm_rows, rs, static_cast<OutT*>(out),
            n_vec4, seed0, seed1, static_cast<float>(levels));
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kScalar, typename OutT>
int launch_dequantize(const int8_t* q, const float* s_rows,
                      const float* norm_rows, float s_fixed, void* out,
                      long long rows, void* stream) {
  const long long n_vec4 = rows * (kLanes / 4);
  if (n_vec4 > 0) {
    dequantize_rows_kernel<kScalar, OutT>
        <<<blocks_for(n_vec4), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
            q, s_rows, norm_rows, s_fixed, static_cast<OutT*>(out), n_vec4);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Every entry point returns the cudaError_t of the launch (0 = success) and
// never synchronises. `levels` is (1 << (bits - 1)) - 1, as quantize.py:246;
// `out_bf16` nonzero selects a bfloat16 result, else float32.
extern "C" int qdq_delta_rows_rng(float* w, const float* base,
                                  const float* s_rows, const float* norm_rows,
                                  long long rows, uint32_t seed0,
                                  uint32_t seed1, int levels, void* stream) {
  return launch_quantize<true, true, false, float>(
      w, base, nullptr, s_rows, norm_rows, 0.0f, w, rows, seed0, seed1,
      levels, stream);
}

extern "C" int qdq_rows_rng(float* w, const float* s_rows,
                            const float* norm_rows, long long rows,
                            uint32_t seed0, uint32_t seed1, int levels,
                            void* stream) {
  return launch_quantize<true, false, false, float>(
      w, nullptr, nullptr, s_rows, norm_rows, 0.0f, w, rows, seed0, seed1,
      levels, stream);
}

extern "C" int qdq_delta_rows(const float* w, const float* base,
                              const float* u, const float* s_rows,
                              const float* norm_rows, void* out, int out_bf16,
                              long long rows, int levels, void* stream) {
  return out_bf16
             ? launch_quantize<false, true, false, __nv_bfloat16>(
                   w, base, u, s_rows, norm_rows, 0.0f, out, rows, 0u, 0u,
                   levels, stream)
             : launch_quantize<false, true, false, float>(
                   w, base, u, s_rows, norm_rows, 0.0f, out, rows, 0u, 0u,
                   levels, stream);
}

extern "C" int qdq_rows(const float* w, const float* u, const float* s_rows,
                        const float* norm_rows, void* out, int out_bf16,
                        long long rows, int levels, void* stream) {
  return out_bf16
             ? launch_quantize<false, false, false, __nv_bfloat16>(
                   w, nullptr, u, s_rows, norm_rows, 0.0f, out, rows, 0u, 0u,
                   levels, stream)
             : launch_quantize<false, false, false, float>(
                   w, nullptr, u, s_rows, norm_rows, 0.0f, out, rows, 0u, 0u,
                   levels, stream);
}

extern "C" int quantize_rows(const float* w, const float* u,
                             const float* s_rows, const float* norm_rows,
                             int8_t* out, long long rows, int levels,
                             void* stream) {
  return launch_quantize<false, false, false, int8_t>(
      w, nullptr, u, s_rows, norm_rows, 0.0f, out, rows, 0u, 0u, levels,
      stream);
}

// `norm` points at one float on the card; rs = float32(1) / float32(s).
extern "C" int quantize(const float* w, const float* u, const float* norm,
                        float rs, int8_t* out, long long rows, int levels,
                        void* stream) {
  return launch_quantize<false, false, true, int8_t>(
      w, nullptr, u, nullptr, norm, rs, out, rows, 0u, 0u, levels, stream);
}

extern "C" int dequantize_rows(const int8_t* q, const float* s_rows,
                               const float* norm_rows, void* out,
                               int out_bf16, long long rows, void* stream) {
  return out_bf16 ? launch_dequantize<false, __nv_bfloat16>(
                        q, s_rows, norm_rows, 0.0f, out, rows, stream)
                  : launch_dequantize<false, float>(q, s_rows, norm_rows,
                                                    0.0f, out, rows, stream);
}

// `norm` points at one float on the card; `s` is float32(s).
extern "C" int dequantize(const int8_t* q, const float* norm, float s,
                          void* out, int out_bf16, long long rows,
                          void* stream) {
  return out_bf16 ? launch_dequantize<true, __nv_bfloat16>(
                        q, nullptr, norm, s, out, rows, stream)
                  : launch_dequantize<true, float>(q, nullptr, norm, s, out,
                                                   rows, stream);
}
