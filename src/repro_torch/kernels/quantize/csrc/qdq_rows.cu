// Fused stochastic quantize -> dequantize over a (R, 128) payload with
// per-row (s, norm) operands and an in-register counter RNG: the QDFedRW
// wire round trip Q^-1(Q(w)) of paper Eq. 12-14, for sm_90a.
//
// Replaces the two Pallas TPU kernels on the flat round engine's path:
//   qdq_delta_rows_rng  <- src/repro/kernels/quantize/quantize.py:156
//                          `_qdq_delta_rows_rng_kernel` (Eq. 13 hop hand-off,
//                          out = base + deq(Q(w)))
//   qdq_rows_rng        <- src/repro/kernels/quantize/quantize.py:171
//                          `_qdq_rows_rng_kernel` (Eq. 14 aggregation payload,
//                          out = deq(Q(w)))
//
// Bound: memory. Per element the kernel reads w (and base) once and writes
// the float result once, plus one (s, norm) pair per 128-element row; the
// arithmetic is ~40 integer and float operations per element, far below the
// card's rate. So the design keeps everything else out of memory:
//   * one pass; each thread owns 4 contiguous elements of one row and moves
//     them as float4 (the wrapper guarantees 16-byte alignment);
//   * the uniforms come from a murmur3-style hash of the element's global
//     index row*128+col, salted by two 32-bit seed words (`_counter_uniforms`
//     at quantize.py:131), so no uniforms operand is read;
//   * the int8 grid index never reaches memory;
//   * the result is written in place over w, as the TPU kernel aliases its
//     payload to its output (quantize.py:274): the caller's diff payload is a
//     temporary it hands over.
//
// Bit-exactness against the reference hangs on two things this file pins:
//   * IEEE division for x = |w|/safe and q = x/s (no fast-math, no
//     __fdividef): an approximate quotient moves floor() across grid lines;
//   * the base fusion is one FMA, __fmaf_rn(idx*sgn*s, norm, base), as XLA
//     contracts base + idx*sign*s*norm; the other products are __fmul_rn so
//     the compiler contracts nothing else.
#include <cstdint>
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

template <bool kDelta>
__device__ __forceinline__ float qdq_one(float w, float base, uint32_t e,
                                         uint32_t seed0, uint32_t seed1,
                                         float s, float norm, float safe,
                                         float levels) {
  const float x = fabsf(w) / safe;
  const float q = x / s;
  const float ell = floorf(q);
  const float phi = q - ell;
  const float u = counter_uniform(e, seed0, seed1);
  float idx = ell + (u < phi ? 1.0f : 0.0f);
  idx = fminf(fmaxf(idx, 0.0f), levels);
  const float sgn = w > 0.0f ? 1.0f : (w < 0.0f ? -1.0f : 0.0f);
  const float t = __fmul_rn(__fmul_rn(idx, sgn), s);
  return kDelta ? __fmaf_rn(t, norm, base) : __fmul_rn(t, norm);
}

template <bool kDelta>
__global__ void __launch_bounds__(kThreads)
qdq_rows_rng_kernel(float* __restrict__ w, const float* __restrict__ base,
                    const float* __restrict__ s_rows,
                    const float* __restrict__ norm_rows, long long n_vec4,
                    uint32_t seed0, uint32_t seed1, float levels) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_vec4) return;
  const long long row = i / (kLanes / 4);
  const float s = s_rows[row];
  const float norm = norm_rows[row];
  const float safe = norm > 0.0f ? norm : 1.0f;
  float4 v = reinterpret_cast<const float4*>(w)[i];
  float4 b = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (kDelta) b = reinterpret_cast<const float4*>(base)[i];
  // Global element index; uint32 wraparound as in the reference hash.
  const uint32_t e = static_cast<uint32_t>(i * 4);
  v.x = qdq_one<kDelta>(v.x, b.x, e + 0u, seed0, seed1, s, norm, safe, levels);
  v.y = qdq_one<kDelta>(v.y, b.y, e + 1u, seed0, seed1, s, norm, safe, levels);
  v.z = qdq_one<kDelta>(v.z, b.z, e + 2u, seed0, seed1, s, norm, safe, levels);
  v.w = qdq_one<kDelta>(v.w, b.w, e + 3u, seed0, seed1, s, norm, safe, levels);
  reinterpret_cast<float4*>(w)[i] = v;
}

template <bool kDelta>
int launch(float* w, const float* base, const float* s_rows,
           const float* norm_rows, long long rows, uint32_t seed0,
           uint32_t seed1, int levels, void* stream) {
  const long long n_vec4 = rows * (kLanes / 4);
  const long long blocks = (n_vec4 + kThreads - 1) / kThreads;
  if (blocks > 0) {
    qdq_rows_rng_kernel<kDelta>
        <<<static_cast<unsigned>(blocks), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
            w, base, s_rows, norm_rows, n_vec4, seed0, seed1,
            static_cast<float>(levels));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Both entry points return the cudaError_t of the launch (0 = success) and
// never synchronise. `levels` is (1 << (bits - 1)) - 1, as quantize.py:246.
extern "C" int qdq_delta_rows_rng(float* w, const float* base,
                                  const float* s_rows, const float* norm_rows,
                                  long long rows, uint32_t seed0,
                                  uint32_t seed1, int levels, void* stream) {
  return launch<true>(w, base, s_rows, norm_rows, rows, seed0, seed1, levels,
                      stream);
}

extern "C" int qdq_rows_rng(float* w, const float* s_rows,
                            const float* norm_rows, long long rows,
                            uint32_t seed0, uint32_t seed1, int levels,
                            void* stream) {
  return launch<false>(w, nullptr, s_rows, norm_rows, rows, seed0, seed1,
                       levels, stream);
}
