// Blockwise softmax attention with an online softmax, float32 in and out,
// on the tensor cores through a 3xTF32 split, for sm_90a.
//
// Replaces the Pallas TPU kernel `_attn_kernel`
// (src/repro/kernels/block_attn/block_attn.py:32). For each batch b, query
// head h and query row i it computes
//   o[b, i, h] = sum_j softmax_j(q[b, i, h] . k[b, j, g] / sqrt(hd)) v[b, j, g]
// over the keys j the mask allows: j <= i when causal (absolute indices, as
// the TPU kernel's iota mask), and i - j < window when window > 0 (the
// model's sliding window, layers.py `_causal_mask`). g = h / (H / KV) is
// the KV head of h (grouped-query attention). With window == 0 this is the
// function `_attn_kernel` computes; the L x L scores never reach memory.
//
// Bound: operations. The function needs 4 hd FLOP per allowed (i, j) pair
// (q.k, then p.v): 274,945,015,808 FLOP at Yi-6B's B = 2, L = 4096, H = 32,
// hd = 128, causal. The split runs three TF32 products for each, so the
// least time is 3 x that at the card's dense TF32 rate of 494.7 TFLOP/s,
// 1.667 ms, against 301,989,888 bytes of q, k, v and o (0.090 ms at
// 3.35 TB/s).
//
// Design:
//   * Grid. One block of 8 warps owns one (b, h, 128-row query tile) and
//     loops over the 64-row K/V tiles itself, from the first tile the
//     window reaches up to the diagonal; tiles above it are never loaded
//     (the TPU kernel's sequential KV grid axis, block_attn.py:46-47).
//     Query tiles run heaviest first, so the short causal blocks fill the
//     tail of the launch. A warp whose 16 rows see none of a tile's keys
//     (above the diagonal, behind the window, past Lq) skips its products;
//     only tiles on an edge (diagonal, window, Lk) test the mask.
//   * Warps and fragments (FlashAttention-2 layout). Warp w owns query rows
//     16w..16w+15 of the tile. Both products run on mma.sync m16n8k8 with
//     TF32 operands and float32 accumulators: S = Q K^T as 8 n-tiles of
//     8 keys (k-steps over hd), O += P V as hd/8 n-tiles (k-steps over the
//     tile's 64 keys). Scores, the (16, hd) accumulator and each row's
//     running max m and partial sum l stay in the accumulator fragments;
//     lane (g, t) = (lane / 4, lane % 4) holds rows g and g + 8, and the
//     row max reduces over the 4 lanes of a quad with two shuffles (l is
//     summed over the quad once, at the end).
//   * P without a barrier and without a shuffle. The accumulator of S holds
//     keys 2t and 2t + 1 of each 8-key n-tile in lane (g, t), while the
//     A operand of the next product wants k-indices t and t + 4. The sum
//     over keys does not care about their order, so k-index t stands for
//     key 2t and k-index t + 4 for key 2t + 1: P's A fragment is
//     {c0, c2, c1, c3} of S's accumulator as it is, and V's B fragment reads
//     rows 2t and 2t + 1 of the tile instead of t and t + 4. The sum over
//     the head dimension in S is permuted the same way, per 16-column chunk
//     (two k-steps): k-indices t and t + 4 are columns 4t and 4t + 1 of the
//     first step, 4t + 2 and 4t + 3 of the second, so a lane loads its Q
//     and K values for both steps with one 16-byte load a row.
//   * 3xTF32 keeps float32 accuracy. Each operand x splits into big =
//     rna(x) and small = rna(x - big) (x - big is exact in float32), rna
//     being cvt.rna.tf32.f32: the magnitude rounded to 10 mantissa bits,
//     ties away from zero. sm_90 has no instruction for that cvt (ptxas
//     emulates it with NaN and infinity tests); for the finite values here
//     an add and a mask give the same bits (`to_tf32`). A product is
//     small.big + big.small + big.big, small terms first, into the one
//     float32 accumulator, as CUTLASS's OpMultiplyAddFastF32. A product of
//     two TF32 values is exact in float32, and the dropped small.small term
//     and the rounding of small are ~2^-22 of |x y|: float32-level, where a
//     single TF32 product errs by ~2^-11 (tests/test_torch_block_attn.py
//     emulates both on the CPU).
//   * Shared memory. The Q tile (128 rows) and a ring of 2 K/V stages (64
//     rows each of K and V), hd padded to hd_p = 16, 32, 64 or 128 (zeros).
//     Row strides: Q and K hd_p rounded up to 32, plus 16 (16 mod 32), so
//     the 8 lanes of a quarter warp that load 16 bytes each (rows g and
//     g + 1, columns 4t) hit 8 distinct 16-byte bank groups; V hd_p + 4
//     (4 mod 8), so the 32 lanes loading V[2t][g] hit 32 distinct banks.
//     Bytes a block: 215,040 at hd = 128 (of the 232,448 a block may take:
//     one block of 8 warps an SM), 116,736 at hd = 64, 67,584 at 32 and
//     59,392 at 16. Q stays in shared memory and its fragments are loaded
//     and split at each k-step, which keeps the registers for the 64-float
//     accumulator at hd = 128.
//   * cp.async ring. The Q tile and each K/V tile arrive by cp.async, one
//     commit group a tile: tile t + 1 is requested right after the barrier
//     that makes tile t visible, so it loads while tile t is computed (one
//     __syncthreads a tile). Rows past Lq or Lk and columns past hd are
//     zero-filled by cp.async's src-size operand (0), with the source
//     address clamped to a valid element and no branch around the copy.
//     Copies are 16-byte cp.async.cg when hd and every stride are
//     multiples of 4 floats and q, k, v are 16-byte aligned, else 4-byte
//     cp.async.ca (for example hd = 18 or a view at an odd offset), decided
//     once a launch.
//   * Masking before the exp. A masked score becomes -inf and its
//     probability is set to 0 by a select, never exponentiated; m starts at
//     -inf and a row that has seen no allowed key rescales by 0, so
//     neither -inf nor a -1e30 sentinel goes through exp. A row that may
//     attend no key writes 0 (the TPU kernel's max(l, 1e-30) guard gives
//     the same). Scores are scaled by scale * log2(e) and exponentiated
//     with ex2.approx (2 ulp).
//   * No repeat, no transposes. K and V are read by group and q, k, v, o by
//     their (batch, seq, head) strides (the last dimension contiguous), so
//     the model hands over (B, L, heads, hd) projections as they are.
//
// What holds it below the bound: mma.sync does not reach the dense TF32
// rate (only wgmma does), and each warp splits every K and V value it
// reads (5 integer and float instructions a value) beside its 3 MMAs.
// Splitting each K/V tile once a block into big and small planes needs
// 32-key tiles and a second barrier a tile to fit in shared memory, and
// was slower in a trial. What a later PR could still do: wgmma (.tf32
// wants both operands K-major, so V transposed in shared memory, and the
// split B operands as planes in shared memory) with a TMA producer warp
// and mbarriers in place of cp.async; K/V shared by the H/KV query heads
// of a group (each K/V tile is read from L2 once per query head today); a
// bf16 path with its own tolerance.
#include <cmath>
#include <cstdint>
#include <initializer_list>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kQTile = 16 * kWarps;  // query rows of a block, 16 a warp
constexpr int kKTile = 64;           // keys of a K/V tile
constexpr int kStages = 2;           // K/V tiles in the cp.async ring
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const float* q;  // (B, Lq, H, hd) by strides sq
  const float* k;  // (B, Lk, KV, hd) by strides sk
  const float* v;  // (B, Lk, KV, hd) by strides sv
  float* o;        // (B, Lq, H, hd) by strides so
  float* lse;      // (B, H, Lq) contiguous, or null: the rows' log-sum-exp
  long long sq[3], sk[3], sv[3], so[3];  // batch, seq, head
  int heads, heads_per_group, lq, lk, hd, causal, window, vec16;
  float scale_log2;  // 1/sqrt(hd) * log2(e)
};

// Row strides of the shared tiles, in floats, both multiples of 4 (16-byte
// rows for cp.async). Q and K: 16 (mod 32), so the 8 lanes of a quarter
// warp that load 16 bytes each (rows g, g + 1, columns 4t) hit 8 distinct
// 16-byte bank groups. V: 4 (mod 8), so the 32 lanes that load V[2t][g]
// (and V[2t + 1][g]) hit 32 distinct banks.
__host__ __device__ constexpr int qk_stride(int hdp) { return (hdp + 31) / 32 * 32 + 16; }
__host__ __device__ constexpr int v_stride(int hdp) { return hdp + 4; }

__host__ __device__ constexpr size_t smem_bytes(int hdp) {
  return (static_cast<size_t>(kQTile + kStages * kKTile) * qk_stride(hdp) +
          static_cast<size_t>(kStages * kKTile) * v_stride(hdp)) * sizeof(float);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits until at most N of this thread's commit groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [r0, r0 + rows) of a (len, hd) operand with row stride `stride` into
// a (rows, kLd) tile by cp.async; zero past len and past hd (up to hd_p). The
// source of a zero-filled copy is clamped to a valid element.
template <int kHD, int kLd>
__device__ __forceinline__ void load_rows(float* tile, const float* src,
                                          long long stride, int r0, int rows,
                                          int len, int hd, bool vec16) {
  if (vec16) {
    constexpr int kChunks = kHD / 4;
    for (int i = threadIdx.x; i < rows * kChunks; i += kThreads) {
      const int r = i / kChunks, c = (i % kChunks) * 4;
      const bool ok = r0 + r < len && c < hd;
      const long long rr = min(r0 + r, len - 1);
      cp_async16(tile + r * kLd + c, src + rr * stride + min(c, hd - 4), ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < rows * kHD; i += kThreads) {
      const int r = i / kHD, c = i % kHD;
      const bool ok = r0 + r < len && c < hd;
      const long long rr = min(r0 + r, len - 1);
      cp_async4(tile + r * kLd + c, src + rr * stride + min(c, hd - 1), ok ? 4 : 0);
    }
  }
}

// cvt.rna.tf32.f32 of a finite x: the magnitude rounded to 10 mantissa
// bits, ties away from zero, as bits. sm_90 has no instruction for that
// cvt (ptxas emulates it with NaN and infinity tests, ~5 instructions);
// for finite values these 2 give the same bits.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = big + small, both TF32 (round to nearest, ties away from zero).
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An A fragment split once into big and small, for several n-tiles:
// mma(d, b0, b1) is d += a b in 3xTF32, small.big, big.small, then big.big.
struct SplitA {
  uint32_t big[4], small[4];
  __device__ __forceinline__ explicit SplitA(const float (&a)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) split(a[i], big[i], small[i]);
  }
  __device__ __forceinline__ void mma(float (&d)[4], float b0, float b1) const {
    uint32_t bb0, bs0, bb1, bs1;
    split(b0, bb0, bs0);
    split(b1, bb1, bs1);
    mma_tf32(d, small, bb0, bb1);
    mma_tf32(d, big, bs0, bs1);
    mma_tf32(d, big, bb0, bb1);
  }
};

// kLse: write each row's log-sum-exp (the training path). A template
// parameter, so the inference path compiles as if the write were not there.
template <int kHD, bool kLse>
__global__ void __launch_bounds__(kThreads, 1) block_attn_kernel(Args a) {
  constexpr int kLdQK = qk_stride(kHD), kLdV = v_stride(kHD);
  constexpr int kN = kHD / 8;     // n-tiles of the output
  constexpr int kKN = kKTile / 8; // n-tiles of S, k-steps of P V
  constexpr int kStage = kKTile * (kLdQK + kLdV);  // floats of one K/V stage
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                   // (kQTile, kLdQK)
  float* kv = qs + kQTile * kLdQK;    // kStages x [K (kKTile, kLdQK), V (kKTile, kLdV)]

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int bi = blockIdx.x / a.heads, h = blockIdx.x % a.heads;
  const int kvh = h / a.heads_per_group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kQTile;  // heaviest first
  const float* qp = a.q + bi * a.sq[0] + h * a.sq[2];
  const float* kp = a.k + bi * a.sk[0] + kvh * a.sk[2];
  const float* vp = a.v + bi * a.sv[0] + kvh * a.sv[2];
  float* op = a.o + bi * a.so[0] + h * a.so[2];
  const bool vec16 = a.vec16 != 0;

  // The key tiles this query tile reaches.
  const int last_row = min(q0 + kQTile, a.lq) - 1;
  int k_end = a.lk;                               // exclusive
  if (a.causal) k_end = min(k_end, last_row + 1);
  int k_begin = 0;
  if (a.window > 0) k_begin = max(0, q0 - a.window + 1);
  const int t_begin = k_begin / kKTile;
  const int t_end = (k_end + kKTile - 1) / kKTile;

  // This warp's rows.
  const int wr0 = q0 + 16 * warp;
  const int wr1 = min(wr0 + 15, a.lq - 1);
  const int row_g = wr0 + g, row_g8 = wr0 + g + 8;

  float acc[kN][4];
#pragma unroll
  for (int j = 0; j < kN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.0f, 0.0f};  // this lane's part of the row sums

  // K/V tile `tile` into its stage of the ring, one commit group a tile
  // (empty past the last tile, so the waits below count alike).
  auto load_kv = [&](int tile) {
    if (tile < t_end) {
      float* dst = kv + ((tile - t_begin) % kStages) * kStage;
      load_rows<kHD, kLdQK>(dst, kp, a.sk[1], tile * kKTile, kKTile, a.lk, a.hd, vec16);
      load_rows<kHD, kLdV>(dst + kKTile * kLdQK, vp, a.sv[1], tile * kKTile, kKTile,
                           a.lk, a.hd, vec16);
    }
    cp_async_commit();
  };
  if (t_begin < t_end) {
    load_rows<kHD, kLdQK>(qs, qp, a.sq[1], q0, kQTile, a.lq, a.hd, vec16);  // with tile 0
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) load_kv(t_begin + i);
  }

  for (int tile = t_begin; tile < t_end; ++tile) {
    const int k0 = tile * kKTile;
    cp_async_wait<kStages - 2>();
    // Tile `tile` is visible to all, and every warp is done with the stage
    // the next copy overwrites (the one tile `tile - 1` used).
    __syncthreads();
    load_kv(tile + kStages - 1);
    const bool skip = wr0 >= a.lq || (a.causal && k0 > wr1) ||
                      (a.window > 0 && wr0 - (k0 + kKTile - 1) >= a.window);
    if (skip) continue;  // warp-uniform
    const bool edge = k0 + kKTile > a.lk || (a.causal && k0 + kKTile - 1 > wr0) ||
                      (a.window > 0 && wr1 - k0 >= a.window);
    const float* ks = kv + ((tile - t_begin) % kStages) * kStage;
    const float* vs = ks + kKTile * kLdQK;

    // S = Q K^T, 16 x kKTile for this warp, two k-steps a 16-column chunk:
    // k-indices t and t + 4 of the first are columns 4t and 4t + 1, of the
    // second 4t + 2 and 4t + 3, so each lane loads 16 bytes of a row.
    float s[kKN][4];
#pragma unroll
    for (int j = 0; j < kKN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
    for (int c = 0; c < kHD; c += 16) {
      const float* qa = qs + (16 * warp + g) * kLdQK + c + 4 * t;
      const float4 lo = *reinterpret_cast<const float4*>(qa);
      const float4 hi = *reinterpret_cast<const float4*>(qa + 8 * kLdQK);
      const float f0[4] = {lo.x, hi.x, lo.y, hi.y}, f1[4] = {lo.z, hi.z, lo.w, hi.w};
      const SplitA q_even(f0), q_odd(f1);
#pragma unroll
      for (int j = 0; j < kKN; ++j) {
        const float4 kb =
            *reinterpret_cast<const float4*>(ks + (8 * j + g) * kLdQK + c + 4 * t);
        q_even.mma(s[j], kb.x, kb.y);
        q_odd.mma(s[j], kb.z, kb.w);
      }
    }

    // Scale, mask, and the online-softmax update of rows g and g + 8.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kKN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * a.scale_log2;
        if (edge) {
          const int row = e < 2 ? row_g : row_g8;
          const int col = k0 + 8 * j + 2 * t + (e & 1);
          const bool ok = col < a.lk && (!a.causal || col <= row) &&
                          (a.window <= 0 || row - col < a.window);
          if (!ok) x = -INFINITY;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      // m == -inf: nothing seen yet, acc and l are 0 and stay so.
      alpha[r] = m[r] == -INFINITY ? 0.0f : fast_exp2(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < kKN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // A masked score (-inf) is never exponentiated; an allowed one is
        // finite and at most m, so m is finite too.
        const float p = s[j][e] == -INFINITY ? 0.0f : fast_exp2(s[j][e] - m[e >> 1]);
        s[j][e] = p;
        l[e >> 1] += p;
      }
#pragma unroll
    for (int j = 0; j < kN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= alpha[e >> 1];

    // O += P V: k-index t is key 2t, k-index t + 4 is key 2t + 1.
#pragma unroll
    for (int kk = 0; kk < kKN; ++kk) {
      const float pf[4] = {s[kk][0], s[kk][2], s[kk][1], s[kk][3]};
      const SplitA psplit(pf);
      const float* vb = vs + (8 * kk + 2 * t) * kLdV + g;
#pragma unroll
      for (int j = 0; j < kN; ++j) psplit.mma(acc[j], vb[8 * j], vb[kLdV + 8 * j]);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r == 0 ? row_g : row_g8;
    if (row >= a.lq) continue;
    // The natural log-sum-exp of the row's scaled scores, for the backward
    // pass: (m + log2 l) ln 2; -inf for a row that may attend no key.
    if (kLse && t == 0)
      a.lse[(static_cast<long long>(bi) * a.heads + h) * a.lq + row] =
          l[r] > 0.0f ? (m[r] + log2f(l[r])) * 0.6931471805599453f : -INFINITY;
    const float inv = l[r] > 0.0f ? 1.0f / l[r] : 0.0f;
#pragma unroll
    for (int j = 0; j < kN; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * t + e;
        if (c < a.hd) op[row * a.so[1] + c] = l[r] > 0.0f ? acc[j][2 * r + e] * inv : 0.0f;
      }
  }
}

template <int kHD, bool kLse>
int launch(const Args& a, int batch, void* stream) {
  const size_t bytes = smem_bytes(kHD);
  cudaError_t err = cudaFuncSetAttribute(
      block_attn_kernel<kHD, kLse>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(block_attn_kernel<kHD, kLse>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(batch * a.heads, (a.lq + kQTile - 1) / kQTile);
  block_attn_kernel<kHD, kLse><<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int padded_hd(int hd) { return hd <= 16 ? 16 : hd <= 32 ? 32 : hd <= 64 ? 64 : 128; }

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }


// ------------------------------------------------------------------ backward
//
// The gradient of the function above, for training: FlashAttention-2's
// backward (Dao 2023, Alg. 2) in two kernels, launched in order, that
// recompute P_ij = exp(scale q_i.k_j - lse_i) from the log-sum-exp the
// forward wrote, and each compute D_i = rowsum(dO_i o O_i) for the rows they
// read. With dP = dO V^T and dS = P o (dP - D):
//   dV_j = sum_i P_ij dO_i,  dK_j = scale sum_i dS_ij q_i,  dQ_i = scale sum_j dS_ij k_j.
//   * attn_bwd_dkdv: one block per (b, KV head, 64-key tile) keeps its K and
//     V tile in shared memory and walks the query heads of its group and
//     the 64-row query tiles that reach the keys (causal: from the key
//     tile's diagonal on; window: up to the last key + window), so dK and
//     dV sum over the H/KV heads of the group inside one block, in a fixed
//     order: no atomics, no repeat.
//   * attn_bwd_dq: one block per (b, query head, 64-row query tile) keeps its
//     Q and dO tile and walks the key tiles its rows reach, as the forward.
// The mask is the forward's, element by element (causal by absolute index,
// window, Lq and Lk ragged); a row that attends no key has lse = -inf and
// P = 0, so its dQ is 0 and it adds nothing to dK and dV.
//
// Bound: operations. Five products of 2 hd FLOP per allowed (i, j) pair
// (S, dP, dV, dK, dQ; the kernels recompute S and dP once more, seven in
// all): 2.5 x the forward's count, 687,362,539,520 FLOP at Yi-6B's layer.
// This first version runs them as plain float32 FMAs (SIMT), 4 x 4 elements
// of a 64 x 64 tile a thread, operands from shared memory with an odd row
// stride (hd_p + 1), so its bound is the card's 67 TFLOP/s float32 rate
// (10.26 ms at Yi-6B's layer), not the tensor cores'; it takes 54.05 ms
// there (chip_smoke.py, H100 at 700 W): two scalar shared-memory loads an
// FMA pair, one block of 8 warps an SM at hd 128. What a later PR could do:
// the forward's 3xTF32 mma.sync fragments for the five products.
constexpr int kBT = 64;          // rows of a backward tile (queries or keys)
constexpr int kBThreads = 256;   // 16 x 16 threads, 4 x 4 elements of a tile each

struct BwdArgs {
  const float *q, *k, *v, *o, *dout, *lse;  // lse (B, H, Lq) contiguous
  float *dq, *dk, *dv;
  long long sq[3], sk[3], sv[3], so[3], sdo[3], sdq[3], sdk[3], sdv[3];
  int heads, heads_per_group, lq, lk, hd, causal, window;
  float scale, scale_log2;
};

__host__ __device__ constexpr size_t bwd_smem_bytes(int hdp, int tiles, bool p_tile) {
  return (static_cast<size_t>(tiles) * kBT * (hdp + 1) +
          static_cast<size_t>(p_tile ? 2 : 1) * kBT * (kBT + 1) + 2 * kBT) * sizeof(float);
}

__device__ __forceinline__ bool allowed(const BwdArgs& a, int i, int j) {
  return i < a.lq && j < a.lk && (!a.causal || j <= i) && (a.window <= 0 || i - j < a.window);
}

// Rows [r0, r0 + 64) of a (len, hd) operand with row stride `stride` into a
// (64, kHD + 1) tile; zero past len and past hd.
template <int kHD>
__device__ __forceinline__ void load_tile(float* tile, const float* src, long long stride,
                                          int r0, int len, int hd) {
  for (int i = threadIdx.x; i < kBT * kHD; i += kBThreads) {
    const int r = i / kHD, c = i % kHD;
    tile[r * (kHD + 1) + c] =
        r0 + r < len && c < hd ? src[static_cast<long long>(r0 + r) * stride + c] : 0.0f;
  }
}

// D_i = sum_c dO_ic O_ic and lse_i log2(e) of the rows [q0, q0 + 64) of one
// (b, h) into d_s and lse_s (-inf past Lq); warp w takes rows w, w + 8, ...
__device__ __forceinline__ void row_terms(const BwdArgs& a, int bi, int h, int q0,
                                          float* d_s, float* lse_s) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const float* op = a.o + bi * a.so[0] + h * a.so[2];
  const float* dp = a.dout + bi * a.sdo[0] + h * a.sdo[2];
  for (int r = warp; r < kBT; r += kBThreads / 32) {
    const int i = q0 + r;
    float acc = 0.0f;
    if (i < a.lq)
      for (int c = lane; c < a.hd; c += 32) acc = fmaf(dp[i * a.sdo[1] + c], op[i * a.so[1] + c], acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      d_s[r] = acc;
      lse_s[r] = i < a.lq
          ? a.lse[(static_cast<long long>(bi) * a.heads + h) * a.lq + i] * kLog2e : -INFINITY;
    }
  }
}

// The (64, 64) tile of queries [q0, q0 + 64) x keys [k0, k0 + 64): thread
// (ty, tx) takes rows ty + 16 m and columns tx + 16 n, and writes P (when
// p_s is not null) and dS = P (dP - D) to [query][key] tiles of row stride 65.
template <int kHD>
__device__ __forceinline__ void score_tile(const BwdArgs& a, const float* qs, const float* dos,
                                           const float* ks, const float* vs,
                                           const float* d_s, const float* lse_s,
                                           int q0, int k0, float* p_s, float* ds_s) {
  constexpr int kLd = kHD + 1;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n) s[m][n] = dp[m][n] = 0.0f;
#pragma unroll 4
  for (int c = 0; c < kHD; ++c) {
    float qa[4], da[4], kb[4], vb[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      qa[m] = qs[(ty + 16 * m) * kLd + c];
      da[m] = dos[(ty + 16 * m) * kLd + c];
      kb[m] = ks[(tx + 16 * m) * kLd + c];
      vb[m] = vs[(tx + 16 * m) * kLd + c];
    }
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        s[m][n] = fmaf(qa[m], kb[n], s[m][n]);
        dp[m][n] = fmaf(da[m], vb[n], dp[m][n]);
      }
  }
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int r = ty + 16 * m, col = tx + 16 * n;
      float p = 0.0f;
      if (allowed(a, q0 + r, k0 + col) && lse_s[r] != -INFINITY)
        p = exp2f(s[m][n] * a.scale_log2 - lse_s[r]);
      if (p_s != nullptr) p_s[r * (kBT + 1) + col] = p;
      ds_s[r * (kBT + 1) + col] = p * (dp[m][n] - d_s[r]);
    }
}

template <int kHD>
__global__ void __launch_bounds__(kBThreads, 1) attn_bwd_dkdv_kernel(BwdArgs a) {
  constexpr int kLd = kHD + 1, kLdP = kBT + 1, kNC = kHD / 16;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = ks + kBT * kLd;
  float* qs = vs + kBT * kLd;
  float* dos = qs + kBT * kLd;
  float* p_s = dos + kBT * kLd;
  float* ds_s = p_s + kBT * kLdP;
  float* d_s = ds_s + kBT * kLdP;
  float* lse_s = d_s + kBT;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int kv_heads = a.heads / a.heads_per_group;
  const int bi = blockIdx.x / kv_heads, kvh = blockIdx.x % kv_heads;
  const int k0 = blockIdx.y * kBT;
  load_tile<kHD>(ks, a.k + bi * a.sk[0] + kvh * a.sk[2], a.sk[1], k0, a.lk, a.hd);
  load_tile<kHD>(vs, a.v + bi * a.sv[0] + kvh * a.sv[2], a.sv[1], k0, a.lk, a.hd);
  float dk[4][kNC], dv[4][kNC];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int n = 0; n < kNC; ++n) dk[m][n] = dv[m][n] = 0.0f;
  // The query rows that reach keys [k0, k_last].
  const int k_last = min(k0 + kBT, a.lk) - 1;
  const int i_lo = a.causal ? k0 : 0;
  const int i_hi = a.window > 0 ? min(a.lq, k_last + a.window) : a.lq;  // exclusive
  for (int r = 0; r < a.heads_per_group; ++r) {
    const int h = kvh * a.heads_per_group + r;
    const float* qp = a.q + bi * a.sq[0] + h * a.sq[2];
    const float* dop = a.dout + bi * a.sdo[0] + h * a.sdo[2];
    for (int q0 = i_lo / kBT * kBT; q0 < i_hi; q0 += kBT) {
      __syncthreads();  // every thread is done with the last tile's qs, dos, p_s, ds_s
      load_tile<kHD>(qs, qp, a.sq[1], q0, a.lq, a.hd);
      load_tile<kHD>(dos, dop, a.sdo[1], q0, a.lq, a.hd);
      row_terms(a, bi, h, q0, d_s, lse_s);
      __syncthreads();
      score_tile<kHD>(a, qs, dos, ks, vs, d_s, lse_s, q0, k0, p_s, ds_s);
      __syncthreads();
      // Key rows ty + 16 m, columns tx + 16 n.
#pragma unroll 4
      for (int i = 0; i < kBT; ++i) {
        float pv[4], sv[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          pv[m] = p_s[i * kLdP + ty + 16 * m];
          sv[m] = ds_s[i * kLdP + ty + 16 * m];
        }
#pragma unroll
        for (int n = 0; n < kNC; ++n) {
          const float dov = dos[i * kLd + tx + 16 * n], qv = qs[i * kLd + tx + 16 * n];
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            dv[m][n] = fmaf(pv[m], dov, dv[m][n]);
            dk[m][n] = fmaf(sv[m], qv, dk[m][n]);
          }
        }
      }
    }
  }
  float* dkp = a.dk + bi * a.sdk[0] + kvh * a.sdk[2];
  float* dvp = a.dv + bi * a.sdv[0] + kvh * a.sdv[2];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int j = k0 + ty + 16 * m;
    if (j >= a.lk) continue;
#pragma unroll
    for (int n = 0; n < kNC; ++n) {
      const int c = tx + 16 * n;
      if (c < a.hd) {
        dkp[j * a.sdk[1] + c] = dk[m][n] * a.scale;
        dvp[j * a.sdv[1] + c] = dv[m][n];
      }
    }
  }
}

template <int kHD>
__global__ void __launch_bounds__(kBThreads, 1) attn_bwd_dq_kernel(BwdArgs a) {
  constexpr int kLd = kHD + 1, kLdP = kBT + 1, kNC = kHD / 16;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* dos = qs + kBT * kLd;
  float* ks = dos + kBT * kLd;
  float* vs = ks + kBT * kLd;
  float* ds_s = vs + kBT * kLd;
  float* d_s = ds_s + kBT * kLdP;
  float* lse_s = d_s + kBT;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int bi = blockIdx.x / a.heads, h = blockIdx.x % a.heads;
  const int kvh = h / a.heads_per_group;
  const int q0 = blockIdx.y * kBT;
  load_tile<kHD>(qs, a.q + bi * a.sq[0] + h * a.sq[2], a.sq[1], q0, a.lq, a.hd);
  load_tile<kHD>(dos, a.dout + bi * a.sdo[0] + h * a.sdo[2], a.sdo[1], q0, a.lq, a.hd);
  row_terms(a, bi, h, q0, d_s, lse_s);
  const float* kp = a.k + bi * a.sk[0] + kvh * a.sk[2];
  const float* vp = a.v + bi * a.sv[0] + kvh * a.sv[2];
  float dq[4][kNC];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int n = 0; n < kNC; ++n) dq[m][n] = 0.0f;
  // The keys rows [q0, q_last] reach.
  const int q_last = min(q0 + kBT, a.lq) - 1;
  const int j_hi = a.causal ? min(a.lk, q_last + 1) : a.lk;  // exclusive
  const int j_lo = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  for (int k0 = j_lo / kBT * kBT; k0 < j_hi; k0 += kBT) {
    __syncthreads();  // every thread is done with the last tile's ks, ds_s
    load_tile<kHD>(ks, kp, a.sk[1], k0, a.lk, a.hd);
    load_tile<kHD>(vs, vp, a.sv[1], k0, a.lk, a.hd);
    __syncthreads();
    score_tile<kHD>(a, qs, dos, ks, vs, d_s, lse_s, q0, k0, nullptr, ds_s);
    __syncthreads();
    // Query rows ty + 16 m, columns tx + 16 n.
#pragma unroll 4
    for (int j = 0; j < kBT; ++j) {
      float sv[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) sv[m] = ds_s[(ty + 16 * m) * kLdP + j];
#pragma unroll
      for (int n = 0; n < kNC; ++n) {
        const float kv = ks[j * kLd + tx + 16 * n];
#pragma unroll
        for (int m = 0; m < 4; ++m) dq[m][n] = fmaf(sv[m], kv, dq[m][n]);
      }
    }
  }
  float* dqp = a.dq + bi * a.sdq[0] + h * a.sdq[2];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int i = q0 + ty + 16 * m;
    if (i >= a.lq) continue;
#pragma unroll
    for (int n = 0; n < kNC; ++n) {
      const int c = tx + 16 * n;
      if (c < a.hd) dqp[i * a.sdq[1] + c] = dq[m][n] * a.scale;
    }
  }
}

template <typename Kernel>
int launch_bwd(Kernel kernel, dim3 grid, size_t bytes, const BwdArgs& a, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kBThreads, bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ptrs: q, k, v, o, dout, lse, dq, dk, dv; strides (batch, seq, head) of
// q, k, v, o, dout, dq, dk, dv; dims: batch, heads, kv_heads, lq, lk, hd,
// causal, window. False when the sizes are not taken.
bool make_bwd_args(BwdArgs& a, int& batch, void* const* ptrs, const long long* strides,
                   const int* dims, float scale) {
  batch = dims[0];
  const int heads = dims[1], kv_heads = dims[2];
  if (dims[5] < 1 || dims[5] > 128 || kv_heads < 1 || heads % kv_heads != 0 || batch < 0 ||
      dims[3] < 0 || dims[4] < 1 || (dims[3] + kBT - 1) / kBT > 65535 ||
      (dims[4] + kBT - 1) / kBT > 65535)
    return false;
  a.q = static_cast<const float*>(ptrs[0]);
  a.k = static_cast<const float*>(ptrs[1]);
  a.v = static_cast<const float*>(ptrs[2]);
  a.o = static_cast<const float*>(ptrs[3]);
  a.dout = static_cast<const float*>(ptrs[4]);
  a.lse = static_cast<const float*>(ptrs[5]);
  a.dq = static_cast<float*>(ptrs[6]);
  a.dk = static_cast<float*>(ptrs[7]);
  a.dv = static_cast<float*>(ptrs[8]);
  long long* dst[8] = {a.sq, a.sk, a.sv, a.so, a.sdo, a.sdq, a.sdk, a.sdv};
  for (int t = 0; t < 8; ++t)
    for (int i = 0; i < 3; ++i) dst[t][i] = strides[3 * t + i];
  a.heads = heads; a.heads_per_group = heads / kv_heads;
  a.lq = dims[3]; a.lk = dims[4]; a.hd = dims[5]; a.causal = dims[6]; a.window = dims[7];
  a.scale = scale;
  a.scale_log2 = scale * kLog2e;
  return true;
}

}  // namespace

// Dynamic shared memory one launch asks for, in bytes.
extern "C" long long block_attn_smem_bytes(int hd) {
  return static_cast<long long>(smem_bytes(padded_hd(hd)));
}

// Returns the cudaError_t of cudaFuncSetAttribute or of the launch (0 =
// success); never synchronises. Strides are in elements, (batch, seq, head)
// for each operand; the head dimension's stride is 1. hd <= 128, H % KV == 0,
// at most 65,535 query tiles of 128 rows. `lse` (B, H, Lq) receives each
// row's natural log-sum-exp when it is not null (the training path).
extern "C" int block_attn(const float* q, const float* k, const float* v,
                          float* o, long long sq0, long long sq1, long long sq2,
                          long long sk0, long long sk1, long long sk2,
                          long long sv0, long long sv1, long long sv2,
                          long long so0, long long so1, long long so2,
                          int batch, int heads, int kv_heads, int lq, int lk,
                          int hd, int causal, int window, float* lse, float scale,
                          void* stream) {
  if (hd < 1 || hd > 128 || kv_heads < 1 || heads % kv_heads != 0 ||
      (lq + kQTile - 1) / kQTile > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || heads == 0 || lq == 0) return 0;
  Args a;
  a.q = q; a.k = k; a.v = v; a.o = o; a.lse = lse;
  a.sq[0] = sq0; a.sq[1] = sq1; a.sq[2] = sq2;
  a.sk[0] = sk0; a.sk[1] = sk1; a.sk[2] = sk2;
  a.sv[0] = sv0; a.sv[1] = sv1; a.sv[2] = sv2;
  a.so[0] = so0; a.so[1] = so1; a.so[2] = so2;
  a.heads = heads; a.heads_per_group = heads / kv_heads;
  a.lq = lq; a.lk = lk; a.hd = hd; a.causal = causal; a.window = window;
  a.scale_log2 = scale * kLog2e;
  // 16-byte copies need every row start of q, k and v 16-byte aligned.
  bool vec16 = hd % 4 == 0 && aligned16(q) && aligned16(k) && aligned16(v);
  for (long long s : {sq0, sq1, sq2, sk0, sk1, sk2, sv0, sv1, sv2})
    vec16 = vec16 && s % 4 == 0;
  a.vec16 = vec16 ? 1 : 0;
  switch (padded_hd(hd)) {
    case 16: return lse ? launch<16, true>(a, batch, stream) : launch<16, false>(a, batch, stream);
    case 32: return lse ? launch<32, true>(a, batch, stream) : launch<32, false>(a, batch, stream);
    case 64: return lse ? launch<64, true>(a, batch, stream) : launch<64, false>(a, batch, stream);
    default:
      return lse ? launch<128, true>(a, batch, stream) : launch<128, false>(a, batch, stream);
  }
}

// Dynamic shared memory of a backward launch, in bytes: kernel 0 is
// attn_bwd_dkdv, 1 attn_bwd_dq.
extern "C" long long block_attn_bwd_smem_bytes(int kernel, int hd) {
  return static_cast<long long>(bwd_smem_bytes(padded_hd(hd), 4, kernel == 0));
}

// dK and dV (B, Lk, KV, hd), written whole. Launch before or after
// block_attn_bwd_dq, on the stream of the forward; never synchronises.
extern "C" int block_attn_bwd_dkdv(void* const* ptrs, const long long* strides, const int* dims,
                                   float scale, void* stream) {
  BwdArgs a;
  int batch;
  if (!make_bwd_args(a, batch, ptrs, strides, dims, scale))
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  const dim3 grid(batch * (a.heads / a.heads_per_group), (a.lk + kBT - 1) / kBT);
  const int hdp = padded_hd(a.hd);
  const size_t bytes = bwd_smem_bytes(hdp, 4, true);
  switch (hdp) {
    case 16: return launch_bwd(attn_bwd_dkdv_kernel<16>, grid, bytes, a, stream);
    case 32: return launch_bwd(attn_bwd_dkdv_kernel<32>, grid, bytes, a, stream);
    case 64: return launch_bwd(attn_bwd_dkdv_kernel<64>, grid, bytes, a, stream);
    default: return launch_bwd(attn_bwd_dkdv_kernel<128>, grid, bytes, a, stream);
  }
}

// dQ (B, Lq, H, hd), written whole.
extern "C" int block_attn_bwd_dq(void* const* ptrs, const long long* strides, const int* dims,
                                 float scale, void* stream) {
  BwdArgs a;
  int batch;
  if (!make_bwd_args(a, batch, ptrs, strides, dims, scale))
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || a.lq == 0) return 0;
  const dim3 grid(batch * a.heads, (a.lq + kBT - 1) / kBT);
  const int hdp = padded_hd(a.hd);
  const size_t bytes = bwd_smem_bytes(hdp, 4, false);
  switch (hdp) {
    case 16: return launch_bwd(attn_bwd_dq_kernel<16>, grid, bytes, a, stream);
    case 32: return launch_bwd(attn_bwd_dq_kernel<32>, grid, bytes, a, stream);
    case 64: return launch_bwd(attn_bwd_dq_kernel<64>, grid, bytes, a, stream);
    default: return launch_bwd(attn_bwd_dq_kernel<128>, grid, bytes, a, stream);
  }
}
