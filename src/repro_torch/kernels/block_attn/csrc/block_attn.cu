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
// forward wrote. With D_i = rowsum(dO_i o O_i), dP = dO V^T and
// dS = P o (dP - D):
//   dV_j = sum_i P_ij dO_i,  dK_j = scale sum_i dS_ij q_i,  dQ_i = scale sum_j dS_ij k_j.
//   * attn_bwd_dot: D_i once a row, and lse_i log2(e), into a (B, H, Lq, 2)
//     float32 scratch: one warp a row, coalesced float32 FMAs (a row's dot
//     product, 2 hd FLOP; no matrix product).
//   * attn_bwd_dkdvq: one block per (b, KV head, key tile of kFix rows)
//     keeps its K and V tile in shared memory and streams 32-row tiles of
//     Q and dO of every query head of its group that reach the keys
//     (causal: from the tile's diagonal on; window: up to the last key +
//     window) through a 2-stage cp.async ring, each with its rows' (lse
//     log2(e), D). Warp w owns key rows 16w .. 16w + 15: S^T = K Q^T and
//     dP^T = V dO^T put the keys in the accumulators' M rows, so P^T and
//     dS^T = P^T o (dP^T - D) sit in the accumulator layout and are the A
//     operands of dV += P^T dO and dK += dS^T Q as they stand (the
//     forward's k-index permutation: k-index t is column 2t, t + 4 is
//     2t + 1, and the B operand's rows are read at 2t and 2t + 1). dK and
//     dV sum over the H/KV heads of the group inside the block, in a fixed
//     order. dS^T also goes to shared memory, and after a barrier the warps
//     compute the tile's dQ = dS K over the block's keys (each warp 16 rows
//     by kHD / 8 / (kWarps / 2) n-tiles) and add it to dq with float32
//     atomics (a float2 a lane where dq's rows allow).
//   dQ by atomics, FlashAttention-2's own choice, computes the five
//   products the function needs. A deterministic pair (this kernel without
//   dQ, and a dq kernel of its own that recomputes S and dP from the query
//   side, seven products) took 19.8 ms at Yi-6B's layer 0 against 15.1 ms
//   for this kernel, and 0.71-0.72 against 0.52 ms at Seamless's encoder
//   and cross shapes (chip_smoke.py (g), H100 at 700 W). The
//   order of dq's adds varies from run to run: dq differs between runs by
//   float32 rounding, ~1e-7 of its magnitude, which GRAD_TOL (2e-4 of each
//   gradient's largest magnitude) covers; dK and dV are deterministic.
// Every product runs on mma.sync m16n8k8 with the forward's 3xTF32 split
// (SplitA for A operands; split_b, small unrounded, for B operands):
// float32-level error. dK and dV add each query tile's products, summed in
// a zeroed accumulator, with one float32 add (accumulate). The mask is
// the forward's, element by element on the tiles that cross an edge
// (diagonal, window, Lq, Lk); a row that attends no key has lse = -inf and
// P = 0, so its dQ is 0 and it adds nothing to dK and dV (never NaN).
//
// Shared tiles are swizzled: row r keeps its 16-byte group q at q ^ swz(r),
// with a row stride that is a multiple of 32 floats. Each tile is read in
// three patterns, 16-byte loads at (row g, columns 4t..4t + 3) for the
// score products' operands, scalar loads at (rows 2t and 2t + 1, column g)
// for dV's and dK's B operands and at (rows t and t + 4, column g) for
// dQ's; the swizzle keeps all three free of bank conflicts, where one
// padded stride serves only one of them. hd is padded to hd_p = 16, 32, 64
// or 128 (zeros); rows of 16 and 32 floats take a 32-float stride. The dS
// tile has a row stride of kFix + 4 (4 mod 32), so its (g, t) reads and
// the accumulator-layout writes are conflict-free.
//
// Tiles: at hd 128, 8 warps and 128-key tiles (214,016 B of shared
// memory, one block an SM; 128 accumulator floats a thread for dK and
// dV); at hd <= 64, 4 warps and 64-key tiles (74,752 B at hd 64). Key
// tiles run heaviest first when causal (the first reach the most queries).
//
// Bound: operations. Five products of 2 hd FLOP per allowed (i, j) pair
// (S, dP, dV, dK, dQ): 2.5 x the forward's count, 687,362,539,520 FLOP at
// Yi-6B's layer 0; at 3 passes of the dense TF32 rate, 4.168 ms (float32
// SIMT 10.26 ms; bytes 0.18 ms). What holds it below: as the forward,
// each B value is split where it is read (3 instructions beside 3 MMAs),
// mma.sync does not reach the dense TF32 rate (only wgmma does), and one
// block of 8 warps an SM at hd 128 (registers and shared memory) leaves
// little to hide the latency of two barriers a query tile.
struct BwdArgs {
  const float *q, *k, *v, *o, *dout, *lse;  // lse (B, H, Lq) contiguous
  float *dq, *dk, *dv;
  float* rows;  // scratch (B, H, Lq, 2): lse log2(e), D
  long long sq[3], sk[3], sv[3], so[3], sdo[3], sdq[3], sdk[3], sdv[3];
  int batch, heads, heads_per_group, lq, lk, hd, causal, window, vec16;
  int dq8;  // dq's rows take float2 atomics (8-byte aligned pairs)
  float scale, scale_log2;
};

// x = big + small for a B operand: big = rna(x); small = x - big (exact)
// goes to the tensor core as it is, which reads a .tf32 operand's top 19
// bits, so it enters truncated: within 2^-10 |small| <= 2^-21 |x|, as
// csrc/ssd_scan.cu splits. Three instructions a value where rounding small
// too takes five; B values are split where they are read, A values once
// for several n-tiles (SplitA, rounded).
__device__ __forceinline__ void split_b(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = __float_as_uint(x - __uint_as_float(big));
}

// d += a b in 3xTF32 for a split A fragment and a B fragment (b0, b1).
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&big)[4],
                                     const uint32_t (&small)[4], float b0, float b1) {
  uint32_t bb0, bs0, bb1, bs1;
  split_b(b0, bb0, bs0);
  split_b(b1, bb1, bs1);
  mma_tf32(d, small, bb0, bb1);
  mma_tf32(d, big, bs0, bs1);
  mma_tf32(d, big, bb0, bb1);
}

__device__ __forceinline__ bool allowed(const BwdArgs& a, int i, int j) {
  return i < a.lq && j < a.lk && (!a.causal || j <= i) && (a.window <= 0 || i - j < a.window);
}

__device__ __forceinline__ void cp_async8(float* dst, const float* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(src),
               "r"(bytes));
}

// The swizzle of row r: 16-byte group q of the row is kept at q ^ swz(r).
// Rows 2m and 2m + 1 differ in bit 2 (16-byte loads of rows g and g + 1 hit
// the two halves of the banks); rows 0, 2, 4, 6 (and 1, 3, 5, 7) differ in
// bits 1-2 (scalar loads of rows 2t at columns g hit 32 banks).
__device__ __forceinline__ int swz(int r) { return (((r >> 1) & 3) << 1) ^ ((r & 1) << 2); }

// The offset of column c in a row whose swizzle is s.
__device__ __forceinline__ int sw_col(int c, int s) { return (((c >> 2) ^ s) << 2) | (c & 3); }

// Rows [r0, r0 + rows) of a (len, hd) operand with row stride `stride` into
// a swizzled (rows, kLd) tile by cp.async; zero past len and past hd (up to
// kHD). The source of a zero-filled copy is clamped to a valid element.
template <int kHD, int kLd, int kThreads>
__device__ __forceinline__ void load_swz(float* tile, const float* src, long long stride,
                                         int r0, int rows, int len, int hd, bool vec16) {
  if (vec16) {
    constexpr int kChunks = kHD / 4;
    for (int i = threadIdx.x; i < rows * kChunks; i += kThreads) {
      const int r = i / kChunks, c = (i % kChunks) * 4;
      const bool ok = r0 + r < len && c < hd;
      const long long rr = max(0, min(r0 + r, len - 1));
      cp_async16(tile + r * kLd + sw_col(c, swz(r)), src + rr * stride + min(c, hd - 4),
                 ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < rows * kHD; i += kThreads) {
      const int r = i / kHD, c = i % kHD;
      const bool ok = r0 + r < len && c < hd;
      const long long rr = max(0, min(r0 + r, len - 1));
      cp_async4(tile + r * kLd + sw_col(c, swz(r)), src + rr * stride + min(c, hd - 1),
                ok ? 4 : 0);
    }
  }
}

// 16 bytes of row `row` (swizzle s) at column c, a multiple of 4.
template <int kLd>
__device__ __forceinline__ float4 ld4(const float* tile, int row, int c, int s) {
  return *reinterpret_cast<const float4*>(tile + row * kLd + sw_col(c, s));
}

// acc[j] += A B^T over kHD columns for the warp's 16 rows of `fix` (rows
// fr, fr + 8, swizzle sg) against the 8 rows 8j + g of `str`: the score
// products, two k-steps a 16-column chunk as in the forward.
template <int kHD, int kLd, int kNT>
__device__ __forceinline__ void scores(float (&acc)[kNT][4], const float* fix, int fr,
                                       const float* str, int g, int t, int sg) {
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
#pragma unroll
  for (int c = 0; c < kHD; c += 16) {
    const float4 lo = ld4<kLd>(fix, fr, c + 4 * t, sg);
    const float4 hi = ld4<kLd>(fix, fr + 8, c + 4 * t, sg);
    const float f0[4] = {lo.x, hi.x, lo.y, hi.y}, f1[4] = {lo.z, hi.z, lo.w, hi.w};
    const SplitA a_even(f0), a_odd(f1);
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const float4 b = ld4<kLd>(str, 8 * j + g, c + 4 * t, sg);
      mma3(acc[j], a_even.big, a_even.small, b.x, b.y);
      mma3(acc[j], a_odd.big, a_odd.small, b.z, b.w);
    }
  }
}

// out[j] += X B over the kKN k-steps of X, a 16 x (8 kKN) score tile in the
// accumulator layout, against B = rows [0, 8 kKN) of `str` (swizzled), hd
// columns 8j + g: k-index t of step kk is row 8kk + 2t, t + 4 is 8kk + 2t + 1.
// Each n-tile's products over this tile are summed in a zeroed accumulator
// and added to out[j] with one float32 add: carried in the accumulator
// itself over every query row of a group (dK and dV sum 32,768 at Yi-6B's
// layer 0), the tensor core's float32 sums drifted 2.1e-4 of dK's largest
// magnitude from autograd through the plain version.
template <int kKN, int kN, int kLd>
__device__ __forceinline__ void accumulate(float (&out)[kN][4], const float (&x)[kKN][4],
                                           const float* str, int g, int t) {
  const int s0 = swz(2 * t), s1 = swz(2 * t + 1);
  uint32_t big[kKN][4], small[kKN][4];
#pragma unroll
  for (int kk = 0; kk < kKN; ++kk) {
    const float xf[4] = {x[kk][0], x[kk][2], x[kk][1], x[kk][3]};
#pragma unroll
    for (int i = 0; i < 4; ++i) split(xf[i], big[kk][i], small[kk][i]);
  }
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int kk = 0; kk < kKN; ++kk) {
      const float* r0 = str + (8 * kk + 2 * t) * kLd;
      mma3(part, big[kk], small[kk], r0[sw_col(8 * j + g, s0)],
           r0[kLd + sw_col(8 * j + g, s1)]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) out[j][e] += part[e];
  }
}

__global__ void __launch_bounds__(256) attn_bwd_dot_kernel(BwdArgs a) {
  const long long row = blockIdx.x * 8LL + threadIdx.x / 32;  // (b, h, i), i fastest
  const int lane = threadIdx.x % 32;
  if (row >= static_cast<long long>(a.batch) * a.heads * a.lq) return;
  const int i = static_cast<int>(row % a.lq);
  const long long bh = row / a.lq;
  const int h = static_cast<int>(bh % a.heads), bi = static_cast<int>(bh / a.heads);
  const float* op = a.o + bi * a.so[0] + i * a.so[1] + h * a.so[2];
  const float* dp = a.dout + bi * a.sdo[0] + i * a.sdo[1] + h * a.sdo[2];
  float acc = 0.0f;
  for (int c = lane; c < a.hd; c += 32) acc = fmaf(dp[c], op[c], acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    a.rows[2 * row] = a.lse[row] * kLog2e;  // -inf stays -inf
    a.rows[2 * row + 1] = acc;
  }
}

template <int kHD>
struct BwdShape {
  static constexpr int kWarps = kHD == 128 ? 8 : 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kFix = 16 * kWarps;          // keys of a block
  static constexpr int kStr = 32;                   // query rows of a streamed tile
  static constexpr int kLd = kHD < 32 ? 32 : kHD;   // row stride in floats, swizzled
  static constexpr int kLdS = kFix + 4;             // row stride of the dS tile
  static constexpr int kStage = 2 * kStr * kLd + 2 * kStr;  // Q, dO, (lse2, D) a row
  static constexpr size_t kSmem =
      (static_cast<size_t>(2) * kFix * kLd + static_cast<size_t>(kStages) * kStage +
       static_cast<size_t>(kStr) * kLdS) * sizeof(float);
};

template <int kHD>
__global__ void __launch_bounds__(BwdShape<kHD>::kThreads, 1) attn_bwd_dkdvq_kernel(BwdArgs a) {
  using Sh = BwdShape<kHD>;
  constexpr int kLd = Sh::kLd, kFix = Sh::kFix, kStr = Sh::kStr, kThr = Sh::kThreads;
  constexpr int kLdS = Sh::kLdS;
  constexpr int kSN = kStr / 8;
  constexpr int kN = kHD / 8;
  constexpr int kMT = kStr / 16, kGroups = Sh::kWarps / kMT, kNPer = kN / kGroups;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = ks + kFix * kLd;
  float* ring = vs + kFix * kLd;
  float* dss = ring + kStages * Sh::kStage;  // (kStr, kLdS): the tile's dS, [query][key]
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4, sg = swz(g);
  const int kv_heads = a.heads / a.heads_per_group;
  const int bi = blockIdx.x / kv_heads, kvh = blockIdx.x % kv_heads;
  const int k0 = blockIdx.y * kFix;
  const bool vec16 = a.vec16 != 0;
  const int k_last = min(k0 + kFix, a.lk) - 1;
  const int i_lo = a.causal ? k0 : 0;
  const int i_hi = a.window > 0 ? min(a.lq, k_last + a.window) : a.lq;
  const int q_first = i_lo / kStr * kStr;
  const int n_q = i_hi > i_lo ? (i_hi - q_first + kStr - 1) / kStr : 0;
  const int steps = a.heads_per_group * n_q;

  auto load_step = [&](int s) {
    if (s < steps) {
      const int h = kvh * a.heads_per_group + s / n_q, q0 = q_first + (s % n_q) * kStr;
      float* dst = ring + (s % kStages) * Sh::kStage;
      load_swz<kHD, kLd, kThr>(dst, a.q + bi * a.sq[0] + h * a.sq[2], a.sq[1], q0, kStr,
                               a.lq, a.hd, vec16);
      load_swz<kHD, kLd, kThr>(dst + kStr * kLd, a.dout + bi * a.sdo[0] + h * a.sdo[2],
                               a.sdo[1], q0, kStr, a.lq, a.hd, vec16);
      float* rd = dst + 2 * kStr * kLd;
      const float* src = a.rows + 2 * (static_cast<long long>(bi) * a.heads + h) * a.lq;
      for (int i = threadIdx.x; i < kStr; i += kThr)
        cp_async8(rd + 2 * i, src + 2 * max(0, min(q0 + i, a.lq - 1)), q0 + i < a.lq ? 8 : 0);
    }
    cp_async_commit();
  };
  load_swz<kHD, kLd, kThr>(ks, a.k + bi * a.sk[0] + kvh * a.sk[2], a.sk[1], k0, kFix, a.lk,
                           a.hd, vec16);
  load_swz<kHD, kLd, kThr>(vs, a.v + bi * a.sv[0] + kvh * a.sv[2], a.sv[1], k0, kFix, a.lk,
                           a.hd, vec16);
  load_step(0);

  float dk[kN][4], dv[kN][4];
#pragma unroll
  for (int j = 0; j < kN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.0f;
  const int fr = 16 * warp + g;
  const int kw0 = k0 + 16 * warp, kw1 = kw0 + 15;
  const int mt = warp % kMT, ng = warp / kMT;
  const int st0 = swz(t), st4 = swz(t + 4);

  for (int s = 0; s < steps; ++s) {
    cp_async_wait<0>();
    __syncthreads();
    load_step(s + 1);
    const int h = kvh * a.heads_per_group + s / n_q, q0 = q_first + (s % n_q) * kStr;
    const bool skip = kw0 >= a.lk || (a.causal && q0 + kStr - 1 < kw0) ||
                      (a.window > 0 && q0 - kw1 >= a.window);
    const bool edge = kw1 >= a.lk || q0 + kStr > a.lq || (a.causal && kw1 > q0) ||
                      (a.window > 0 && q0 + kStr - 1 - kw0 >= a.window);
    const float* qs = ring + (s % kStages) * Sh::kStage;
    const float* dos = qs + kStr * kLd;
    const float* rd = dos + kStr * kLd;
    // S^T = K Q^T and dP^T = V dO^T (keys in rows, queries in columns),
    // then P^T and dS^T in place: column 8n + 2t + (e & 1) is query q0 + that.
    float st[kSN][4], dpt[kSN][4];
    if (!skip) {
      scores<kHD, kLd, kSN>(st, ks, fr, qs, g, t, sg);
      scores<kHD, kLd, kSN>(dpt, vs, fr, dos, g, t, sg);
#pragma unroll
      for (int n = 0; n < kSN; ++n) {
        const float4 ld = *reinterpret_cast<const float4*>(rd + 2 * (8 * n + 2 * t));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float lse2 = e & 1 ? ld.z : ld.x, dd = e & 1 ? ld.w : ld.y;
          bool ok = lse2 != -INFINITY;
          if (edge) ok = ok && allowed(a, q0 + 8 * n + 2 * t + (e & 1), kw0 + g + 8 * (e >> 1));
          const float p = ok ? fast_exp2(fmaf(st[n][e], a.scale_log2, -lse2)) : 0.0f;
          st[n][e] = p;
          dpt[n][e] = p * (dpt[n][e] - dd);
        }
      }
    }
    // dS^T into dss as [query][key] (zeros from a warp that skips), then
    // dV += P^T dO and dK += dS^T Q.
#pragma unroll
    for (int n = 0; n < kSN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dss[(8 * n + 2 * t + (e & 1)) * kLdS + fr + 8 * (e >> 1)] = skip ? 0.0f : dpt[n][e];
    if (!skip) {
      accumulate<kSN, kN, kLd>(dv, st, dos, g, t);
      accumulate<kSN, kN, kLd>(dk, dpt, qs, g, t);
    }
    __syncthreads();  // dS of every warp in dss
    // dQ of rows q0 + 16 mt .. + 15 of head h, n-tiles ng kNPer ..: dS K over
    // the block's keys, A = dS at (row g, column t), B = K at (rows t and
    // t + 4, column g); added to dq by atomics.
    float part[kNPer][4];
#pragma unroll
    for (int j = 0; j < kNPer; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[j][e] = 0.0f;
#pragma unroll 4
    for (int k = 0; k < kFix; k += 8) {
      const float* da = dss + (16 * mt + g) * kLdS + k + t;
      const float af[4] = {da[0], da[8 * kLdS], da[4], da[8 * kLdS + 4]};
      const SplitA as(af);
      const float* kr0 = ks + (k + t) * kLd;
      const float* kr4 = ks + (k + t + 4) * kLd;
#pragma unroll
      for (int jj = 0; jj < kNPer; ++jj) {
        const int c = 8 * (ng * kNPer + jj) + g;
        mma3(part[jj], as.big, as.small, kr0[sw_col(c, st0)], kr4[sw_col(c, st4)]);
      }
    }
    float* dqp = a.dq + bi * a.sdq[0] + h * a.sdq[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = q0 + 16 * mt + g + 8 * r;
      if (i >= a.lq) continue;
#pragma unroll
      for (int jj = 0; jj < kNPer; ++jj) {
        const int c = 8 * (ng * kNPer + jj) + 2 * t;
        float* dst = dqp + i * a.sdq[1] + c;
        const float x0 = part[jj][2 * r] * a.scale, x1 = part[jj][2 * r + 1] * a.scale;
        if (c + 1 < a.hd && a.dq8) {
          atomicAdd(reinterpret_cast<float2*>(dst), make_float2(x0, x1));
        } else {
          if (c < a.hd) atomicAdd(dst, x0);
          if (c + 1 < a.hd) atomicAdd(dst + 1, x1);
        }
      }
    }
  }

  float* dkp = a.dk + bi * a.sdk[0] + kvh * a.sdk[2];
  float* dvp = a.dv + bi * a.sdv[0] + kvh * a.sdv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = k0 + fr + 8 * r;
    if (j >= a.lk) continue;
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * n + 2 * t + e;
        if (c < a.hd) {
          dkp[j * a.sdk[1] + c] = dk[n][2 * r + e] * a.scale;
          dvp[j * a.sdv[1] + c] = dv[n][2 * r + e];
        }
      }
  }
}

template <typename Kernel>
int launch_bwd(Kernel kernel, dim3 grid, int threads, size_t bytes, const BwdArgs& a,
               void* stream) {
  if (bytes > 0) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, threads, bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of backward kernel `kernel` (0 dot, 1 dkdvq) at
// padded head dim hdp, in bytes.
size_t bwd_smem(int kernel, int hdp) {
  if (kernel == 0) return 0;
  switch (hdp) {
    case 16: return BwdShape<16>::kSmem;
    case 32: return BwdShape<32>::kSmem;
    case 64: return BwdShape<64>::kSmem;
    default: return BwdShape<128>::kSmem;
  }
}

// ptrs: q, k, v, o, dout, lse, dq, dk, dv, rows; strides (batch, seq, head)
// of q, k, v, o, dout, dq, dk, dv; dims: batch, heads, kv_heads, lq, lk, hd,
// causal, window. False when the sizes are not taken.
bool make_bwd_args(BwdArgs& a, void* const* ptrs, const long long* strides, const int* dims,
                   float scale) {
  const int batch = dims[0], heads = dims[1], kv_heads = dims[2];
  if (dims[5] < 1 || dims[5] > 128 || kv_heads < 1 || heads % kv_heads != 0 || batch < 0 ||
      dims[3] < 0 || dims[4] < 1 || (dims[3] + 63) / 64 > 65535 || (dims[4] + 63) / 64 > 65535)
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
  a.rows = static_cast<float*>(ptrs[9]);
  long long* dst[8] = {a.sq, a.sk, a.sv, a.so, a.sdo, a.sdq, a.sdk, a.sdv};
  for (int t = 0; t < 8; ++t)
    for (int i = 0; i < 3; ++i) dst[t][i] = strides[3 * t + i];
  a.batch = batch; a.heads = heads; a.heads_per_group = heads / kv_heads;
  a.lq = dims[3]; a.lk = dims[4]; a.hd = dims[5]; a.causal = dims[6]; a.window = dims[7];
  a.scale = scale;
  a.scale_log2 = scale * kLog2e;
  // 16-byte copies need every row start of q, k, v and dout 16-byte aligned.
  bool vec16 = a.hd % 4 == 0 && aligned16(a.q) && aligned16(a.k) && aligned16(a.v) &&
               aligned16(a.dout);
  const long long* const copied[4] = {a.sq, a.sk, a.sv, a.sdo};
  for (const long long* s : copied)
    for (int i = 0; i < 3; ++i) vec16 = vec16 && s[i] % 4 == 0;
  a.vec16 = vec16 ? 1 : 0;
  bool dq8 = a.hd % 2 == 0 && (reinterpret_cast<uintptr_t>(a.dq) & 7u) == 0;
  for (int i = 0; i < 3; ++i) dq8 = dq8 && a.sdq[i] % 2 == 0;
  a.dq8 = dq8 ? 1 : 0;
  return true;
}

template <int kHD>
int launch_dkdvq(const BwdArgs& a, void* stream) {
  using Sh = BwdShape<kHD>;
  const dim3 grid(a.batch * (a.heads / a.heads_per_group), (a.lk + Sh::kFix - 1) / Sh::kFix);
  return launch_bwd(attn_bwd_dkdvq_kernel<kHD>, grid, Sh::kThreads, Sh::kSmem, a, stream);
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
// attn_bwd_dot, 1 attn_bwd_dkdvq.
extern "C" long long block_attn_bwd_smem_bytes(int kernel, int hd) {
  return static_cast<long long>(bwd_smem(kernel, padded_hd(hd)));
}

// The two backward kernels, launched in this order on the stream of the
// forward; each returns the cudaError_t of cudaFuncSetAttribute or of its
// launch (0 = success) and never synchronises. attn_bwd_dot writes the rows
// scratch (B, H, Lq, 2); attn_bwd_dkdvq writes dK and dV (B, Lk, KV, hd)
// whole and adds dQ into a zeroed, contiguous (B, Lq, H, hd) dq.
extern "C" int block_attn_bwd_dot(void* const* ptrs, const long long* strides, const int* dims,
                                  float scale, void* stream) {
  BwdArgs a;
  if (!make_bwd_args(a, ptrs, strides, dims, scale))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (static_cast<long long>(a.batch) * a.heads * a.lq + 7) / 8;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  return launch_bwd(attn_bwd_dot_kernel, dim3(static_cast<unsigned>(blocks)), 256, 0, a, stream);
}

extern "C" int block_attn_bwd_dkdvq(void* const* ptrs, const long long* strides, const int* dims,
                                    float scale, void* stream) {
  BwdArgs a;
  if (!make_bwd_args(a, ptrs, strides, dims, scale))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.batch == 0) return 0;
  switch (padded_hd(a.hd)) {
    case 16: return launch_dkdvq<16>(a, stream);
    case 32: return launch_dkdvq<32>(a, stream);
    case 64: return launch_dkdvq<64>(a, stream);
    default: return launch_dkdvq<128>(a, stream);
  }
}
