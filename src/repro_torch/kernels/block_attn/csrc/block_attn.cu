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

template <int kHD>
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

template <int kHD>
int launch(const Args& a, int batch, void* stream) {
  const size_t bytes = smem_bytes(kHD);
  cudaError_t err = cudaFuncSetAttribute(
      block_attn_kernel<kHD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(block_attn_kernel<kHD>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(batch * a.heads, (a.lq + kQTile - 1) / kQTile);
  block_attn_kernel<kHD><<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int padded_hd(int hd) { return hd <= 16 ? 16 : hd <= 32 ? 32 : hd <= 64 ? 64 : 128; }

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

// Dynamic shared memory one launch asks for, in bytes.
extern "C" long long block_attn_smem_bytes(int hd) {
  return static_cast<long long>(smem_bytes(padded_hd(hd)));
}

// Returns the cudaError_t of cudaFuncSetAttribute or of the launch (0 =
// success); never synchronises. Strides are in elements, (batch, seq, head)
// for each operand; the head dimension's stride is 1. hd <= 128, H % KV == 0,
// at most 65,535 query tiles of 128 rows.
extern "C" int block_attn(const float* q, const float* k, const float* v,
                          float* o, long long sq0, long long sq1, long long sq2,
                          long long sk0, long long sk1, long long sk2,
                          long long sv0, long long sv1, long long sv2,
                          long long so0, long long so1, long long so2,
                          int batch, int heads, int kv_heads, int lq, int lk,
                          int hd, int causal, int window, float scale,
                          void* stream) {
  if (hd < 1 || hd > 128 || kv_heads < 1 || heads % kv_heads != 0 ||
      (lq + kQTile - 1) / kQTile > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || heads == 0 || lq == 0) return 0;
  Args a;
  a.q = q; a.k = k; a.v = v; a.o = o;
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
    case 16: return launch<16>(a, batch, stream);
    case 32: return launch<32>(a, batch, stream);
    case 64: return launch<64>(a, batch, stream);
    default: return launch<128>(a, batch, stream);
  }
}
