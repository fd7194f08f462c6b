// Blockwise softmax attention for bf16 q, k, v and o on Hopper's bf16
// tensor cores (wgmma), fed by TMA from a producer warpgroup, for sm_90a.
//
// Replaces the Pallas TPU kernel `_attn_kernel`
// (src/repro/kernels/block_attn/block_attn.py:32) for bf16 operands, as the
// TPU kernel takes them: q, k and v are read as float32 values, the scores,
// the softmax state and p stay float32 (block_attn.py:61, :63), and o is
// rounded once to bf16. For each batch b, query head h and query row i
//   o[b, i, h] = sum_j softmax_j(q[b, i, h] . k[b, j, g] / sqrt(hd)) v[b, j, g]
// over the keys j the mask allows: j <= i when causal (absolute indices),
// i - j < window when window > 0; g = h / (H / KV) is h's KV head.
// csrc/block_attn.cu keeps the float32 kernel and the backward kernels.
//
// Bound: operations or bytes. The function needs 4 hd FLOP per allowed (i, j)
// pair (q.k, then p.v): at the card's dense bf16 rate (989 TFLOP/s) that is
// 0.2780 ms at Yi-6B's layer 0 (B = 2, L = 4096, H = 32, hd = 128, causal;
// 274,945,015,808 FLOP), against 150,994,944 bytes of bf16 q, k, v and o
// (0.0451 ms at 3.35 TB/s). The design issues 6 hd FLOP a pair (Q K^T once,
// P V twice: P's two bf16 halves), 1.5 times the function's, 0.417 ms.
//
// Design:
//   * Grid and roles. One block of three warpgroups owns one (b, h, 128-row
//     query tile), heaviest query tiles first. Warpgroups 0 and 1 compute,
//     64 query rows each; warpgroup 2 is the producer, one thread of which
//     issues every load (the rest exit). Nine or more warps put three on one
//     SM sub-partition, so ptxas caps every thread at 168 registers;
//     setmaxnreg (24 or 40 for the producer, 232 or 240 for the consumers)
//     did not lift that cap in ptxas's allocation and added spills, so the
//     consumers are written to fit 168: 149 at hd 64, 168 at hd 128, no
//     spills (chip_smoke.py prints the report).
//   * TMA. q, k and v are described by 4-D tensor maps (hd, heads, L, B) over
//     their own strides, so the fused-QKV views of the model are read as they
//     are; rows past Lq or Lk and columns past hd are zero-filled by the
//     hardware, and no box reaches into the next head or batch. A box is 64
//     columns (128 bytes, the 128-byte swizzle's width): hd 128 takes two.
//     The Q tile (128 rows) is loaded once; K/V tiles of 64 keys go through a
//     ring of kStages stages, each with a full barrier (the producer's
//     expected bytes, completed by the copies) and an empty barrier (one
//     arrival of each consumer warp when its products have read the stage).
//     The producer loads only the tiles from the first one the window
//     reaches up to the diagonal. The maps are encoded on the host with
//     cuTensorMapEncodeTiled, found through cudaGetDriverEntryPoint (no
//     -lcuda), and passed as __grid_constant__ parameters.
//   * S = Q K^T. wgmma m64n64k16, both operands in shared memory, K-major,
//     128-byte swizzled (the layout TMA writes): hd / 16 products a tile into
//     a zeroed accumulator. A product of two bf16 values is exact in float32.
//     128-key tiles (S m64n128k16) need 64 more registers and spilled.
//   * Online softmax in float32 registers. Each thread holds rows g and g + 8
//     of its warp's 16 (g = lane / 4) and 16 of the tile's 64 keys, in the
//     accumulator layout; the row max of the raw scores reduces over a quad
//     with two shuffles and is scaled by scale * log2(e); each weight is
//     2^(s scale log2(e) - m) by one fma and ex2.approx. A masked score
//     becomes -inf and its weight is selected to 0, never exponentiated; only
//     tiles on an edge (the diagonal, the window, Lk) test the mask; a tile
//     that no row of a warpgroup may see is skipped by that warpgroup. A row
//     with no allowed key writes 0. l sums the float32 weights.
//   * P V as two bf16 halves. P_hi = bf16_rn(P) and P_lo = bf16_rn(P - P_hi)
//     go to the tensor cores as register A operands (wgmma's RS form: S's
//     accumulator layout is the A fragment's) against V in shared memory as
//     an MN-major B operand (the transpose bit; V is never transposed):
//     P_hi + P_lo is P within 2^-18, where one bf16 rounding of P errs by up
//     to 2^-9 of each weight, which beside l summed from float32 weights
//     breaks the 1-bf16-ulp contract (tests/test_torch_block_attn.py, a
//     rounding-biased case: 11 ulps). Each tile's P V is summed in a zeroed
//     accumulator, one 64-column box of V at a time (32 registers), and
//     added to o's float32 sum with one multiply-add a value (a tensor-core
//     accumulator drifts over long sums, ROADMAP.md C).
//
// What holds it below its bound: the 1.5x of the split P V; S at n = 64
// reads both operands from shared memory, 4 KB a 32-cycle product, which is
// all of the SM's 128 bytes a cycle; each consumer warpgroup waits for its
// own products (its softmax overlaps only the other warpgroup's products,
// which the 168-register cap leaves no room to pipeline); the producer loads
// each K/V tile once per query head (the H / KV heads of a group read it
// from L2); and at hd 64 the softmax's instructions match the products'
// tensor-core time.
//
// Operands TMA cannot describe (a base not 16-byte aligned, a stride not a
// multiple of 8 elements, hd not a multiple of 8) are copied by the wrapper
// into padded contiguous tensors first (block_attn.py `tma_takes`,
// BF16_REPACKS); no model path needs that.
#include <cmath>
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kConsumers = 2;                     // warpgroups of 64 query rows
constexpr int kThreads = 128 * (kConsumers + 1);  // and one producer warpgroup
constexpr int kQTile = 64 * kConsumers;           // query rows of a block
constexpr int kKTile = 64;                        // keys of a K/V tile
constexpr int kStages = 4;                        // K/V tiles in the ring
constexpr int kBox = 64;                          // bf16 columns of a TMA box: 128 bytes
constexpr int kRowBytes = 2 * kBox;
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  bf16* o;           // (B, Lq, H, hd) by strides so
  long long so[3];   // batch, seq, head
  int heads, heads_per_group, lq, lk, hd, causal, window;
  float scale_log2;  // 1/sqrt(hd) * log2(e)
};

// Shared memory, in bytes from a 1024-byte aligned base (the 128-byte
// swizzle repeats every 8 rows of 128 bytes): the Q tile, the ring of K/V
// stages, then the barriers. Each 64-column box of a tile is a block of
// rows x 128 bytes.
template <int kHD>
struct Layout {
  static constexpr int kBoxes = kHD / kBox;
  static constexpr int kQBox = kQTile * kRowBytes;
  static constexpr int kKVBox = kKTile * kRowBytes;
  static constexpr int kStage = 2 * kBoxes * kKVBox;  // K boxes, then V boxes
  static constexpr int kRingAt = kBoxes * kQBox;
  static constexpr int kBarsAt = kRingAt + kStages * kStage;  // q_full, full[], empty[]
  static constexpr int kBytes = kBarsAt + 8 * (1 + 2 * kStages);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Waits until the phase of `bar` with this parity has completed. A wait
// that has failed 2^26 times traps (a launch error) rather than hang.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t tries = 0;; ++tries) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == (1u << 26)) __trap();
  }
}

// One box of a 4-D tensor map at (column, head, row, batch) into shared
// memory; its bytes complete a transaction of `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A wgmma shared-memory descriptor of a 128-byte swizzled operand whose
// 8-row groups are 1024 bytes apart (SBO); the leading offset is unused
// (the operand's 64 columns are one swizzle atom wide).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of wgmma's registers across
// the asynchronous product (it sees them change here).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define WGMMA_D32                                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define WGMMA_OUT8(d, i)                                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),               \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define WGMMA_OUT32(d) \
  WGMMA_OUT8(d, 0), WGMMA_OUT8(d, 8), WGMMA_OUT8(d, 16), WGMMA_OUT8(d, 24)

// d (64 x 64 float32 over the warpgroup, 32 a thread) = A B +
// (accumulate ? d : 0), A and B both K-major bf16 in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WGMMA_OUT32(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d = A B + (accumulate ? d : 0), A (64 x 16 bf16) from registers in the
// m16n8k16 fragment layout a warp a 16-row slice, B (16 x 64) MN-major bf16
// in shared memory (the transpose bit: V's rows are keys, its columns hd).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WGMMA_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// (x0, x1) -> bf16x2 of their round-to-nearest values (x0 in the low half),
// and of what that rounding left.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

template <int kHD>
__global__ void __launch_bounds__(kThreads, 1)
    attn_bf16_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const Args a) {
  using L = Layout<kHD>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t q_full = base + L::kBarsAt;
  const uint32_t full0 = q_full + 8, empty0 = full0 + 8 * kStages;

  const int bi = blockIdx.x / a.heads, h = blockIdx.x % a.heads;
  const int kvh = h / a.heads_per_group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kQTile;  // heaviest first
  // The key tiles this query tile reaches.
  const int last_row = min(q0 + kQTile, a.lq) - 1;
  int k_end = a.lk;
  if (a.causal) k_end = min(k_end, last_row + 1);
  const int k_begin = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  const int t_begin = k_begin / kKTile;
  const int t_end = (k_end + kKTile - 1) / kKTile;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4 * kConsumers);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128 * kConsumers) {
    // ------------------------------------------------------------ producer
    if (threadIdx.x == 128 * kConsumers && t_begin < t_end) {
      mbar_expect_tx(q_full, L::kBoxes * L::kQBox);
      for (int cb = 0; cb < L::kBoxes; ++cb)
        tma_load(base + cb * L::kQBox, &tq, q_full, cb * kBox, h, q0, bi);
      for (int tile = t_begin; tile < t_end; ++tile) {
        const int i = tile - t_begin, s = i % kStages;
        mbar_wait(empty0 + 8 * s, ((i / kStages) & 1) ^ 1);  // round 0 passes at once
        const uint32_t full = full0 + 8 * s;
        const uint32_t stage = base + L::kRingAt + s * L::kStage;
        mbar_expect_tx(full, L::kStage);
        for (int cb = 0; cb < L::kBoxes; ++cb) {
          tma_load(stage + cb * L::kKVBox, &tk, full, cb * kBox, kvh, tile * kKTile, bi);
          tma_load(stage + (L::kBoxes + cb) * L::kKVBox, &tv, full, cb * kBox, kvh,
                   tile * kKTile, bi);
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const int wr0 = q0 + 64 * wg;                 // this warpgroup's rows
    const int wr1 = min(wr0 + 63, a.lq - 1);
    const int row_g = wr0 + 16 * warp + g, row_g8 = row_g + 8;

    // o's float32 sums, box by box: columns 64 cb + 8j + 2t, + 1 of rows g
    // (acc[32 cb + 4j], [.. + 1]) and g + 8 (acc[32 cb + 4j + 2], [.. + 3]).
    float acc[kHD / 2];
#pragma unroll
    for (int e = 0; e < kHD / 2; ++e) acc[e] = 0.0f;
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.0f, 0.0f};  // this lane's part of the row sums

    if (t_begin < t_end) mbar_wait(q_full, 0);
    const uint32_t q_rows = base + wg * 64 * kRowBytes;
    for (int tile = t_begin; tile < t_end; ++tile) {
      const int i = tile - t_begin, s = i % kStages;
      const int k0 = tile * kKTile;
      const uint32_t ks = base + L::kRingAt + s * L::kStage;
      const uint32_t vs = ks + L::kBoxes * L::kKVBox;
      const bool skip = wr0 >= a.lq || (a.causal && k0 > wr1) ||
                        (a.window > 0 && wr0 - (k0 + kKTile - 1) >= a.window);
      mbar_wait(full0 + 8 * s, (i / kStages) & 1);
      if (!skip) {  // warpgroup-uniform
        const bool edge = k0 + kKTile > a.lk || (a.causal && k0 + kKTile - 1 > wr0) ||
                          (a.window > 0 && wr1 - k0 >= a.window);
        // S = Q K^T: keys 8j + 2t, 8j + 2t + 1 of rows g (s_[4j], s_[4j + 1])
        // and g + 8 (s_[4j + 2], s_[4j + 3]).
        float s_[kKTile / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kHD / 16; ++kk) {
          const uint32_t off = (kk % 4) * 32;  // 16 columns of the box's 64
          wgmma_ss(s_, sw128_desc(q_rows + (kk / 4) * L::kQBox + off),
                   sw128_desc(ks + (kk / 4) * L::kKVBox + off), kk > 0);
        }
        wgmma_commit();
        wgmma_wait();
        fence_regs(s_);

        // Mask, and the online-softmax update of rows g and g + 8: the row
        // max of the raw scores, scaled (scale > 0 keeps the order).
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int e = 0; e < kKTile / 2; ++e) {
          float x = s_[e];
          if (edge) {
            const int row = (e & 2) ? row_g8 : row_g;
            const int col = k0 + 8 * (e / 4) + 2 * t + (e & 1);
            const bool ok = col < a.lk && (!a.causal || col <= row) &&
                            (a.window <= 0 || row - col < a.window);
            if (!ok) x = -INFINITY;
          }
          s_[e] = x;
          mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], x);
        }
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          const float m_new = fmaxf(m[r], mx[r] * a.scale_log2);
          // m == -inf: nothing seen yet, acc and l are 0 and stay so.
          alpha[r] = m[r] == -INFINITY ? 0.0f : fast_exp2(m[r] - m_new);
          m[r] = m_new;
          l[r] *= alpha[r];
        }
        // P and its two bf16 halves, as A fragments of the k-steps of 16
        // keys: register r of k-step kk holds s_[8 kk + 2r], s_[8 kk + 2r + 1]
        // (rows g, g + 8, g, g + 8).
        uint32_t p_hi[kKTile / 16][4], p_lo[kKTile / 16][4];
#pragma unroll
        for (int kk = 0; kk < kKTile / 16; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            float p2[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int idx = 8 * kk + 2 * r + e;
              // A masked score (-inf, only on an edge tile) is never
              // exponentiated; an allowed one is finite and scales to at
              // most m, so m is finite too: p = 2^(s scale - m), one rounding.
              const float p = edge && s_[idx] == -INFINITY
                                  ? 0.0f
                                  : fast_exp2(fmaf(s_[idx], a.scale_log2, -m[r & 1]));
              l[r & 1] += p;
              p2[e] = p;
            }
            split_bf16(p2[0], p2[1], p_hi[kk][r], p_lo[kk][r]);
          }

        // This tile's P V in a zeroed accumulator, one 64-column box of V at
        // a time (32 registers): 16 keys a k-step (V's rows 16 kk .. 16 kk +
        // 15, 2048 bytes a step).
#pragma unroll
        for (int cb = 0; cb < L::kBoxes; ++cb) {
          float pv[32];
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kKTile / 16; ++kk) {
            const uint64_t vd = sw128_desc(vs + cb * L::kKVBox + kk * 16 * kRowBytes);
            wgmma_rs(pv, p_lo[kk], vd, kk > 0);
            wgmma_rs(pv, p_hi[kk], vd, 1);
          }
          wgmma_commit();
          wgmma_wait();
          fence_regs(pv);
#pragma unroll
          for (int e = 0; e < 32; ++e)
            acc[32 * cb + e] = fmaf(acc[32 * cb + e], alpha[(e >> 1) & 1], pv[e]);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty0 + 8 * s);
      } else {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty0 + 8 * s);
      }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    bf16* op = a.o + bi * a.so[0] + h * a.so[2];
    const bool pairs = (a.hd % 2) == 0;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r == 0 ? row_g : row_g8;
      if (row >= a.lq) continue;
      const float inv = l[r] > 0.0f ? 1.0f / l[r] : 0.0f;
      bf16* orow = op + row * a.so[1];
#pragma unroll
      for (int j = 0; j < kHD / 8; ++j) {
        const int c = 8 * j + 2 * t;
        const float v0 = acc[4 * j + 2 * r] * inv, v1 = acc[4 * j + 2 * r + 1] * inv;
        if (pairs && c + 1 < a.hd) {
          *reinterpret_cast<__nv_bfloat162*>(orow + c) = __floats2bfloat162_rn(v0, v1);
        } else {
          if (c < a.hd) orow[c] = __float2bfloat16_rn(v0);
          if (c + 1 < a.hd) orow[c + 1] = __float2bfloat16_rn(v1);
        }
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found through the runtime (the library
// links no -lcuda); null if libcuda has none.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (hd, heads, len, batch) bf16 map over element strides (batch, seq,
// head), boxes of 64 columns x `rows` rows of one head and batch, 128-byte
// swizzled, zero fill out of bounds. A stride of a dimension of size 1 is
// never stepped over: any multiple of 16 bytes stands for it.
bool make_map(CUtensorMap* map, const void* ptr, int hd, int heads, int len, int batch,
              const long long* strides, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const int sizes[3] = {heads, len, batch};
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(heads),
                        static_cast<cuuint64_t>(len), static_cast<cuuint64_t>(batch)};
  cuuint64_t steps[3];
  for (int i = 0; i < 3; ++i)
    steps[i] = sizes[i] == 1 ? 16 : static_cast<cuuint64_t>(strides[2 - i]) * sizeof(bf16);
  cuuint32_t box[4] = {static_cast<cuuint32_t>(kBox), 1, static_cast<cuuint32_t>(rows), 1};
  cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, steps,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int kHD>
int launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv, const Args& a,
           int batch, void* stream) {
  const int bytes = Layout<kHD>::kBytes + 1024;  // and the base's alignment
  cudaError_t err = cudaFuncSetAttribute(attn_bf16_kernel<kHD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(batch * a.heads, (a.lq + kQTile - 1) / kQTile);
  attn_bf16_kernel<kHD><<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(tq, tk, tv,
                                                                                    a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Dynamic shared memory of a launch at this head dim (the width q, k and v
// are read at), in bytes.
extern "C" long long block_attn_bf16_smem_bytes(int hd) {
  return (hd <= 64 ? Layout<64>::kBytes : Layout<128>::kBytes) + 1024;
}

// q, k, v and o bf16, with element strides (batch, seq, head) each, the head
// dimension's stride being 1. q, k and v are read hd_in wide (a multiple of
// 8, 16-byte aligned bases and strides: block_attn.py `tma_takes`), o
// written hd wide (hd <= hd_in; the columns between are zeros the wrapper
// padded). Returns the cudaError_t of cudaFuncSetAttribute or of the launch
// (0 = success), cudaErrorInvalidValue for what the kernel does not take or
// a tensor map cuTensorMapEncodeTiled refuses; never synchronises.
extern "C" int block_attn_bf16(const void* q, const void* k, const void* v, void* o,
                               long long sq0, long long sq1, long long sq2, long long sk0,
                               long long sk1, long long sk2, long long sv0, long long sv1,
                               long long sv2, long long so0, long long so1, long long so2,
                               int batch, int heads, int kv_heads, int lq, int lk, int hd_in,
                               int hd, int causal, int window, float scale, void* stream) {
  if (hd < 1 || hd_in < hd || hd_in > 128 || hd_in % 8 != 0 || kv_heads < 1 ||
      heads % kv_heads != 0 || (lq + kQTile - 1) / kQTile > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || heads == 0 || lq == 0) return 0;
  const long long sq[3] = {sq0, sq1, sq2}, sk[3] = {sk0, sk1, sk2}, sv[3] = {sv0, sv1, sv2};
  const int lk_map = lk > 0 ? lk : 1;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, hd_in, heads, lq, batch, sq, kQTile) ||
      !make_map(&tk, k, hd_in, kv_heads, lk_map, batch, sk, kKTile) ||
      !make_map(&tv, v, hd_in, kv_heads, lk_map, batch, sv, kKTile))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.o = static_cast<bf16*>(o);
  a.so[0] = so0; a.so[1] = so1; a.so[2] = so2;
  a.heads = heads; a.heads_per_group = heads / kv_heads;
  a.lq = lq; a.lk = lk; a.hd = hd; a.causal = causal; a.window = window;
  a.scale_log2 = scale * kLog2e;
  return hd_in <= 64 ? launch<64>(tq, tk, tv, a, batch, stream)
                     : launch<128>(tq, tk, tv, a, batch, stream);
}
