// Mamba2 SSD chunked scan (arXiv:2405.21060, Alg. 1), float32 in and out,
// chunk-parallel on the tensor cores through a 3xTF32 split, for sm_90a.
//
// Replaces the Pallas TPU kernel `_ssd_kernel`
// (src/repro/kernels/ssd_scan/ssd_scan.py:32). For each batch b and head h
// (group g = h / (H / G)), over chunks of length C, with dta = dt * -exp(A_log[h]),
// cum the inclusive prefix sum of dta within the chunk and xdt = x * dt:
//   y = ((C B^T) o L) xdt + (C o exp(cum)) S_c,  L[i,j] = exp(cum_i - cum_j), j <= i
//   S_0 = 0,  S_{c+1} = exp(cum_last) S_c + (B o exp(cum_last - cum))^T xdt
// The TPU kernel walks the chunks in order on one core and keeps the (N, P)
// state in VMEM. Here the same algebra is cut into four kernels, launched in
// order on one stream, as the Mamba2 authors' GPU kernels cut it:
//   1. chunk_cb    C B^T once per (batch, GROUP, chunk), on the 64 x 64 tile
//                  pairs on or below the diagonal, into a float32 scratch
//                  (B, G, nc, Cp, Cp): the H/G heads of a group read it.
//   2. chunk_state dS_c = (B o w)^T x, w_j = dt_j exp(cum_last - cum_j), per
//                  (batch, head, chunk, 128 state rows), into a float32
//                  scratch (B, H, nc, Np, Pp); and exp(cum_last) per chunk.
//   3. state_pass  S_c in place of dS_c, in order over the chunks: the one
//                  sequential part, elementwise, one thread a float4.
//   4. chunk_scan  y rows of one 64-row tile per (batch, head, chunk, tile):
//                  exp(cum_i) (C S_c)_i, then the masked (C B^T o L o dt_j)
//                  tiles times x.
// Every product runs on mma.sync m16n8k8 with TF32 operands and float32
// accumulators, each operand x split into big = rna(x) and small = x - big,
// each product taken as small.big + big.small + big.big (3xTF32, as
// csrc/block_attn.cu): float32-level error where one TF32 product a term
// misses the 2e-4 tolerance (tests/test_torch_ssd.py emulates both on the
// CPU).
//
// Bound: operations. The function needs C(C+1) N FLOP per (batch, group,
// chunk) for C B^T on the causal pairs, and C(C+1) P + 4 C N P per (batch,
// head, chunk) for the masked product, C S_c and the state update:
// 19,891,486,720 FLOP at the main path's x (8, 24, 2048, 64), B/C (8, 1,
// 2048, 128), chunk 256. The split runs 3 TF32 products for each: 0.1206 ms
// at the card's 494.7 TFLOP/s dense TF32, against 219,676,768 bytes of x,
// dt, B, C and y (0.0656 ms at 3.35 TB/s). The scratches (16.8 MB of C B^T,
// 50.3 MB of states) are this design's traffic, not the function's.
//
// Design, against what the TPU kernel relied on:
//   * Chunk-parallel grid. The TPU kernel's sequential chunk axis is kept
//     only in state_pass; the chunk-local products (chunk_cb, chunk_state,
//     chunk_scan) run one block per chunk tile: 640, 1,536 and 6,144 blocks
//     at the main path's shapes, against the 192 serial blocks of a loop in
//     the block. chunk_scan runs its heaviest tiles (most C B^T tiles left
//     of the diagonal) first; the heads of one chunk are neighbours in the
//     grid, so the group's C B^T tile is read from L2.
//   * Warps and fragments. A warp owns 16 rows of an output tile (32 in
//     chunk_state: two m-tiles share each B fragment) and all of its
//     columns (8-wide n-tiles). A fragments are split once a k-step and
//     serve every n-tile; B fragments are split as they are read. In
//     chunk_scan the masked score tile is formed in float32 registers in
//     the accumulator layout (lane (g, t) holds rows g, g + 8 and columns
//     2t, 2t + 1) and used as the A operand as it stands: k-index t stands
//     for column 2t and t + 4 for 2t + 1, so the x rows are read at 2t and
//     2t + 1 (csrc/block_attn.cu, P between its two products). On a
//     diagonal tile a warp skips the k-steps and n-tiles wholly above its
//     rows.
//   * The split. big is rna(x) by an add and a mask (sm_90 has no
//     instruction for cvt.rna.tf32.f32); small = x - big is exact and goes
//     to the tensor core as it is, which reads a .tf32 operand's top 19 bits
//     and so truncates it: within 2^-10 |small| <= 2^-21 |x|. Three
//     instructions a value where rounding small too takes five.
//   * float64 prefix sums. Within a chunk |cum| reaches thousands when
//     dt |A| is large (2,800 at the main path's random weights), and
//     exp(cum_i - cum_j) of nearby i, j then loses ulp(|cum|) to the
//     cancellation in float32: 1e-3 in y. Each block that needs cum
//     recomputes it from dt in float64 in shared memory (a block scan),
//     scaled by log2(e); every difference cum_i - cum_j, cum_last - cum_j
//     and every cum_i, cum_last is rounded to float32 once, then raised
//     with exp2f. L is masked before the exp (exp(cum_i - cum_j), j > i,
//     overflows). exp(cum_last) may underflow to 0: S is finite, so 0 * S
//     is 0, never NaN.
//   * Staging. Each block streams its operand tiles through a 2-stage
//     cp.async ring (one commit group and one barrier a stage): tile s + 1
//     loads while tile s is computed. chunk_scan's stages are 32 wide (32
//     state rows of C S_c, 32 columns of C B^T), which keeps it at five
//     blocks an SM. 16-byte copies where the rows of
//     that operand are 16-byte aligned (B/C: N and their strides multiples
//     of 4; x: P and its strides), 4-byte copies otherwise; rows past the
//     chunk or L, and columns past N or P, are zero-filled through
//     cp.async's source size (0) from a clamped, valid address. Row strides
//     in shared memory are chosen so each fragment load hits 32 distinct
//     banks. Shared memory a block at P = 64, N = 128, C = 256: 69,632 B
//     (chunk_cb), 57,600 (chunk_state), 41,216 (chunk_scan).
//   * Padding. P is padded to Pp = 8, 16, 32, 64 or 128 (the n-tiles), N to
//     16 in the state scratch and to 64 (C B^T) or 32 (C S) in the k-loops, the
//     chunk to Cp = 64 tiles; pads are zeros. A ragged last chunk loads as
//     zero rows with dt = 0 (a no-op step) and is not written.
//   * Strided operands. x, dt, B, C and y come with their strides (the last
//     dimension's must be 1), so the model hands over its (B, L, H, P)
//     activations and its (B, L, G, N) conv outputs as views. B and C are
//     read by group: no copy repeated over the heads is made.
//   * Nothing is allocated here: the caller passes the three scratches.
//
// What holds it below the bound, as trials on the card point to:
// instruction issue. Each mma.sync of a 3xTF32 product comes with about six
// other instructions (the B operand's split, shared loads, in chunk_scan
// the scores' exps and masks), and mma.sync does not reach the dense TF32
// rate (only wgmma does). A
// chunk_scan with 32-row warps (128-row tiles, two m-tiles a B fragment)
// fits two blocks an SM, not three, by shared memory or by registers, and
// was slower in a trial, as were chunk_scan stages 64 wide (three blocks an
// SM).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;          // chunk positions of a tile; columns of a C B^T tile
constexpr int kNK = 64;            // state rows (N) a stage of the C B^T product
constexpr int kStateJ = 32;        // chunk positions a stage of chunk_state
constexpr int kStateRows = 128;    // state rows (N) of one chunk_state block
constexpr int kStages = 2;         // tiles in each cp.async ring
constexpr int kCbThreads = 128;    // 4 warps x 16 rows = one 64-row tile
constexpr int kStateThreads = 128; // 4 warps x 32 state rows
constexpr int kPassThreads = 256;
constexpr int kScanThreads = 128;  // 4 warps x 16 rows = one 64-row tile
constexpr int kScanK = 32;         // k (state rows or columns) of one chunk_scan stage
constexpr double kLog2e = 1.4426950408889634;

// The pointers, strides and sizes every stage reads.
struct Args {
  const float* x;      // (B, H, L, P) by strides sx
  const float* dt;     // (B, H, L) by strides sdt
  const float* a_log;  // (H,) contiguous
  const float* b;      // (B, G, L, N) by strides sb
  const float* c;      // (B, G, L, N) by strides sc
  float* y;            // (B, H, L, P) by strides sy
  float* cb;           // scratch (B, G, nc, Cp, Cp): C B^T, lower tiles
  float* states;       // scratch (B, H, nc, Np, Pp): dS_c, then S_c
  float* decay;        // scratch (B, H, nc): exp(cum_last)
  long long sx[3], sdt[3], sb[3], sc[3], sy[3];  // batch, head|group, seq
  int batch, heads, groups, seqlen, p, n, chunk;
  int hpg, nc, ntile, cpad, np, pp;  // heads a group, chunks, tiles a chunk, padded sizes
  int x16, bc16;                     // 16-byte copies of x, of B and C
};

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }
// Row strides of the shared tiles, in floats, multiples of 4 (16-byte rows):
// 4 (mod 32) for a fragment read at (row g, column t), 8 (mod 32) for one
// read at (row t, column g), 4 (mod 8) for one read at (row 2t, column g).
__host__ __device__ constexpr int ld_gt(int w) { return w + 4; }
__host__ __device__ constexpr int ld_tg(int w) { return round_up(w, 32) + 8; }
__host__ __device__ constexpr int ld_2tg(int w) { return round_up(w, 32) + 4; }
__host__ __device__ constexpr int mx(int a, int b) { return a > b ? a : b; }

int padded_p(int p) { return p <= 8 ? 8 : p <= 16 ? 16 : p <= 32 ? 32 : p <= 64 ? 64 : 128; }

// Shared memory of each stage in bytes, in the order the kernels lay it out:
// float64 prefix sums and scan carries first, then float32 arrays, then the ring.
size_t cb_smem() { return static_cast<size_t>(kStages) * 2 * kTile * ld_gt(kNK) * sizeof(float); }
__host__ __device__ constexpr int state_stage(int pp) { return kStateJ * (ld_tg(kStateRows) + ld_tg(pp)); }
size_t state_smem(int pp, int cpad) {
  return (static_cast<size_t>(cpad) + 32) * sizeof(double) +
         (2 * static_cast<size_t>(cpad) + kStages * state_stage(pp)) * sizeof(float);
}
__host__ __device__ constexpr int scan_stage(int pp) {
  return mx(kTile * ld_gt(kScanK) + kScanK * ld_tg(pp),
            kTile * (kScanK + 8) + kScanK * ld_2tg(pp));
}
size_t scan_smem(int pp, int cpad) {
  return (static_cast<size_t>(cpad) + 32) * sizeof(double) +
         (static_cast<size_t>(cpad) + kStages * scan_stage(pp)) * sizeof(float);
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

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// kRows x kCols of a sequence operand into a shared tile (row stride ld):
// row r is sequence row r of `src` (row stride `stride`), valid while
// r < rows_ok; column k is valid while k < cols. Invalid elements are
// zero-filled from a clamped, valid address. rows_ok >= 1.
template <int kRows, int kCols, int kThreads>
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* src,
                                          long long stride, int rows_ok, int cols,
                                          bool vec16) {
  if (vec16) {  // cols is a multiple of 4
    constexpr int kChunks = kCols / 4;
    for (int i = threadIdx.x; i < kRows * kChunks; i += kThreads) {
      const int r = i / kChunks, k = (i % kChunks) * 4;
      const bool ok = r < rows_ok && k < cols;
      cp_async16(dst + r * ld + k, src + min(r, rows_ok - 1) * stride + min(k, cols - 4),
                 ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kRows * kCols; i += kThreads) {
      const int r = i / kCols, k = i % kCols;
      const bool ok = r < rows_ok && k < cols;
      cp_async4(dst + r * ld + k, src + min(r, rows_ok - 1) * stride + min(k, cols - 1),
                ok ? 4 : 0);
    }
  }
}

// kRows x kCols of a dense, 16-byte aligned scratch (row stride src_ld)
// into a shared tile; rows from rows_ok on are zero-filled. rows_ok >= 1.
template <int kRows, int kCols, int kThreads>
__device__ __forceinline__ void load_dense(float* dst, int ld, const float* src,
                                           long long src_ld, int rows_ok) {
  constexpr int kChunks = kCols / 4;
  for (int i = threadIdx.x; i < kRows * kChunks; i += kThreads) {
    const int r = i / kChunks, k = (i % kChunks) * 4;
    cp_async16(dst + r * ld + k, src + min(r, rows_ok - 1) * src_ld + k, r < rows_ok ? 16 : 0);
  }
}

// dts[r] = dt of chunk row r (0 from row len on) and cum[r] = log2(e) times
// the inclusive prefix sum of dts * A, in float64, for r < count: each
// thread sums a run of rows, a warp-shuffle scan adds the runs. Ends with a
// barrier. In units of log2 the kernels exponentiate with exp2f.
template <int kThreads>
__device__ void chunk_cum(double* cum, double* carry, float* dts, const float* dt,
                          long long stride, int len, int count, float A) {
  for (int r = threadIdx.x; r < count; r += kThreads) dts[r] = r < len ? dt[r * stride] : 0.0f;
  __syncthreads();
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int per = (count + kThreads - 1) / kThreads;
  const int lo = threadIdx.x * per;
  double run = 0.0;
  for (int k = 0; k < per; ++k) {
    if (lo + k < count) {
      run += static_cast<double>(dts[lo + k] * A);
      cum[lo + k] = run;
    }
  }
  double incl = run;
  for (int off = 1; off < 32; off <<= 1) {
    const double v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) carry[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    double w = lane < kThreads / 32 ? carry[lane] : 0.0;
    for (int off = 1; off < 32; off <<= 1) {
      const double v = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += v;
    }
    if (lane < kThreads / 32) carry[lane] = w;
  }
  __syncthreads();
  const double offset = (incl - run) + (warp > 0 ? carry[warp - 1] : 0.0);
  for (int k = 0; k < per; ++k)
    if (lo + k < count) cum[lo + k] = (cum[lo + k] + offset) * kLog2e;
  __syncthreads();
}

// cvt.rna.tf32.f32 of a finite x (the magnitude rounded to 10 mantissa
// bits, ties away from zero), as bits, by an add and a mask: sm_90 has no
// instruction for that cvt and ptxas emulates it slowly.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = big + small: big = rna(x) is TF32; small = x - big (exact) is passed
// as it is, and the tensor core reads a .tf32 operand's top 19 bits, so it
// enters the product truncated to TF32: within 2^-10 |small| <= 2^-21 |x|.
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = __float_as_uint(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A B fragment (b0 = B[t][g], b1 = B[t + 4][g]) split once.
struct SplitB {
  uint32_t big0, small0, big1, small1;
  __device__ __forceinline__ SplitB(float b0, float b1) {
    split(b0, big0, small0);
    split(b1, big1, small1);
  }
};

// An A fragment (rows g, g + 8 at k-indices t, t + 4: a0 (g, t), a1
// (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)) split once, for several
// n-tiles: mma(d, b) is d += a b in 3xTF32, small.big, big.small, then
// big.big.
struct SplitA {
  uint32_t big[4], small[4];
  __device__ __forceinline__ explicit SplitA(const float (&a)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) split(a[i], big[i], small[i]);
  }
  __device__ __forceinline__ void mma(float (&d)[4], const SplitB& b) const {
    mma_tf32(d, small, b.big0, b.big1);
    mma_tf32(d, big, b.small0, b.small1);
    mma_tf32(d, big, b.big0, b.big1);
  }
};

// Stage 1: one 64 x 64 tile (it, jt), jt <= it, of C B^T for one (batch,
// group, chunk). Blocks: (tile pair, chunk, batch x group), pairs slowest.
__global__ void __launch_bounds__(kCbThreads, 4) chunk_cb_kernel(Args a) {
  constexpr int kLd = ld_gt(kNK);
  constexpr int kStage = 2 * kTile * kLd;
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int bgs = a.batch * a.groups;
  const int bg = blockIdx.x % bgs;
  const int ci = (blockIdx.x / bgs) % a.nc;
  const int pair = blockIdx.x / bgs / a.nc;
  int it = 0;
  while ((it + 1) * (it + 2) / 2 <= pair) ++it;
  const int jt = pair - it * (it + 1) / 2;
  const long long c0 = static_cast<long long>(ci) * a.chunk;
  const int len = static_cast<int>(min(static_cast<long long>(a.chunk), a.seqlen - c0));
  const int i0 = it * kTile, j0 = jt * kTile;
  if (i0 >= len) return;  // past a ragged last chunk: never read
  const int bi = bg / a.groups, gi = bg % a.groups;
  const float* cp = a.c + bi * a.sc[0] + gi * a.sc[1] + (c0 + i0) * a.sc[2];
  const float* bp = a.b + bi * a.sb[0] + gi * a.sb[1] + (c0 + j0) * a.sb[2];
  const int nk = (a.n + kNK - 1) / kNK;
  const bool vec16 = a.bc16 != 0;

  auto load = [=](int s) {
    if (s < nk) {
      float* dst = smem + (s % kStages) * kStage;
      const int n0 = s * kNK;
      load_rows<kTile, kNK, kCbThreads>(dst, kLd, cp + n0, a.sc[2], len - i0, a.n - n0, vec16);
      load_rows<kTile, kNK, kCbThreads>(dst + kTile * kLd, kLd, bp + n0, a.sb[2], len - j0,
                                        a.n - n0, vec16);
    }
    cp_async_commit();
  };
  load(0);

  // On the diagonal, n-tiles right of this warp's last row are not needed.
  const int jmax = it == jt ? 2 * warp + 1 : kTile / 8 - 1;
  float acc[kTile / 8][4];
#pragma unroll
  for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  for (int s = 0; s < nk; ++s) {
    cp_async_wait_all();
    // Stage s is visible to all, and every warp is done with the stage the
    // next copy overwrites.
    __syncthreads();
    load(s + 1);
    const float* cs = smem + (s % kStages) * kStage;
    const float* bs = cs + kTile * kLd;
#pragma unroll
    for (int k = 0; k < kNK; k += 8) {
      const float* ca = cs + (16 * warp + g) * kLd + k + t;
      const float af[4] = {ca[0], ca[8 * kLd], ca[4], ca[8 * kLd + 4]};
      const SplitA as(af);
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j) {
        if (j <= jmax) {
          const float* bb = bs + (8 * j + g) * kLd + k + t;
          as.mma(acc[j], SplitB(bb[0], bb[4]));
        }
      }
    }
  }
  float* out = a.cb + ((static_cast<long long>(bg) * a.nc + ci) * a.cpad + i0 + 16 * warp + g) *
                          a.cpad + j0 + 2 * t;
#pragma unroll
  for (int j = 0; j < kTile / 8; ++j) {
    if (j <= jmax) {
      *reinterpret_cast<float2*>(out + 8 * j) = make_float2(acc[j][0], acc[j][1]);
      *reinterpret_cast<float2*>(out + 8 * a.cpad + 8 * j) = make_float2(acc[j][2], acc[j][3]);
    }
  }
}

// Stage 2: dS_c rows [128 ns, 128 ns + 128) for one (batch, head, chunk),
// and exp(cum_last). Blocks: (chunk, batch x head, N slice), slices fastest.
// kGrad: the backward's dS^loc_c = (C o exp(cum))^T dy, the caller passing
// C as B and dy as x; the weight of position j is then exp(cum_j).
template <int kPP, bool kGrad>
__global__ void __launch_bounds__(kStateThreads) chunk_state_kernel(Args a) {
  constexpr int kNT = kPP / 8;
  constexpr int kLdB = ld_tg(kStateRows), kLdX = ld_tg(kPP);
  constexpr int kStage = state_stage(kPP);
  extern __shared__ __align__(16) double smem_d[];
  double* cum = smem_d;                                    // (cpad)
  double* carry = cum + a.cpad;                            // (32)
  float* dts = reinterpret_cast<float*>(carry + 32);       // (cpad)
  float* w = dts + a.cpad;                                 // (cpad)
  float* ring = w + a.cpad;                                // kStages x [B (kStateJ, kLdB), x (kStateJ, kLdX)]
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int nslices = (a.np + kStateRows - 1) / kStateRows;
  const int bhs = a.batch * a.heads;
  const int ns = blockIdx.x % nslices;
  const int bh = (blockIdx.x / nslices) % bhs;
  const int ci = blockIdx.x / nslices / bhs;
  const int bi = bh / a.heads, h = bh % a.heads, gi = h / a.hpg;
  const long long c0 = static_cast<long long>(ci) * a.chunk;
  const int len = static_cast<int>(min(static_cast<long long>(a.chunk), a.seqlen - c0));
  const float A = -expf(a.a_log[h]);
  const float* xp = a.x + bi * a.sx[0] + h * a.sx[1] + c0 * a.sx[2];
  const float* dtp = a.dt + bi * a.sdt[0] + h * a.sdt[1] + c0 * a.sdt[2];
  const float* bp = a.b + bi * a.sb[0] + gi * a.sb[1] + c0 * a.sb[2] + ns * kStateRows;
  const int nj = (len + kStateJ - 1) / kStateJ;

  auto load = [&](int s) {
    if (s < nj) {
      float* dst = ring + (s % kStages) * kStage;
      const int j0 = s * kStateJ;
      load_rows<kStateJ, kStateRows, kStateThreads>(dst, kLdB, bp + j0 * a.sb[2], a.sb[2],
                                                    len - j0, a.n - ns * kStateRows,
                                                    a.bc16 != 0);
      load_rows<kStateJ, kPP, kStateThreads>(dst + kStateJ * kLdB, kLdX, xp + j0 * a.sx[2],
                                             a.sx[2], len - j0, a.p, a.x16 != 0);
    }
    cp_async_commit();
  };
  load(0);
  chunk_cum<kStateThreads>(cum, carry, dts, dtp, a.sdt[2], len, len, A);
  const double last = cum[len - 1];
  for (int j = threadIdx.x; j < nj * kStateJ; j += kStateThreads) {
    const float wj = kGrad ? exp2f(static_cast<float>(cum[j]))
                           : dts[j] * exp2f(static_cast<float>(last - cum[j]));
    w[j] = j < len ? wj : 0.0f;
  }
  if (ns == 0 && threadIdx.x == 0)
    a.decay[static_cast<long long>(bh) * a.nc + ci] = exp2f(static_cast<float>(last));

  const int m0 = 32 * warp;  // this warp's state rows in the slice, two m-tiles
  const bool active = ns * kStateRows + m0 < a.np;
  const bool active1 = ns * kStateRows + m0 + 16 < a.np;
  float acc0[kNT][4], acc1[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc0[j][e] = acc1[j][e] = 0.0f;
  for (int s = 0; s < nj; ++s) {
    cp_async_wait_all();
    __syncthreads();  // stage s (and w) visible; the other stage free
    load(s + 1);
    if (!active) continue;  // warp-uniform
    const float* bs = ring + (s % kStages) * kStage;
    const float* xs = bs + kStateJ * kLdB;
    const float* ws = w + s * kStateJ;
#pragma unroll
    for (int k = 0; k < kStateJ; k += 8) {
      const float w0 = ws[k + t], w1 = ws[k + t + 4];
      const float* ba = bs + (k + t) * kLdB + m0 + g;
      const float af0[4] = {ba[0] * w0, ba[8] * w0, ba[4 * kLdB] * w1, ba[4 * kLdB + 8] * w1};
      const float af1[4] = {ba[16] * w0, ba[24] * w0, ba[4 * kLdB + 16] * w1,
                            ba[4 * kLdB + 24] * w1};
      const SplitA as0(af0), as1(af1);
      const float* xb = xs + (k + t) * kLdX + g;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const SplitB sb(xb[8 * j], xb[4 * kLdX + 8 * j]);
        as0.mma(acc0[j], sb);
        as1.mma(acc1[j], sb);
      }
    }
  }
  if (!active) return;
  float* out = a.states + ((static_cast<long long>(bh) * a.nc + ci) * a.np + ns * kStateRows +
                           m0 + g) * kPP + 2 * t;
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    *reinterpret_cast<float2*>(out + 8 * j) = make_float2(acc0[j][0], acc0[j][1]);
    *reinterpret_cast<float2*>(out + 8 * kPP + 8 * j) = make_float2(acc0[j][2], acc0[j][3]);
    if (active1) {
      *reinterpret_cast<float2*>(out + 16 * kPP + 8 * j) = make_float2(acc1[j][0], acc1[j][1]);
      *reinterpret_cast<float2*>(out + 24 * kPP + 8 * j) = make_float2(acc1[j][2], acc1[j][3]);
    }
  }
}

// Stage 3: S_0 = 0, S_{c+1} = exp(cum_last_c) S_c + dS_c, S_c written in
// place of dS_c. One thread a float4 of the (Np, Pp) state of one (batch,
// head).
__global__ void __launch_bounds__(kPassThreads) state_pass_kernel(Args a) {
  const long long per = static_cast<long long>(a.np) * a.pp / 4;
  const long long blocks_per = (per + kPassThreads - 1) / kPassThreads;
  const long long bh = blockIdx.x / blocks_per;
  const long long e = (blockIdx.x % blocks_per) * kPassThreads + threadIdx.x;
  if (e >= per) return;
  float4* st = reinterpret_cast<float4*>(a.states) + bh * a.nc * per + e;
  const float* dec = a.decay + bh * a.nc;
  float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float4 d = st[0];
  for (int ci = 0; ci < a.nc; ++ci) {
    const float4 next = ci + 1 < a.nc ? st[(ci + 1) * per] : d;
    st[ci * per] = s;
    const float k = dec[ci];
    s = make_float4(fmaf(k, s.x, d.x), fmaf(k, s.y, d.y), fmaf(k, s.z, d.z), fmaf(k, s.w, d.w));
    d = next;
  }
}

// Stage 4: y rows [64 it, 64 it + 64) of one (batch, head, chunk). Blocks:
// (tile, chunk, batch x head), the heaviest tiles first.
template <int kPP>
__global__ void __launch_bounds__(kScanThreads, kPP <= 64 ? 5 : 2) chunk_scan_kernel(Args a) {
  constexpr int kNT = kPP / 8;
  constexpr int kLdC = ld_gt(kScanK), kLdS = ld_tg(kPP);  // C (64, 32), S (32, Pp)
  constexpr int kLdCB = kScanK + 8, kLdX = ld_2tg(kPP);   // C B^T (64, 32), x (32, Pp)
  constexpr int kStage = scan_stage(kPP);
  extern __shared__ __align__(16) double smem_d[];
  double* cum = smem_d;                                    // (cpad)
  double* carry = cum + a.cpad;                            // (32)
  float* dts = reinterpret_cast<float*>(carry + 32);       // (cpad)
  float* ring = dts + a.cpad;                              // kStages x kStage
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int bhs = a.batch * a.heads;
  const int bh = blockIdx.x % bhs;
  const int ci = (blockIdx.x / bhs) % a.nc;
  const int it = a.ntile - 1 - static_cast<int>(blockIdx.x / bhs / a.nc);
  const long long c0 = static_cast<long long>(ci) * a.chunk;
  const int len = static_cast<int>(min(static_cast<long long>(a.chunk), a.seqlen - c0));
  const int i0 = it * kTile;
  if (i0 >= len) return;  // past a ragged last chunk
  const int bi = bh / a.heads, h = bh % a.heads, gi = h / a.hpg;
  const float A = -expf(a.a_log[h]);
  const float* xp = a.x + bi * a.sx[0] + h * a.sx[1] + c0 * a.sx[2];
  const float* dtp = a.dt + bi * a.sdt[0] + h * a.sdt[1] + c0 * a.sdt[2];
  const float* cp = a.c + bi * a.sc[0] + gi * a.sc[1] + (c0 + i0) * a.sc[2];
  const float* cbp = a.cb + ((static_cast<long long>(bi) * a.groups + gi) * a.nc + ci) *
                                a.cpad * a.cpad + static_cast<long long>(i0) * a.cpad;
  const float* sp = a.states + (static_cast<long long>(bh) * a.nc + ci) * a.np * kPP;
  // Stages: ceil(N / kScanK) of C S_c (none for the first chunk, S_0 = 0),
  // then the kScanK-column slices of C B^T left of and on the diagonal.
  const int n1 = ci > 0 ? (a.n + kScanK - 1) / kScanK : 0;
  const int nstage = n1 + (min(len, i0 + kTile) - 1) / kScanK + 1;

  auto load = [&](int s) {
    if (s < nstage) {
      float* dst = ring + (s % kStages) * kStage;
      if (s < n1) {
        const int n0 = s * kScanK;
        load_rows<kTile, kScanK, kScanThreads>(dst, kLdC, cp + n0, a.sc[2], len - i0, a.n - n0,
                                            a.bc16 != 0);
        load_dense<kScanK, kPP, kScanThreads>(dst + kTile * kLdC, kLdS, sp + n0 * kPP, kPP,
                                           a.np - n0);
      } else {
        const int j0 = (s - n1) * kScanK;
        load_dense<kTile, kScanK, kScanThreads>(dst, kLdCB, cbp + j0, a.cpad, kTile);
        load_rows<kScanK, kPP, kScanThreads>(dst + kTile * kLdCB, kLdX, xp + j0 * a.sx[2],
                                            a.sx[2], len - j0, a.p, a.x16 != 0);
      }
    }
    cp_async_commit();
  };
  load(0);
  chunk_cum<kScanThreads>(cum, carry, dts, dtp, a.sdt[2], len, i0 + kTile, A);

  const int ra = 16 * warp + g, rb = ra + 8;  // this lane's rows in the tile
  const double cum_a = cum[i0 + ra], cum_b = cum[i0 + rb];
  float acc[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  for (int s = 0; s < nstage; ++s) {
    cp_async_wait_all();
    __syncthreads();  // stage s visible; the other stage free
    load(s + 1);
    const float* st = ring + (s % kStages) * kStage;
    if (s < n1) {
      // acc += C S_c over this stage's kScanK state rows.
      const float* ss = st + kTile * kLdC;
#pragma unroll
      for (int k = 0; k < kScanK; k += 8) {
        const float* ca = st + ra * kLdC + k + t;
        const float af[4] = {ca[0], ca[8 * kLdC], ca[4], ca[8 * kLdC + 4]};
        const SplitA as(af);
        const float* sb = ss + (k + t) * kLdS + g;
#pragma unroll
        for (int j = 0; j < kNT; ++j) as.mma(acc[j], SplitB(sb[8 * j], sb[4 * kLdS + 8 * j]));
      }
      continue;
    }
    if (s == n1 && n1 > 0) {  // (C o exp(cum)) S_c = exp(cum_i) (C S_c)_i
      const float ea = exp2f(static_cast<float>(cum_a)), eb = exp2f(static_cast<float>(cum_b));
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        acc[j][0] *= ea;
        acc[j][1] *= ea;
        acc[j][2] *= eb;
        acc[j][3] *= eb;
      }
    }
    const int w_lo = i0 + 16 * warp;  // the warp's first chunk row
    const float* xs = st + kTile * kLdCB;
    const int ia = i0 + ra, ib = i0 + rb;
#pragma unroll
    for (int kk = 0; kk < kScanK / 8; ++kk) {
      const int k0 = (s - n1) * kScanK + 8 * kk;  // the k-step's first chunk column
      const bool diag = k0 + 7 > w_lo;          // some column right of some row: mask
      if (k0 <= w_lo + 15) {                    // else right of all the warp's rows
        // Scores of rows ra, rb at columns 2t, 2t + 1 of this k-step, times
        // L (masked before the exp) and dt_j: the A fragment as it stands,
        // k-index t for column 2t and t + 4 for 2t + 1.
        const int j = k0 + 2 * t;
        const float2 sa = *reinterpret_cast<const float2*>(st + ra * kLdCB + 8 * kk + 2 * t);
        const float2 sb = *reinterpret_cast<const float2*>(st + rb * kLdCB + 8 * kk + 2 * t);
        const double cj0 = cum[j], cj1 = cum[j + 1];
        const float d0 = dts[j], d1 = dts[j + 1];
        const float af[4] = {
            !diag || j <= ia ? sa.x * exp2f(static_cast<float>(cum_a - cj0)) * d0 : 0.0f,
            !diag || j <= ib ? sb.x * exp2f(static_cast<float>(cum_b - cj0)) * d0 : 0.0f,
            !diag || j + 1 <= ia ? sa.y * exp2f(static_cast<float>(cum_a - cj1)) * d1 : 0.0f,
            !diag || j + 1 <= ib ? sb.y * exp2f(static_cast<float>(cum_b - cj1)) * d1 : 0.0f};
        const SplitA as(af);
        const float* xb = xs + (8 * kk + 2 * t) * kLdX + g;
#pragma unroll
        for (int n = 0; n < kNT; ++n) as.mma(acc[n], SplitB(xb[8 * n], xb[kLdX + 8 * n]));
      }
    }
  }

  float* yp = a.y + bi * a.sy[0] + h * a.sy[1] + c0 * a.sy[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = i0 + (r == 0 ? ra : rb);
    if (row >= len) continue;
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * t + e;
        if (col < a.p) yp[row * a.sy[2] + col] = acc[j][2 * r + e];
      }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// Fills the sizes of `a` from dims = (batch, heads, groups, seqlen, p, n,
// chunk); false if they are outside what the kernels take.
bool set_sizes(Args& a, const int* dims) {
  a.batch = dims[0]; a.heads = dims[1]; a.groups = dims[2]; a.seqlen = dims[3];
  a.p = dims[4]; a.n = dims[5]; a.chunk = dims[6];
  if (a.batch < 0 || a.heads < 0 || a.seqlen < 0 || a.p < 1 || a.p > 128 || a.n < 1 ||
      a.chunk < 1 || a.groups < 1 || a.heads % a.groups != 0)
    return false;
  a.hpg = a.heads / a.groups;
  a.nc = (a.seqlen + a.chunk - 1) / a.chunk;
  a.ntile = (a.chunk + kTile - 1) / kTile;
  a.cpad = a.ntile * kTile;
  a.np = round_up(a.n, 16);
  a.pp = padded_p(a.p);
  return true;
}

// Blocks of each stage's 1-D grid.
long long stage_blocks(int stage, const Args& a) {
  const long long bh = static_cast<long long>(a.batch) * a.heads;
  switch (stage) {
    case 0: return static_cast<long long>(a.ntile) * (a.ntile + 1) / 2 * a.nc * a.batch * a.groups;
    case 1: return static_cast<long long>(a.nc) * bh * ((a.np + kStateRows - 1) / kStateRows);
    case 2: return bh * ((static_cast<long long>(a.np) * a.pp / 4 + kPassThreads - 1) / kPassThreads);
    default: return static_cast<long long>(a.ntile) * a.nc * bh;
  }
}

size_t stage_smem(int stage, const Args& a) {
  switch (stage) {
    case 0: return cb_smem();
    case 1: return state_smem(a.pp, a.cpad);
    case 2: return 0;
    default: return scan_smem(a.pp, a.cpad);
  }
}

int stage_threads(int stage) {
  const int threads[4] = {kCbThreads, kStateThreads, kPassThreads, kScanThreads};
  return threads[stage];
}

template <typename Kernel>
int launch(Kernel kernel, int stage, const Args& a, void* stream) {
  const long long blocks = stage_blocks(stage, a);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0) return 0;
  const size_t bytes = stage_smem(stage, a);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), stage_threads(stage), bytes,
           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ptrs = (x, dt, a_log, b, c, y, cb, states, decay); strides = 15 element
// strides, (batch, head or group, seq) for x, dt, B, C and y.
bool make_args(Args& a, void* const* ptrs, const long long* strides, const int* dims) {
  if (!set_sizes(a, dims)) return false;
  a.x = static_cast<const float*>(ptrs[0]);
  a.dt = static_cast<const float*>(ptrs[1]);
  a.a_log = static_cast<const float*>(ptrs[2]);
  a.b = static_cast<const float*>(ptrs[3]);
  a.c = static_cast<const float*>(ptrs[4]);
  a.y = static_cast<float*>(ptrs[5]);
  a.cb = static_cast<float*>(ptrs[6]);
  a.states = static_cast<float*>(ptrs[7]);
  a.decay = static_cast<float*>(ptrs[8]);
  for (int i = 0; i < 3; ++i) {
    a.sx[i] = strides[i];
    a.sdt[i] = strides[3 + i];
    a.sb[i] = strides[6 + i];
    a.sc[i] = strides[9 + i];
    a.sy[i] = strides[12 + i];
  }
  bool bc16 = a.n % 4 == 0 && aligned16(a.b) && aligned16(a.c);
  bool x16 = a.p % 4 == 0 && aligned16(a.x);
  for (int i = 0; i < 3; ++i) {
    bc16 = bc16 && a.sb[i] % 4 == 0 && a.sc[i] % 4 == 0;
    x16 = x16 && a.sx[i] % 4 == 0;
  }
  a.bc16 = bc16 ? 1 : 0;
  a.x16 = x16 ? 1 : 0;
  return true;
}


// ------------------------------------------------------------------ backward
//
// The gradient of the scan, for training, in the Mamba2 authors' chunked
// matrix form, mirroring the four forward stages. Within chunk c, with
// positions i, j, L_ij = exp(cum_i - cum_j) (j <= i), w_j = exp(cum_last -
// cum_j), CB = C B^T, xdt = x dt, S_c the state entering the chunk (the
// forward's `states` scratch) and G_c = dloss/dS_{c+1}, the state's gradient
// at the chunk's end:
//   1. bwd_chunk_cb    the forward's chunk_cb into its scratch again (C B^T
//                      per group, lower tiles).
//   2. bwd_chunk_state dS^loc_c = (C o exp(cum))^T dy per (batch, head,
//                      chunk): the forward's chunk_state on C and dy, with
//                      exp(cum_j) in place of w_j; and exp(cum_last).
//   3. bwd_state_pass  G_{nc-1} = 0, G_{c-1} = exp(cum_last_c) G_c + dS^loc_c,
//                      in place, in reverse order over the chunks: the one
//                      sequential part, elementwise, nc steps.
//   4. bwd_chunk_dc    per (batch, head, chunk, 64-row tile of i), with
//                      R = (dy xdt^T) o L: dC = R B + diag(exp cum) dy S_c^T,
//                      and the terms of dcum_i the rows hold,
//                      sum_{j<i} M_ij + y^off_i.dy_i, M = R o CB.
//   5. bwd_chunk_db    per (batch, head, chunk, 64-row tile of j):
//                      dB = R^T C + diag(w) xdt G_c^T, dxdt = (CB o L)^T dy +
//                      (B o w) G_c, dx = dxdt dt, and the column terms
//                      sum_{i>j} M_ij, u_j = w_j B_j^T G_c xdt_j, dxdt_j.x_j.
//   6. bwd_ddt         per (batch, head, chunk): ddA_r, the gradient of the
//                      log-decay a_r = dt_r A, is the reverse cumulative sum
//                      of dcum_s = sum_{j<s} M_sj - sum_{i>s} M_is +
//                      y^off_s.dy_s, plus the state terms summed from r on,
//                      exp(cum_last) <G_c, S_c> + sum_{j<r} u_j (no terms
//                      that cancel); ddt_r = dxdt_r.x_r + A ddA_r and the
//                      chunk's part of dA_log = A sum_r ddA_r dt_r, float64.
// M = R o CB is strictly lower: the pair (s, s), which dcum_s would hold
// twice with opposite signs, never enters. The prefix and reverse sums are
// float64 block scans; each cum difference is rounded to float32 once, as
// the forward does (chunk_cum). Every product runs on mma.sync m16n8k8 in
// 3xTF32 (SplitA, SplitB), as the forward stages; in stages 4 and 5 the
// masked score tile (R, R^T, (CB o L)^T) is formed in the accumulator layout
// and is the A operand of the next product as it stands (k-index t for
// column 2t, t + 4 for 2t + 1, the B operand's rows read at 2t and 2t + 1).
// Shared row strides: 4 (mod 32) for tiles read at (row g, column t) and at
// (row 2t, column g), 8 (mod 32) for float2 reads at (row g, column 2t).
//
// dB and dC are summed over the H/G heads of a group by float32 atomicAdd
// into outputs the caller zeroes, so their order varies from run to run
// (per-head partials and a fixed-order pass would cost 2 B H L N floats of
// scratch, 403 MB at mamba2-130m's layer; not measured). dA_log's parts are
// one float64 a (batch, head, chunk), summed by the caller.
//
// Bound: operations. At mamba2-130m's layer (8, 24, 2,048, 64; N 128,
// chunk 256) the chunked form needs dS^loc (2 C N P a chunk), dxdt's two
// products, dC's two and dB's two (the C x C ones on the C(C+1)/2 causal
// pairs), R, and C B^T once per group: chip_smoke.py counts them; at 3
// passes of the dense TF32 rate, ~0.4 ms. The recurrent form's 12 N P
// float32 FLOP a position (0.577 ms at the SIMT rate) is the other bound.
constexpr int kBwdThreads = 128;  // 4 warps x 16 rows = one 64-row tile
constexpr int kBwdK = 32;         // chunk positions a ring stage of bwd_chunk_dc/db
constexpr int kMaxN = 128;        // the backward takes N <= 128
constexpr int kMaxNT = kMaxN / 8; // n-tiles over N
constexpr int kDdtThreads = 256;

struct BwdArgs {
  const float *x, *dt, *a_log, *b, *c, *dy;
  const float* states;   // the forward's (B, H, nc, Np, Pp): S entering each chunk
  float* cb;             // scratch (B, G, nc, Cp, Cp): C B^T, lower tiles
  float* gstates;        // scratch (B, H, nc, Np, Pp): dS^loc_c, then G_c
  float* decay;          // scratch (B, H, nc): exp(cum_last)
  float* rowterms;       // scratch (B, H, nc, Cp): sum_{j<i} M_ij + y^off_i.dy_i
  float* colterms;       // scratch (B, H, nc, Cp, 3): sum_{i>j} M_ij, u_j, dxdt_j.x_j
  double* dalog;         // scratch (B, H, nc): A sum_r ddA_r dt_r of each chunk
  float *dx, *ddt, *db, *dc;  // db, dc zeroed by the caller
  long long sx[3], sdt[3], sb[3], sc[3], sdy[3], sdx[3], sddt[3], sdb[3], sdc[3];
  int batch, heads, groups, seqlen, p, n, chunk, hpg, nc, ntile, cpad, np, pp;
  int x16, bc16, dy16;
};

// The forward's view of the backward's operands: for stage 1 as they are,
// for stage 2 with dy in place of x and C in place of B.
Args fwd_view(const BwdArgs& a, bool grad) {
  Args f;
  f.batch = a.batch; f.heads = a.heads; f.groups = a.groups; f.seqlen = a.seqlen;
  f.p = a.p; f.n = a.n; f.chunk = a.chunk; f.hpg = a.hpg; f.nc = a.nc; f.ntile = a.ntile;
  f.cpad = a.cpad; f.np = a.np; f.pp = a.pp;
  f.x = grad ? a.dy : a.x;
  f.dt = a.dt;
  f.a_log = a.a_log;
  f.b = grad ? a.c : a.b;
  f.c = a.c;
  f.y = nullptr;
  f.cb = a.cb;
  f.states = a.gstates;
  f.decay = a.decay;
  for (int i = 0; i < 3; ++i) {
    f.sx[i] = grad ? a.sdy[i] : a.sx[i];
    f.sdt[i] = a.sdt[i];
    f.sb[i] = grad ? a.sc[i] : a.sb[i];
    f.sc[i] = a.sc[i];
    f.sy[i] = 0;
  }
  f.x16 = grad ? a.dy16 : a.x16;
  f.bc16 = a.bc16;
  return f;
}

// Stage 3: G_c in place of dS^loc_c, in reverse order. One thread a float4
// of the (Np, Pp) state of one (batch, head).
__global__ void __launch_bounds__(kPassThreads) bwd_state_pass_kernel(Args a) {
  const long long per = static_cast<long long>(a.np) * a.pp / 4;
  const long long blocks_per = (per + kPassThreads - 1) / kPassThreads;
  const long long bh = blockIdx.x / blocks_per;
  const long long e = (blockIdx.x % blocks_per) * kPassThreads + threadIdx.x;
  if (e >= per) return;
  float4* st = reinterpret_cast<float4*>(a.states) + bh * a.nc * per + e;
  const float* dec = a.decay + bh * a.nc;
  float4 g = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int ci = a.nc - 1; ci >= 0; --ci) {
    const float4 d = st[ci * per];
    st[ci * per] = g;
    const float k = dec[ci];
    g = make_float4(fmaf(k, g.x, d.x), fmaf(k, g.y, d.y), fmaf(k, g.z, d.z), fmaf(k, g.w, d.w));
  }
}

// Shared memory of bwd_chunk_dc and bwd_chunk_db, in floats after the
// float64 cum (cpad) and carry (32): dts (and w) (cpad each), the block's
// own 64-row tile, then one region that holds first the state operands and
// then the cp.async ring.
__host__ __device__ constexpr int dc_ring_stage(int pp) {
  return kBwdK * ld_gt(pp) + kBwdK * ld_2tg(kMaxN) + kTile * (kBwdK + 8);
}
__host__ __device__ constexpr int dc_region(int pp) {
  return mx(kTile * (round_up(kMaxN, 32) + 8) + kMaxN * ld_gt(pp), kStages * dc_ring_stage(pp));
}
__host__ __device__ constexpr int db_ring_stage(int pp) {
  return kBwdK * ld_gt(pp) + kBwdK * ld_2tg(kMaxN) + kBwdK * ld_gt(kTile);
}
__host__ __device__ constexpr int db_region(int pp) {
  return mx(kTile * (round_up(kMaxN, 32) + 8) + kMaxN * ld_gt(pp), kStages * db_ring_stage(pp));
}
size_t dc_smem(int pp, int cpad) {
  return (static_cast<size_t>(cpad) + 32) * sizeof(double) +
         (static_cast<size_t>(cpad) + kTile * ld_gt(pp) + dc_region(pp)) * sizeof(float);
}
size_t db_smem(int pp, int cpad) {
  return (static_cast<size_t>(cpad) + 32) * sizeof(double) +
         (2 * static_cast<size_t>(cpad) + kTile * ld_gt(pp) + db_region(pp)) * sizeof(float);
}

// The 8-position k-step k of an A fragment read at (row, column) from a
// tile with row stride ld, rows ra and ra + 8: a0 (ra, k + t), a1 (ra + 8,
// k + t), a2 (ra, k + t + 4), a3 (ra + 8, k + t + 4), each row scaled.
__device__ __forceinline__ SplitA frag_gt(const float* tile, int ld, int ra, int k, int t,
                                          float sa, float sb) {
  const float* p = tile + ra * ld + k + t;
  const float f[4] = {p[0] * sa, p[8 * ld] * sb, p[4] * sa, p[8 * ld + 4] * sb};
  return SplitA(f);
}

// A score tile x (16 rows, columns 8n .. 8n + 7) in the accumulator layout
// as the A operand of step n: k-index t is column 2t, t + 4 is 2t + 1.
__device__ __forceinline__ SplitA frag_acc(const float (&x)[4]) {
  const float f[4] = {x[0], x[2], x[1], x[3]};
  return SplitA(f);
}

// Stage 4: dC rows [64 it, 64 it + 64) of one (batch, head, chunk), and the
// rows' dcum terms. Blocks: (tile, chunk, batch x head), heaviest tiles first.
template <int kPP>
__global__ void __launch_bounds__(kBwdThreads) bwd_chunk_dc_kernel(BwdArgs a) {
  constexpr int kLdY = ld_gt(kPP);                       // dy (64, Pp): (g, t)
  constexpr int kLdC = round_up(kMaxN, 32) + 8;          // C (64, N): float2 at (g, 2t)
  constexpr int kLdS = ld_gt(kPP);                       // S_c (N, Pp): (g, t)
  constexpr int kLdX = ld_gt(kPP);                       // x (32, Pp): (g, t)
  constexpr int kLdB = ld_2tg(kMaxN);                    // B (32, N): (2t, g)
  constexpr int kLdCB = kBwdK + 8;                       // C B^T (64, 32): float2 at (g, 2t)
  constexpr int kStage = dc_ring_stage(kPP);
  extern __shared__ __align__(16) double smem_dc[];
  double* cum = smem_dc;                                     // (cpad)
  double* carry = cum + a.cpad;                              // (32)
  float* dts = reinterpret_cast<float*>(carry + 32);         // (cpad)
  float* dyt = dts + a.cpad;                                 // (64, kLdY)
  float* region = dyt + kTile * kLdY;
  float* ct = region;                                        // phase 1: C (64, kLdC)
  float* stile = ct + kTile * kLdC;                          //          S_c (N, kLdS)
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int bhs = a.batch * a.heads;
  const int bh = blockIdx.x % bhs;
  const int ci = (blockIdx.x / bhs) % a.nc;
  const int it = a.ntile - 1 - static_cast<int>(blockIdx.x / bhs / a.nc);
  const long long c0 = static_cast<long long>(ci) * a.chunk;
  const int len = static_cast<int>(min(static_cast<long long>(a.chunk), a.seqlen - c0));
  const int i0 = it * kTile;
  if (i0 >= len) return;
  const int bi = bh / a.heads, h = bh % a.heads, gi = h / a.hpg;
  const float A = -expf(a.a_log[h]);
  const float* xp = a.x + bi * a.sx[0] + h * a.sx[1] + c0 * a.sx[2];
  const float* dtp = a.dt + bi * a.sdt[0] + h * a.sdt[1] + c0 * a.sdt[2];
  const float* bp = a.b + bi * a.sb[0] + gi * a.sb[1] + c0 * a.sb[2];
  const float* cp = a.c + bi * a.sc[0] + gi * a.sc[1] + (c0 + i0) * a.sc[2];
  const float* dyp = a.dy + bi * a.sdy[0] + h * a.sdy[1] + (c0 + i0) * a.sdy[2];
  const float* cbp = a.cb + ((static_cast<long long>(bi) * a.groups + gi) * a.nc + ci) *
                                a.cpad * a.cpad + static_cast<long long>(i0) * a.cpad;
  const float* sp = a.states + (static_cast<long long>(bh) * a.nc + ci) * a.np * kPP;
  const int ntn = a.np / 8;  // n-tiles over N

  load_rows<kTile, kPP, kBwdThreads>(dyt, kLdY, dyp, a.sdy[2], len - i0, a.p, a.dy16 != 0);
  if (ci > 0) {
    load_rows<kTile, kMaxN, kBwdThreads>(ct, kLdC, cp, a.sc[2], len - i0, a.n, a.bc16 != 0);
    load_dense<kMaxN, kPP, kBwdThreads>(stile, kLdS, sp, kPP, a.np);
  }
  cp_async_commit();
  chunk_cum<kBwdThreads>(cum, carry, dts, dtp, a.sdt[2], len, i0 + kTile, A);
  cp_async_wait_all();
  __syncthreads();

  const int ra = 16 * warp + g, rb = ra + 8;  // this lane's rows in the tile
  const int ia = i0 + ra, ib = i0 + rb;       // ... in the chunk
  const double cum_a = cum[ia], cum_b = cum[ib];
  float acc[kMaxNT][4];
#pragma unroll
  for (int j = 0; j < kMaxNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  float row_a = 0.0f, row_b = 0.0f;  // this lane's part of the rows' dcum terms
  if (ci > 0) {
    // acc = exp(cum_i) (dy S_c^T)_i, then y^off_i.dy_i = C_i . acc_i.
#pragma unroll
    for (int k = 0; k < kPP; k += 8) {
      const SplitA as = frag_gt(dyt, kLdY, ra, k, t, 1.0f, 1.0f);
#pragma unroll
      for (int j = 0; j < kMaxNT; ++j) {
        if (j < ntn) {
          const float* sb = stile + (8 * j + g) * kLdS + k + t;
          as.mma(acc[j], SplitB(sb[0], sb[4]));
        }
      }
    }
    const float ea = exp2f(static_cast<float>(cum_a)), eb = exp2f(static_cast<float>(cum_b));
#pragma unroll
    for (int j = 0; j < kMaxNT; ++j) {
      acc[j][0] *= ea;
      acc[j][1] *= ea;
      acc[j][2] *= eb;
      acc[j][3] *= eb;
      if (j < ntn) {
        const float2 ca = *reinterpret_cast<const float2*>(ct + ra * kLdC + 8 * j + 2 * t);
        const float2 cb = *reinterpret_cast<const float2*>(ct + rb * kLdC + 8 * j + 2 * t);
        row_a = fmaf(ca.x, acc[j][0], fmaf(ca.y, acc[j][1], row_a));
        row_b = fmaf(cb.x, acc[j][2], fmaf(cb.y, acc[j][3], row_b));
      }
    }
  }
  __syncthreads();  // the region now takes the ring

  // Stages: the kBwdK-column slices of R left of and on the diagonal.
  const int nstage = (min(len, i0 + kTile) - 1) / kBwdK + 1;
  auto load = [&](int s) {
    if (s < nstage) {
      float* dst = region + (s % kStages) * kStage;
      const int j0 = s * kBwdK;
      load_rows<kBwdK, kPP, kBwdThreads>(dst, kLdX, xp + j0 * a.sx[2], a.sx[2], len - j0, a.p,
                                         a.x16 != 0);
      load_rows<kBwdK, kMaxN, kBwdThreads>(dst + kBwdK * kLdX, kLdB, bp + j0 * a.sb[2], a.sb[2],
                                           len - j0, a.n, a.bc16 != 0);
      load_dense<kTile, kBwdK, kBwdThreads>(dst + kBwdK * kLdX + kBwdK * kLdB, kLdCB, cbp + j0,
                                            a.cpad, kTile);
    }
    cp_async_commit();
  };
  load(0);
  const int w_hi = i0 + 16 * warp + 15;  // the warp's last chunk row
  for (int s = 0; s < nstage; ++s) {
    cp_async_wait_all();
    __syncthreads();  // stage s visible; the other stage free
    load(s + 1);
    const int j0 = s * kBwdK;
    if (j0 > w_hi) continue;  // right of all the warp's rows (warp-uniform)
    const float* xs = region + (s % kStages) * kStage;
    const float* bs = xs + kBwdK * kLdX;
    const float* cbs = bs + kBwdK * kLdB;
    // R = dy_i . xdt_j over this stage's columns.
    float r[kBwdK / 8][4];
#pragma unroll
    for (int n = 0; n < kBwdK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) r[n][e] = 0.0f;
#pragma unroll
    for (int k = 0; k < kPP; k += 8) {
      const SplitA as = frag_gt(dyt, kLdY, ra, k, t, 1.0f, 1.0f);
#pragma unroll
      for (int n = 0; n < kBwdK / 8; ++n) {
        if (j0 + 8 * n <= w_hi) {
          const float* xb = xs + (8 * n + g) * kLdX + k + t;
          const float d = dts[j0 + 8 * n + g];
          as.mma(r[n], SplitB(xb[0] * d, xb[4] * d));
        }
      }
    }
    // R o L, masked before the exp; sum_{j<i} M_ij; dC += (R o L) B.
#pragma unroll
    for (int n = 0; n < kBwdK / 8; ++n) {
      if (j0 + 8 * n > w_hi) continue;
      const int j = j0 + 8 * n + 2 * t;
      const float2 cba = *reinterpret_cast<const float2*>(cbs + ra * kLdCB + 8 * n + 2 * t);
      const float2 cbb = *reinterpret_cast<const float2*>(cbs + rb * kLdCB + 8 * n + 2 * t);
      const double cj0 = cum[j], cj1 = cum[j + 1];
      r[n][0] = j <= ia ? r[n][0] * exp2f(static_cast<float>(cum_a - cj0)) : 0.0f;
      r[n][1] = j + 1 <= ia ? r[n][1] * exp2f(static_cast<float>(cum_a - cj1)) : 0.0f;
      r[n][2] = j <= ib ? r[n][2] * exp2f(static_cast<float>(cum_b - cj0)) : 0.0f;
      r[n][3] = j + 1 <= ib ? r[n][3] * exp2f(static_cast<float>(cum_b - cj1)) : 0.0f;
      row_a += (j < ia ? r[n][0] * cba.x : 0.0f) + (j + 1 < ia ? r[n][1] * cba.y : 0.0f);
      row_b += (j < ib ? r[n][2] * cbb.x : 0.0f) + (j + 1 < ib ? r[n][3] * cbb.y : 0.0f);
      const SplitA as = frag_acc(r[n]);
      const float* bb = bs + (8 * n + 2 * t) * kLdB + g;
#pragma unroll
      for (int jn = 0; jn < kMaxNT; ++jn)
        if (jn < ntn) as.mma(acc[jn], SplitB(bb[8 * jn], bb[kLdB + 8 * jn]));
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    row_a += __shfl_xor_sync(0xffffffffu, row_a, off);
    row_b += __shfl_xor_sync(0xffffffffu, row_b, off);
  }
  float* dcp = a.dc + bi * a.sdc[0] + gi * a.sdc[1] + c0 * a.sdc[2];
  float* rows = a.rowterms + (static_cast<long long>(bh) * a.nc + ci) * a.cpad;
#pragma unroll
  for (int r2 = 0; r2 < 2; ++r2) {
    const int row = r2 == 0 ? ia : ib;
    if (row >= len) continue;
    if (t == 0) rows[row] = r2 == 0 ? row_a : row_b;
#pragma unroll
    for (int j = 0; j < kMaxNT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * t + e;
        if (col < a.n) atomicAdd(dcp + row * a.sdc[2] + col, acc[j][2 * r2 + e]);
      }
  }
}

// Stage 5: dB, dx and the column terms of rows [64 jt, 64 jt + 64) of one
// (batch, head, chunk). Blocks: (tile, chunk, batch x head), heaviest (the
// first) tiles first.
template <int kPP>
__global__ void __launch_bounds__(kBwdThreads) bwd_chunk_db_kernel(BwdArgs a) {
  constexpr int kNT = kPP / 8;
  constexpr int kLdX = ld_gt(kPP);                       // x (64, Pp): (g, t)
  constexpr int kLdBt = round_up(kMaxN, 32) + 8;         // B (64, N): float2 at (g, 2t)
  constexpr int kLdG = ld_gt(kPP);                       // G_c (N, Pp): (g, t) and (2t, g)
  constexpr int kLdY = ld_gt(kPP);                       // dy (32, Pp): (g, t) and (2t, g)
  constexpr int kLdC = ld_2tg(kMaxN);                    // C (32, N): (2t, g)
  constexpr int kLdCB = ld_gt(kTile);                    // C B^T (32 i, 64 j): (2t, g)
  constexpr int kStage = db_ring_stage(kPP);
  extern __shared__ __align__(16) double smem_db[];
  double* cum = smem_db;                                     // (cpad)
  double* carry = cum + a.cpad;                              // (32)
  float* dts = reinterpret_cast<float*>(carry + 32);         // (cpad)
  float* w = dts + a.cpad;                                   // (cpad)
  float* xt = w + a.cpad;                                    // (64, kLdX)
  float* region = xt + kTile * kLdX;
  float* bt = region;                                        // phase 1: B (64, kLdBt)
  float* gt = bt + kTile * kLdBt;                            //          G_c (N, kLdG)
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int bhs = a.batch * a.heads;
  const int bh = blockIdx.x % bhs;
  const int ci = (blockIdx.x / bhs) % a.nc;
  const int jt = static_cast<int>(blockIdx.x / bhs / a.nc);
  const long long c0 = static_cast<long long>(ci) * a.chunk;
  const int len = static_cast<int>(min(static_cast<long long>(a.chunk), a.seqlen - c0));
  const int j0 = jt * kTile;
  if (j0 >= len) return;
  const int bi = bh / a.heads, h = bh % a.heads, gi = h / a.hpg;
  const float A = -expf(a.a_log[h]);
  const float* xp = a.x + bi * a.sx[0] + h * a.sx[1] + (c0 + j0) * a.sx[2];
  const float* dtp = a.dt + bi * a.sdt[0] + h * a.sdt[1] + c0 * a.sdt[2];
  const float* bp = a.b + bi * a.sb[0] + gi * a.sb[1] + (c0 + j0) * a.sb[2];
  const float* cp = a.c + bi * a.sc[0] + gi * a.sc[1] + c0 * a.sc[2];
  const float* dyp = a.dy + bi * a.sdy[0] + h * a.sdy[1] + c0 * a.sdy[2];
  const float* cbp = a.cb + ((static_cast<long long>(bi) * a.groups + gi) * a.nc + ci) *
                                a.cpad * a.cpad + j0;
  const float* gp = a.gstates + (static_cast<long long>(bh) * a.nc + ci) * a.np * kPP;
  const bool has_g = ci + 1 < a.nc;  // G of the last chunk is 0
  const int ntn = a.np / 8;

  load_rows<kTile, kPP, kBwdThreads>(xt, kLdX, xp, a.sx[2], len - j0, a.p, a.x16 != 0);
  if (has_g) {
    load_rows<kTile, kMaxN, kBwdThreads>(bt, kLdBt, bp, a.sb[2], len - j0, a.n, a.bc16 != 0);
    load_dense<kMaxN, kPP, kBwdThreads>(gt, kLdG, gp, kPP, a.np);
  }
  cp_async_commit();
  chunk_cum<kBwdThreads>(cum, carry, dts, dtp, a.sdt[2], len, a.cpad, A);
  const double last = cum[len - 1];
  for (int r = threadIdx.x; r < a.cpad; r += kBwdThreads)
    w[r] = r < len ? exp2f(static_cast<float>(last - cum[r])) : 0.0f;
  cp_async_wait_all();
  __syncthreads();

  const int ra = 16 * warp + g, rb = ra + 8;  // this lane's rows in the tile
  const int ja = j0 + ra, jb = j0 + rb;       // ... in the chunk
  const float dta = dts[ja], dtb = dts[jb];
  const double cum_a = cum[ja], cum_b = cum[jb];
  float dbacc[kMaxNT][4], dxdt[kNT][4];
#pragma unroll
  for (int j = 0; j < kMaxNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dbacc[j][e] = 0.0f;
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dxdt[j][e] = 0.0f;
  float u_a = 0.0f, u_b = 0.0f;
  if (has_g) {
    // dB = diag(w) xdt G_c^T.
#pragma unroll
    for (int k = 0; k < kPP; k += 8) {
      const SplitA as = frag_gt(xt, kLdX, ra, k, t, dta, dtb);
#pragma unroll
      for (int jn = 0; jn < kMaxNT; ++jn) {
        if (jn < ntn) {
          const float* gb = gt + (8 * jn + g) * kLdG + k + t;
          as.mma(dbacc[jn], SplitB(gb[0], gb[4]));
        }
      }
    }
    // dxdt = diag(w) B G_c: k-index t is state row k + 2t, t + 4 is k + 2t + 1.
#pragma unroll
    for (int kn = 0; kn < kMaxNT; ++kn) {
      if (kn < ntn) {
        const int k = 8 * kn;
        const float2 lo = *reinterpret_cast<const float2*>(bt + ra * kLdBt + k + 2 * t);
        const float2 hi = *reinterpret_cast<const float2*>(bt + rb * kLdBt + k + 2 * t);
        const float af[4] = {lo.x, hi.x, lo.y, hi.y};
        const SplitA as(af);
        const float* gb = gt + (k + 2 * t) * kLdG + g;
#pragma unroll
        for (int jp = 0; jp < kNT; ++jp) as.mma(dxdt[jp], SplitB(gb[8 * jp], gb[kLdG + 8 * jp]));
      }
    }
    // u_j = w_j xdt_j . (B G_c)_j, and the w scaling.
    const float wa = w[ja], wb = w[jb];
#pragma unroll
    for (int jp = 0; jp < kNT; ++jp) {
      const float2 xa = *reinterpret_cast<const float2*>(xt + ra * kLdX + 8 * jp + 2 * t);
      const float2 xb = *reinterpret_cast<const float2*>(xt + rb * kLdX + 8 * jp + 2 * t);
      u_a = fmaf(xa.x, dxdt[jp][0], fmaf(xa.y, dxdt[jp][1], u_a));
      u_b = fmaf(xb.x, dxdt[jp][2], fmaf(xb.y, dxdt[jp][3], u_b));
      dxdt[jp][0] *= wa;
      dxdt[jp][1] *= wa;
      dxdt[jp][2] *= wb;
      dxdt[jp][3] *= wb;
    }
    u_a *= dta * wa;
    u_b *= dtb * wb;
#pragma unroll
    for (int jn = 0; jn < kMaxNT; ++jn) {
      dbacc[jn][0] *= wa;
      dbacc[jn][1] *= wa;
      dbacc[jn][2] *= wb;
      dbacc[jn][3] *= wb;
    }
  }
  __syncthreads();  // the region now takes the ring

  // Stages: the kBwdK-row slices of i from j0 to the chunk's end.
  const int nstage = (len - j0 + kBwdK - 1) / kBwdK;
  auto load = [&](int s) {
    if (s < nstage) {
      float* dst = region + (s % kStages) * kStage;
      const int i0 = j0 + s * kBwdK;
      load_rows<kBwdK, kPP, kBwdThreads>(dst, kLdY, dyp + i0 * a.sdy[2], a.sdy[2], len - i0,
                                         a.p, a.dy16 != 0);
      load_rows<kBwdK, kMaxN, kBwdThreads>(dst + kBwdK * kLdY, kLdC, cp + i0 * a.sc[2], a.sc[2],
                                           len - i0, a.n, a.bc16 != 0);
      load_dense<kBwdK, kTile, kBwdThreads>(dst + kBwdK * kLdY + kBwdK * kLdC, kLdCB,
                                            cbp + static_cast<long long>(i0) * a.cpad, a.cpad,
                                            kBwdK);
    }
    cp_async_commit();
  };
  load(0);
  const int w_lo = j0 + 16 * warp;  // the warp's first chunk row
  float col_a = 0.0f, col_b = 0.0f;  // this lane's part of sum_{i>j} M_ij
  for (int s = 0; s < nstage; ++s) {
    cp_async_wait_all();
    __syncthreads();  // stage s visible; the other stage free
    load(s + 1);
    const int i0 = j0 + s * kBwdK;
    if (i0 + kBwdK - 1 < w_lo) continue;  // above all the warp's rows (warp-uniform)
    const float* ys = region + (s % kStages) * kStage;
    const float* cs = ys + kBwdK * kLdY;
    const float* cbs = cs + kBwdK * kLdC;
    // R^T = xdt_j . dy_i over this stage's rows i.
    float r[kBwdK / 8][4], q[kBwdK / 8][4];
#pragma unroll
    for (int n = 0; n < kBwdK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) r[n][e] = 0.0f;
#pragma unroll
    for (int k = 0; k < kPP; k += 8) {
      const SplitA as = frag_gt(xt, kLdX, ra, k, t, dta, dtb);
#pragma unroll
      for (int n = 0; n < kBwdK / 8; ++n) {
        const float* yb = ys + (8 * n + g) * kLdY + k + t;
        as.mma(r[n], SplitB(yb[0], yb[4]));
      }
    }
    // E = L_ij (masked before the exp), R^T o E, (C B^T o E)^T, sum_{i>j} M_ij.
#pragma unroll
    for (int n = 0; n < kBwdK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ii = 8 * n + 2 * t + (e & 1);   // row of the stage
        const int i = i0 + ii, j = e < 2 ? ja : jb;
        const bool ok = i >= j && i < len;
        const float cbv = cbs[ii * kLdCB + (e < 2 ? ra : rb)];
        const float el = ok ? exp2f(static_cast<float>(cum[i] - (e < 2 ? cum_a : cum_b))) : 0.0f;
        r[n][e] = ok ? r[n][e] * el : 0.0f;
        q[n][e] = ok ? cbv * el : 0.0f;
        const float m = i > j && ok ? r[n][e] * cbv : 0.0f;
        if (e < 2) col_a += m; else col_b += m;
      }
    // dB += (R^T o E) C_i, dxdt += (C B^T o E)^T dy_i.
#pragma unroll
    for (int n = 0; n < kBwdK / 8; ++n) {
      const SplitA ar = frag_acc(r[n]), aq = frag_acc(q[n]);
      const float* cb = cs + (8 * n + 2 * t) * kLdC + g;
#pragma unroll
      for (int jn = 0; jn < kMaxNT; ++jn)
        if (jn < ntn) ar.mma(dbacc[jn], SplitB(cb[8 * jn], cb[kLdC + 8 * jn]));
      const float* yb = ys + (8 * n + 2 * t) * kLdY + g;
#pragma unroll
      for (int jp = 0; jp < kNT; ++jp) aq.mma(dxdt[jp], SplitB(yb[8 * jp], yb[kLdY + 8 * jp]));
    }
  }

  // dx = dxdt dt, dxdt.x, and the quad sums of the column terms.
  float xd_a = 0.0f, xd_b = 0.0f;
#pragma unroll
  for (int jp = 0; jp < kNT; ++jp) {
    const float2 xa = *reinterpret_cast<const float2*>(xt + ra * kLdX + 8 * jp + 2 * t);
    const float2 xb = *reinterpret_cast<const float2*>(xt + rb * kLdX + 8 * jp + 2 * t);
    xd_a = fmaf(xa.x, dxdt[jp][0], fmaf(xa.y, dxdt[jp][1], xd_a));
    xd_b = fmaf(xb.x, dxdt[jp][2], fmaf(xb.y, dxdt[jp][3], xd_b));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    col_a += __shfl_xor_sync(0xffffffffu, col_a, off);
    col_b += __shfl_xor_sync(0xffffffffu, col_b, off);
    u_a += __shfl_xor_sync(0xffffffffu, u_a, off);
    u_b += __shfl_xor_sync(0xffffffffu, u_b, off);
    xd_a += __shfl_xor_sync(0xffffffffu, xd_a, off);
    xd_b += __shfl_xor_sync(0xffffffffu, xd_b, off);
  }
  float* dxp = a.dx + bi * a.sdx[0] + h * a.sdx[1] + c0 * a.sdx[2];
  float* dbp = a.db + bi * a.sdb[0] + gi * a.sdb[1] + c0 * a.sdb[2];
  float* cols = a.colterms + (static_cast<long long>(bh) * a.nc + ci) * a.cpad * 3;
#pragma unroll
  for (int r2 = 0; r2 < 2; ++r2) {
    const int row = r2 == 0 ? ja : jb;
    if (row >= len) continue;
    const float d = r2 == 0 ? dta : dtb;
    if (t == 0) {
      cols[3 * row] = r2 == 0 ? col_a : col_b;
      cols[3 * row + 1] = r2 == 0 ? u_a : u_b;
      cols[3 * row + 2] = r2 == 0 ? xd_a : xd_b;
    }
#pragma unroll
    for (int jp = 0; jp < kNT; ++jp)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * jp + 2 * t + e;
        if (col < a.p) dxp[row * a.sdx[2] + col] = dxdt[jp][2 * r2 + e] * d;
      }
#pragma unroll
    for (int jn = 0; jn < kMaxNT; ++jn)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * jn + 2 * t + e;
        if (col < a.n) atomicAdd(dbp + row * a.sdb[2] + col, dbacc[jn][2 * r2 + e]);
      }
  }
}

// In-place inclusive prefix sums of v[0, count) (float64, shared memory): a
// run of rows a thread, then warp-shuffle scans of the runs. Ends with a
// barrier.
template <int kThreads>
__device__ void block_scan(double* v, double* carry, int count) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int per = (count + kThreads - 1) / kThreads;
  const int lo = threadIdx.x * per;
  double run = 0.0;
  for (int k = 0; k < per; ++k)
    if (lo + k < count) {
      run += v[lo + k];
      v[lo + k] = run;
    }
  double incl = run;
  for (int off = 1; off < 32; off <<= 1) {
    const double u = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += u;
  }
  if (lane == 31) carry[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    double c = lane < kThreads / 32 ? carry[lane] : 0.0;
    for (int off = 1; off < 32; off <<= 1) {
      const double u = __shfl_up_sync(0xffffffffu, c, off);
      if (lane >= off) c += u;
    }
    if (lane < kThreads / 32) carry[lane] = c;
  }
  __syncthreads();
  const double offset = (incl - run) + (warp > 0 ? carry[warp - 1] : 0.0);
  for (int k = 0; k < per; ++k)
    if (lo + k < count) v[lo + k] += offset;
  __syncthreads();
}

// A block-wide float64 sum; every thread gets it. `red` holds 32 doubles.
template <int kThreads>
__device__ double block_sum(double v, double* red) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  double s = 0.0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) s += red[w];
  __syncthreads();
  return s;
}

// Stage 6: ddt and the chunk's part of dA_log, per (batch, head, chunk).
// Shared: the reverse sums and the prefix sums (cpad float64 each), 32 for
// the carries and 32 for the block sums.
__global__ void __launch_bounds__(kDdtThreads) bwd_ddt_kernel(BwdArgs a) {
  extern __shared__ __align__(16) double smem_dd[];
  double* suf = smem_dd;          // reversed: suf[len - 1 - s] = dcum_s, then its prefix sums
  double* pre = suf + a.cpad;     // u_j, then its prefix sums
  double* carry = pre + a.cpad;   // (32)
  double* red = carry + 32;       // (32)
  const int bhs = a.batch * a.heads;
  const int bh = blockIdx.x % bhs, ci = blockIdx.x / bhs;
  const int bi = bh / a.heads, h = bh % a.heads;
  const long long c0 = static_cast<long long>(ci) * a.chunk;
  const int len = static_cast<int>(min(static_cast<long long>(a.chunk), a.seqlen - c0));
  const float A = -expf(a.a_log[h]);
  const long long cidx = static_cast<long long>(bh) * a.nc + ci;
  const float* rows = a.rowterms + cidx * a.cpad;
  const float* cols = a.colterms + cidx * a.cpad * 3;
  const float* dtp = a.dt + bi * a.sdt[0] + h * a.sdt[1] + c0 * a.sdt[2];
  float* ddtp = a.ddt + bi * a.sddt[0] + h * a.sddt[1] + c0 * a.sddt[2];
  for (int r = threadIdx.x; r < len; r += kDdtThreads) {
    suf[len - 1 - r] = static_cast<double>(rows[r]) - static_cast<double>(cols[3 * r]);
    pre[r] = cols[3 * r + 1];
  }
  // <G_c, S_c> over the (Np, Pp) state; 0 for the last chunk (G = 0).
  const long long per = static_cast<long long>(a.np) * a.pp;
  const float* gs = a.gstates + cidx * per;
  const float* ss = a.states + cidx * per;
  double dot = 0.0;
  for (long long e = threadIdx.x; e < per; e += kDdtThreads)
    dot += static_cast<double>(gs[e]) * static_cast<double>(ss[e]);
  dot = block_sum<kDdtThreads>(dot, red);  // (its barriers publish suf and pre)
  block_scan<kDdtThreads>(suf, carry, len);
  block_scan<kDdtThreads>(pre, carry, len);
  const double state = static_cast<double>(a.decay[cidx]) * dot;
  double da = 0.0;
  for (int r = threadIdx.x; r < len; r += kDdtThreads) {
    const double dda = suf[len - 1 - r] + state + (pre[r] - static_cast<double>(cols[3 * r + 1]));
    ddtp[r * a.sddt[2]] = static_cast<float>(cols[3 * r + 2] + static_cast<double>(A) * dda);
    da += dda * static_cast<double>(dtp[r * a.sdt[2]]);
  }
  da = block_sum<kDdtThreads>(da, red);
  if (threadIdx.x == 0) a.dalog[cidx] = da * static_cast<double>(A);
}

size_t ddt_smem(int cpad) { return (2 * static_cast<size_t>(cpad) + 64) * sizeof(double); }

// ptrs: x, dt, a_log, b, c, dy, states, cb, gstates, decay, rowterms,
// colterms, dalog, dx, ddt, db, dc; strides (batch, head or group, seq) of
// x, dt, b, c, dy, dx, ddt, db, dc.
bool make_bwd_args(BwdArgs& a, void* const* ptrs, const long long* strides, const int* dims) {
  Args f;
  if (!set_sizes(f, dims) || f.n > kMaxN) return false;
  a.batch = f.batch; a.heads = f.heads; a.groups = f.groups; a.seqlen = f.seqlen;
  a.p = f.p; a.n = f.n; a.chunk = f.chunk; a.hpg = f.hpg; a.nc = f.nc; a.ntile = f.ntile;
  a.cpad = f.cpad; a.np = f.np; a.pp = f.pp;
  a.x = static_cast<const float*>(ptrs[0]);
  a.dt = static_cast<const float*>(ptrs[1]);
  a.a_log = static_cast<const float*>(ptrs[2]);
  a.b = static_cast<const float*>(ptrs[3]);
  a.c = static_cast<const float*>(ptrs[4]);
  a.dy = static_cast<const float*>(ptrs[5]);
  a.states = static_cast<const float*>(ptrs[6]);
  a.cb = static_cast<float*>(ptrs[7]);
  a.gstates = static_cast<float*>(ptrs[8]);
  a.decay = static_cast<float*>(ptrs[9]);
  a.rowterms = static_cast<float*>(ptrs[10]);
  a.colterms = static_cast<float*>(ptrs[11]);
  a.dalog = static_cast<double*>(ptrs[12]);
  a.dx = static_cast<float*>(ptrs[13]);
  a.ddt = static_cast<float*>(ptrs[14]);
  a.db = static_cast<float*>(ptrs[15]);
  a.dc = static_cast<float*>(ptrs[16]);
  long long* dst[9] = {a.sx, a.sdt, a.sb, a.sc, a.sdy, a.sdx, a.sddt, a.sdb, a.sdc};
  for (int t = 0; t < 9; ++t)
    for (int i = 0; i < 3; ++i) dst[t][i] = strides[3 * t + i];
  bool bc16 = a.n % 4 == 0 && aligned16(a.b) && aligned16(a.c);
  bool x16 = a.p % 4 == 0 && aligned16(a.x);
  bool dy16 = a.p % 4 == 0 && aligned16(a.dy);
  for (int i = 0; i < 3; ++i) {
    bc16 = bc16 && a.sb[i] % 4 == 0 && a.sc[i] % 4 == 0;
    x16 = x16 && a.sx[i] % 4 == 0;
    dy16 = dy16 && a.sdy[i] % 4 == 0;
  }
  a.bc16 = bc16 ? 1 : 0;
  a.x16 = x16 ? 1 : 0;
  a.dy16 = dy16 ? 1 : 0;
  return true;
}

// Launch shape of backward kernel 0..5 (BWD order): dynamic shared memory,
// blocks, threads.
void bwd_shape(int kernel, const BwdArgs& a, long long* out) {
  const Args f = fwd_view(a, kernel == 1);
  const long long bhc = static_cast<long long>(a.batch) * a.heads * a.nc;
  switch (kernel) {
    case 0: out[0] = stage_smem(0, f); out[1] = stage_blocks(0, f); out[2] = kCbThreads; break;
    case 1: out[0] = stage_smem(1, f); out[1] = stage_blocks(1, f); out[2] = kStateThreads; break;
    case 2: out[0] = 0; out[1] = stage_blocks(2, f); out[2] = kPassThreads; break;
    case 3: out[0] = dc_smem(a.pp, a.cpad); out[1] = bhc * a.ntile; out[2] = kBwdThreads; break;
    case 4: out[0] = db_smem(a.pp, a.cpad); out[1] = bhc * a.ntile; out[2] = kBwdThreads; break;
    default: out[0] = ddt_smem(a.cpad); out[1] = bhc; out[2] = kDdtThreads;
  }
}

template <typename Kernel>
int launch_bwd(Kernel kernel, int which, const BwdArgs& a, void* stream) {
  long long shape[3];
  bwd_shape(which, a, shape);
  if (shape[1] > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (shape[1] == 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(shape[0]));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(shape[1]), static_cast<int>(shape[2]), shape[0],
           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Elements of the three scratches, (C B^T, states, decay), into out[3];
// returns cudaErrorInvalidValue for sizes the kernels do not take, else 0.
extern "C" int ssd_scratch_elems(const int* dims, long long* out) {
  Args a;
  if (!set_sizes(a, dims)) return static_cast<int>(cudaErrorInvalidValue);
  const long long chunks = static_cast<long long>(a.batch) * a.nc;
  out[0] = chunks * a.groups * a.cpad * a.cpad;
  out[1] = chunks * a.heads * a.np * a.pp;
  out[2] = chunks * a.heads;
  return 0;
}

// Launch shape of stage 0..3 (chunk_cb, chunk_state, state_pass,
// chunk_scan) into out[3]: dynamic shared memory bytes a block, blocks,
// threads a block.
extern "C" int ssd_stage_shape(int stage, const int* dims, long long* out) {
  Args a;
  if (stage < 0 || stage > 3 || !set_sizes(a, dims)) return static_cast<int>(cudaErrorInvalidValue);
  out[0] = static_cast<long long>(stage_smem(stage, a));
  out[1] = stage_blocks(stage, a);
  out[2] = stage_threads(stage);
  return 0;
}

// The four stages, each returning the cudaError_t of cudaFuncSetAttribute or
// of its launch (0 = success); none synchronises. Launch them in this order
// on one stream.
extern "C" int ssd_chunk_cb(void* const* ptrs, const long long* strides, const int* dims,
                            void* stream) {
  Args a;
  if (!make_args(a, ptrs, strides, dims)) return static_cast<int>(cudaErrorInvalidValue);
  return launch(chunk_cb_kernel, 0, a, stream);
}

extern "C" int ssd_chunk_state(void* const* ptrs, const long long* strides, const int* dims,
                               void* stream) {
  Args a;
  if (!make_args(a, ptrs, strides, dims)) return static_cast<int>(cudaErrorInvalidValue);
  switch (a.pp) {
    case 8: return launch(chunk_state_kernel<8, false>, 1, a, stream);
    case 16: return launch(chunk_state_kernel<16, false>, 1, a, stream);
    case 32: return launch(chunk_state_kernel<32, false>, 1, a, stream);
    case 64: return launch(chunk_state_kernel<64, false>, 1, a, stream);
    default: return launch(chunk_state_kernel<128, false>, 1, a, stream);
  }
}

extern "C" int ssd_state_pass(void* const* ptrs, const long long* strides, const int* dims,
                              void* stream) {
  Args a;
  if (!make_args(a, ptrs, strides, dims)) return static_cast<int>(cudaErrorInvalidValue);
  return launch(state_pass_kernel, 2, a, stream);
}

extern "C" int ssd_chunk_scan(void* const* ptrs, const long long* strides, const int* dims,
                              void* stream) {
  Args a;
  if (!make_args(a, ptrs, strides, dims)) return static_cast<int>(cudaErrorInvalidValue);
  switch (a.pp) {
    case 8: return launch(chunk_scan_kernel<8>, 3, a, stream);
    case 16: return launch(chunk_scan_kernel<16>, 3, a, stream);
    case 32: return launch(chunk_scan_kernel<32>, 3, a, stream);
    case 64: return launch(chunk_scan_kernel<64>, 3, a, stream);
    default: return launch(chunk_scan_kernel<128>, 3, a, stream);
  }
}

// Elements of the backward's scratches, (C B^T, G, decay, row terms,
// column terms, dA_log parts (float64)), into out[6]; returns
// cudaErrorInvalidValue for sizes the backward does not take (N > 128).
extern "C" int ssd_bwd_scratch_elems(const int* dims, long long* out) {
  Args a;
  if (!set_sizes(a, dims) || a.n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  const long long chunks = static_cast<long long>(a.batch) * a.nc;
  out[0] = chunks * a.groups * a.cpad * a.cpad;
  out[1] = chunks * a.heads * a.np * a.pp;
  out[2] = chunks * a.heads;
  out[3] = chunks * a.heads * a.cpad;
  out[4] = 3 * out[3];
  out[5] = chunks * a.heads;
  return 0;
}

// Launch shape of backward kernel 0..5 (bwd_chunk_cb, bwd_chunk_state,
// bwd_state_pass, bwd_chunk_dc, bwd_chunk_db, bwd_ddt) into out[3]: dynamic
// shared memory bytes a block, blocks, threads a block.
extern "C" int ssd_bwd_shape(int kernel, const int* dims, long long* out) {
  Args f;
  if (kernel < 0 || kernel > 5 || !set_sizes(f, dims) || f.n > kMaxN)
    return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a;
  a.batch = f.batch; a.heads = f.heads; a.groups = f.groups; a.seqlen = f.seqlen;
  a.p = f.p; a.n = f.n; a.chunk = f.chunk; a.hpg = f.hpg; a.nc = f.nc; a.ntile = f.ntile;
  a.cpad = f.cpad; a.np = f.np; a.pp = f.pp;
  a.x16 = a.bc16 = a.dy16 = 0;
  bwd_shape(kernel, a, out);
  return 0;
}

// The six backward kernels, each returning the cudaError_t of
// cudaFuncSetAttribute or of its launch (0 = success); none synchronises.
// Launch them in this order on the stream of the forward. dx and ddt are
// written whole, dB and dC added into zeroed outputs, dA_log's parts
// written to their scratch.
extern "C" int ssd_bwd_chunk_cb(void* const* ptrs, const long long* strides, const int* dims,
                                void* stream) {
  BwdArgs a;
  if (!make_bwd_args(a, ptrs, strides, dims)) return static_cast<int>(cudaErrorInvalidValue);
  return launch(chunk_cb_kernel, 0, fwd_view(a, false), stream);
}

extern "C" int ssd_bwd_chunk_state(void* const* ptrs, const long long* strides, const int* dims,
                                   void* stream) {
  BwdArgs a;
  if (!make_bwd_args(a, ptrs, strides, dims)) return static_cast<int>(cudaErrorInvalidValue);
  const Args f = fwd_view(a, true);
  switch (a.pp) {
    case 8: return launch(chunk_state_kernel<8, true>, 1, f, stream);
    case 16: return launch(chunk_state_kernel<16, true>, 1, f, stream);
    case 32: return launch(chunk_state_kernel<32, true>, 1, f, stream);
    case 64: return launch(chunk_state_kernel<64, true>, 1, f, stream);
    default: return launch(chunk_state_kernel<128, true>, 1, f, stream);
  }
}

extern "C" int ssd_bwd_state_pass(void* const* ptrs, const long long* strides, const int* dims,
                                  void* stream) {
  BwdArgs a;
  if (!make_bwd_args(a, ptrs, strides, dims)) return static_cast<int>(cudaErrorInvalidValue);
  return launch(bwd_state_pass_kernel, 2, fwd_view(a, true), stream);
}

extern "C" int ssd_bwd_chunk_dc(void* const* ptrs, const long long* strides, const int* dims,
                                void* stream) {
  BwdArgs a;
  if (!make_bwd_args(a, ptrs, strides, dims)) return static_cast<int>(cudaErrorInvalidValue);
  switch (a.pp) {
    case 8: return launch_bwd(bwd_chunk_dc_kernel<8>, 3, a, stream);
    case 16: return launch_bwd(bwd_chunk_dc_kernel<16>, 3, a, stream);
    case 32: return launch_bwd(bwd_chunk_dc_kernel<32>, 3, a, stream);
    case 64: return launch_bwd(bwd_chunk_dc_kernel<64>, 3, a, stream);
    default: return launch_bwd(bwd_chunk_dc_kernel<128>, 3, a, stream);
  }
}

extern "C" int ssd_bwd_chunk_db(void* const* ptrs, const long long* strides, const int* dims,
                                void* stream) {
  BwdArgs a;
  if (!make_bwd_args(a, ptrs, strides, dims)) return static_cast<int>(cudaErrorInvalidValue);
  switch (a.pp) {
    case 8: return launch_bwd(bwd_chunk_db_kernel<8>, 4, a, stream);
    case 16: return launch_bwd(bwd_chunk_db_kernel<16>, 4, a, stream);
    case 32: return launch_bwd(bwd_chunk_db_kernel<32>, 4, a, stream);
    case 64: return launch_bwd(bwd_chunk_db_kernel<64>, 4, a, stream);
    default: return launch_bwd(bwd_chunk_db_kernel<128>, 4, a, stream);
  }
}

extern "C" int ssd_bwd_ddt(void* const* ptrs, const long long* strides, const int* dims,
                           void* stream) {
  BwdArgs a;
  if (!make_bwd_args(a, ptrs, strides, dims)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_bwd(bwd_ddt_kernel, 5, a, stream);
}
