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
template <int kPP>
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
  for (int j = threadIdx.x; j < nj * kStateJ; j += kStateThreads)
    w[j] = j < len ? dts[j] * exp2f(static_cast<float>(last - cum[j])) : 0.0f;
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
    case 8: return launch(chunk_state_kernel<8>, 1, a, stream);
    case 16: return launch(chunk_state_kernel<16>, 1, a, stream);
    case 32: return launch(chunk_state_kernel<32>, 1, a, stream);
    case 64: return launch(chunk_state_kernel<64>, 1, a, stream);
    default: return launch(chunk_state_kernel<128>, 1, a, stream);
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
