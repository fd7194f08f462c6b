// Mamba2 SSD chunked scan (arXiv:2405.21060, Alg. 1), float32, for sm_90a.
//
// Replaces the Pallas TPU kernel `_ssd_kernel`
// (src/repro/kernels/ssd_scan/ssd_scan.py:32). For each (batch b, head h) it
// walks the chunks of length C in order, carrying an (N, P) float32 state S
// that starts at zero. With dta = dt * -exp(A_log[h]), cum the inclusive
// prefix sum of dta within the chunk and xdt = x * dt:
//   y = ((C B^T) o L) xdt + (C o exp(cum)) S,  L[i,j] = exp(cum_i - cum_j), j <= i
//   S <- exp(cum_last) S + (B o exp(cum_last - cum))^T xdt
// The four products (C B^T, (scores o L) xdt, C S, (B o decay)^T xdt) are
// this kernel's own fp32 FMA loops over shared memory.
//
// Design, against what the TPU kernel relied on:
//   * Sequential grid -> a loop in the block. The TPU kernel's chunk axis is
//     a sequential grid dimension with S in VMEM scratch; blocks on Hopper
//     run in no order. One block per (b, h) walks its chunks and keeps S in
//     shared memory (N*P*4 = 32 KB at N=128, P=64). B*H = 192 blocks at the
//     main path's shapes: 1.45 waves on 132 SMs, one block per SM.
//   * The chunk's C x C score matrix (256 KB at C=256) does not fit the
//     227 KB a block may have. Rows and columns are cut into 64-wide tiles;
//     tiles above the diagonal are skipped, so 10 of 16 are computed at
//     C=256. L is masked before the exp: exp(cum_i - cum_j), j > i,
//     overflows.
//   * B and C are read by group (head h uses group h / (H/G)): no copy
//     repeated over the heads is made.
//   * Strided operands. x, dt, B, C and y come with their strides (the last
//     dimension's must be 1), so the model hands over its (B, L, H, P)
//     activations and its (B, L, G, N) conv outputs as views.
//   * Ragged edge. Rows past L (or past the chunk inside a 64-row tile) load
//     as zero with dt = 0, a no-op step, and are not written.
//   * The prefix sum cum is kept in float64. Within a chunk |cum| reaches
//     thousands when dt*|A| is large (2,800 at the main path's random
//     weights), and exp(cum_i - cum_j) for nearby i, j then loses
//     ulp(|cum|) ~ 2.4e-4 to the cancellation in float32: 1e-3 in y. The
//     differences are taken in float64 and rounded once; the products stay
//     float32.
// Each thread holds a 4 x (P/16) tile of y, a 4 x 4 tile of scores and an
// 8 x (P/16) tile of the state update in registers (16 x 16 threads).
//
// Bound: operations. Per (b, h, chunk) the TPU kernel's products are
// 2 C^2 N + 2 C^2 P + 4 C N P FLOP (33.5 MFLOP at C=256, N=128, P=64),
// 51.5 GFLOP per launch at the main path's shapes, against about 219 MB of
// traffic. This first kernel runs plain FMAs from shared memory (no
// mma.sync / wgmma, no TF32), so it sits well below the fp32 rate.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // 16 x 16
constexpr int kTile = 64;       // rows (and columns) of one score tile
constexpr int kNRows = 128;     // state rows of one state-update pass

struct Args {
  const float* x;       // (B, H, L, P) by strides sx
  const float* dt;      // (B, H, L) by strides sdt
  const float* a_log;   // (H,) contiguous
  const float* b;       // (B, G, L, N) by strides sb
  const float* c;       // (B, G, L, N) by strides sc
  float* y;             // (B, H, L, P) by strides sy
  long long sx[3], sdt[3], sb[3], sc[3], sy[3];  // batch, head|group, seq
  int heads, seqlen, p, n, heads_per_group, chunk;
};

__host__ __device__ inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

// Shared memory in bytes, in the order the kernel lays it out: the float64
// arrays first, then the float32 ones.
__host__ __device__ inline size_t smem_bytes(int pp, int nr, int cpad) {
  const size_t doubles = static_cast<size_t>(cpad)   // cum
                         + 32;                        // scan carries
  const size_t floats = static_cast<size_t>(nr) * pp        // S
                        + 2 * static_cast<size_t>(cpad)     // dt, decay to chunk end
                        + 2 * static_cast<size_t>(kTile) * (nr + 1)  // C rows, B rows
                        + static_cast<size_t>(kTile) * pp   // xdt rows
                        + static_cast<size_t>(kTile) * (kTile + 1);  // masked scores
  return doubles * sizeof(double) + floats * sizeof(float);
}

// rows [r0, r0 + kTile) of a (L, N) operand into a (kTile, nr + 1) tile;
// zero outside the chunk, past L and past N.
__device__ __forceinline__ void load_rows(float* tile, const float* src,
                                          long long stride_l, long long c0,
                                          int r0, int chunk, int seqlen, int n,
                                          int nr) {
  for (int i = threadIdx.x; i < kTile * nr; i += kThreads) {
    const int r = i / nr, k = i % nr;
    const long long l = c0 + r0 + r;
    float v = 0.0f;
    if (r0 + r < chunk && l < seqlen && k < n) v = src[l * stride_l + k];
    tile[r * (nr + 1) + k] = v;
  }
}

// rows [q0, q0 + kTile) of x * dt into a (kTile, kPP) tile; zero outside
// the chunk, past L and past P.
template <int kPP>
__device__ __forceinline__ void load_xdt(float* tile, const float* x,
                                         long long stride_l, const float* dts,
                                         long long c0, int q0, int chunk,
                                         int seqlen, int p) {
  for (int i = threadIdx.x; i < kTile * kPP; i += kThreads) {
    const int r = i / kPP, k = i % kPP;
    const long long l = c0 + q0 + r;
    float v = 0.0f;
    if (q0 + r < chunk && l < seqlen && k < p) v = x[l * stride_l + k] * dts[q0 + r];
    tile[i] = v;
  }
}

template <int kPB>
__global__ void __launch_bounds__(kThreads, 1) ssd_scan_kernel(Args a) {
  constexpr int kPP = 16 * kPB;  // P padded to the register tile
  extern __shared__ double smem[];
  const int n = a.n, chunk = a.chunk, seqlen = a.seqlen;
  const int nr = round_up(n, kNRows);
  const int ntile = (chunk + kTile - 1) / kTile;
  const int cpad = ntile * kTile;
  const int np1 = nr + 1;
  double* cum = smem;                    // (cpad)
  double* carry = cum + cpad;            // (32)
  float* S = reinterpret_cast<float*>(carry + 32);  // (nr, kPP)
  float* dts = S + nr * kPP;             // (cpad)
  float* dec = dts + cpad;               // (cpad)
  float* ct = dec + cpad;                // (kTile, nr + 1)
  float* bt = ct + kTile * np1;          // (kTile, nr + 1)
  float* xt = bt + kTile * np1;          // (kTile, kPP)
  float* sc = xt + kTile * kPP;          // (kTile, kTile + 1)

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int lane = tid % 32, warp = tid / 32;
  const int bi = blockIdx.x / a.heads, h = blockIdx.x % a.heads;
  const int gi = h / a.heads_per_group;
  const float A = -expf(a.a_log[h]);
  const float* xp = a.x + bi * a.sx[0] + h * a.sx[1];
  const float* dtp = a.dt + bi * a.sdt[0] + h * a.sdt[1];
  const float* bp = a.b + bi * a.sb[0] + gi * a.sb[1];
  const float* cp = a.c + bi * a.sc[0] + gi * a.sc[1];
  float* yp = a.y + bi * a.sy[0] + h * a.sy[1];

  for (int i = tid; i < nr * kPP; i += kThreads) S[i] = 0.0f;

  for (long long c0 = 0; c0 < seqlen; c0 += chunk) {
    // dt of the chunk, then cum = inclusive prefix sum of dt * A in float64:
    // each thread sums a run of `per` rows, a warp-shuffle scan adds the runs.
    for (int r = tid; r < cpad; r += kThreads) {
      const long long l = c0 + r;
      dts[r] = (r < chunk && l < seqlen) ? dtp[l * a.sdt[2]] : 0.0f;
    }
    __syncthreads();
    const int per = (cpad + kThreads - 1) / kThreads;
    const int lo = tid * per;
    double run = 0.0;
    for (int k = 0; k < per; ++k) {
      if (lo + k < cpad) {
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
      if (lo + k < cpad) cum[lo + k] += offset;
    __syncthreads();
    const double cend = cum[chunk - 1];
    for (int r = tid; r < cpad; r += kThreads)
      dec[r] = expf(static_cast<float>(cend - cum[r]));

    // y, one 64-row tile at a time: first exp(cum_i) C_i S, then the masked
    // score tiles on and below the diagonal.
    for (int it = 0; it < ntile; ++it) {
      const int r0 = it * kTile;
      __syncthreads();
      load_rows(ct, cp, a.sc[2], c0, r0, chunk, seqlen, n, nr);
      __syncthreads();
      float acc[4][kPB];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kPB; ++j) acc[i][j] = 0.0f;
      for (int k = 0; k < n; ++k) {
        float cv[4], sv[kPB];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = ct[(ty + 16 * i) * np1 + k];
#pragma unroll
        for (int j = 0; j < kPB; ++j) sv[j] = S[k * kPP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < kPB; ++j) acc[i][j] = fmaf(cv[i], sv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float e = expf(static_cast<float>(cum[r0 + ty + 16 * i]));
#pragma unroll
        for (int j = 0; j < kPB; ++j) acc[i][j] *= e;
      }

      for (int jt = 0; jt <= it; ++jt) {
        const int q0 = jt * kTile;
        __syncthreads();
        load_rows(bt, bp, a.sb[2], c0, q0, chunk, seqlen, n, nr);
        load_xdt<kPP>(xt, xp, a.sx[2], dts, c0, q0, chunk, seqlen, a.p);
        __syncthreads();
        float s4[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s4[i][j] = 0.0f;
        for (int k = 0; k < n; ++k) {
          float cv[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) cv[i] = ct[(ty + 16 * i) * np1 + k];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = bt[(tx + 16 * j) * np1 + k];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s4[i][j] = fmaf(cv[i], bv[j], s4[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int ri = r0 + ty + 16 * i;
          const double cum_i = cum[ri];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int cj = q0 + tx + 16 * j;
            // Mask before the exp.
            const float v =
                cj <= ri ? s4[i][j] * expf(static_cast<float>(cum_i - cum[cj])) : 0.0f;
            sc[(ty + 16 * i) * (kTile + 1) + tx + 16 * j] = v;
          }
        }
        __syncthreads();
        for (int k = 0; k < kTile; ++k) {
          float sv[4], xv[kPB];
#pragma unroll
          for (int i = 0; i < 4; ++i) sv[i] = sc[(ty + 16 * i) * (kTile + 1) + k];
#pragma unroll
          for (int j = 0; j < kPB; ++j) xv[j] = xt[k * kPP + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < kPB; ++j) acc[i][j] = fmaf(sv[i], xv[j], acc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = r0 + ty + 16 * i;
        const long long l = c0 + r;
        if (r < chunk && l < seqlen) {
#pragma unroll
          for (int j = 0; j < kPB; ++j) {
            const int p = tx + 16 * j;
            if (p < a.p) yp[l * a.sy[2] + p] = acc[i][j];
          }
        }
      }
    }

    // S <- exp(cum_last) S + (B o decay)^T xdt, 128 state rows a pass.
    const float chunk_decay = expf(static_cast<float>(cend));
    for (int nb0 = 0; nb0 < nr; nb0 += kNRows) {
      float ds[8][kPB];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < kPB; ++j) ds[i][j] = 0.0f;
      for (int jt = 0; jt < ntile; ++jt) {
        const int q0 = jt * kTile;
        __syncthreads();
        load_rows(bt, bp, a.sb[2], c0, q0, chunk, seqlen, n, nr);
        load_xdt<kPP>(xt, xp, a.sx[2], dts, c0, q0, chunk, seqlen, a.p);
        __syncthreads();
        for (int k = 0; k < kTile; ++k) {
          const float w = dec[q0 + k];
          float bv[8], xv[kPB];
#pragma unroll
          for (int i = 0; i < 8; ++i) bv[i] = bt[k * np1 + nb0 + ty + 16 * i] * w;
#pragma unroll
          for (int j = 0; j < kPB; ++j) xv[j] = xt[k * kPP + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < kPB; ++j) ds[i][j] = fmaf(bv[i], xv[j], ds[i][j]);
        }
      }
      // Every read of S for this chunk's y happened before the last barrier.
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < kPB; ++j) {
          float* s = &S[(nb0 + ty + 16 * i) * kPP + tx + 16 * j];
          *s = fmaf(chunk_decay, *s, ds[i][j]);
        }
    }
    __syncthreads();
  }
}

template <int kPB>
int launch(const Args& a, int blocks, void* stream) {
  const size_t bytes =
      smem_bytes(16 * kPB, round_up(a.n, kNRows), round_up(a.chunk, kTile));
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<kPB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_scan_kernel<kPB><<<blocks, kThreads, bytes,
                         static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int p_blocks(int p) {
  const int pb = (p + 15) / 16;
  return pb <= 1 ? 1 : pb <= 2 ? 2 : pb <= 4 ? 4 : 8;
}

}  // namespace

// Dynamic shared memory one launch asks for, in bytes.
extern "C" long long ssd_scan_smem_bytes(int p, int n, int chunk) {
  return static_cast<long long>(
      smem_bytes(16 * p_blocks(p), round_up(n, kNRows), round_up(chunk, kTile)));
}

// Returns the cudaError_t of cudaFuncSetAttribute or of the launch (0 =
// success); never synchronises. `strides` holds 15 element strides: x, dt,
// B, C, y, each as (batch, head or group, seq). P <= 128; H % G == 0.
extern "C" int ssd_scan(const float* x, const float* dt, const float* a_log,
                        const float* b, const float* c, float* y,
                        const long long* strides, int batch, int heads,
                        int groups, int seqlen, int p, int n, int chunk,
                        void* stream) {
  if (p < 1 || p > 128 || n < 1 || chunk < 1 || groups < 1 ||
      heads % groups != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || heads == 0 || seqlen == 0) return 0;
  Args a;
  a.x = x; a.dt = dt; a.a_log = a_log; a.b = b; a.c = c; a.y = y;
  for (int i = 0; i < 3; ++i) {
    a.sx[i] = strides[i];
    a.sdt[i] = strides[3 + i];
    a.sb[i] = strides[6 + i];
    a.sc[i] = strides[9 + i];
    a.sy[i] = strides[12 + i];
  }
  a.heads = heads; a.seqlen = seqlen; a.p = p; a.n = n;
  a.heads_per_group = heads / groups; a.chunk = chunk;
  const int blocks = batch * heads;
  switch (p_blocks(p)) {
    case 1: return launch<1>(a, blocks, stream);
    case 2: return launch<2>(a, blocks, stream);
    case 4: return launch<4>(a, blocks, stream);
    default: return launch<8>(a, blocks, stream);
  }
}
