// Blockwise softmax attention with an online softmax, float32, for sm_90a.
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
// Design, against what the TPU kernel relied on:
//   * Sequential grid -> a loop in the block. The TPU kernel runs the KV
//     axis as a sequential grid dimension with m, l and acc in VMEM scratch.
//     Here one block owns one (b, h, 64-row query tile) and loops over the
//     64-row K/V tiles itself, from the first tile the window reaches up to
//     the diagonal; tiles above it are never loaded (block_attn.py:46-47).
//     At B = 2, L = 4096, H = 32 that is 4,096 blocks. Query tiles run
//     heaviest first (the last tile of the sequence has the most keys), so
//     the short causal blocks fill the tail of the launch.
//   * Shared memory. The Q tile, the K tile and the V tile sit in shared
//     memory (Q and K rows padded by one float against bank conflicts); the
//     64 x 64 probability tile reuses the K tile's space once the scores are
//     in registers. 98,816 bytes at hd = 128: two blocks per SM.
//   * Online softmax. Each thread keeps a 4 x 4 tile of scores, the running
//     max m and normalizer l of its 4 rows, and a 4 x (hd / 16) tile of the
//     (64, hd) accumulator, all float32 in registers (16 x 16 threads; the
//     16 threads of a row are one half-warp, reduced by shuffles).
//   * Masking before the exp. A masked score is never exponentiated: its
//     probability is set to 0. m starts at -inf and a row that has seen no
//     allowed key rescales by 0, so neither -inf nor a -1e30 sentinel goes
//     through exp. A row that may attend no key writes 0 (the TPU kernel's
//     max(l, 1e-30) guard gives the same).
//   * Ragged lengths. Rows past Lq and keys past Lk load as 0 and are
//     masked here, where the JAX wrapper pads to block multiples
//     (ops.py:31-36).
//   * No repeat, no transposes. K and V are read by group and q, k, v, o by
//     their (batch, seq, head) strides (the last dimension contiguous), so
//     the model hands over (B, L, heads, hd) projections as they are; the
//     JAX wrapper repeats K/V to every head (ops.py:24-27) and transposes
//     three times (ops.py:28-30).
//
// Bound: operations. The function needs 4 hd FLOP per allowed (i, j) pair
// (q.k, then p.v), 274,945,015,808 FLOP at Yi-6B's B = 2, L = 4096, H = 32,
// hd = 128, causal: 4.104 ms at the card's 67 TFLOP/s float32 rate, against
// 301,989,888 bytes of q, k, v and o (0.090 ms at 3.35 TB/s). This first
// kernel runs plain fp32 FMAs from shared memory (no TF32, no mma.sync or
// wgmma, no cp.async pipelining), one shared-memory load for every two
// FMAs, so it sits well below that rate; it computes the diagonal tiles
// whole, 1.5 % more pairs than the causal ones at L = 4096.
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kTile = 64;      // query rows and key rows of one tile
constexpr int kPS = kTile + 1; // row stride of the probability tile

struct Args {
  const float* q;  // (B, Lq, H, hd) by strides sq
  const float* k;  // (B, Lk, KV, hd) by strides sk
  const float* v;  // (B, Lk, KV, hd) by strides sv
  float* o;        // (B, Lq, H, hd) by strides so
  long long sq[3], sk[3], sv[3], so[3];  // batch, seq, head
  int heads, heads_per_group, lq, lk, hd, causal, window;
  float scale;
};

// Floats of the K tile's space, which the probability tile reuses.
__host__ __device__ constexpr int k_area(int hdp) {
  return kTile * (hdp + 1 > kPS ? hdp + 1 : kPS);
}

// Shared memory of one block: the Q tile with rows of hd + 1 floats, the
// K (then P) space, the V tile with rows of hd (hd padded to 16, 32, 64 or
// 128).
__host__ __device__ constexpr size_t smem_bytes(int hdp) {
  return (static_cast<size_t>(kTile) * (hdp + 1) + k_area(hdp) +
          static_cast<size_t>(kTile) * hdp) * sizeof(float);
}

// Rows [r0, r0 + kTile) of a (L, hd) operand with row stride `stride` into a
// (kTile, ld) tile; zero past L and past hd.
template <int kHD>
__device__ __forceinline__ void load_tile(float* tile, int ld, const float* src,
                                          long long stride, int r0, int len,
                                          int hd) {
  for (int i = threadIdx.x; i < kTile * kHD; i += kThreads) {
    const int r = i / kHD, c = i % kHD;
    float val = 0.0f;
    if (r0 + r < len && c < hd) val = src[(r0 + r) * stride + c];
    tile[r * ld + c] = val;
  }
}

template <int kPB>
__global__ void __launch_bounds__(kThreads, 2) block_attn_kernel(Args a) {
  constexpr int kHD = 16 * kPB;  // hd padded to the register tile
  constexpr int kQS = kHD + 1;   // row stride of the Q and K tiles
  extern __shared__ float smem[];
  float* qs = smem;                   // (kTile, kQS)
  float* ks = qs + kTile * kQS;       // (kTile, kQS); then P (kTile, kPS)
  float* vs = ks + k_area(kHD);       // (kTile, kHD)
  float* ps = ks;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int bi = blockIdx.x / a.heads, h = blockIdx.x % a.heads;
  const int g = h / a.heads_per_group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;  // heaviest first
  const float* qp = a.q + bi * a.sq[0] + h * a.sq[2];
  const float* kp = a.k + bi * a.sk[0] + g * a.sk[2];
  const float* vp = a.v + bi * a.sv[0] + g * a.sv[2];
  float* op = a.o + bi * a.so[0] + h * a.so[2];

  // The key tiles this query tile reaches.
  const int last_row = min(q0 + kTile, a.lq) - 1;
  int k_end = a.lk;                               // exclusive
  if (a.causal) k_end = min(k_end, last_row + 1);
  int k_begin = 0;
  if (a.window > 0) k_begin = max(0, q0 - a.window + 1);
  const int t_begin = k_begin / kTile;
  const int t_end = (k_end + kTile - 1) / kTile;

  load_tile<kHD>(qs, kQS, qp, a.sq[1], q0, a.lq, a.hd);

  float acc[4][kPB];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < kPB; ++j) acc[i][j] = 0.0f;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kTile;
    __syncthreads();  // every read of the previous K/P and V tiles is done
    load_tile<kHD>(ks, kQS, kp, a.sk[1], k0, a.lk, a.hd);
    load_tile<kHD>(vs, kHD, vp, a.sv[1], k0, a.lk, a.hd);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int c = 0; c < kHD; ++c) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * kQS + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * kQS + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // Scale, mask, and the online-softmax update of each of the 4 rows.
    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      bool ok[4];
      float tile_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        ok[j] = col < a.lk && (!a.causal || col <= row) &&
                (a.window <= 0 || row - col < a.window);
        s[i][j] *= a.scale;
        if (ok[j]) tile_max = fmaxf(tile_max, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, off));
      const float m_new = fmaxf(m[i], tile_max);
      // m[i] == -inf: nothing seen yet, acc and l are 0 and stay so.
      const float alpha = m[i] == -INFINITY ? 0.0f : expf(m[i] - m_new);
      float row_sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[i][j] = ok[j] ? expf(s[i][j] - m_new) : 0.0f;
        row_sum += p[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
      l[i] = l[i] * alpha + row_sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kPB; ++j) acc[i][j] *= alpha;
    }

    __syncthreads();  // every read of the K tile is done: P takes its place
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) ps[(ty + 16 * i) * kPS + tx + 16 * j] = p[i][j];
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float pv[4], vv[kPB];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * kPS + c];
#pragma unroll
      for (int j = 0; j < kPB; ++j) vv[j] = vs[c * kHD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kPB; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= a.lq) continue;
#pragma unroll
    for (int j = 0; j < kPB; ++j) {
      const int c = tx + 16 * j;
      if (c < a.hd) op[row * a.so[1] + c] = l[i] > 0.0f ? acc[i][j] / l[i] : 0.0f;
    }
  }
}

template <int kPB>
int launch(const Args& a, int batch, void* stream) {
  const size_t bytes = smem_bytes(16 * kPB);
  cudaError_t err = cudaFuncSetAttribute(
      block_attn_kernel<kPB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(block_attn_kernel<kPB>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(batch * a.heads, (a.lq + kTile - 1) / kTile);
  block_attn_kernel<kPB><<<grid, kThreads, bytes,
                           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int hd_blocks(int hd) {
  const int pb = (hd + 15) / 16;
  return pb <= 1 ? 1 : pb <= 2 ? 2 : pb <= 4 ? 4 : 8;
}

}  // namespace

// Dynamic shared memory one launch asks for, in bytes.
extern "C" long long block_attn_smem_bytes(int hd) {
  return static_cast<long long>(smem_bytes(16 * hd_blocks(hd)));
}

// Returns the cudaError_t of cudaFuncSetAttribute or of the launch (0 =
// success); never synchronises. Strides are in elements, (batch, seq, head)
// for each operand; the head dimension's stride is 1. hd <= 128, H % KV == 0,
// at most 65,535 query tiles.
extern "C" int block_attn(const float* q, const float* k, const float* v,
                          float* o, long long sq0, long long sq1, long long sq2,
                          long long sk0, long long sk1, long long sk2,
                          long long sv0, long long sv1, long long sv2,
                          long long so0, long long so1, long long so2,
                          int batch, int heads, int kv_heads, int lq, int lk,
                          int hd, int causal, int window, float scale,
                          void* stream) {
  if (hd < 1 || hd > 128 || kv_heads < 1 || heads % kv_heads != 0 ||
      (lq + kTile - 1) / kTile > 65535)
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
  a.scale = scale;
  switch (hd_blocks(hd)) {
    case 1: return launch<1>(a, batch, stream);
    case 2: return launch<2>(a, batch, stream);
    case 4: return launch<4>(a, batch, stream);
    default: return launch<8>(a, batch, stream);
  }
}
