// Flash attention forward for Hopper (sm_90a), bound with a plain C
// interface and loaded through ctypes by repro_torch/kernels/flash_attention.py.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py:_flash_kernel
// (wrapper flash_attention).
//
// What it computes, for batch b, query head h (reading KV head h / (H / K)),
// query i and key j, both counted from 0:
//   s_ij  = (q_i . k_j) * scale                      scale = 1 / sqrt(D), f32
//   s_ij  = tanh(s_ij / softcap) * softcap            when softcap > 0
//   valid = j < Skv and, only when causal, 0 <= i - j < window (window 0: no bound)
//   o_i   = sum_j p_ij v_j / max(sum_j p_ij, 1e-30)   online softmax over key tiles
// q, k and v are f32 or bf16, computed in f32; o is written in q's type.
// tanh is tanhf (no --use_fast_math); exp is expf in the f32 body and exp2
// of log2(e)-scaled arguments in the bf16 body. Two bodies compute it,
// one for each input type, and flash_attention_launch picks by type: f32
// runs the CUDA-core body (flash_attention_kernel), bf16 the tensor-core
// body (flash_attention_kernel_wgmma). Neither stands in for the other.
//
// Bound: operations. A (query, key) pair costs 4D operations (a D-deep dot
// product and a D-wide multiply-add into the output) against the 2D-byte
// rows of q, k, v and o moved once each: at gemma2-2b's D = 256 and 8192
// tokens the pairs are 2,000x more work than bytes, far above the card's
// 295 operations per byte in bf16 on the tensor cores, let alone its 20 in
// fp32 outside them.
//
// Both bodies loop over the key tiles that can hold a valid key: up to the
// diagonal when causal, from q0 - window + 1 when windowed. Skipping a tile
// changes nothing: a masked entry contributes exp(-inf - m) = 0. Masked
// scores are -inf and m starts at -1e30, so a row that has not met a valid
// key yet adds nothing (the Pallas kernel adds weight 1 there and clears it
// with alpha = 0 once a valid key arrives), and a row that meets none
// returns 0. Query tiles run longest first, so the causal tail does not
// trail. Rows and keys past the sequence read as zero and are masked: the
// wrapper pads nothing.
//
// The f32 body runs the work on the fp32 units. The TPU walks the key
// blocks on its sequential grid and keeps the running max m, sum l and the
// (Qb, D) accumulator in VMEM scratch. Here one block of 256 threads owns
// one (batch, head, 64-row query tile), keeps m and l in registers (the 16
// threads of a row group hold copies) and the (64, D) accumulator in
// registers (4x4 micro-tiles). Both products are register-tiled f32
// products out of shared memory: q and k stored k-major (transposed, pitch
// 68) so that neighbouring threads read neighbouring float4s, v and the
// probabilities likewise. At D = 256 the q, k and v tiles take 64 KB each,
// 222,464 bytes in all with the probabilities, set with
// cudaFuncSetAttribute (one block per SM). What holds it back: the fp32
// units at 1/15 of the bf16 tensor-core rate, two shared-memory float4
// reads per 16 FMAs, and one block of 8 warps per SM at D = 256. It stays
// for f32 inputs: TF32 would not meet the f32 checks (atol 2e-5 + rtol
// 2e-4, and 1e-5 between a model's logits on the card and on the CPU).
//
// The bf16 body runs both products on the tensor cores, in FlashAttention-3's
// shape. One block of 384 threads owns one (batch, query head, 128-row
// query tile): two consumer warpgroups of 64 rows each and a producer
// warpgroup, one thread of which drives the Tensor Memory Accelerator (TMA);
// setmaxnreg moves registers from the producer (24) to the consumers (240).
// The TMA descriptors (one per tensor, over the (B, S, heads, D) view and
// its strides) cut each tile into 64-byte column chunks of 32 bf16 with the
// matching 64-byte swizzle, so every D that is a multiple of 32 takes the
// same code. q is loaded once; k and v pass through rings of 2 stages of
// 64-key tiles, each stage with an mbarrier full/empty pair, so that the
// next tiles load while this one is computed (at D = 256: 64 KB of q and
// 2 x 2 x 32 KB of k and v, 197,704 bytes with the barriers and the
// alignment slack). S = q k^T runs on wgmma.m64n64k16 from shared memory
// into f32; the scale (after the product: 1/sqrt(D) is no power of two at
// D = 128), softcap (tanhf), mask and online softmax act on the accumulator
// fragment in registers, in log2 units (exp2 of log2(e)-scaled arguments).
// O += P V runs on wgmma with P in registers (the S fragment is already
// laid out as wgmma's A operand) and v read in its natural (key, d) layout,
// transposed by the instruction. P goes in as two bf16 halves, hi = bf16(p)
// and lo = bf16(p - hi), accumulated into the same f32 O: one rounding of p
// to bf16 would move o by up to 2^-9 p |v| per key, outside the 2^-8 |o| +
// 2e-5 max|o| the checks allow on rows that weigh a few keys heavily; the
// split leaves 2^-18 p and costs 1.5x the tensor-core work, so the bound is
// reachable at most to 2/3. Each consumer issues S of tile t together with
// P V of tile t - 1 and runs the softmax of tile t while P V runs
// (FlashAttention-3's overlap inside a warpgroup); the two warpgroups run
// unsynchronised, as making them alternate (its ping-pong) measured slower
// on the H100. The (64, D) O accumulator holds D/2 f32 a thread (128 at
// D = 256), S and P 32 registers each beside it. What holds it back: the
// softmax's CUDA-core work (a tanhf, with two special-function operations,
// and an exp2 per score) beside the tensor cores, and shared-memory reads:
// each S step reads 2 KB of q and 2 KB of k for 64 x 64 x 16 products, and
// each v tile is read twice (for hi and lo) by both warpgroups. Each k and
// v tile also feeds one query head, not both heads of its KV group. For a
// backward (lse and o32 given; scoring and serve pass neither) the epilogue
// also writes o in f32, (B, Sq, H, D), and each row's log-sum-exp lse =
// ln 2 (m + log2 l), (B, H, Sq) f32, -inf for a row with no valid key: what
// flash_attention_bwd.cu's bf16 body reads (4 (D + 1) bytes a row more).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileQ = 64;  // query rows of a block
constexpr int kTileK = 64;  // key rows of a step
constexpr int kPitch = kTileQ + 4;  // k-major pitch of the transposed q, k and p tiles
constexpr int kMaxD = 256;
constexpr int kMaxOTiles = kMaxD / 64;  // 4x4 micro-tiles of the (64, D) output per thread
constexpr float kMInit = -1e30f;  // the running max before any valid key, as in Pallas
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

__device__ __forceinline__ void fma44(float (&acc)[4][4], float4 a, float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w};
  const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
  }
}

// The max (or sum) over the 16 lanes of a row group: lanes 0-15 and 16-31
// of a warp each hold one row group of the score tile.
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       T* __restrict__ o, int Sq, int Skv, int H, int rep, int D, Strides qs,
                       Strides ks, Strides vs, float scale, float softcap, int causal,
                       int window) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Qt = smem;                 // q * scale, k-major: [D][kPitch]
  float* Kt = Qt + D * kPitch;      // k tile, k-major: [D][kPitch]
  float* Vs = Kt + D * kPitch;      // v tile: [kTileK][D]
  float* Pt = Vs + kTileK * D;      // probabilities, key-major: [kTileK][kPitch]
  float* rowv = Pt + kTileK * kPitch;  // per query row: alpha of the step, l at the end

  const int nq = (Sq + kTileQ - 1) / kTileQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * kTileQ;  // longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int rows = min(kTileQ, Sq - q0);
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + (h / rep) * ks.h;
  const T* vb = v + b * vs.b + (h / rep) * vs.h;

  // q tile, scaled after the f32 cast; rows past the sequence read 0
  for (int idx = threadIdx.x; idx < kTileQ * D; idx += kThreads) {
    const int r = idx % kTileQ, d = idx / kTileQ;
    Qt[d * kPitch + r] = r < rows ? to_float(qb[(q0 + r) * qs.s + d]) * scale : 0.0f;
  }

  // the keys any row of this tile may see
  int j_begin = 0, j_end = Skv;
  if (causal) {
    j_end = min(Skv, q0 + rows);
    if (window > 0) j_begin = max(0, q0 - window + 1);
  }

  // score-tile roles: rows ri..ri+3, keys cj..cj+3 of the (64, 64) tile
  const int ri = 4 * (threadIdx.x / 16), cj = 4 * (threadIdx.x % 16);
  const bool row_leader = (threadIdx.x % 16) == 0;
  const int D4 = D / 4, otiles = 16 * D4;
  float m_run[4], l_run[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m_run[r] = kMInit;
    l_run[r] = 0.0f;
  }
  float acc[kMaxOTiles][4][4];
#pragma unroll
  for (int u = 0; u < kMaxOTiles; ++u)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[u][r][c] = 0.0f;

  for (int j0 = j_begin; j0 < j_end; j0 += kTileK) {
    __syncthreads();  // the previous step has finished reading Kt, Vs and Pt
    for (int idx = threadIdx.x; idx < kTileK * D; idx += kThreads) {
      const int r = idx % kTileK, d = idx / kTileK, j = j0 + r;
      Kt[d * kPitch + r] = j < Skv ? to_float(kb[j * ks.s + d]) : 0.0f;
    }
    for (int idx = threadIdx.x; idx < kTileK * D; idx += kThreads) {
      const int r = idx / D, d = idx - r * D, j = j0 + r;
      Vs[idx] = j < Skv ? to_float(vb[j * vs.s + d]) : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      fma44(s, *reinterpret_cast<const float4*>(Qt + d * kPitch + ri),
            *reinterpret_cast<const float4*>(Kt + d * kPitch + cj));
    }

    // softcap, mask, and the online softmax of rows ri..ri+3
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = q0 + ri + r;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = j0 + cj + c;
        float x = s[r][c];
        if (softcap > 0.0f) x = tanhf(x / softcap) * softcap;
        bool ok = j < Skv;
        if (causal) {
          const int rel = i - j;
          ok = ok && rel >= 0 && (window <= 0 || rel < window);
        }
        s[r][c] = ok ? x : -INFINITY;
        mx = fmaxf(mx, s[r][c]);
      }
      const float m_new = fmaxf(m_run[r], group_max(mx));
      const float alpha = expf(m_run[r] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = expf(s[r][c] - m_new);
        sum += s[r][c];
      }
      l_run[r] = l_run[r] * alpha + group_sum(sum);
      m_run[r] = m_new;
      if (row_leader) rowv[ri + r] = alpha;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      *reinterpret_cast<float4*>(Pt + (cj + c) * kPitch + ri) =
          make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
    }
    __syncthreads();

    // acc = acc * alpha + p v over the 64 keys of the tile
#pragma unroll
    for (int u = 0; u < kMaxOTiles; ++u) {
      const int t = threadIdx.x + u * kThreads;
      if (t < otiles) {
        const int orow = 4 * (t / D4), ocol = 4 * (t % D4);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float a = rowv[orow + r];
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[u][r][c] *= a;
        }
#pragma unroll 4
        for (int jj = 0; jj < kTileK; ++jj) {
          fma44(acc[u], *reinterpret_cast<const float4*>(Pt + jj * kPitch + orow),
                *reinterpret_cast<const float4*>(Vs + jj * D + ocol));
        }
      }
    }
  }

  __syncthreads();
  if (row_leader) {
#pragma unroll
    for (int r = 0; r < 4; ++r) rowv[ri + r] = l_run[r];
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kMaxOTiles; ++u) {
    const int t = threadIdx.x + u * kThreads;
    if (t < otiles) {
      const int orow = 4 * (t / D4), ocol = 4 * (t % D4);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (orow + r < rows) {
          const float denom = fmaxf(rowv[orow + r], 1e-30f);
          T* out = o + ((static_cast<long long>(b) * Sq + q0 + orow + r) * H + h) * D + ocol;
#pragma unroll
          for (int c = 0; c < 4; ++c) store(out + c, acc[u][r][c] / denom);
        }
      }
    }
  }
}

size_t smem_bytes(int D) {
  return sizeof(float) * (static_cast<size_t>(2 * D * kPitch) + kTileK * D + kTileK * kPitch +
                          kTileQ);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int batch, int Sq, int Skv,
           int H, int K, int D, Strides qs, Strides ks, Strides vs, float scale, float softcap,
           int causal, int window, cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kTileQ - 1) / kTileQ, H, batch);
  flash_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Sq, Skv, H, H / K, D, qs, ks, vs, scale, softcap, causal, window);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The bf16 body: wgmma on TMA-fed tiles.
// ---------------------------------------------------------------------------

constexpr int kTcThreads = 384;          // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int kTcConsumers = 256;
constexpr int kTcTileQ = 128;            // query rows of a block, 64 per consumer warpgroup
constexpr int kStages = 2;               // stages of the k and v rings
constexpr uint32_t kQChunkBytes = kTcTileQ * 64;  // one column chunk of the q tile
constexpr uint32_t kKVChunkBytes = kRowChunkBytes;  // one column chunk of a k or v tile
constexpr int kProducerRegs = 24, kConsumerRegs = 240;

// The rows and columns of the score tile that one consumer thread holds.
struct Rows {
  int lo, hi;  // the warpgroup's first and last row inside the sequence
  int r0, c0;  // this thread's rows r0 and r0 + 8, columns c0 and c0 + 1 of each 8
};

// The keys a score tile may see, and how a raw score s (q . k) becomes
// z = log2(e) * its softmax argument: z = post * tanh(pre * s) with a
// softcap (pre = scale / softcap, post = softcap log2(e)), z = post * s
// without (post = scale log2(e)). exp2(z - max z) is the probability.
struct Mask {
  int Skv, causal, window, capped;
  float pre, post;
};

// Softcap and mask the scores of keys j0.. in place, then the online
// softmax of rows r0 and r0 + 8 in log2 units: m (the running max of z) and
// l updated, alpha = 2^(m_old - m_new), sc = 2^(z - m_new). Each step runs
// over all 32 scores without a branch, so that their chains interleave.
__device__ __forceinline__ void softmax_tile(float (&sc)[32], float (&m_run)[2], float (&l_run)[2],
                                             float (&alpha)[2], const Rows& rows, int j0,
                                             const Mask& mk) {
  if (mk.capped) {
#pragma unroll
    for (int e = 0; e < 32; ++e) sc[e] = tanhf(sc[e] * mk.pre);
  }
  const bool edge = j0 + kTileK > mk.Skv ||
                    (mk.causal && (j0 + kTileK - 1 > rows.lo ||
                                   (mk.window > 0 && rows.hi - j0 >= mk.window)));
  if (edge) {
    // score e holds key j0 + c0 + k, k = 8 (e / 4) + (e & 1), of row r0 + 8 ((e >> 1) & 1):
    // valid where lo[r] <= k <= hi[r]
    int lo[2], hi[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = rows.r0 + 8 * r, base = j0 + rows.c0;
      hi[r] = (mk.causal ? min(mk.Skv - 1, i) : mk.Skv - 1) - base;
      lo[r] = mk.causal && mk.window > 0 ? i - mk.window + 1 - base : -kTileK;
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int k = 8 * (e / 4) + (e & 1), r = (e >> 1) & 1;
      if (k < lo[r] || k > hi[r]) sc[e] = -INFINITY;
    }
  }
  float mx[2] = {-INFINITY, -INFINITY};  // of tanh(pre s), or of s: post z is monotone in both
#pragma unroll
  for (int e = 0; e < 32; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[e]);
  float sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m_run[r], quad_max(mx[r]) * mk.post);
    alpha[r] = exp2_ftz(m_run[r] - m_new);
    m_run[r] = m_new;
  }
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    sc[e] = exp2_ftz(fmaf(sc[e], mk.post, -m_run[(e >> 1) & 1]));
    sum[(e >> 1) & 1] += sc[e];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + quad_sum(sum[r]);
  fence_regs(sc);  // the softmax stays ahead of the wait for the P V in flight
}

// O *= alpha row by row (skipped where the warp's running maxima did not
// move: alpha = 1), and P split into two bf16 halves for the next P V.
template <int kD>
__device__ __forceinline__ void rescale_and_split(float (&acc)[kD / 2], const float (&alpha)[2],
                                                  const float (&sc)[32], uint32_t (&p_hi)[16],
                                                  uint32_t (&p_lo)[16]) {
  if (__any_sync(0xffffffffu, alpha[0] != 1.0f || alpha[1] != 1.0f)) {
#pragma unroll
    for (int i = 0; i < kD / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
  }
  split_bf16(sc, p_hi, p_lo);
  fence_regs(acc);
  fence_regs(p_hi);
  fence_regs(p_lo);
}

constexpr uint32_t tc_smem_bytes(int D) {
  // 1024 bytes of slack to align the tiles to the swizzle pattern, the
  // q tile, kStages k and v tiles, 1 + 4 kStages barriers
  return 1024 + kTcTileQ * D * 2 + 2 * kStages * kTileK * D * 2 + 8 * (1 + 4 * kStages);
}

template <int kD>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_attention_kernel_wgmma(const __grid_constant__ CUtensorMap qmap,
                             const __grid_constant__ CUtensorMap kmap,
                             const __grid_constant__ CUtensorMap vmap,
                             __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                             float* __restrict__ o32, int Sq, int Skv, int H, int rep,
                             float scale, float softcap, int causal, int window) {
  constexpr int kChunks = kD / kChunkCols;
  constexpr uint32_t kQBytes = kChunks * kQChunkBytes, kKVBytes = kChunks * kKVChunkBytes;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;  // chunk c at sQ + c kQChunkBytes
  const uint32_t sK = sQ + kQBytes;                            // stage s at sK + s kKVBytes
  const uint32_t sV = sK + kStages * kKVBytes;
  // barriers: q full; then k full, k empty, v full, v empty, each kStages of 8 bytes
  const uint32_t q_full = sV + kStages * kKVBytes, k_full = q_full + 8;
  const uint32_t k_empty = k_full + 8 * kStages, v_full = k_empty + 8 * kStages;
  const uint32_t v_empty = v_full + 8 * kStages;

  const int nq = (Sq + kTcTileQ - 1) / kTcTileQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * kTcTileQ;  // longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  int j_begin = 0, j_end = Skv;
  if (causal) {
    j_end = min(Skv, q0 + min(kTcTileQ, Sq - q0));
    if (window > 0) j_begin = max(0, q0 - window + 1);
  }
  const int ntiles = j_end > j_begin ? (j_end - j_begin + kTileK - 1) / kTileK : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, kTcConsumers);
      mbar_init(v_empty + 8 * s, kTcConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // producer: one thread issues every load; the rings' empty barriers pace it
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 2 * 128) {
      const int hk = h / rep;
      mbar_expect_tx(q_full, kQBytes);
      for (int c = 0; c < kChunks; ++c) {
        tma_load(sQ + c * kQChunkBytes, &qmap, q_full, c * kChunkCols, q0, h, b);
      }
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % kStages;
        const uint32_t parity = ((t / kStages) & 1) ^ 1;
        const int j0 = j_begin + t * kTileK;
        mbar_wait(k_empty + 8 * s, parity);
        mbar_expect_tx(k_full + 8 * s, kKVBytes);
        for (int c = 0; c < kChunks; ++c) {
          tma_load(sK + s * kKVBytes + c * kKVChunkBytes, &kmap, k_full + 8 * s, c * kChunkCols,
                   j0, hk, b);
        }
        mbar_wait(v_empty + 8 * s, parity);
        mbar_expect_tx(v_full + 8 * s, kKVBytes);
        for (int c = 0; c < kChunks; ++c) {
          tma_load(sV + s * kKVBytes + c * kKVChunkBytes, &vmap, v_full + 8 * s, c * kChunkCols,
                   j0, hk, b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
    Rows rows;
    rows.lo = q0 + 64 * wg;
    rows.hi = min(rows.lo + 63, Sq - 1);
    rows.r0 = rows.lo + 16 * warp + lane / 4;  // this thread's rows: r0 and r0 + 8
    rows.c0 = 2 * (lane % 4);                  // and columns c0, c0 + 1 of each 8
    const bool capped = softcap > 0.0f;
    const Mask mask{Skv, causal, window, capped, capped ? scale / softcap : 0.0f,
                    (capped ? softcap : scale) * kLog2e};
    const uint32_t sQw = sQ + wg * (kQChunkBytes / 2);  // this warpgroup's 64 rows of q
    float acc[kD / 2];
#pragma unroll
    for (int i = 0; i < kD / 2; ++i) acc[i] = 0.0f;
    float m_run[2] = {kMInit, kMInit}, l_run[2] = {0.0f, 0.0f};
    float sc[32];  // a (64, 64) score tile: rows r0, r0 + 8, columns 8n + c0 + {0, 1}
#pragma unroll
    for (int e = 0; e < 32; ++e) sc[e] = 0.0f;
    uint32_t p_hi[16], p_lo[16];  // its probabilities, P = hi + lo; pair n: scores 2n, 2n + 1
    float alpha[2];

    mbar_wait(q_full, 0);
    // Step t issues S of tile t and P V of tile t - 1, so that the softmax of
    // tile t runs while the tensor cores add P V of tile t - 1 (and the other
    // warpgroup's products). Step 0 has no P V and step ntiles no S.
    if (ntiles > 0) {
      mbar_wait(k_full, 0);
      wgmma_fence();
      wgmma_scores<kD, kQChunkBytes, kKVChunkBytes>(sc, sQw, sK);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      mbar_arrive(k_empty);
      softmax_tile(sc, m_run, l_run, alpha, rows, j_begin, mask);
      rescale_and_split<kD>(acc, alpha, sc, p_hi, p_lo);
      for (int t = 1; t < ntiles; ++t) {
        const int s = t % kStages, sp = (t - 1) % kStages;
        mbar_wait(k_full + 8 * s, (t / kStages) & 1);
        mbar_wait(v_full + 8 * sp, ((t - 1) / kStages) & 1);
        wgmma_fence();
        wgmma_scores<kD, kQChunkBytes, kKVChunkBytes>(sc, sQw, sK + s * kKVBytes);
        wgmma_commit();
        wgmma_rows_split<kD>(acc, p_hi, p_lo, sV + sp * kKVBytes);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(sc);
        mbar_arrive(k_empty + 8 * s);
        softmax_tile(sc, m_run, l_run, alpha, rows, j_begin + t * kTileK, mask);
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(p_hi);
        fence_regs(p_lo);
        mbar_arrive(v_empty + 8 * sp);
        rescale_and_split<kD>(acc, alpha, sc, p_hi, p_lo);
      }
      const int sp = (ntiles - 1) % kStages;
      mbar_wait(v_full + 8 * sp, ((ntiles - 1) / kStages) & 1);
      wgmma_fence();
      wgmma_rows_split<kD>(acc, p_hi, p_lo, sV + sp * kKVBytes);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(v_empty + 8 * sp);
    }

    // o = acc / l, rounded once to bf16; rows past the sequence are not stored.
    // For a backward (lse given): o also in f32, and lse = ln 2 (m + log2 l),
    // -inf for a row with no valid key.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = rows.r0 + 8 * r;
      if (i < Sq) {
        const float denom = fmaxf(l_run[r], 1e-30f);
        const long long row = (static_cast<long long>(b) * Sq + i) * H + h;
        __nv_bfloat16* out = o + row * kD + rows.c0;
#pragma unroll
        for (int n = 0; n < kD / 8; ++n) {
          *reinterpret_cast<__nv_bfloat162*>(out + 8 * n) =
              __floats2bfloat162_rn(acc[4 * n + 2 * r] / denom, acc[4 * n + 2 * r + 1] / denom);
        }
        if (lse != nullptr) {
          float* out32 = o32 + row * kD + rows.c0;
#pragma unroll
          for (int n = 0; n < kD / 8; ++n) {
            *reinterpret_cast<float2*>(out32 + 8 * n) =
                make_float2(acc[4 * n + 2 * r] / denom, acc[4 * n + 2 * r + 1] / denom);
          }
          if (rows.c0 == 0) {
            lse[(static_cast<long long>(b) * H + h) * Sq + i] =
                l_run[r] > 0.0f ? (m_run[r] + log2f(l_run[r])) * kLn2 : -INFINITY;
          }
        }
      }
    }
  }
}

template <int kD>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, float* lse, float* o32,
                 int batch, int Sq, int Skv, int H, int K, Strides qs, Strides ks, Strides vs,
                 float scale, float softcap, int causal, int window, cudaStream_t stream) {
  CUtensorMap qmap, kmap, vmap;
  if (!make_map(&qmap, q, kD, Sq, H, batch, qs, kTcTileQ) ||
      !make_map(&kmap, k, kD, Skv, K, batch, ks, kTileK) ||
      !make_map(&vmap, v, kD, Skv, K, batch, vs, kTileK)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr size_t smem = tc_smem_bytes(kD);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel_wgmma<kD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kTcTileQ - 1) / kTcTileQ, H, batch);
  flash_attention_kernel_wgmma<kD><<<grid, kTcThreads, smem, stream>>>(
      qmap, kmap, vmap, static_cast<__nv_bfloat16*>(o), lse, o32, Sq, Skv, H, H / K, scale,
      softcap, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      void* lse, void* o32, int batch, int Sq, int Skv, int H,
                                      int K, int D, int bf16,
                                      long long q_sb, long long q_ss, long long q_sh,
                                      long long k_sb, long long k_ss, long long k_sh,
                                      long long v_sb, long long v_ss, long long v_sh,
                                      float scale, float softcap, int causal, int window,
                                      void* stream) {
  if (D <= 0 || D % 32 || D > kMaxD || K <= 0 || H % K || batch <= 0 || Sq <= 0 || Skv <= 0 ||
      batch > 65535 || H > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lse_f = static_cast<float*>(lse);
  float* o32_f = static_cast<float*>(o32);
  if (!bf16) {
    if (lse_f != nullptr) return static_cast<int>(cudaErrorInvalidValue);  // the bf16 body's only
    return launch<float>(q, k, v, o, batch, Sq, Skv, H, K, D, qs, ks, vs, scale, softcap, causal,
                         window, st);
  }
#define FLASH_WGMMA_CASE(d)                                                                    \
  case d:                                                                                      \
    return launch_wgmma<d>(q, k, v, o, lse_f, o32_f, batch, Sq, Skv, H, K, qs, ks, vs, scale,  \
                           softcap, causal, window, st);
  switch (D) {
    FLASH_WGMMA_CASE(32)
    FLASH_WGMMA_CASE(64)
    FLASH_WGMMA_CASE(96)
    FLASH_WGMMA_CASE(128)
    FLASH_WGMMA_CASE(160)
    FLASH_WGMMA_CASE(192)
    FLASH_WGMMA_CASE(224)
    FLASH_WGMMA_CASE(256)
  }
#undef FLASH_WGMMA_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
