// Flash attention backward for Hopper (sm_90a), bound with a plain C
// interface and loaded through ctypes by repro_torch/kernels/flash_attention.py.
//
// Stands for the reference's jax.grad of the function that the Pallas TPU
// kernel repro/kernels/flash_attention.py:_flash_kernel computes: the
// reference's models differentiate attend (repro/models/layers.py:188), and
// the Pallas kernel has no backward of its own.
//
// What it computes, for batch b, query head h (reading KV head h / (H / K)),
// query i and key j, both counted from 0, given the output's cotangent dO:
//   u_ij  = (q_i . k_j) * scale                   scale = 1 / sqrt(D), f32
//   t_ij  = tanh(u_ij / softcap), s_ij = softcap * t_ij   (s = u without softcap)
//   valid = j < Skv and, only when causal, 0 <= i - j < window (window 0: no bound)
//   p_ij  = exp(s_ij - lse_i) on the valid pairs, else 0
//   dv_j  = sum_i p_ij dO_i,  dp_ij = dO_i . v_j,  delta_i = dO_i . o_i
//   du_ij = p_ij (dp_ij - delta_i) (1 - t_ij^2)    (no factor without softcap)
//   dq_i  = scale sum_j du_ij k_j,  dk_j = scale sum_i du_ij q_i
// dk and dv sum over the H / K query heads of each KV group; dq, dk and dv
// are written once, in the inputs' type. A query row with no valid key gets
// zero gradient (the forward gives it a zero output and lse = -inf). No
// launch uses atomics: the same inputs give the same bits on every run
// (atomic adds into dq would save the second S and dP below, and lose that).
//
// Bound: operations. The function's five products (s, dp, dv, dq, dk) cost
// 10 D operations a valid pair against 2 D bytes a row of each tensor.
//
// Two bodies, picked by input type in flash_attention_backward_launch.
//
// bf16, on the tensor cores, from the forward's lse (batch, H, Sq) f32.
// The cancellation in dp - delta needs delta at f32 accuracy and free of
// lse's error: from the bf16 output the dq check fails by 270x, from the
// forward's o in f32 (P V with P as bf16 hi + lo: 1.3e-5 of |o|) by 7.7x
// on qwen2.5-3b's trained rows; so delta_i = sum_j p_ij dp_ij / sum_j p_ij,
// from the same p and dp as dq (an error of lse then scales the row's
// gradients). Two launches in FlashAttention-2's deterministic form, both
// built from hopper.cuh: TMA loads of 64-row tiles in 64-byte column
// chunks with the 64-byte swizzle, mbarrier full/empty pairs, one producer
// thread, wgmma.
//   (1) dq: one block per (batch, head, 64-query tile), one consumer
//       warpgroup and a producer warpgroup, which streams the key tiles
//       twice. Sweep 1 takes S and dP of each tile and sums p and p dp over
//       the row (each row's 4 lanes, then a quad sum) into delta, written
//       to the scratch, (batch, H, Sq) f32, for launch (2). Sweep 2, per
//       key tile the mask leaves (k and v through 2-stage rings): S = q k^T
//       and dP = dO v^T
//       on wgmma.m64n64k16 from shared memory; softcap, mask, p = 2^(z -
//       lse log2 e) and dS = p (dP - delta)(1 - t^2) on the accumulator
//       fragments in registers; dq += dS k with dS as the register A
//       operand and k read in its natural (key, D) layout, the forward's P V
//       pattern. At D = 256: q, dO and two stages of k and v, 197,704 bytes
//       of shared memory.
//   (2) dk and dv: one block per (batch, KV head, 64-key tile): the keys are
//       wgmma's M, so S^T = k q^T and dP^T = v dO^T land in registers laid
//       out as the A operand of dv += P^T dO and dk += dS^T q, which read dO
//       and q in their natural layout. It walks the group's query heads and
//       the query tiles that see its keys, q and dO double-buffered. Two
//       (64, D) f32 accumulators do not fit one thread's 240 registers at D
//       = 256, so two consumer warpgroups split the work: warpgroup 0
//       computes S^T, P^T and g = P^T (1 - t^2) and owns dv; warpgroup 1
//       computes dP^T, reads g through shared memory (one f32 fragment,
//       16 KB, thread for thread: both hold the same (key, query) positions;
//       named barriers 1 and 2 say written and read), forms dS^T = g (dP^T -
//       delta) and owns dk. setmaxnreg gives the consumers 240 registers and
//       the producer 24; no spills. At D = 256: k, v, two stages of q and dO
//       and the exchange, 214,088 bytes.
//   Work: 18 D operations a valid pair (S and dP in both sweeps of launch
//   (1) and in launch (2)) against the function's 10 D, at the bf16
//   tensor-core rate. P and dS enter the
//   tensor cores as two bf16 halves, hi = bf16(x) and lo = bf16(x - hi),
//   both multiplied: one rounding of P or dS to bf16 moves a gradient by
//   up to 2^-9 of a term, outside the 2^-8 |g| + 2e-5 max|g| the checks
//   allow on gradients that cancel; the split leaves 2^-17. That makes 24 D
//   on the tensor cores. What holds it back: one consumer warpgroup per SM
//   in launch (1) and no overlap of the softcap and exponentials (CUDA
//   cores) with the products, the serial hand-over of g in launch (2), and
//   wgmma.m64n64 score tiles.
//
// f32, on the CUDA cores (TF32 would not meet the f32 checks): three
// launches on one stream, none with atomics:
//   (a) stats: one block per (batch, head, 64-query tile) runs the forward
//       again in f32 (online softmax over 32-key tiles, as the f32 forward
//       body does), and writes lse_i = m_i + log(l_i) and delta_i = dO_i .
//       o_i with o_i in f32, into a scratch of 2 (batch, H, Sq) f32.
//   (b) dq: one block per (batch, head, 64-query tile) walks the key tiles
//       that its rows may see, recomputes s and dp for each (64 x 32) tile,
//       and adds du k into a (64, D) f32 accumulator in registers.
//   (c) dk and dv: one block per (batch, KV head, 32-key tile) walks the
//       group's query heads and the query tiles that may see its keys, and
//       adds p^T dO and du^T q into two (32, D) accumulators in registers.
// Each pass skips the tiles the mask empties, as the forward does. Tiles
// live in shared memory as f32 rows with a pitch of D + 4 floats; a (64 x
// 32) score tile is 2 rows x 4 keys a thread (rows r and r + 32, keys c,
// c + 8, c + 16, c + 24: float4 reads along D without bank conflicts), and
// the accumulators are 4 x 4 micro-tiles fed from a transposed copy of the
// probabilities. At D = 256 pass (c) holds k, v, q and dO tiles and two
// probability tiles, 220,672 bytes, set with cudaFuncSetAttribute. It
// spends 18 D operations a pair at the fp32 rate.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// The f32 body: three launches on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kTq = 64;             // query rows of a tile
constexpr int kTk = 32;             // key rows of a tile
constexpr int kMaxD = 256;
constexpr int kMaxUq = kMaxD / 64;   // (64, D) accumulator: 4 D micro-tiles of 4 x 4, 4 D / 256 a thread
constexpr int kMaxUk = kMaxD / 128;  // (32, D) accumulator: 2 D micro-tiles of 4 x 4, 2 D / 256 a thread
constexpr int kPq = kTq + 4;        // pitch of key-major probability tiles [key][query]
constexpr int kPk = kTk + 8;        // pitch of query-major probability tiles [query][key]
constexpr float kMInit = -1e30f;    // the running max before any valid key

struct Problem {
  int Sq, Skv, H, rep, D;
  Strides qs, ks, vs, dos;
  float scale, softcap;
  int causal, window;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

__device__ __forceinline__ bool is_valid(int i, int j, const Problem& p) {
  if (i >= p.Sq || j >= p.Skv) return false;
  if (!p.causal) return true;
  const int rel = i - j;
  return rel >= 0 && (p.window <= 0 || rel < p.window);
}

// n rows of D values from row r0 of src (row stride ld elements) into dst
// [n][pitch] as f32 times mul; rows past S read 0.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* __restrict__ src, long long ld,
                                          int r0, int n, int S, int D, int pitch, float mul) {
  for (int idx = threadIdx.x; idx < n * D; idx += kThreads) {
    const int r = idx / D, d = idx - r * D, i = r0 + r;
    dst[r * pitch + d] = i < S ? to_float(src[i * ld + d]) * mul : 0.0f;
  }
}

// acc[r][c] += A[row_r] . B[key_c] over D for rows rq, rq + 32 of A
// ([64][pitch]) and keys ck + 8c of B ([32][pitch]).
__device__ __forceinline__ void score_tile(float (&acc)[2][4], const float* A, const float* Bm,
                                           int rq, int ck, int D, int pitch) {
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    const float4 a0 = *reinterpret_cast<const float4*>(A + rq * pitch + d);
    const float4 a1 = *reinterpret_cast<const float4*>(A + (rq + 32) * pitch + d);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float4 b = *reinterpret_cast<const float4*>(Bm + (ck + 8 * c) * pitch + d);
      acc[0][c] = fmaf(a0.x, b.x, acc[0][c]);
      acc[0][c] = fmaf(a0.y, b.y, acc[0][c]);
      acc[0][c] = fmaf(a0.z, b.z, acc[0][c]);
      acc[0][c] = fmaf(a0.w, b.w, acc[0][c]);
      acc[1][c] = fmaf(a1.x, b.x, acc[1][c]);
      acc[1][c] = fmaf(a1.y, b.y, acc[1][c]);
      acc[1][c] = fmaf(a1.z, b.z, acc[1][c]);
      acc[1][c] = fmaf(a1.w, b.w, acc[1][c]);
    }
  }
}

__device__ __forceinline__ void fma44(float (&acc)[4][4], float4 a, float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w};
  const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
  }
}

// The max (or sum) over the 8 lanes that hold one row of a score tile.
__device__ __forceinline__ float group8_max(float x) {
#pragma unroll
  for (int off = 4; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float group8_sum(float x) {
#pragma unroll
  for (int off = 4; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// The keys [begin, end) that some row of the query tile [q0, q0 + rows) may see.
__device__ __forceinline__ void key_range(int q0, int rows, const Problem& p, int* begin,
                                          int* end) {
  *begin = 0;
  *end = p.Skv;
  if (p.causal) {
    *end = min(p.Skv, q0 + rows);
    if (p.window > 0) *begin = max(0, q0 - p.window + 1);
  }
}

// The capped score, with t = tanh(u / softcap) for the derivative (0 without softcap).
__device__ __forceinline__ float capped(float u, float softcap, float* t) {
  if (softcap > 0.0f) {
    *t = tanhf(u / softcap);
    return softcap * *t;
  }
  *t = 0.0f;
  return u;
}

// ---------------------------------------------------------------------------
// (a) row statistics: lse and delta
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_stats_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ dO, float* __restrict__ lse, float* __restrict__ delta,
                 Problem p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int D = p.D, pitch = D + 4;
  float* Qs = smem;                // q * scale, then o: [kTq][pitch]
  float* Ks = Qs + kTq * pitch;    // [kTk][pitch]
  float* Vs = Ks + kTk * pitch;    // [kTk][pitch]
  float* Pt = Vs + kTk * pitch;    // probabilities, key-major: [kTk][kPq]
  float* rowv = Pt + kTk * kPq;    // per query row: alpha of the step, l at the end

  const int nq = (p.Sq + kTq - 1) / kTq;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * kTq;  // longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int rows = min(kTq, p.Sq - q0);
  const T* qb = q + b * p.qs.b + h * p.qs.h;
  const T* kb = k + b * p.ks.b + (h / p.rep) * p.ks.h;
  const T* vb = v + b * p.vs.b + (h / p.rep) * p.vs.h;
  const T* dob = dO + b * p.dos.b + h * p.dos.h;
  load_rows(Qs, qb, p.qs.s, q0, kTq, p.Sq, D, pitch, p.scale);
  int j_begin, j_end;
  key_range(q0, rows, p, &j_begin, &j_end);

  const int rq = threadIdx.x / 8, ck = threadIdx.x % 8;
  const int D4 = D / 4, otiles = 16 * D4;
  float m_run[2] = {kMInit, kMInit}, l_run[2] = {0.0f, 0.0f};
  float acc[kMaxUq][4][4];
#pragma unroll
  for (int u = 0; u < kMaxUq; ++u)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[u][r][c] = 0.0f;

  for (int j0 = j_begin; j0 < j_end; j0 += kTk) {
    __syncthreads();  // the previous step has finished reading Ks, Vs and Pt
    load_rows(Ks, kb, p.ks.s, j0, kTk, p.Skv, D, pitch, 1.0f);
    load_rows(Vs, vb, p.vs.s, j0, kTk, p.Skv, D, pitch, 1.0f);
    __syncthreads();
    float s[2][4] = {};
    score_tile(s, Qs, Ks, rq, ck, D, pitch);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = rq + 32 * r, i = q0 + row;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float t;
        const float x = capped(s[r][c], p.softcap, &t);
        s[r][c] = is_valid(i, j0 + ck + 8 * c, p) ? x : -INFINITY;
        mx = fmaxf(mx, s[r][c]);
      }
      const float m_new = fmaxf(m_run[r], group8_max(mx));
      const float alpha = expf(m_run[r] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = expf(s[r][c] - m_new);
        sum += s[r][c];
        Pt[(ck + 8 * c) * kPq + row] = s[r][c];
      }
      l_run[r] = l_run[r] * alpha + group8_sum(sum);
      m_run[r] = m_new;
      if (ck == 0) rowv[row] = alpha;
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kMaxUq; ++u) {
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
        for (int jj = 0; jj < kTk; ++jj) {
          fma44(acc[u], *reinterpret_cast<const float4*>(Pt + jj * kPq + orow),
                *reinterpret_cast<const float4*>(Vs + jj * pitch + ocol));
        }
      }
    }
  }

  __syncthreads();  // every thread is done with Qs: it takes o now
  if (ck == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = rq + 32 * r, i = q0 + row;
      rowv[row] = l_run[r];
      // a row with no valid key has l = 0 and never reads its lse
      if (i < p.Sq) lse[(static_cast<long long>(b) * p.H + h) * p.Sq + i] =
          l_run[r] > 0.0f ? m_run[r] + logf(l_run[r]) : 0.0f;
    }
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kMaxUq; ++u) {
    const int t = threadIdx.x + u * kThreads;
    if (t < otiles) {
      const int orow = 4 * (t / D4), ocol = 4 * (t % D4);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float denom = fmaxf(rowv[orow + r], 1e-30f);
#pragma unroll
        for (int c = 0; c < 4; ++c) Qs[(orow + r) * pitch + ocol + c] = acc[u][r][c] / denom;
      }
    }
  }
  __syncthreads();
  // delta_i = dO_i . o_i: four lanes a row, each over every fourth column
  const int row = threadIdx.x / 4, part = threadIdx.x % 4, i = q0 + row;
  float sum = 0.0f;
  if (i < p.Sq) {
    for (int d = part; d < D; d += 4) sum = fmaf(to_float(dob[i * p.dos.s + d]), Qs[row * pitch + d], sum);
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  sum += __shfl_xor_sync(0xffffffffu, sum, 2);
  if (part == 0 && i < p.Sq) delta[(static_cast<long long>(b) * p.H + h) * p.Sq + i] = sum;
}

// ---------------------------------------------------------------------------
// (b) dq
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const T* __restrict__ dO, const float* __restrict__ lse,
              const float* __restrict__ delta, T* __restrict__ dq, Problem p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int D = p.D, pitch = D + 4;
  float* Qs = smem;                // q * scale: [kTq][pitch]
  float* dOs = Qs + kTq * pitch;   // [kTq][pitch]
  float* Ks = dOs + kTq * pitch;   // [kTk][pitch]
  float* Vs = Ks + kTk * pitch;    // [kTk][pitch]
  float* dUt = Vs + kTk * pitch;   // du, key-major: [kTk][kPq]
  float* rl = dUt + kTk * kPq;     // lse of the tile's rows
  float* rd = rl + kTq;            // delta of the tile's rows

  const int nq = (p.Sq + kTq - 1) / kTq;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * kTq;  // longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int rows = min(kTq, p.Sq - q0);
  const T* kb = k + b * p.ks.b + (h / p.rep) * p.ks.h;
  const T* vb = v + b * p.vs.b + (h / p.rep) * p.vs.h;
  load_rows(Qs, q + b * p.qs.b + h * p.qs.h, p.qs.s, q0, kTq, p.Sq, D, pitch, p.scale);
  load_rows(dOs, dO + b * p.dos.b + h * p.dos.h, p.dos.s, q0, kTq, p.Sq, D, pitch, 1.0f);
  const long long stat0 = (static_cast<long long>(b) * p.H + h) * p.Sq;
  for (int r = threadIdx.x; r < kTq; r += kThreads) {
    rl[r] = r < rows ? lse[stat0 + q0 + r] : 0.0f;
    rd[r] = r < rows ? delta[stat0 + q0 + r] : 0.0f;
  }
  int j_begin, j_end;
  key_range(q0, rows, p, &j_begin, &j_end);

  const int rq = threadIdx.x / 8, ck = threadIdx.x % 8;
  const int D4 = D / 4, otiles = 16 * D4;
  float acc[kMaxUq][4][4];
#pragma unroll
  for (int u = 0; u < kMaxUq; ++u)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[u][r][c] = 0.0f;

  for (int j0 = j_begin; j0 < j_end; j0 += kTk) {
    __syncthreads();  // the previous step has finished reading Ks, Vs and dUt
    load_rows(Ks, kb, p.ks.s, j0, kTk, p.Skv, D, pitch, 1.0f);
    load_rows(Vs, vb, p.vs.s, j0, kTk, p.Skv, D, pitch, 1.0f);
    __syncthreads();
    float s[2][4] = {}, dp[2][4] = {};
    score_tile(s, Qs, Ks, rq, ck, D, pitch);
    score_tile(dp, dOs, Vs, rq, ck, D, pitch);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = rq + 32 * r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float du = 0.0f;
        if (is_valid(q0 + row, j0 + ck + 8 * c, p)) {
          float t;
          const float x = capped(s[r][c], p.softcap, &t);
          du = expf(x - rl[row]) * (dp[r][c] - rd[row]) * (1.0f - t * t);
        }
        dUt[(ck + 8 * c) * kPq + row] = du;
      }
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kMaxUq; ++u) {
      const int t = threadIdx.x + u * kThreads;
      if (t < otiles) {
        const int orow = 4 * (t / D4), ocol = 4 * (t % D4);
#pragma unroll 4
        for (int jj = 0; jj < kTk; ++jj) {
          fma44(acc[u], *reinterpret_cast<const float4*>(dUt + jj * kPq + orow),
                *reinterpret_cast<const float4*>(Ks + jj * pitch + ocol));
        }
      }
    }
  }

#pragma unroll
  for (int u = 0; u < kMaxUq; ++u) {
    const int t = threadIdx.x + u * kThreads;
    if (t < otiles) {
      const int orow = 4 * (t / D4), ocol = 4 * (t % D4);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (orow + r < rows) {
          T* out = dq + ((static_cast<long long>(b) * p.Sq + q0 + orow + r) * p.H + h) * D + ocol;
#pragma unroll
          for (int c = 0; c < 4; ++c) store(out + c, acc[u][r][c] * p.scale);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// (c) dk and dv
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dO, const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                int K, Problem p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int D = p.D, pitch = D + 4;
  float* Ks = smem;                // [kTk][pitch]
  float* Vs = Ks + kTk * pitch;    // [kTk][pitch]
  float* Qs = Vs + kTk * pitch;    // q * scale: [kTq][pitch]
  float* dOs = Qs + kTq * pitch;   // [kTq][pitch]
  float* Ps = dOs + kTq * pitch;   // probabilities, query-major: [kTq][kPk]
  float* dUs = Ps + kTq * kPk;     // du, query-major: [kTq][kPk]
  float* rl = dUs + kTq * kPk;     // lse of the query tile's rows
  float* rd = rl + kTq;            // delta of the query tile's rows

  const int j0 = blockIdx.x * kTk;  // the first key tiles see the most queries
  const int g = blockIdx.y, b = blockIdx.z;
  const int keys = min(kTk, p.Skv - j0);
  load_rows(Ks, k + b * p.ks.b + g * p.ks.h, p.ks.s, j0, kTk, p.Skv, D, pitch, 1.0f);
  load_rows(Vs, v + b * p.vs.b + g * p.vs.h, p.vs.s, j0, kTk, p.Skv, D, pitch, 1.0f);

  // the queries [i_begin, i_end) that may see a key of [j0, j0 + keys)
  int i_begin = 0, i_end = p.Sq;
  if (p.causal) {
    i_begin = j0 / kTq * kTq;
    if (p.window > 0) i_end = min(p.Sq, j0 + keys - 1 + p.window);
  }

  const int rq = threadIdx.x / 8, ck = threadIdx.x % 8;
  const int D4 = D / 4, ktiles = 8 * D4;
  float acc_dk[kMaxUk][4][4], acc_dv[kMaxUk][4][4];
#pragma unroll
  for (int u = 0; u < kMaxUk; ++u)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc_dk[u][r][c] = acc_dv[u][r][c] = 0.0f;

  for (int hh = 0; hh < p.rep; ++hh) {
    const int h = g * p.rep + hh;
    const T* qb = q + b * p.qs.b + h * p.qs.h;
    const T* dob = dO + b * p.dos.b + h * p.dos.h;
    const long long stat0 = (static_cast<long long>(b) * p.H + h) * p.Sq;
    for (int q0 = i_begin; q0 < i_end; q0 += kTq) {
      __syncthreads();  // the previous step has finished reading Qs, dOs, Ps and dUs
      load_rows(Qs, qb, p.qs.s, q0, kTq, p.Sq, D, pitch, p.scale);
      load_rows(dOs, dob, p.dos.s, q0, kTq, p.Sq, D, pitch, 1.0f);
      for (int r = threadIdx.x; r < kTq; r += kThreads) {
        const bool in = q0 + r < p.Sq;
        rl[r] = in ? lse[stat0 + q0 + r] : 0.0f;
        rd[r] = in ? delta[stat0 + q0 + r] : 0.0f;
      }
      __syncthreads();
      float s[2][4] = {}, dp[2][4] = {};
      score_tile(s, Qs, Ks, rq, ck, D, pitch);
      score_tile(dp, dOs, Vs, rq, ck, D, pitch);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = rq + 32 * r;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int key = ck + 8 * c;
          float pr = 0.0f, du = 0.0f;
          if (is_valid(q0 + row, j0 + key, p)) {
            float t;
            const float x = capped(s[r][c], p.softcap, &t);
            pr = expf(x - rl[row]);
            du = pr * (dp[r][c] - rd[row]) * (1.0f - t * t);
          }
          Ps[row * kPk + key] = pr;
          dUs[row * kPk + key] = du;
        }
      }
      __syncthreads();
#pragma unroll
      for (int u = 0; u < kMaxUk; ++u) {
        const int t = threadIdx.x + u * kThreads;
        if (t < ktiles) {
          const int krow = 4 * (t / D4), ocol = 4 * (t % D4);
#pragma unroll 4
          for (int ii = 0; ii < kTq; ++ii) {
            fma44(acc_dv[u], *reinterpret_cast<const float4*>(Ps + ii * kPk + krow),
                  *reinterpret_cast<const float4*>(dOs + ii * pitch + ocol));
            fma44(acc_dk[u], *reinterpret_cast<const float4*>(dUs + ii * kPk + krow),
                  *reinterpret_cast<const float4*>(Qs + ii * pitch + ocol));
          }
        }
      }
    }
  }

#pragma unroll
  for (int u = 0; u < kMaxUk; ++u) {
    const int t = threadIdx.x + u * kThreads;
    if (t < ktiles) {
      const int krow = 4 * (t / D4), ocol = 4 * (t % D4);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (krow + r < keys) {
          const long long off = ((static_cast<long long>(b) * p.Skv + j0 + krow + r) * K + g) * D + ocol;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            store(dk + off + c, acc_dk[u][r][c]);
            store(dv + off + c, acc_dv[u][r][c]);
          }
        }
      }
    }
  }
}

size_t stats_smem(int D) {
  return sizeof(float) * (static_cast<size_t>(kTq + 2 * kTk) * (D + 4) + kTk * kPq + kTq);
}

size_t dq_smem(int D) {
  return sizeof(float) * (static_cast<size_t>(2 * kTq + 2 * kTk) * (D + 4) + kTk * kPq + 2 * kTq);
}

size_t dkdv_smem(int D) {
  return sizeof(float) * (static_cast<size_t>(2 * kTk + 2 * kTq) * (D + 4) + 2 * kTq * kPk + 2 * kTq);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* dO, void* dq, void* dk,
           void* dv, float* lse, float* delta, int batch, int K, const Problem& p,
           cudaStream_t stream) {
  const size_t sa = stats_smem(p.D), sb = dq_smem(p.D), sc = dkdv_smem(p.D);
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(bwd_stats_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(sa))) != cudaSuccess ||
      (err = cudaFuncSetAttribute(bwd_dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(sb))) != cudaSuccess ||
      (err = cudaFuncSetAttribute(bwd_dkdv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(sc))) != cudaSuccess) {
    return static_cast<int>(err);
  }
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dO);
  const int nq = (p.Sq + kTq - 1) / kTq, nk = (p.Skv + kTk - 1) / kTk;
  bwd_stats_kernel<T><<<dim3(nq, p.H, batch), kThreads, sa, stream>>>(qt, kt, vt, dot, lse, delta, p);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  bwd_dq_kernel<T><<<dim3(nq, p.H, batch), kThreads, sb, stream>>>(qt, kt, vt, dot, lse, delta,
                                                                   static_cast<T*>(dq), p);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  bwd_dkdv_kernel<T><<<dim3(nk, K, batch), kThreads, sc, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), K, p);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The bf16 body: two launches on the tensor cores (wgmma on TMA-fed tiles)
// ---------------------------------------------------------------------------

constexpr int kTile = 64;     // query rows or keys of a tile: wgmma's M and the depth of A B
constexpr int kStages = 2;    // stages of the streamed tiles' rings
constexpr int kConsumer = 128;  // threads of a consumer warpgroup
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ constexpr uint32_t tile_bytes(int D) {
  return (D / kChunkCols) * kRowChunkBytes;
}

// 1024 bytes of slack to align the tiles to the swizzle pattern; the dq
// launch holds q, dO and kStages k and v tiles, the dk and dv launch k, v,
// kStages q and dO tiles and the exchange of one (64 x 64) f32 fragment.
constexpr size_t dq_tc_smem(int D) {
  return 1024 + (2 + 2 * kStages) * tile_bytes(D) + 8 * (1 + 4 * kStages);
}
constexpr size_t dkdv_tc_smem(int D) {
  return 1024 + (2 + 2 * kStages) * tile_bytes(D) + 32 * kConsumer * 4 + 8 * (1 + 4 * kStages);
}

// (1) dq and delta. One block per (batch, head, 64-query tile): one
// consumer warpgroup (threads 0-127) and one producer warpgroup whose
// thread 128 loads q and dO once and the key tiles through the k and v
// rings. A thread holds rows r0 and r0 + 8 of the tile and columns c0 +
// 8n + {0, 1} of each score fragment, as wgmma lays them out.
template <int kD>
__global__ void __launch_bounds__(2 * kConsumer, 1)
bwd_dq_wgmma(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
             const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap domap,
             const float* __restrict__ lse, float* __restrict__ delta,
             __nv_bfloat16* __restrict__ dq, Problem p) {
  constexpr int kChunks = kD / kChunkCols;
  constexpr uint32_t kBytes = tile_bytes(kD);
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;  // chunk c at sQ + c kRowChunkBytes
  const uint32_t sDO = sQ + kBytes;
  const uint32_t sK = sDO + kBytes;  // stage s at sK + s kBytes
  const uint32_t sV = sK + kStages * kBytes;
  // barriers: q and dO full; then k full, k empty, v full, v empty, each kStages of 8 bytes
  const uint32_t qd_full = sV + kStages * kBytes, k_full = qd_full + 8;
  const uint32_t k_empty = k_full + 8 * kStages, v_full = k_empty + 8 * kStages;
  const uint32_t v_empty = v_full + 8 * kStages;

  const int nq = (p.Sq + kTile - 1) / kTile;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * kTile;  // longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  int j_begin, j_end;
  key_range(q0, min(kTile, p.Sq - q0), p, &j_begin, &j_end);
  const int ntiles = j_end > j_begin ? (j_end - j_begin + kTile - 1) / kTile : 0;

  if (threadIdx.x == 0) {
    mbar_init(qd_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, kConsumer);
      mbar_init(v_empty + 8 * s, kConsumer);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumer) {
    // producer: one thread issues every load; the rings' empty barriers pace it
    if (threadIdx.x == kConsumer) {
      const int hk = h / p.rep;
      mbar_expect_tx(qd_full, 2 * kBytes);
      for (int c = 0; c < kChunks; ++c) {
        tma_load(sQ + c * kRowChunkBytes, &qmap, qd_full, c * kChunkCols, q0, h, b);
        tma_load(sDO + c * kRowChunkBytes, &domap, qd_full, c * kChunkCols, q0, h, b);
      }
      for (int t = 0; t < 2 * ntiles; ++t) {  // two sweeps: delta, then dq
        const int s = t % kStages;
        const uint32_t parity = ((t / kStages) & 1) ^ 1;
        const int j0 = j_begin + (t % ntiles) * kTile;
        mbar_wait(k_empty + 8 * s, parity);
        mbar_expect_tx(k_full + 8 * s, kBytes);
        for (int c = 0; c < kChunks; ++c) {
          tma_load(sK + s * kBytes + c * kRowChunkBytes, &kmap, k_full + 8 * s, c * kChunkCols,
                   j0, hk, b);
        }
        mbar_wait(v_empty + 8 * s, parity);
        mbar_expect_tx(v_full + 8 * s, kBytes);
        for (int c = 0; c < kChunks; ++c) {
          tma_load(sV + s * kBytes + c * kRowChunkBytes, &vmap, v_full + 8 * s, c * kChunkCols,
                   j0, hk, b);
        }
      }
    }
  } else {
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int r0 = q0 + 16 * warp + lane / 4, c0 = 2 * (lane % 4);
    const long long stat0 = (static_cast<long long>(b) * p.H + h) * p.Sq;
    const bool capped = p.softcap > 0.0f;
    const float pre = capped ? p.scale / p.softcap : 0.0f;
    const float post = (capped ? p.softcap : p.scale) * kLog2e;
    float L2[2];  // lse of rows r0 and r0 + 8 in log2 units
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = r0 + 8 * r;
      L2[r] = i < p.Sq ? lse[stat0 + i] * kLog2e : 0.0f;
    }
    float sc[32], dp[32];

    // sweep 1: delta_i = sum_j p_ij dp_ij / sum_j p_ij over the row's keys,
    // from the same S and dP as sweep 2 (the division takes out the error of
    // lse that p shares along the row), written to the scratch for launch (2)
    float ps[2] = {0.0f, 0.0f}, pd[2] = {0.0f, 0.0f};
    mbar_wait(qd_full, 0);
    for (int t = 0; t < ntiles; ++t) {
      const int s = t % kStages;
      const uint32_t ph = (t / kStages) & 1;
      const int j0 = j_begin + t * kTile;
      mbar_wait(k_full + 8 * s, ph);
      mbar_wait(v_full + 8 * s, ph);
      wgmma_fence();
      wgmma_scores<kD, kRowChunkBytes, kRowChunkBytes>(sc, sQ, sK + s * kBytes);
      wgmma_scores<kD, kRowChunkBytes, kRowChunkBytes>(dp, sDO, sV + s * kBytes);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      mbar_arrive(v_empty + 8 * s);
      mbar_arrive(k_empty + 8 * s);
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int r = (e >> 1) & 1;
        const int j = j0 + c0 + 8 * (e / 4) + (e & 1);
        const float x = capped ? tanhf(sc[e] * pre) : sc[e];
        const float pr = is_valid(r0 + 8 * r, j, p) ? exp2_ftz(fmaf(x, post, -L2[r])) : 0.0f;
        ps[r] += pr;
        pd[r] = fmaf(pr, dp[e], pd[r]);
      }
    }
    float dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = r0 + 8 * r;
      const float sum_p = quad_sum(ps[r]), sum_pd = quad_sum(pd[r]);
      dl[r] = sum_p > 0.0f ? sum_pd / sum_p : 0.0f;  // a row with no valid key: 0
      if (i < p.Sq && lane % 4 == 0) delta[stat0 + i] = dl[r];
    }

    // sweep 2: ds = p (dp - delta) (1 - t^2); dq += ds k
    float acc[kD / 2];
#pragma unroll
    for (int i = 0; i < kD / 2; ++i) acc[i] = 0.0f;
    uint32_t hi[16], lo[16];
    for (int t = ntiles; t < 2 * ntiles; ++t) {
      const int s = t % kStages;
      const uint32_t ph = (t / kStages) & 1;
      const int j0 = j_begin + (t - ntiles) * kTile;
      mbar_wait(k_full + 8 * s, ph);
      mbar_wait(v_full + 8 * s, ph);
      wgmma_fence();
      wgmma_scores<kD, kRowChunkBytes, kRowChunkBytes>(sc, sQ, sK + s * kBytes);
      wgmma_scores<kD, kRowChunkBytes, kRowChunkBytes>(dp, sDO, sV + s * kBytes);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      mbar_arrive(v_empty + 8 * s);
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int r = (e >> 1) & 1;
        const int j = j0 + c0 + 8 * (e / 4) + (e & 1);
        float x = sc[e], g = 1.0f;
        if (capped) {
          x = tanhf(x * pre);
          g = 1.0f - x * x;
        }
        const float pr = is_valid(r0 + 8 * r, j, p) ? exp2_ftz(fmaf(x, post, -L2[r])) : 0.0f;
        sc[e] = pr * (dp[e] - dl[r]) * g;
      }
      split_bf16(sc, hi, lo);
      fence_regs(hi);
      fence_regs(lo);
      wgmma_fence();
      wgmma_rows_split<kD>(acc, hi, lo, sK + s * kBytes);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(k_empty + 8 * s);
    }

    // dq = scale acc, rounded once to bf16; rows past the sequence are not stored
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = r0 + 8 * r;
      if (i < p.Sq) {
        __nv_bfloat16* out = dq + ((static_cast<long long>(b) * p.Sq + i) * p.H + h) * kD + c0;
#pragma unroll
        for (int n = 0; n < kD / 8; ++n) {
          *reinterpret_cast<__nv_bfloat162*>(out + 8 * n) = __floats2bfloat162_rn(
              acc[4 * n + 2 * r] * p.scale, acc[4 * n + 2 * r + 1] * p.scale);
        }
      }
    }
  }
}

// (2) dk and dv. One block per (batch, KV head, 64-key tile): consumer
// warpgroups 0 and 1 and a producer warpgroup, one thread of which loads
// the k and v tiles once and streams the (q, dO) tiles of the group's heads
// and of the query tiles that see the keys through two rings. Keys are
// wgmma's M, so S^T and dP^T come out laid out as the A operand of P^T dO
// and dS^T q. Warpgroup 0 computes S^T, P^T and g = P^T (1 - t^2) and owns
// dv; warpgroup 1 computes dP^T, takes g through shared memory (one f32
// fragment, thread for thread: both warpgroups hold the same (key, query)
// positions), forms dS^T = g (dP^T - delta) and owns dk. Named barrier 1
// says g is written, 2 that it has been read.
template <int kD>
__global__ void __launch_bounds__(3 * kConsumer, 1)
bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
               const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap domap,
               const float* __restrict__ lse, const float* __restrict__ delta,
               __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int K, Problem p) {
  constexpr int kChunks = kD / kChunkCols;
  constexpr uint32_t kBytes = tile_bytes(kD);
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sK = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sV = sK + kBytes;
  const uint32_t sQ = sV + kBytes;  // stage s at sQ + s kBytes
  const uint32_t sDO = sQ + kStages * kBytes;
  const uint32_t sX = sDO + kStages * kBytes;  // g: [32][kConsumer] f32
  // barriers: k and v full; then q full, q empty, dO full, dO empty, each kStages of 8 bytes
  const uint32_t kv_full = sX + 32 * kConsumer * 4, q_full = kv_full + 8;
  const uint32_t q_empty = q_full + 8 * kStages, do_full = q_empty + 8 * kStages;
  const uint32_t do_empty = do_full + 8 * kStages;

  const int j0 = blockIdx.x * kTile;  // the first key tiles see the most queries
  const int g = blockIdx.y, b = blockIdx.z;
  const int keys = min(kTile, p.Skv - j0);
  // the queries [i_begin, i_end) that may see a key of [j0, j0 + keys)
  int i_begin = 0, i_end = p.Sq;
  if (p.causal) {
    i_begin = j0;
    if (p.window > 0) i_end = min(p.Sq, j0 + keys - 1 + p.window);
  }
  const int nqt = i_end > i_begin ? (i_end - i_begin + kTile - 1) / kTile : 0;
  const int steps = p.rep * nqt;  // (head, query tile) pairs, head-major

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(q_full + 8 * s, 1);
      mbar_init(do_full + 8 * s, 1);
      mbar_init(q_empty + 8 * s, 2 * kConsumer);
      mbar_init(do_empty + 8 * s, 2 * kConsumer);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / kConsumer;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 2 * kConsumer) {
      mbar_expect_tx(kv_full, 2 * kBytes);
      for (int c = 0; c < kChunks; ++c) {
        tma_load(sK + c * kRowChunkBytes, &kmap, kv_full, c * kChunkCols, j0, g, b);
        tma_load(sV + c * kRowChunkBytes, &vmap, kv_full, c * kChunkCols, j0, g, b);
      }
      for (int u = 0; u < steps; ++u) {
        const int s = u % kStages;
        const uint32_t parity = ((u / kStages) & 1) ^ 1;
        const int h = g * p.rep + u / nqt, i0 = i_begin + (u % nqt) * kTile;
        mbar_wait(q_empty + 8 * s, parity);
        mbar_expect_tx(q_full + 8 * s, kBytes);
        for (int c = 0; c < kChunks; ++c) {
          tma_load(sQ + s * kBytes + c * kRowChunkBytes, &qmap, q_full + 8 * s, c * kChunkCols, i0,
                   h, b);
        }
        mbar_wait(do_empty + 8 * s, parity);
        mbar_expect_tx(do_full + 8 * s, kBytes);
        for (int c = 0; c < kChunks; ++c) {
          tma_load(sDO + s * kBytes + c * kRowChunkBytes, &domap, do_full + 8 * s, c * kChunkCols,
                   i0, h, b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int tid = threadIdx.x % kConsumer, lane = tid % 32, warp = tid / 32;
    const int r0 = j0 + 16 * warp + lane / 4, c0 = 2 * (lane % 4);  // keys r0, r0 + 8
    float* X = reinterpret_cast<float*>(smem_raw + (sX - smem_u32(smem_raw)));
    const bool capped = p.softcap > 0.0f;
    const float pre = capped ? p.scale / p.softcap : 0.0f;
    const float post = (capped ? p.softcap : p.scale) * kLog2e;
    float acc[kD / 2];  // dv in warpgroup 0, dk / scale in warpgroup 1
#pragma unroll
    for (int i = 0; i < kD / 2; ++i) acc[i] = 0.0f;
    float sc[32], col[16];
    uint32_t hi[16], lo[16];

    mbar_wait(kv_full, 0);
    for (int u = 0; u < steps; ++u) {
      const int s = u % kStages;
      const uint32_t ph = (u / kStages) & 1;
      const int h = g * p.rep + u / nqt, i0 = i_begin + (u % nqt) * kTile;
      // this thread's 16 query columns' lse (log2 units; warpgroup 0) or delta (1)
      const float* stat = (wg == 0 ? lse : delta) + (static_cast<long long>(b) * p.H + h) * p.Sq;
      const float mul = wg == 0 ? kLog2e : 1.0f;
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        const int i = i0 + c0 + 8 * (n / 2) + (n & 1);
        col[n] = i < p.Sq ? stat[i] * mul : 0.0f;
      }
      if (wg == 0) {
        mbar_wait(q_full + 8 * s, ph);
        wgmma_fence();
        wgmma_scores<kD, kRowChunkBytes, kRowChunkBytes>(sc, sK, sQ + s * kBytes);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);
        if (u > 0) named_sync(2, 2 * kConsumer);  // warpgroup 1 has read the last g
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int j = r0 + 8 * ((e >> 1) & 1);
          const int i = i0 + c0 + 8 * (e / 4) + (e & 1);
          float x = sc[e], gt = 1.0f;
          if (capped) {
            x = tanhf(x * pre);
            gt = 1.0f - x * x;
          }
          const float pr =
              is_valid(i, j, p) ? exp2_ftz(fmaf(x, post, -col[2 * (e / 4) + (e & 1)])) : 0.0f;
          X[e * kConsumer + tid] = pr * gt;
          sc[e] = pr;
        }
        __threadfence_block();
        named_arrive(1, 2 * kConsumer);
        split_bf16(sc, hi, lo);
        fence_regs(hi);
        fence_regs(lo);
        mbar_wait(do_full + 8 * s, ph);
        wgmma_fence();
        wgmma_rows_split<kD>(acc, hi, lo, sDO + s * kBytes);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
      } else {
        mbar_wait(do_full + 8 * s, ph);
        wgmma_fence();
        wgmma_scores<kD, kRowChunkBytes, kRowChunkBytes>(sc, sV, sDO + s * kBytes);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);
        named_sync(1, 2 * kConsumer);  // warpgroup 0's g of this step
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          sc[e] = X[e * kConsumer + tid] * (sc[e] - col[2 * (e / 4) + (e & 1)]);
        }
        __threadfence_block();
        if (u + 1 < steps) named_arrive(2, 2 * kConsumer);
        split_bf16(sc, hi, lo);
        fence_regs(hi);
        fence_regs(lo);
        mbar_wait(q_full + 8 * s, ph);
        wgmma_fence();
        wgmma_rows_split<kD>(acc, hi, lo, sQ + s * kBytes);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
      }
      mbar_arrive(q_empty + 8 * s);
      mbar_arrive(do_empty + 8 * s);
    }

    // dv, or dk = scale acc, rounded once to bf16; keys past the sequence are not stored
    __nv_bfloat16* out = wg == 0 ? dv : dk;
    const float mul = wg == 0 ? 1.0f : p.scale;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int j = r0 + 8 * r;
      if (j < p.Skv) {
        __nv_bfloat16* row = out + ((static_cast<long long>(b) * p.Skv + j) * K + g) * kD + c0;
#pragma unroll
        for (int n = 0; n < kD / 8; ++n) {
          *reinterpret_cast<__nv_bfloat162*>(row + 8 * n) =
              __floats2bfloat162_rn(acc[4 * n + 2 * r] * mul, acc[4 * n + 2 * r + 1] * mul);
        }
      }
    }
  }
}

template <int kD>
int launch_wgmma(const void* q, const void* k, const void* v, const void* lse, const void* dO,
                 void* dq, void* dk, void* dv, float* delta, int batch, int K, const Problem& p,
                 cudaStream_t stream) {
  CUtensorMap qmap, kmap, vmap, domap;
  if (!make_map(&qmap, q, kD, p.Sq, p.H, batch, p.qs, kTile) ||
      !make_map(&kmap, k, kD, p.Skv, K, batch, p.ks, kTile) ||
      !make_map(&vmap, v, kD, p.Skv, K, batch, p.vs, kTile) ||
      !make_map(&domap, dO, kD, p.Sq, p.H, batch, p.dos, kTile)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr size_t sa = dq_tc_smem(kD), sb = dkdv_tc_smem(kD);
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(bwd_dq_wgmma<kD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(sa))) != cudaSuccess ||
      (err = cudaFuncSetAttribute(bwd_dkdv_wgmma<kD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(sb))) != cudaSuccess) {
    return static_cast<int>(err);
  }
  const int nq = (p.Sq + kTile - 1) / kTile, nk = (p.Skv + kTile - 1) / kTile;
  bwd_dq_wgmma<kD><<<dim3(nq, p.H, batch), 2 * kConsumer, sa, stream>>>(
      qmap, kmap, vmap, domap, static_cast<const float*>(lse), delta,
      static_cast<__nv_bfloat16*>(dq), p);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  bwd_dkdv_wgmma<kD><<<dim3(nk, K, batch), 3 * kConsumer, sb, stream>>>(
      qmap, kmap, vmap, domap, static_cast<const float*>(lse), delta,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), K, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 (the tensor-core body): lse is the forward's (batch, H, Sq) f32
// row statistic, contiguous, and scratch takes delta (batch, H, Sq) f32;
// dO's base and strides must suit TMA. f32 (the CUDA-core body): lse is
// not read, and scratch takes lse and delta, 2 (batch, H, Sq) f32.
extern "C" int flash_attention_backward_launch(
    const void* q, const void* k, const void* v, const void* lse, const void* dO,
    void* dq, void* dk, void* dv, void* scratch, int batch, int Sq, int Skv, int H, int K, int D,
    int bf16, long long q_sb, long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh, long long do_sb,
    long long do_ss, long long do_sh, float scale, float softcap, int causal, int window,
    void* stream) {
  if (D <= 0 || D % 32 || D > kMaxD || K <= 0 || H % K || batch <= 0 || Sq <= 0 || Skv <= 0 ||
      batch > 65535 || H > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Problem p{Sq, Skv, H, H / K, D,
                  Strides{q_sb, q_ss, q_sh}, Strides{k_sb, k_ss, k_sh},
                  Strides{v_sb, v_ss, v_sh}, Strides{do_sb, do_ss, do_sh},
                  scale, softcap, causal, window};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* stats = static_cast<float*>(scratch);
  if (!bf16) {
    const long long n = static_cast<long long>(batch) * H * Sq;
    return launch<float>(q, k, v, dO, dq, dk, dv, stats, stats + n, batch, K, p, st);
  }
  if (lse == nullptr) return static_cast<int>(cudaErrorInvalidValue);
#define FLASH_BWD_WGMMA_CASE(d) \
  case d:                       \
    return launch_wgmma<d>(q, k, v, lse, dO, dq, dk, dv, stats, batch, K, p, st);
  switch (D) {
    FLASH_BWD_WGMMA_CASE(32)
    FLASH_BWD_WGMMA_CASE(64)
    FLASH_BWD_WGMMA_CASE(96)
    FLASH_BWD_WGMMA_CASE(128)
    FLASH_BWD_WGMMA_CASE(160)
    FLASH_BWD_WGMMA_CASE(192)
    FLASH_BWD_WGMMA_CASE(224)
    FLASH_BWD_WGMMA_CASE(256)
  }
#undef FLASH_BWD_WGMMA_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
