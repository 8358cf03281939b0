// Mamba-2 chunked SSD scan for Hopper (sm_90a), bound with a plain C
// interface and loaded through ctypes by repro_torch/kernels/ssd_scan.py.
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan.py:_ssd_kernel
// (wrapper ssd_scan_pallas).
//
// What it computes, per (batch b, head h) and per chunk of Q steps:
//   cum   = inclusive cumsum(dt * A)
//   L     = exp(where(i >= j, cum_i - cum_j, -inf))      (masked before exp)
//   y     = ((C B^T) o L) (x dt) + (C state^T) o exp(cum)
//   state = state * exp(cum_Q) + ((x dt) o exp(cum_Q - cum))^T B
// with head h reading group h / (H / G) of B and C. x, B and C are f32 or
// bf16 (read as bf16, computed in f32); dt, A and y are f32. The carried
// state (P, N) is f32 and is not returned, as in Pallas.
//
// Bound: fp32 operations. The scan needs at least the per-step recurrence's
// 4PN operations per (batch, head, step) against about 400 bytes moved
// (x in bf16, dt, y in f32, B and C shared by the heads of a group), about
// 80 operations per byte at P = 64, N = 128: above the card's fp32 rate per
// byte of device memory (67 TFLOP/s / 3.35 TB/s = 20). The chunked form
// computed here does Q(Q+1)(N+P) + 4QNP per chunk, 2.5x that at Q = 256.
//
// Design. The TPU walks the chunks in order on its sequential grid and
// carries the state in VMEM scratch. Blocks run in no order here, so one
// block of 256 threads owns one (batch, head) pair and loops over its
// chunks, with the (P, N) state kept in shared memory between them. The
// (Q, Q) scores, B and C of one 256-step chunk (256 KB, 128 KB and 128 KB in
// f32) do not fit in the 227 KB of shared memory a block can have, so the
// chunk is tiled: 64-row tiles of C and of the output, against streamed
// 64-row tiles of B and x dt. Tiles with j > i lie under the causal mask
// and are skipped. Every product is a register-tiled f32 product out of
// shared memory: each thread owns 4x4 output micro-tiles and reads one
// float4 of each operand per step, the operands stored k-major so that
// neighbouring threads read neighbouring float4s. The ragged last chunk is
// masked (rows past the sequence read as zero), so the wrapper pads nothing.
//
// What holds it back: one block per (batch, head) is 128 blocks for the
// card's 132 SMs at batch 4 x 32 heads, and 32 blocks at batch 1, each
// walking its chunks in sequence, with 8 warps per SM to hide latency; and
// the products run on the fp32 units, not the tensor cores. A two-pass
// chunk-parallel scan (chunk states first, then the outputs) and wgmma are
// later work.
//
// exp is expf (no --use_fast_math): the tolerance against the plain
// version is the summation order, not a fast exponential.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;       // rows of a C / output tile and of a B / x tile
constexpr int kPitch = kTile + 4;  // k-major pitch of the transposed tiles (float4 rows)
constexpr int kMaxYTiles = 2;   // 4x4 micro-tiles of a (64, P <= 128) output tile per thread
constexpr int kMaxSTiles = 4;   // 4x4 micro-tiles of an (N <= 128, P <= 128) state per thread

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }

__device__ __forceinline__ void fma44(float (&acc)[4][4], float4 a, float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w};
  const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
  }
}

// acc[u] += A^T B over k < depth for the 4x4 micro-tiles this thread owns:
// tile m = threadIdx.x + u * kThreads of an output with cols4 micro-tiles
// per row, rows 4 * (m / cols4) .. +3 and cols 4 * (m % cols4) .. +3.
// A is k-major with pitch lda (A[k * lda + row]), B likewise (B[k * ldb + col]).
template <int MT>
__device__ __forceinline__ void product(float (&acc)[MT][4][4], const float* A, int lda,
                                        const float* B, int ldb, int depth, int cols4,
                                        int tiles) {
#pragma unroll
  for (int u = 0; u < MT; ++u) {
    const int m = threadIdx.x + u * kThreads;
    if (m < tiles) {
      const float* a = A + 4 * (m / cols4);
      const float* b = B + 4 * (m % cols4);
#pragma unroll 4
      for (int k = 0; k < depth; ++k) {
        fma44(acc[u], *reinterpret_cast<const float4*>(a + k * lda),
              *reinterpret_cast<const float4*>(b + k * ldb));
      }
    }
  }
}

template <int MT>
__device__ __forceinline__ void zero(float (&acc)[MT][4][4]) {
#pragma unroll
  for (int u = 0; u < MT; ++u)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[u][r][c] = 0.0f;
}

struct Strides {
  long long b, s, h;
};

// Load rows [row0, row0 + kTile) of a (seq, N) slice into a k-major tile
// dst[n * kPitch + r]; rows past the chunk (q >= Q) or the sequence read 0.
template <typename T>
__device__ __forceinline__ void load_transposed(float* dst, const T* src, Strides st, int s0,
                                                int row0, int Q, int S, int N) {
  for (int idx = threadIdx.x; idx < kTile * N; idx += kThreads) {
    const int r = idx / N, n = idx - r * N;
    const int q = row0 + r, s = s0 + q;
    dst[n * kPitch + r] = (q < Q && s < S) ? load(src + s * st.s + n) : 0.0f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ Aneg,
           const T* __restrict__ Bm, const T* __restrict__ Cm, float* __restrict__ y,
           int S, int H, int P, int G, int N, int Q, Strides xs, Strides dts, Strides bs,
           Strides cs) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Ct = smem;                  // C tile, k-major: [N][kPitch]
  float* Bt = Ct + N * kPitch;       // B tile, [N][kPitch]; natural [kTile][N] in the state pass
  float* St = Bt + N * kPitch;       // masked scores, [j][kPitch] over i
  float* Xs = St + kTile * kPitch;   // x dt tile, [kTile][P]
  float* state = Xs + kTile * P;     // carried state, transposed: [N][P]
  float* cum = state + N * P;        // [Q4]
  float* dts_ = cum + ((Q + 3) & ~3);  // [Q4]

  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (H / G);
  const float A = Aneg[h];
  const T* xb = x + b * xs.b + h * xs.h;
  const float* dtb = dt + b * dts.b + h * dts.h;
  const T* Bb = Bm + b * bs.b + g * bs.h;
  const T* Cb = Cm + b * cs.b + g * cs.h;
  float* yb = y + (static_cast<long long>(b) * S * H + h) * P;
  const long long y_s = static_cast<long long>(H) * P;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int P4 = P / 4, N4 = N / 4;

  for (int idx = threadIdx.x; idx < N * P; idx += kThreads) state[idx] = 0.0f;

  for (int s0 = 0; s0 < S; s0 += Q) {
    // dt of the chunk (0 past the sequence) and cum = inclusive cumsum(dt A):
    // each lane of warp 0 sums a run of steps, then a shuffle scan adds the
    // runs before it.
    for (int q = threadIdx.x; q < Q; q += kThreads) {
      dts_[q] = (s0 + q < S) ? dtb[(s0 + q) * dts.s] : 0.0f;
    }
    __syncthreads();
    if (warp == 0) {
      const int per = (Q + 31) / 32;
      const int beg = min(lane * per, Q), end = min(beg + per, Q);
      float run = 0.0f;
      for (int q = beg; q < end; ++q) {
        run += dts_[q] * A;
        cum[q] = run;
      }
      float incl = run;
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += v;
      }
      const float before = incl - run;
      for (int q = beg; q < end; ++q) cum[q] += before;
    }
    __syncthreads();
    const float cum_end = cum[Q - 1];

    for (int i0 = 0; i0 < Q; i0 += kTile) {
      load_transposed(Ct, Cb, cs, s0, i0, Q, S, N);
      __syncthreads();
      // inter-chunk term: (C state^T)[i, p] * exp(cum_i)
      float acc[kMaxYTiles][4][4];
      zero(acc);
      product(acc, Ct, kPitch, state, P, N, P4, 16 * P4);
#pragma unroll
      for (int u = 0; u < kMaxYTiles; ++u) {
        const int m = threadIdx.x + u * kThreads;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + 4 * (m / P4) + r;
          const float f = i < Q ? expf(cum[i]) : 0.0f;
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[u][r][c] *= f;
        }
      }
      // intra-chunk term over the tiles j0 <= i0 (j > i is masked to 0)
      for (int j0 = 0; j0 <= i0; j0 += kTile) {
        load_transposed(Bt, Bb, bs, s0, j0, Q, S, N);
        for (int idx = threadIdx.x; idx < kTile * P; idx += kThreads) {
          const int r = idx / P, p = idx - r * P;
          const int q = j0 + r, s = s0 + q;
          Xs[idx] = (q < Q && s < S) ? load(xb + s * xs.s + p) * dts_[q] : 0.0f;
        }
        __syncthreads();
        // scores[j, i] = (B C^T)[j, i] * L[i, j], stored [j][i]
        float sc[1][4][4];
        zero(sc);
        product(sc, Bt, kPitch, Ct, kPitch, N, kTile / 4, (kTile / 4) * (kTile / 4));
        {
          const int m = threadIdx.x;
          const int jr = 4 * (m / (kTile / 4)), ic = 4 * (m % (kTile / 4));
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int j = j0 + jr + r;
            float out[4];
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int i = i0 + ic + c;
              out[c] = (i >= j && i < Q) ? sc[0][r][c] * expf(cum[i] - cum[j]) : 0.0f;
            }
            *reinterpret_cast<float4*>(St + (jr + r) * kPitch + ic) =
                make_float4(out[0], out[1], out[2], out[3]);
          }
        }
        __syncthreads();
        product(acc, St, kPitch, Xs, P, kTile, P4, 16 * P4);
        __syncthreads();
      }
#pragma unroll
      for (int u = 0; u < kMaxYTiles; ++u) {
        const int m = threadIdx.x + u * kThreads;
        if (m < 16 * P4) {
          const int pc = 4 * (m % P4);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int q = i0 + 4 * (m / P4) + r;
            if (q < Q && s0 + q < S) {
              *reinterpret_cast<float4*>(yb + (s0 + q) * y_s + pc) =
                  make_float4(acc[u][r][0], acc[u][r][1], acc[u][r][2], acc[u][r][3]);
            }
          }
        }
      }
    }

    // state^T[n, p] <- state^T[n, p] exp(cum_end)
    //                  + sum_j B[j, n] x[j, p] dt_j exp(cum_end - cum_j)
    float acc_s[kMaxSTiles][4][4];
    zero(acc_s);
    for (int j0 = 0; j0 < Q; j0 += kTile) {
      for (int idx = threadIdx.x; idx < kTile * N; idx += kThreads) {
        const int r = idx / N, n = idx - r * N;
        const int q = j0 + r, s = s0 + q;
        Bt[idx] = (q < Q && s < S) ? load(Bb + s * bs.s + n) : 0.0f;
      }
      for (int idx = threadIdx.x; idx < kTile * P; idx += kThreads) {
        const int r = idx / P, p = idx - r * P;
        const int q = j0 + r, s = s0 + q;
        Xs[idx] = (q < Q && s < S)
                      ? load(xb + s * xs.s + p) * dts_[q] * expf(cum_end - cum[q])
                      : 0.0f;
      }
      __syncthreads();
      product(acc_s, Bt, N, Xs, P, kTile, P4, N4 * P4);
      __syncthreads();
    }
    const float decay = expf(cum_end);
#pragma unroll
    for (int u = 0; u < kMaxSTiles; ++u) {
      const int m = threadIdx.x + u * kThreads;
      if (m < N4 * P4) {
        const int nr = 4 * (m / P4), pc = 4 * (m % P4);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            float& st = state[(nr + r) * P + pc + c];
            st = st * decay + acc_s[u][r][c];
          }
        }
      }
    }
    __syncthreads();
  }
}

size_t smem_bytes(int P, int N, int Q) {
  const int q4 = (Q + 3) & ~3;
  return sizeof(float) *
         (static_cast<size_t>(2 * N * kPitch) + kTile * kPitch + kTile * P + N * P + 2 * q4);
}

template <typename T>
int launch(const void* x, const float* dt, const float* A, const void* Bm, const void* Cm,
           float* y, int batch, int S, int H, int P, int G, int N, int Q, Strides xs,
           Strides dts, Strides bs, Strides cs, cudaStream_t stream) {
  const size_t smem = smem_bytes(P, N, Q);
  cudaError_t err = cudaFuncSetAttribute(ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_kernel<T><<<dim3(H, batch), kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm), static_cast<const T*>(Cm), y,
      S, H, P, G, N, Q, xs, dts, bs, cs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A, const void* Bm,
                               const void* Cm, void* y, int batch, int S, int H, int P, int G,
                               int N, int Q, int bf16, long long x_sb, long long x_ss,
                               long long x_sh, long long dt_sb, long long dt_ss,
                               long long dt_sh, long long b_sb, long long b_ss, long long b_sg,
                               long long c_sb, long long c_ss, long long c_sg, void* stream) {
  if (P % 4 || N % 4 || Q % 4 || P > 128 || N > 128 || Q > 1024 || G <= 0 || H % G) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Strides xs{x_sb, x_ss, x_sh}, dts{dt_sb, dt_ss, dt_sh}, bs{b_sb, b_ss, b_sg},
      cs{c_sb, c_ss, c_sg};
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  float* yf = static_cast<float*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return launch<__nv_bfloat16>(x, dtf, Af, Bm, Cm, yf, batch, S, H, P, G, N, Q, xs, dts, bs,
                                 cs, st);
  }
  return launch<float>(x, dtf, Af, Bm, Cm, yf, batch, S, H, P, G, N, Q, xs, dts, bs, cs, st);
}
