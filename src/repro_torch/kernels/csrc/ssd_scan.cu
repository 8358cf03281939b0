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
// with head h reading group h / (H / G) of B and C. dt, A and y are f32; A
// is one (H,) row for the whole batch or one per batch row (a_sb = H: the
// peers of a vmapped banked step). The carried state (P, N) is f32 and is
// not returned, as in Pallas. Rows
// past the sequence are masked in the kernel (the wrapper pads nothing), and
// x, B and C may be strided views whose last dimension is contiguous.
// ssd_scan_launch picks one of two bodies by the type of x, B and C;
// neither stands in for the other.
//
// Bound. The scan needs at least the per-step recurrence's 4PN operations
// per (batch, head, step) against about 400 bytes moved (x in bf16, dt, y in
// f32; B and C shared by the heads of a group). At P = 64, N = 128 that is
// about 80 operations per byte: above the card's fp32 rate per byte of
// device memory (67 TFLOP/s / 3.35 TB/s = 20), below its bf16 tensor-core
// rate per byte (989 / 3.35 = 295). On the tensor cores the bytes bound it:
// 105.9 MB, 0.0316 ms, at mamba2-370m's 4 x 2048.
//
// The bf16 body (ssd_kernel_states, ssd_kernel_carry, ssd_kernel_outputs)
// splits the scan into three launches on the caller's stream, each of which
// spreads over the card, where the TPU walks the chunks in order:
//   1. states: one block per (batch, head, chunk) computes cum and the
//      chunk's end state s_c = x^T W, W_j = dt_j exp(cum_Q - cum_j) B_j, and
//      its decay exp(cum_Q), into f32 scratch of (B, chunks, H, P, N) and
//      (B, chunks, H) that the wrapper allocates;
//   2. carry: R_0 = 0, R_{c+1} = R_c exp(cum_Q,c) + s_c (a multiply, then an
//      add, in the plain version's order), one thread per four state
//      elements walking the chunks, writing each entering state R_c as bf16
//      hi and lo halves (B, chunks, H, 2, P, N) for pass 3;
//   3. outputs: one block per (batch, head, chunk) recomputes cum with the
//      same code and writes y = (C B^T o L o dt_j) x + (C R_c^T) o exp(cum_i)
//      once, L masked before the exp.
// Every product runs on wgmma.m64n64k16 in bf16 with f32 accumulators. Each
// has one operand that is exact in bf16 (x, B and C are bf16 inputs); the
// other is an f32 value, which goes in as two bf16 terms, hi = bf16(v) and
// lo = bf16(v - hi), accumulated into the same f32 sum: one bf16 rounding
// moves y by about 2e-3 of max|y| at mamba2-370m's widths, hi + lo by about
// 5e-6, inside the 2e-5 the checks allow. C B^T takes C and B from shared
// memory as they are; W (pass 1) and S' = C B^T o L o dt_j (pass 3) are
// built in registers as wgmma's A fragment, hi and lo, against x read
// N-major (transposed by the instruction); R_c enters C R_c^T as its hi and
// lo tiles. Tiles arrive by TMA in the 64-byte swizzle (make_map's boxes of
// 32 columns by up to 64 rows; rows past the sequence and columns past P or
// N read as zero), P padded to 64 columns, N to 64 or 128 and the chunk to
// 64-row tiles (a chunk below 64 is one box of its rows, the rest zero). A
// producer warp issues the boxes, so that no thread that computes waits on
// a copy it issued, and two consumer warpgroups compute. Pass 3 holds the
// chunk's C, B, x and R (at Q = 256, N = 128: 195 KB, one block per SM) and
// receives B and x in 64-row stages, each counted on its own mbarrier: the
// warpgroups start on the first while the rest land. Its (64-row output
// tile, 64-row key tile) pairs under the causal mask are dealt out so that
// both warpgroups do the same number, tiles 3 and 0 to one, 2 and 1 to the
// other; each walks its key tiles as flash's loop does, S of tile u issued
// with S' x of tile u - 1 and weighed while that runs. The mask's exp is
// ex2.approx of log2(e)-scaled differences. The body takes P <= 64 and N <=
// 128, both multiples of 8, a chunk that is a multiple of 8 up to 64 or of
// 64 up to 256, and 16-byte-aligned rows (the wrapper raises otherwise).
//
// What still holds it back: at one block per SM, each pass-3 block loads
// its chunk (about 2.5 us) before it computes and its tensor cores are busy
// about a third of the time it runs, every key step waiting on its own
// products and weighing; the split terms double the tensor work of three
// of the four products; pass 1 builds its W fragments on the CUDA cores;
// the chunk states cross device memory four times (33.5 MB each at
// 4 x 2048); C B^T, which depends on the group and not the head, is
// recomputed by each of a group's heads.
//
// The f32 body (ssd_kernel<float>, PR 13's design) stays for f32 inputs:
// one block of 256 threads per (batch, head) walks its chunks in order with
// the (P, N) state in shared memory, and every product is a register-tiled
// f32 product on the CUDA cores (4x4 micro-tiles per thread, operands
// k-major in shared memory), the (Q, Q) scores tiled in 64-row tiles with
// the tiles above the diagonal skipped. It takes P, N and chunk in
// multiples of 4 up to 128, 128 and 1024. What holds it back: one block per
// (batch, head), each walking its chunks in sequence, and the fp32 units.
//
// Elsewhere exp is expf (no --use_fast_math): the tolerance against the
// plain version is the summation order and the split, not a fast
// exponential.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;       // rows of a C / output tile and of a B / x tile
constexpr int kPitch = kTile + 4;  // k-major pitch of the transposed tiles (float4 rows)
constexpr int kMaxYTiles = 2;   // 4x4 micro-tiles of a (64, P <= 128) output tile per thread
constexpr int kMaxSTiles = 4;   // 4x4 micro-tiles of an (N <= 128, P <= 128) state per thread

__device__ __forceinline__ float load(const float* p) { return *p; }

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
           int S, int H, int P, int G, int N, int Q, long long a_sb, Strides xs, Strides dts,
           Strides bs, Strides cs) {
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
  const float A = Aneg[b * a_sb + h];
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
           float* y, int batch, int S, int H, int P, int G, int N, int Q, long long a_sb,
           Strides xs, Strides dts, Strides bs, Strides cs, cudaStream_t stream) {
  const size_t smem = smem_bytes(P, N, Q);
  cudaError_t err = cudaFuncSetAttribute(ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_kernel<T><<<dim3(H, batch), kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm), static_cast<const T*>(Cm), y,
      S, H, P, G, N, Q, a_sb, xs, dts, bs, cs);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The bf16 body: three chunk-parallel passes on wgmma, TMA-fed.
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kTcThreads = 256;                  // two consumer warpgroups
constexpr int kTcBlock = kTcThreads + 32;        // and a producer warp that issues the boxes
constexpr int kRows = 64;                        // rows of a wgmma tile and of a full TMA box
constexpr int kPp = 64;                          // headdim columns of an x or R tile (P <= 64)
constexpr int kMaxTcChunk = 256;
constexpr int kMaxStages = kMaxTcChunk / kRows;
constexpr int kMaxTcState = 128;
constexpr uint32_t kSwizzleAtom = 8 * 64;        // 8 rows of 64 bytes
constexpr int kCarryThreads = 256;
constexpr int kCarryAhead = 8;                   // chunk states a carry thread loads ahead
constexpr float kLog2e = 1.4426950408889634f;

// Order this thread's generic-proxy writes to shared memory before the
// async-proxy accesses (TMA, wgmma) that follow a barrier.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void st_shared16(uint32_t dst, uint32_t a, uint32_t b, uint32_t c,
                                            uint32_t d) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst), "r"(a), "r"(b), "r"(c),
               "r"(d)
               : "memory");
}

// Byte offset of the 16 bytes (row r, columns 8 c8 .. 8 c8 + 7) of a bf16
// tile of ``rows`` rows in the 64-byte swizzle, as TMA lays out the boxes
// of make_map: 32 columns per chunk of rows x 64 bytes, the 16-byte units
// of a row permuted by bits 1-2 of the row.
__device__ __forceinline__ uint32_t swizzled(int rows, int r, int c8) {
  return static_cast<uint32_t>((c8 >> 2) * rows * 64 + r * 64 + (((c8 & 3) ^ ((r >> 1) & 3)) << 4));
}

// Zero the units of a tile of ``rows`` x kCols that no box writes: the rows
// of each 64-row tile from ``loaded`` on, and column chunks from ``chunks``
// on. Nothing to do when the boxes cover the tile.
template <int kCols>
__device__ __forceinline__ void zero_unloaded(uint32_t dst, int rows, int loaded, int chunks) {
  constexpr int kGroups = kCols / 8;
  if (loaded == kRows && chunks * kChunkCols == kCols) return;
  for (int u = threadIdx.x; u < rows * kGroups; u += kTcThreads) {
    const int r = u / kGroups, c8 = u % kGroups;
    if (r % kRows >= loaded || c8 / 4 >= chunks) {
      st_shared16(dst + swizzled(rows, r, c8), 0u, 0u, 0u, 0u);
    }
  }
}

// A barrier of the consumer threads 0 .. 255 (the producer warp has left).
__device__ __forceinline__ void sync_consumers() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kTcThreads) : "memory");
}

// cum = the inclusive cumsum of a = dt A over the chunk's Qp <= 256 rows,
// thread q holding a_q (0 past the chunk): a shuffle scan in each warp, then
// the sums of the warps before. Passes 1 and 3 both call it, so both see
// the same cum. ``warp_sum`` holds 8 floats. Consumer threads only; ends
// with their barrier.
__device__ __forceinline__ void chunk_cum(float a, float* cum, float* warp_sum, int Qp) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  float v = a;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += o;
  }
  if (lane == 31) warp_sum[warp] = v;
  sync_consumers();
  float before = 0.0f;
  for (int w = 0; w < warp; ++w) before += warp_sum[w];
  if (tid < Qp) cum[tid] = v + before;
  sync_consumers();
}

// v as wgmma's A operand in two bf16 terms: hi = bf16(v), lo = bf16(v - hi).
__device__ __forceinline__ void split(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 back = __bfloat1622float2(h);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(v0 - back.x, v1 - back.y));
}

struct Dims {
  int S, H, P, G, N, Q, Qp, chunks;  // Qp: the chunk padded to 64-row tiles
  int box;                           // rows of a TMA box: the chunk below 64, else 64
  long long a_sb;                    // A's stride between batch rows: 0 where one A is shared
};

// Where a chunk of rows sits in shared memory and what its boxes bring: per
// 64-row tile, ``box`` rows from the tensor map (rows past the sequence read
// as zero), the rest zero; ``chunks_n`` and ``chunks_p`` column chunks of B
// and C, and of x (the others zero).
struct ChunkLoad {
  int s0, valid, nt, chunks_n, chunks_p;
};

__device__ __forceinline__ ChunkLoad chunk_load(const Dims& d, int c) {
  ChunkLoad L;
  L.s0 = c * d.Q;
  L.valid = min(d.Q, d.S - L.s0);
  L.nt = d.Qp / kRows;
  L.chunks_n = (d.N + kChunkCols - 1) / kChunkCols;
  L.chunks_p = (d.P + kChunkCols - 1) / kChunkCols;
  return L;
}

size_t states_smem(int Qp, int Np) {
  return 1024 + static_cast<size_t>(Qp) * kPp * 2 + static_cast<size_t>(Qp) * Np * 2 +
         3 * sizeof(float) * Qp + 8 * sizeof(float) + 8;
}

// Pass 1: block (chunk c, head h, batch b). s_c^T (N, P) = W^T x over the
// chunk's rows j, W_j = dt_j exp(cum_last - cum_j) B_j: warpgroup w owns
// state rows 64 w .. 64 w + 63, builds W^T's A fragments (hi and lo) from
// the B tile (the 64-byte swizzle keeps those reads off each other's
// banks), and reads the x tile N-major. The producer warp issues the boxes
// of x and B, counted on one mbarrier. Writes s_c as (P, N) and the chunk's
// decay exp(cum_last).
template <int kNp>
__global__ void __launch_bounds__(kTcBlock, 2)
ssd_kernel_states(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap bmap, const float* __restrict__ dt,
                  const float* __restrict__ Aneg, float* __restrict__ states,
                  float* __restrict__ decay, Dims d, Strides dts) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sX = (raw + 1023u) & ~1023u;  // x: Qp rows x kPp
  const uint32_t sB = sX + d.Qp * kPp * 2;     // B: Qp rows x kNp
  const uint8_t* Bs = smem_raw + (sB - raw);
  float* fw = reinterpret_cast<float*>(smem_raw + (sB - raw) + d.Qp * kNp * 2);
  float* cum = fw + d.Qp;  // fw: dt_j exp(cum_last - cum_j)
  float* sdt = cum + d.Qp;
  float* warp_sum = sdt + d.Qp;
  const uint32_t full = smem_u32(warp_sum + 8);

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const ChunkLoad L = chunk_load(d, c);
  const int g = h / (d.H / d.G);
  if (tid == 0) {
    mbar_init(full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid >= kTcThreads) {
    // the producer warp: its lanes share the boxes, per 64-row tile x's then
    // B's chunks, and are done
    const int lane = tid - kTcThreads;
    if (lane == 0) mbar_expect_tx(full, L.nt * (L.chunks_p + L.chunks_n) * d.box * 64);
    __syncwarp();
    const int per = L.chunks_p + L.chunks_n;
    for (int i = lane; i < L.nt * per; i += 32) {
      const int t = i / per, k = i % per, row = L.s0 + t * kRows;
      if (k < L.chunks_p) {
        tma_load(sX + k * d.Qp * 64 + t * kRows * 64, &xmap, full, k * kChunkCols, row, h, b);
      } else {
        const int kb = k - L.chunks_p;
        tma_load(sB + kb * d.Qp * 64 + t * kRows * 64, &bmap, full, kb * kChunkCols, row, g, b);
      }
    }
    return;
  }
  const float A = Aneg[b * d.a_sb + h];
  const float dtq = tid < L.valid ? dt[b * dts.b + h * dts.h + (L.s0 + tid) * dts.s] : 0.0f;
  zero_unloaded<kPp>(sX, d.Qp, d.box, L.chunks_p);
  zero_unloaded<kNp>(sB, d.Qp, d.box, L.chunks_n);
  fence_async_smem();  // the zeros, before the products that follow chunk_cum's barrier
  if (tid < d.Qp) sdt[tid] = dtq;
  chunk_cum(dtq * A, cum, warp_sum, d.Qp);
  const float cum_last = cum[d.Q - 1];
  if (tid < d.Qp) fw[tid] = dtq * expf(cum_last - cum[tid]);
  if (tid == 0) decay[(static_cast<long long>(b) * d.chunks + c) * d.H + h] = expf(cum_last);
  sync_consumers();
  mbar_wait(full, 0);

  const int wg = tid / 128;
  if (wg * kRows >= kNp) return;
  const int lane = tid % 32, warp = (tid / 32) % 4;
  const int n0 = wg * kRows + 16 * warp + lane / 4;  // this thread's state rows n0, n0 + 8
  const int c0 = 2 * (lane % 4);                     // and columns c0, c0 + 1 of each 8
  // B's element (j, n) is 2 bytes at swizzled(Qp, j, n / 8) + 2 (n % 8).
  // This thread reads rows j = c0 (mod 8) and j + 1, whose 16-byte units are
  // permuted by (j >> 1) & 3 = lane % 4 alike, so each of its two state rows
  // n0 and n0 + 8 (units n0 / 8 and n0 / 8 + 1) has one base: + 64 j.
  const uint8_t* brow[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int c8 = (n0 + 8 * r) / 8;
    brow[r] = Bs + (c8 >> 2) * d.Qp * 64 + (((c8 & 3) ^ (lane % 4)) << 4) + 2 * (n0 % 8);
  }
  float acc[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = 0.0f;
  for (int k0 = 0; k0 < d.Qp; k0 += 64) {
    // A fragments of W^T for rows j = k0 .. k0 + 63: register 4 kk + r holds
    // (state row n0 + 8 (r & 1), rows j and j + 1 at k0 + 16 kk + 8 (r >> 1) + c0)
    uint32_t hi[16], lo[16];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int j = k0 + 16 * kk + 8 * (r >> 1) + c0;
        const float2 f = *reinterpret_cast<const float2*>(fw + j);
        const bf16 b0 = *reinterpret_cast<const bf16*>(brow[r & 1] + j * 64);
        const bf16 b1 = *reinterpret_cast<const bf16*>(brow[r & 1] + j * 64 + 64);
        split(__bfloat162float(b0) * f.x, __bfloat162float(b1) * f.y, hi[4 * kk + r], lo[4 * kk + r]);
      }
    }
    fence_regs(hi);
    fence_regs(lo);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t desc = smem_desc(sX + (k0 + 16 * kk) * 64, d.Qp * 64, kSwizzleAtom);
      wgmma_rs_n64(acc, hi + 4 * kk, desc);
      wgmma_rs_n64(acc, lo + 4 * kk, desc);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(hi);
    fence_regs(lo);
  }
  // accumulator e: state row n0 + 8 ((e >> 1) & 1), column p = 8 (e / 4) + c0 + (e & 1)
  float* st = states + ((static_cast<long long>(b) * d.chunks + c) * d.H + h) * d.P * d.N;
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int n = n0 + 8 * ((e >> 1) & 1), p = 8 * (e / 4) + c0 + (e & 1);
    if (n < d.N && p < d.P) st[p * d.N + n] = acc[e];
  }
}

// Pass 2: the carry over the chunks, four state elements a thread: R_0 = 0,
// R_{c+1} = R_c decay_c + s_c (rounded after the multiply and after the
// add, as the plain version's two operations are). Writes the entering
// state R_c split for pass 3, bf16 hi = bf16(R) and lo = bf16(R - hi), as
// (B, chunks, H, 2, P, N).
__global__ void __launch_bounds__(kCarryThreads, 3)
ssd_kernel_carry(const float4* __restrict__ states, const float* __restrict__ decay,
                 uint2* __restrict__ split_states, int chunks, int H, int pn4,
                 long long total4) {
  const long long idx = static_cast<long long>(blockIdx.x) * kCarryThreads + threadIdx.x;
  if (idx >= total4) return;
  const int e4 = static_cast<int>(idx % pn4);
  const long long bh = idx / pn4;
  const int h = static_cast<int>(bh % H);
  const long long b = bh / H;
  float R[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int c0 = 0; c0 < chunks; c0 += kCarryAhead) {
    float4 sv[kCarryAhead];
    float f[kCarryAhead];
#pragma unroll
    for (int k = 0; k < kCarryAhead; ++k) {
      if (c0 + k < chunks) {
        const long long row = (b * chunks + c0 + k) * H + h;
        sv[k] = states[row * pn4 + e4];
        f[k] = decay[row];
      }
    }
#pragma unroll
    for (int k = 0; k < kCarryAhead; ++k) {
      if (c0 + k < chunks) {
        uint2 hi, lo;
        split(R[0], R[1], hi.x, lo.x);
        split(R[2], R[3], hi.y, lo.y);
        uint2* out = split_states + ((b * chunks + c0 + k) * H + h) * 2 * pn4 + e4;
        out[0] = hi;
        out[pn4] = lo;
        const float s4[4] = {sv[k].x, sv[k].y, sv[k].z, sv[k].w};
#pragma unroll
        for (int i = 0; i < 4; ++i) R[i] = __fadd_rn(__fmul_rn(R[i], f[k]), s4[i]);
      }
    }
  }
}

size_t outputs_smem(int Qp, int Np) {
  return 1024 + 2 * static_cast<size_t>(Qp) * Np * 2 + static_cast<size_t>(Qp) * kPp * 2 +
         2 * static_cast<size_t>(kPp) * Np * 2 + 2 * sizeof(float) * Qp + 8 * sizeof(float) +
         8 * kMaxStages;
}

// The shared-memory tiles and per-row values of pass 3, and this thread's
// place in a 64-row output tile.
struct OutTiles {
  uint32_t C, B, X, Rhi, Rlo;  // C, B: Qp x kNp; x: Qp x kPp; R hi and lo: kPp x kNp
  const float* sdt;
  const float* cum;
  int Qp;
  int r0, c0;  // rows r0 and r0 + 8 of a tile, columns c0 and c0 + 1 of each 8
};

// y tile t = (C_t R^T) o exp(cum_i) with R = R_hi + R_lo, or 0 for the first chunk.
template <int kNp>
__device__ __forceinline__ void outputs_init(float (&y)[32], const OutTiles& T, int t, bool carry) {
#pragma unroll
  for (int e = 0; e < 32; ++e) y[e] = 0.0f;
  if (!carry) return;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kNp / 16; ++kk) {
    const uint32_t k_off = (kk / 2) * T.Qp * 64 + (kk % 2) * 32;
    const uint64_t a = smem_desc(T.C + k_off + t * kRows * 64, 16, kSwizzleAtom);
    const uint32_t r_off = (kk / 2) * kPp * 64 + (kk % 2) * 32;
    wgmma_ss_n64(y, a, smem_desc(T.Rhi + r_off, 16, kSwizzleAtom), 1);
    wgmma_ss_n64(y, a, smem_desc(T.Rlo + r_off, 16, kSwizzleAtom), 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(y);
  const float f0 = expf(T.cum[t * kRows + T.r0]), f1 = expf(T.cum[t * kRows + T.r0 + 8]);
#pragma unroll
  for (int e = 0; e < 32; ++e) y[e] *= ((e >> 1) & 1) ? f1 : f0;
}

// S = C_t B_u^T into sc (overwritten), both K-major from shared memory.
template <int kNp>
__device__ __forceinline__ void issue_scores(float (&sc)[32], const OutTiles& T, int t, int u) {
#pragma unroll
  for (int kk = 0; kk < kNp / 16; ++kk) {
    const uint32_t k_off = (kk / 2) * T.Qp * 64 + (kk % 2) * 32;
    wgmma_ss_n64(sc, smem_desc(T.C + k_off + t * kRows * 64, 16, kSwizzleAtom),
                 smem_desc(T.B + k_off + u * kRows * 64, 16, kSwizzleAtom), kk > 0);
  }
}

// y += (S'_hi + S'_lo) x_u over the 64 keys of tile u, x read N-major.
__device__ __forceinline__ void issue_sx(float (&y)[32], const uint32_t (&hi)[16],
                                         const uint32_t (&lo)[16], const OutTiles& T, int u) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t desc = smem_desc(T.X + (u * kRows + 16 * kk) * 64, T.Qp * 64, kSwizzleAtom);
    wgmma_rs_n64(y, hi + 4 * kk, desc);
    wgmma_rs_n64(y, lo + 4 * kk, desc);
  }
}

// S'_ij = S_ij exp(cum_i - cum_j) dt_j where j <= i (masked before the
// exp), else 0, in place; the exp is 2^x of log2(e)-scaled differences.
__device__ __forceinline__ void weigh(float (&sc)[32], const OutTiles& T, int t, int u) {
  const int i0 = t * kRows + T.r0;
  const float ci[2] = {T.cum[i0], T.cum[i0 + 8]};
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    // score e: row i0 + 8 ((e >> 1) & 1), key j = 64 u + 8 (e / 4) + c0 + (e & 1)
    const int r = (e >> 1) & 1, i = i0 + 8 * r, j = u * kRows + 8 * (e / 4) + T.c0 + (e & 1);
    sc[e] = j <= i ? sc[e] * (exp2_ftz((ci[r] - T.cum[j]) * kLog2e) * T.sdt[j]) : 0.0f;
  }
  fence_regs(sc);  // stays ahead of the wait for the S' x in flight
}

__device__ __forceinline__ void split_scores(const float (&sc)[32], uint32_t (&hi)[16],
                                             uint32_t (&lo)[16]) {
#pragma unroll
  for (int n = 0; n < 16; ++n) split(sc[2 * n], sc[2 * n + 1], hi[n], lo[n]);
  fence_regs(hi);
  fence_regs(lo);
}

// y tile t = sum over key tiles u <= t of S'_u x_u, plus (C_t R^T) o
// exp(cum_i), as in flash's loop: step u issues S of tile u and S' x of
// tile u - 1, and weighs S of tile u on the CUDA cores while S' x runs.
// stage(u) runs before step u touches key tile u.
template <int kNp, typename Stage>
__device__ __forceinline__ void outputs_tile(float (&y)[32], const OutTiles& T, int t, bool carry,
                                             Stage stage) {
  float sc[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) sc[e] = 0.0f;
  uint32_t hi[16], lo[16];
  stage(0);
  outputs_init<kNp>(y, T, t, carry);
  wgmma_fence();
  issue_scores<kNp>(sc, T, t, 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sc);
  weigh(sc, T, t, 0);
  split_scores(sc, hi, lo);
  for (int u = 1; u <= t; ++u) {
    stage(u);
    wgmma_fence();
    issue_scores<kNp>(sc, T, t, u);
    wgmma_commit();
    issue_sx(y, hi, lo, T, u - 1);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(sc);
    weigh(sc, T, t, u);
    wgmma_wait<0>();
    fence_regs(y);
    fence_regs(hi);
    fence_regs(lo);
    split_scores(sc, hi, lo);
  }
  wgmma_fence();
  issue_sx(y, hi, lo, T, t);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(y);
}

__device__ __forceinline__ void outputs_store(const float (&y)[32], const OutTiles& T, int t,
                                              float* yb, long long ld, int valid, int P) {
#pragma unroll
  for (int e = 0; e < 32; e += 2) {
    const int i = t * kRows + T.r0 + 8 * ((e >> 1) & 1), p = 8 * (e / 4) + T.c0;
    if (i < valid && p < P) *reinterpret_cast<float2*>(yb + i * ld + p) = make_float2(y[e], y[e + 1]);
  }
}

// Pass 3: block (chunk c, head h, batch b) writes y of the chunk's rows.
// Warpgroup w owns output tiles t1 = nt - 1 - w and t2 (tiles 3 and 0, or
// 2 and 1, at nt = 4; 2, or 1 and 0, at nt = 3). The producer warp issues
// every box at the start, in nt stages, each counted on its own mbarrier:
// stage 0 brings the C tiles of both t1, R_c (hi and lo), B_0 and x_0;
// stage u brings B_u and x_u, the last also the other C tiles. A
// warpgroup waits for stage u before step u of t1, so the later stages
// land while it computes; t2 runs after the last stage.
template <int kNp>
__global__ void __launch_bounds__(kTcBlock, 1)
ssd_kernel_outputs(const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap bmap,
                   const __grid_constant__ CUtensorMap cmap,
                   const __grid_constant__ CUtensorMap rmap, const float* __restrict__ dt,
                   const float* __restrict__ Aneg, float* __restrict__ y, Dims d, Strides dts) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  OutTiles T;
  T.Qp = d.Qp;
  T.C = (raw + 1023u) & ~1023u;
  T.B = T.C + d.Qp * kNp * 2;
  T.X = T.B + d.Qp * kNp * 2;
  T.Rhi = T.X + d.Qp * kPp * 2;
  T.Rlo = T.Rhi + kPp * kNp * 2;
  float* sdt = reinterpret_cast<float*>(smem_raw + (T.Rlo + kPp * kNp * 2 - raw));
  float* cum = sdt + d.Qp;
  float* warp_sum = cum + d.Qp;
  const uint32_t full = smem_u32(warp_sum + 8);  // stage u's mbarrier at full + 8 u
  T.sdt = sdt;
  T.cum = cum;

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const ChunkLoad L = chunk_load(d, c);
  const int g = h / (d.H / d.G);
  const int first = max(L.nt - 2, 0);  // C tiles first .. nt - 1 come with stage 0
  const bool carry = c > 0;
  if (tid == 0) {
    for (int u = 0; u < L.nt; ++u) mbar_init(full + 8 * u, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid >= kTcThreads) {
    // The producer warp: its lanes share each stage's boxes, in this order:
    // the stage's C tiles, R_c's hi and lo (stage 0), B_u, x_u; then it is
    // done. The consumers' zeros go to units no box writes.
    const int lane = tid - kTcThreads;
    const uint32_t region = d.Qp * 64;  // one column chunk of a C, B or x tile
    const int plane = (b * d.chunks + c) * d.H + h;
    for (int u = 0; u < L.nt; ++u) {
      const int n_c = (u == 0 ? L.nt - first : 0) + (u == L.nt - 1 ? first : 0);
      const int n_r = u == 0 && carry ? 2 * L.chunks_n : 0;
      const int count = n_c * L.chunks_n + n_r + L.chunks_n + L.chunks_p;
      const uint32_t bar = full + 8 * u;
      if (lane == 0) {
        mbar_expect_tx(bar, (count - n_r) * d.box * 64 + n_r * kPp * 64);
      }
      __syncwarp();
      for (int i = lane; i < count; i += 32) {
        int k = i;
        if (k < n_c * L.chunks_n) {  // C tiles: first .. nt - 1 at stage 0, 0 .. first - 1 last
          const int t = k / L.chunks_n + (u == 0 ? first : 0), kc = k % L.chunks_n;
          tma_load(T.C + kc * region + t * kRows * 64, &cmap, bar, kc * kChunkCols,
                   L.s0 + t * kRows, g, b);
          continue;
        }
        k -= n_c * L.chunks_n;
        if (k < n_r) {
          const int half = k / L.chunks_n, kc = k % L.chunks_n;
          tma_load((half ? T.Rlo : T.Rhi) + kc * kPp * 64, &rmap, bar, kc * kChunkCols, 0, half,
                   plane);
          continue;
        }
        k -= n_r;
        if (k < L.chunks_n) {
          tma_load(T.B + k * region + u * kRows * 64, &bmap, bar, k * kChunkCols,
                   L.s0 + u * kRows, g, b);
        } else {
          k -= L.chunks_n;
          tma_load(T.X + k * region + u * kRows * 64, &xmap, bar, k * kChunkCols,
                   L.s0 + u * kRows, h, b);
        }
      }
    }
    return;
  }
  const float A = Aneg[b * d.a_sb + h];
  const float dtq = tid < L.valid ? dt[b * dts.b + h * dts.h + (L.s0 + tid) * dts.s] : 0.0f;
  zero_unloaded<kNp>(T.C, d.Qp, d.box, L.chunks_n);
  zero_unloaded<kNp>(T.B, d.Qp, d.box, L.chunks_n);
  zero_unloaded<kPp>(T.X, d.Qp, d.box, L.chunks_p);
  if (carry) {
    zero_unloaded<kNp>(T.Rhi, kPp, kRows, L.chunks_n);
    zero_unloaded<kNp>(T.Rlo, kPp, kRows, L.chunks_n);
  }
  fence_async_smem();  // the zeros, before the products that follow chunk_cum's barrier
  if (tid < d.Qp) sdt[tid] = dtq;
  chunk_cum(dtq * A, cum, warp_sum, d.Qp);

  const auto stage = [full](int u) { mbar_wait(full + 8 * u, 0); };
  const int wg = tid / 128, lane = tid % 32, warp = (tid / 32) % 4;
  T.r0 = 16 * warp + lane / 4;
  T.c0 = 2 * (lane % 4);
  const int t1 = L.nt - 1 - wg;
  const int t2 = L.nt >= 3 ? wg + L.nt - 4 : -1;
  const long long ld = static_cast<long long>(d.H) * d.P;
  float* yb = y + (static_cast<long long>(b) * d.S + L.s0) * ld + h * d.P;
  float acc[32];
  if (t1 >= 0) {
    outputs_tile<kNp>(acc, T, t1, carry, stage);
    outputs_store(acc, T, t1, yb, ld, L.valid, d.P);
  }
  if (t2 >= 0) {
    stage(L.nt - 1);  // the C tile of t2
    outputs_tile<kNp>(acc, T, t2, carry, [](int) {});
    outputs_store(acc, T, t2, yb, ld, L.valid, d.P);
  }
}

// Allow passes 1 and 3 the shared memory of the largest chunk, once per
// device: the attribute is the same for every call.
template <int kNp>
cudaError_t allow_smem() {
  constexpr int kMaxDevices = 64;
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < kMaxDevices && done[dev])) return err;
  err = cudaFuncSetAttribute(ssd_kernel_states<kNp>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(states_smem(kMaxTcChunk, kNp)));
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(ssd_kernel_outputs<kNp>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(outputs_smem(kMaxTcChunk, kNp)));
  }
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

template <int kNp>
int launch_tc(const void* x, const float* dt, const float* A, const void* Bm, const void* Cm,
              float* y, float* states, float* decay, void* split_states, int batch, Dims d,
              Strides xs, Strides dts, Strides bs, Strides cs, cudaStream_t stream) {
  CUtensorMap xmap, bmap, cmap, rmap;
  const Strides rs{2LL * d.P * d.N, d.N, static_cast<long long>(d.P) * d.N};  // planes of (P, N)
  if (!make_map(&xmap, x, d.P, d.S, d.H, batch, xs, d.box) ||
      !make_map(&bmap, Bm, d.N, d.S, d.G, batch, bs, d.box) ||
      !make_map(&cmap, Cm, d.N, d.S, d.G, batch, cs, d.box) ||
      !make_map(&rmap, split_states, d.N, d.P, 2, batch * d.chunks * d.H, rs, kPp)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t allowed = allow_smem<kNp>();
  if (allowed != cudaSuccess) return static_cast<int>(allowed);
  const size_t smem1 = states_smem(d.Qp, kNp), smem3 = outputs_smem(d.Qp, kNp);
  const dim3 grid(d.chunks, d.H, batch);
  ssd_kernel_states<kNp><<<grid, kTcBlock, smem1, stream>>>(xmap, bmap, dt, A, states, decay, d,
                                                              dts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int pn4 = d.P * d.N / 4;
  const long long total4 = static_cast<long long>(batch) * d.H * pn4;
  ssd_kernel_carry<<<static_cast<unsigned>((total4 + kCarryThreads - 1) / kCarryThreads),
                     kCarryThreads, 0, stream>>>(reinterpret_cast<const float4*>(states), decay,
                                                 static_cast<uint2*>(split_states), d.chunks, d.H,
                                                 pn4, total4);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_kernel_outputs<kNp><<<grid, kTcBlock, smem3, stream>>>(xmap, bmap, cmap, rmap, dt, A, y, d,
                                                               dts);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A, const void* Bm,
                               const void* Cm, void* y, void* states, void* decay,
                               void* split_states, int batch, int S, int H, int P, int G, int N,
                               int Q, int bf16_inputs, long long x_sb, long long x_ss,
                               long long x_sh, long long dt_sb, long long dt_ss, long long dt_sh,
                               long long b_sb, long long b_ss, long long b_sg, long long c_sb,
                               long long c_ss, long long c_sg, long long a_sb, void* stream) {
  if (G <= 0 || H % G || batch <= 0 || S <= 0 || Q <= 0 || H > 65535 || batch > 65535 ||
      (a_sb != 0 && a_sb != H)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Strides xs{x_sb, x_ss, x_sh}, dts{dt_sb, dt_ss, dt_sh}, bs{b_sb, b_ss, b_sg},
      cs{c_sb, c_ss, c_sg};
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  float* yf = static_cast<float*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16_inputs) {
    const bool chunk_ok = Q <= kRows ? Q % 8 == 0 : Q % kRows == 0 && Q <= kMaxTcChunk;
    if (P % 8 || N % 8 || P > kPp || N > kMaxTcState || !chunk_ok || !states || !decay ||
        !split_states) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const int chunks = (S + Q - 1) / Q;
    const Dims d{S, H, P, G, N, Q, (Q + kRows - 1) / kRows * kRows, chunks, min(Q, kRows), a_sb};
    float* sf = static_cast<float*>(states);
    float* df = static_cast<float*>(decay);
    return N <= 64 ? launch_tc<64>(x, dtf, Af, Bm, Cm, yf, sf, df, split_states, batch, d, xs,
                                   dts, bs, cs, st)
                   : launch_tc<128>(x, dtf, Af, Bm, Cm, yf, sf, df, split_states, batch, d, xs,
                                    dts, bs, cs, st);
  }
  if (P % 4 || N % 4 || Q % 4 || P > 128 || N > 128 || Q > 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch<float>(x, dtf, Af, Bm, Cm, yf, batch, S, H, P, G, N, Q, a_sb, xs, dts, bs, cs, st);
}
