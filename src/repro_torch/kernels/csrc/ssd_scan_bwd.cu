// Backward of the Mamba-2 chunked SSD scan for Hopper (sm_90a), bound with a
// plain C interface and loaded through ctypes by
// repro_torch/kernels/ssd_scan.py (SsdChunkedBackwardFn).
//
// Replaces no TPU kernel: the reference's Pallas scan has no gradient
// (ROADMAP reference behaviour 18), and the reference trains through the
// chunked scan in f32 under jax.grad. This is the gradient of that function,
// y = ssd_chunked(x, dt, A, B, C)[0] with no initial state, computed from
// the entering states that the bf16 forward (ssd_scan.cu, pass 2) saves.
//
// Per (batch b, chunk c, head h), with cum the inclusive cumsum of dt A
// (A one (H,) row for the batch, or one row per batch row: the peers of a
// vmapped banked step),
// L_ij = exp(cum_i - cum_j) for i >= j (else 0), S = C B^T, M = S o L,
// xdt = x dt, w_j = exp(cum_Q - cum_j), e_i = exp(cum_i), entering state
// R_c (P, N), chunk state s_c = sum_j w_j xdt_j^T B_j, R_{c+1} = R_c D_c +
// s_c with D_c = exp(cum_Q), and dy (Q, P) f32:
//   dxdt   = M^T dy + w o (B ds_c^T)                 (ds_c = dR_{c+1})
//   dM     = dy xdt^T (masked), dS = dM o L
//   dC     = dS B + e o (dy R_c)
//   dB     = dS^T C + (w dt) o (x ds_c)
//   dR_c   = dyT diag(e) C + dR_{c+1} D_c           (the reverse carry)
//   dcum_i = rowsum(dM o M)_i - colsum(dM o M)_i + C_i . e_i (dy R_c)_i
//            - w_i dt_i B_i . (x_i ds_c) + [i = Q-1] (D_c sum(dR_{c+1} o R_c)
//            + sum_j w_j dt_j B_j . (x_j ds_c))
//   da     = reverse cumsum of dcum within the chunk; ddt = x . dxdt + A da;
//   dA     = sum over (batch, seq) of da dt; dx = dt dxdt.
// Head h reads group h / (H / G) of B and C; dB and dC are summed over the
// group's heads.
//
// Seven launches on the caller's stream, none with atomics, so that the same
// inputs give the same bits:
//   1. direct: one block per (chunk, head, batch): cum, the decay D_c and
//      the direct state gradient (e o dy)^T C (P, N) in f32;
//   2. carry: one block per (batch, head) walks the chunks backwards: ds_c =
//      dR_{c+1} as bf16 hi and lo halves, D_c sum(dR_{c+1} o R_c) into the
//      chunk-end slot, dR_c = direct_c + dR_{c+1} D_c;
//   3. rows: one block per (chunk, head, batch): for each 64-row tile of
//      outputs i, dC = e o (dy R_c), then S and dM against the key tiles
//      j <= i and dC += dS B; writes dC for the head and dcum;
//   4. cols: one block per (chunk, head, batch): for each 64-row tile of keys
//      j, the state terms dxdt = w o (B ds^T) and dB = (w dt) o (x ds), then
//      S^T and dM^T against the output tiles i >= j, dxdt += M^T dy and
//      dB += dS^T C; writes dx, x . dxdt, dB for the head and its dcum;
//   5. finish: one block per (chunk, head, batch): the reverse cumsum, ddt,
//      and the chunk's share of dA;
//   6. heads: dB and dC summed over each group's heads in order, in bf16;
//   7. dA: the chunks' shares summed in order, per group of batch rows
//      (the peers of a vmapped call).
//
// Every product runs on wgmma (m64nNk16, bf16 in, f32 accumulate). x, B and
// C are exact in bf16; each f32 operand (dy, M, dS, the e-weighted dy, R_c,
// ds_c) goes in as two bf16 terms, hi = bf16(v) and lo = bf16(v - hi); where
// both operands are f32 (M^T dy, dy R_c) three products hi hi + hi lo +
// lo hi. dt_j is factored out of dM as the forward does: dM_ij = dt_j (dy_i .
// x_j), x exact. Tiles are loaded by all 256 threads of a block (two
// warpgroups, no producer warp) into the 64-byte swizzle that the
// descriptors read, dy split into its hi and lo tiles on the way; each tile
// starts on a 512-byte boundary, the swizzle's period, which lets cols hold
// B, C, dy's two terms and ds_c's in 224 KB.
//
// Bound (kernels/cost.py, ssd_scan_bwd_cost): at mamba2-370m's (32, 2048,
// 32, 64), N 128 the bytes that must move, dy in f32, x, dx, the saved
// entering states, bound it: about 1.4 GB, 0.42 ms. The kernels move more:
// the per-head dB and dC (B, S, H, N) in f32 cross device memory twice each
// (1.07 GB a crossing), dy is read three times, and rows and cols each
// recompute S and dM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;            // two warpgroups
constexpr int kRows = 64;                // rows of a wgmma tile
constexpr int kPp = 64;                  // headdim columns of an x, dy or state tile (P <= 64)
constexpr int kMaxChunk = 256;
constexpr int kMaxState = 128;
constexpr int kDyPitch = kPp + 4;        // f32 pitch of the direct pass's dy rows
constexpr int kCarryThreads = 256;
constexpr int kCarryPer = kPp * kMaxState / kCarryThreads;  // state elements a carry thread holds
constexpr uint32_t kAtom = 8 * 64;       // the 64-byte swizzle's atom: 8 rows of 64 bytes
constexpr uint32_t kAlign = 512;         // a tile's alignment: the swizzle's period
constexpr float kLog2e = 1.4426950408889634f;

struct Dims {
  int S, H, P, G, N, Q, chunks;
  long long a_sb;  // A's stride between batch rows: 0 where one A is shared
};

__device__ __forceinline__ void st_shared16(uint32_t dst, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}

__device__ __forceinline__ uint32_t ld_shared32(uint32_t src) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(src) : "memory");
  return v;
}

// Order generic-proxy writes to shared memory before the async-proxy
// reads (wgmma) that follow the next barrier.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t aligned(uint32_t raw) { return (raw + kAlign - 1) & ~(kAlign - 1); }

__device__ __forceinline__ void sync_all() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
}

// Byte offset of the 16 bytes (row r, columns 8 c8 .. 8 c8 + 7) of a bf16
// tile of ``rows`` rows in the 64-byte swizzle: 32 columns per chunk of
// rows x 64 bytes, the 16-byte units of a row permuted by bits 1-2 of the row.
__device__ __forceinline__ uint32_t swz(int rows, int r, int c8) {
  return static_cast<uint32_t>((c8 >> 2) * rows * 64 + r * 64 + (((c8 & 3) ^ ((r >> 1) & 3)) << 4));
}

// The bf16 pair (row r, columns col, col + 1), col even, of a swizzled tile.
__device__ __forceinline__ uint32_t pair_at(uint32_t tile, int rows, int r, int col) {
  return ld_shared32(tile + swz(rows, r, col >> 3) + 2 * (col & 7));
}

__device__ __forceinline__ float bf16_at(uint32_t tile, int rows, int r, int col) {
  const uint32_t v = ld_shared32(tile + swz(rows, r, col >> 3) + 2 * (col & 6));
  return __uint_as_float((col & 1) ? (v & 0xffff0000u) : (v << 16));
}

// Rows [0, rows) x kCols of a strided bf16 view into a swizzled tile: row r
// from src + r * ld, zero past ``valid`` rows or ``cols`` columns.
template <int kCols>
__device__ __forceinline__ void load_tile(uint32_t dst, int rows, const bf16* src, long long ld,
                                          int valid, int cols) {
  constexpr int kUnits = kCols / 8;
  for (int u = threadIdx.x; u < rows * kUnits; u += kThreads) {
    const int r = u / kUnits, c8 = u % kUnits;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid && 8 * c8 < cols) v = *reinterpret_cast<const uint4*>(src + r * ld + 8 * c8);
    st_shared16(dst + swz(rows, r, c8), v);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  return bf16x2_bits(__floats2bfloat162_rn(a, b));
}

// v as two bf16 terms: hi = bf16(v), lo = bf16(v - hi).
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 back = __bfloat1622float2(h);
  hi = bf16x2_bits(h);
  lo = pack_bf16(v0 - back.x, v1 - back.y);
}

// Rows [0, rows) x kPp of a strided f32 view (dy) into two swizzled bf16
// tiles, its hi and lo terms; zero past ``valid`` rows or P columns.
__device__ __forceinline__ void load_split_tile(uint32_t hi, uint32_t lo, int rows, const float* src,
                                                long long ld, int valid, int P) {
  constexpr int kUnits = kPp / 8;
  for (int u = threadIdx.x; u < rows * kUnits; u += kThreads) {
    const int r = u / kUnits, c8 = u % kUnits;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
    if (r < valid && 8 * c8 < P) {
      a = *reinterpret_cast<const float4*>(src + r * ld + 8 * c8);
      b = *reinterpret_cast<const float4*>(src + r * ld + 8 * c8 + 4);
    }
    uint4 h, l;
    split2(a.x, a.y, h.x, l.x);
    split2(a.z, a.w, h.y, l.y);
    split2(b.x, b.y, h.z, l.z);
    split2(b.z, b.w, h.w, l.w);
    st_shared16(hi + swz(rows, r, c8), h);
    st_shared16(lo + swz(rows, r, c8), l);
  }
}

// The (P, N) plane of a row-major bf16 (.., P, N) tensor into a kPp-row tile.
template <int kNp>
__device__ __forceinline__ void load_plane(uint32_t dst, const bf16* src, int P, int N) {
  load_tile<kNp>(dst, kPp, src, N, P, N);
}

// cum = the inclusive cumsum of a over the block's 256 threads, thread q
// holding a_q: a shuffle scan in each warp, then the sums of the warps
// before. The same code as the forward's chunk_cum, so both see the same
// cum. ``warp_sum`` holds 8 floats. Ends with a barrier.
__device__ __forceinline__ void block_cum(float a, float* cum, float* warp_sum, int n) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  float v = a;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += o;
  }
  if (lane == 31) warp_sum[warp] = v;
  sync_all();
  float before = 0.0f;
  for (int w = 0; w < warp; ++w) before += warp_sum[w];
  if (tid < n) cum[tid] = v + before;
  sync_all();
}

// The sum of v over the block's 256 threads in a fixed order; every thread
// gets it. ``red`` holds 8 floats.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  sync_all();
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  sync_all();
  float s = 0.0f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) s += red[w];
  return s;
}

// d (64 x 64) += a (64 x 16, registers) b^T with b (64 x 16) K-major in
// shared memory: the register form of wgmma_ss_n64.
__device__ __forceinline__ void wgmma_rs_n64_kmajor(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// Descriptors into a swizzled tile of ``rows`` rows. K-major (the tile's
// columns are the depth): the 64 rows from row0, depth columns 16 kk ..
// 16 kk + 15. N-major (the tile's rows are the depth, read transposed): depth
// rows row0 + 16 kk .., all the tile's column chunks ``rows`` x 64 bytes apart.
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int rows, int row0, int kk) {
  return smem_desc(tile + (kk / 2) * rows * 64 + (kk % 2) * 32 + row0 * 64, 16, kAtom);
}

__device__ __forceinline__ uint64_t nmajor(uint32_t tile, int rows, int row0, int kk) {
  return smem_desc(tile + (row0 + 16 * kk) * 64, rows * 64, kAtom);
}

// S (64 x 64) = A_t B_u^T over kK columns, both K-major tiles of ``rows`` rows.
template <int kK>
__device__ __forceinline__ void ss_scores(float (&d)[32], uint32_t a, uint32_t b, int rows, int t,
                                          int u) {
#pragma unroll
  for (int kk = 0; kk < kK / 16; ++kk) {
    wgmma_ss_n64(d, kmajor(a, rows, t * kRows, kk), kmajor(b, rows, u * kRows, kk), kk > 0);
  }
}

// This thread's place in a 64-row wgmma fragment: rows r0 and r0 + 8,
// columns c0 and c0 + 1 of each 8. Accumulator element e sits at row r0 +
// 8 ((e >> 1) & 1), column 8 (e / 4) + c0 + (e & 1); register 4 kk + r of an
// A fragment holds row r0 + 8 (r & 1), columns 16 kk + 8 (r >> 1) + c0, + 1.
struct Frag {
  int r0, c0;
};

__device__ __forceinline__ Frag frag() {
  const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
  return {16 * warp + lane / 4, 2 * (lane % 4)};
}

__device__ __forceinline__ int acc_row(const Frag& f, int e) { return f.r0 + 8 * ((e >> 1) & 1); }
__device__ __forceinline__ int acc_col(const Frag& f, int e) { return 8 * (e / 4) + f.c0 + (e & 1); }

// The 64 x 64 f32 fragment v as A operand terms (hi, lo).
__device__ __forceinline__ void split_frag(const float (&v)[32], uint32_t (&hi)[16],
                                           uint32_t (&lo)[16]) {
#pragma unroll
  for (int n = 0; n < 16; ++n) split2(v[2 * n], v[2 * n + 1], hi[n], lo[n]);
}

// The tiles a warpgroup owns, so that the two do equal work under the
// causal mask: tile w, and nt - 1 - w where that is neither warpgroup's
// first tile.
__device__ __forceinline__ int tile_of(int wg, int k, int nt) {
  if (k == 0) return wg < nt ? wg : -1;
  const int t = nt - 1 - wg;
  return t >= 2 ? t : -1;
}

// ---------------------------------------------------------------------------
// 1. direct
// ---------------------------------------------------------------------------

size_t direct_smem(int Q, int Np) {
  return kAlign - 1 + static_cast<size_t>(Q) * Np * 2 + static_cast<size_t>(Q) * kDyPitch * 4 +
         4 * static_cast<size_t>(Q) + 64;
}

template <int kNp>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_direct(const bf16* __restrict__ Cm, const float* __restrict__ dt,
               const float* __restrict__ Aneg, const float* __restrict__ dy,
               float* __restrict__ direct, float* __restrict__ decay, Dims d, Strides cs,
               Strides dts) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sC = aligned(raw);  // C: Q x kNp
  float* sdy = reinterpret_cast<float*>(smem_raw + (sC + d.Q * kNp * 2 - raw));  // Q x kDyPitch
  float* cum = sdy + d.Q * kDyPitch;
  float* warp_sum = cum + d.Q;

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int s0 = c * d.Q, valid = min(d.Q, d.S - s0), g = h / (d.H / d.G);
  const long long bch = (static_cast<long long>(b) * d.chunks + c) * d.H + h;
  const long long ld = static_cast<long long>(d.H) * d.P;  // dy's row stride
  const float* dyc = dy + (static_cast<long long>(b) * d.S + s0) * ld + h * d.P;
  load_tile<kNp>(sC, d.Q, Cm + b * cs.b + s0 * cs.s + g * cs.h, cs.s, valid, d.N);
  for (int u = tid; u < d.Q * (kPp / 4); u += kThreads) {
    const int r = u / (kPp / 4), p4 = u % (kPp / 4);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid && 4 * p4 < d.P) v = *reinterpret_cast<const float4*>(dyc + r * ld + 4 * p4);
    *reinterpret_cast<float4*>(sdy + r * kDyPitch + 4 * p4) = v;
  }
  fence_async_smem();
  const float dtq = tid < valid ? dt[b * dts.b + h * dts.h + (s0 + tid) * dts.s] : 0.0f;
  block_cum(dtq * Aneg[b * d.a_sb + h], cum, warp_sum, d.Q);  // ends with a barrier: the tiles are in
  if (tid == 0) decay[bch] = expf(cum[d.Q - 1]);

  // direct (P x N) = (e o dy)^T C: warpgroup w owns columns 64 w .. 64 w + 63
  const int wg = tid / 128;
  const Frag f = frag();
  if (wg * 64 >= kNp) return;
  float acc[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = 0.0f;
  for (int k0 = 0; k0 < d.Q; k0 += kRows) {
    uint32_t hi[16], lo[16];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int p = f.r0 + 8 * (r & 1), i = k0 + 16 * kk + 8 * (r >> 1) + f.c0;
        split2(expf(cum[i]) * sdy[i * kDyPitch + p], expf(cum[i + 1]) * sdy[(i + 1) * kDyPitch + p],
               hi[4 * kk + r], lo[4 * kk + r]);
      }
    }
    fence_regs(hi);
    fence_regs(lo);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t desc = smem_desc(sC + (k0 + 16 * kk) * 64 + 2 * wg * d.Q * 64, d.Q * 64, kAtom);
      wgmma_rs_n64(acc, hi + 4 * kk, desc);
      wgmma_rs_n64(acc, lo + 4 * kk, desc);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(hi);
    fence_regs(lo);
  }
  float* out = direct + bch * d.P * d.N;
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int p = acc_row(f, e), n = 64 * wg + acc_col(f, e);
    if (p < d.P && n < d.N) out[p * d.N + n] = acc[e];
  }
}

// ---------------------------------------------------------------------------
// 2. carry
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kCarryThreads, 2)
ssd_bwd_carry(const float* __restrict__ direct, const float* __restrict__ decay,
              const bf16* __restrict__ split_states, bf16* __restrict__ ds_split,
              float* __restrict__ dcumQ, int chunks, int H, int PN) {
  __shared__ float red[8];
  const int bh = blockIdx.x, h = bh % H, b = bh / H, tid = threadIdx.x;
  float G[kCarryPer];
#pragma unroll
  for (int k = 0; k < kCarryPer; ++k) G[k] = 0.0f;
  for (int c = chunks - 1; c >= 0; --c) {
    const long long bch = (static_cast<long long>(b) * chunks + c) * H + h;
    const float D = decay[bch];
    const bf16* R = split_states + bch * 2 * PN;
    bf16* out = ds_split + bch * 2 * PN;
    const float* dir = direct + bch * PN;
    float part = 0.0f;
#pragma unroll
    for (int k = 0; k < kCarryPer; ++k) {
      const int idx = tid + k * kCarryThreads;
      if (idx < PN) {
        const bf16 hi = __float2bfloat16_rn(G[k]);
        out[idx] = hi;
        out[PN + idx] = __float2bfloat16_rn(G[k] - __bfloat162float(hi));
        part += G[k] * (__bfloat162float(R[idx]) + __bfloat162float(R[PN + idx]));
        G[k] = __fadd_rn(__fmul_rn(G[k], D), dir[idx]);
      }
    }
    const float tot = block_sum(part, red);
    if (tid == 0) dcumQ[bch] = tot * D;
  }
}

// ---------------------------------------------------------------------------
// 3. rows
// ---------------------------------------------------------------------------

size_t rows_smem(int Q, int Np) {
  return kAlign - 1 + 2 * static_cast<size_t>(Q) * Np * 2 + static_cast<size_t>(Q) * kPp * 2 +
         2 * static_cast<size_t>(kPp) * Np * 2 + 2 * 4 * static_cast<size_t>(Q) + 64;
}

template <int kNp>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_rows(const bf16* __restrict__ x, const float* __restrict__ dt,
             const float* __restrict__ Aneg, const bf16* __restrict__ Bm,
             const bf16* __restrict__ Cm, const float* __restrict__ dy,
             const bf16* __restrict__ split_states, float* __restrict__ dCh,
             float* __restrict__ dcum, Dims d, Strides xs, Strides dts, Strides bs, Strides cs) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sC = aligned(raw);            // C, B: Q x kNp
  const uint32_t sB = sC + d.Q * kNp * 2;
  const uint32_t sX = sB + d.Q * kNp * 2;      // x: Q x kPp
  const uint32_t sRhi = sX + d.Q * kPp * 2;    // R_c hi, lo: kPp x kNp
  const uint32_t sRlo = sRhi + kPp * kNp * 2;
  float* cum = reinterpret_cast<float*>(smem_raw + (sRlo + kPp * kNp * 2 - raw));
  float* sdt = cum + d.Q;
  float* warp_sum = sdt + d.Q;

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int s0 = c * d.Q, valid = min(d.Q, d.S - s0), g = h / (d.H / d.G);
  const long long bch = (static_cast<long long>(b) * d.chunks + c) * d.H + h;
  load_tile<kNp>(sC, d.Q, Cm + b * cs.b + s0 * cs.s + g * cs.h, cs.s, valid, d.N);
  load_tile<kNp>(sB, d.Q, Bm + b * bs.b + s0 * bs.s + g * bs.h, bs.s, valid, d.N);
  load_tile<kPp>(sX, d.Q, x + b * xs.b + s0 * xs.s + h * xs.h, xs.s, valid, d.P);
  const bf16* plane = split_states + bch * 2 * d.P * d.N;
  load_plane<kNp>(sRhi, plane, d.P, d.N);
  load_plane<kNp>(sRlo, plane + d.P * d.N, d.P, d.N);
  fence_async_smem();
  const float dtq = tid < valid ? dt[b * dts.b + h * dts.h + (s0 + tid) * dts.s] : 0.0f;
  if (tid < d.Q) sdt[tid] = dtq;
  block_cum(dtq * Aneg[b * d.a_sb + h], cum, warp_sum, d.Q);

  const int wg = tid / 128, nt = d.Q / kRows;
  const Frag f = frag();
  const long long ld = static_cast<long long>(d.H) * d.P;  // dy's row stride
  const long long ldn = static_cast<long long>(d.H) * d.N;  // dCh's
  const long long row0 = static_cast<long long>(b) * d.S + s0;
  const float* dyr = dy + row0 * ld + h * d.P;
  float* dCrow = dCh + row0 * ldn + h * d.N;
  for (int k = 0; k < 2; ++k) {
    const int t = tile_of(wg, k, nt);
    if (t < 0) continue;
    uint32_t yhi[16], ylo[16];  // dy_i as the A operand of dy R and dy x^T
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = t * kRows + f.r0 + 8 * (r & 1), p = 16 * kk + 8 * (r >> 1) + f.c0;
        float2 v = make_float2(0.f, 0.f);
        if (i < valid && p < d.P) v = *reinterpret_cast<const float2*>(dyr + i * ld + p);
        split2(v.x, v.y, yhi[4 * kk + r], ylo[4 * kk + r]);
      }
    }
    fence_regs(yhi);
    fence_regs(ylo);
    // dC = e o (dy R_c); dcum_i starts at C_i . dC_i
    float dC[kNp / 2];
#pragma unroll
    for (int e = 0; e < kNp / 2; ++e) dC[e] = 0.0f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs<kNp>(dC, yhi + 4 * kk, nmajor(sRhi, kPp, 0, kk));
      wgmma_rs<kNp>(dC, yhi + 4 * kk, nmajor(sRlo, kPp, 0, kk));
      wgmma_rs<kNp>(dC, ylo + 4 * kk, nmajor(sRhi, kPp, 0, kk));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dC);
    const float ci[2] = {cum[t * kRows + f.r0], cum[t * kRows + f.r0 + 8]};
    const float ei[2] = {expf(ci[0]), expf(ci[1])};
    float rowz[2] = {0.0f, 0.0f};
#pragma unroll
    for (int e = 0; e < kNp / 2; ++e) {
      const int r = (e >> 1) & 1;
      dC[e] *= ei[r];
      rowz[r] += dC[e] * bf16_at(sC, d.Q, t * kRows + acc_row(f, e), acc_col(f, e));
    }
    // dC_i += sum_{j <= i} dS_ij B_j over key tiles u <= t, dS = dt_j (dy_i . x_j) L_ij;
    // dcum_i += rowsum(dM o M)_i
    for (int u = 0; u <= t; ++u) {
      float sc[32], dm[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) dm[e] = 0.0f;
      wgmma_fence();
      ss_scores<kNp>(sc, sC, sB, d.Q, t, u);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t desc = kmajor(sX, d.Q, u * kRows, kk);
        wgmma_rs_n64_kmajor(dm, yhi + 4 * kk, desc);
        wgmma_rs_n64_kmajor(dm, ylo + 4 * kk, desc);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dm);
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int r = (e >> 1) & 1, i = t * kRows + acc_row(f, e), j = u * kRows + acc_col(f, e);
        float ds = 0.0f;
        if (j <= i) {
          const float L = exp2_ftz((ci[r] - cum[j]) * kLog2e);
          const float dM = dm[e] * sdt[j];
          rowz[r] += dM * (sc[e] * L);
          ds = dM * L;
        }
        dm[e] = ds;
      }
      uint32_t hi[16], lo[16];
      split_frag(dm, hi, lo);
      fence_regs(hi);
      fence_regs(lo);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t desc = nmajor(sB, d.Q, u * kRows, kk);
        wgmma_rs<kNp>(dC, hi + 4 * kk, desc);
        wgmma_rs<kNp>(dC, lo + 4 * kk, desc);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dC);
      fence_regs(hi);
      fence_regs(lo);
    }
#pragma unroll
    for (int e = 0; e < kNp / 2; e += 2) {
      const int i = t * kRows + acc_row(f, e), n = acc_col(f, e);
      if (i < valid && n < d.N) {
        *reinterpret_cast<float2*>(dCrow + i * ldn + n) = make_float2(dC[e], dC[e + 1]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = t * kRows + f.r0 + 8 * r;
      const float z = quad_sum(rowz[r]);
      if (f.c0 == 0 && i < valid) dcum[(row0 + i) * d.H + h] = z;
    }
  }
}

// ---------------------------------------------------------------------------
// 4. cols
// ---------------------------------------------------------------------------

size_t cols_smem(int Q, int Np) {
  return kAlign - 1 + 2 * static_cast<size_t>(Q) * Np * 2 + 2 * static_cast<size_t>(Q) * kPp * 2 +
         2 * static_cast<size_t>(kPp) * Np * 2 + 2 * 4 * static_cast<size_t>(Q) + 64;
}

template <int kNp>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_cols(const bf16* __restrict__ x, const float* __restrict__ dt,
             const float* __restrict__ Aneg, const bf16* __restrict__ Bm,
             const bf16* __restrict__ Cm, const float* __restrict__ dy,
             const bf16* __restrict__ ds_split, float* __restrict__ dBh, bf16* __restrict__ dx,
             float* __restrict__ ddt, float* __restrict__ dcum, float* __restrict__ dcumQ, Dims d,
             Strides xs, Strides dts, Strides bs, Strides cs) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sB = aligned(raw);            // B, C: Q x kNp
  const uint32_t sC = sB + d.Q * kNp * 2;
  const uint32_t sYhi = sC + d.Q * kNp * 2;    // dy hi, lo: Q x kPp
  const uint32_t sYlo = sYhi + d.Q * kPp * 2;
  const uint32_t sDhi = sYlo + d.Q * kPp * 2;  // ds_c hi, lo: kPp x kNp
  const uint32_t sDlo = sDhi + kPp * kNp * 2;
  float* cum = reinterpret_cast<float*>(smem_raw + (sDlo + kPp * kNp * 2 - raw));
  float* sdt = cum + d.Q;
  float* warp_sum = sdt + d.Q;
  float* red = warp_sum + 8;

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int s0 = c * d.Q, valid = min(d.Q, d.S - s0), g = h / (d.H / d.G);
  const long long bch = (static_cast<long long>(b) * d.chunks + c) * d.H + h;
  const long long ld = static_cast<long long>(d.H) * d.P;
  const long long ldn = static_cast<long long>(d.H) * d.N;
  const long long row0 = static_cast<long long>(b) * d.S + s0;
  load_tile<kNp>(sB, d.Q, Bm + b * bs.b + s0 * bs.s + g * bs.h, bs.s, valid, d.N);
  load_tile<kNp>(sC, d.Q, Cm + b * cs.b + s0 * cs.s + g * cs.h, cs.s, valid, d.N);
  load_split_tile(sYhi, sYlo, d.Q, dy + row0 * ld + h * d.P, ld, valid, d.P);
  const bf16* plane = ds_split + bch * 2 * d.P * d.N;
  load_plane<kNp>(sDhi, plane, d.P, d.N);
  load_plane<kNp>(sDlo, plane + d.P * d.N, d.P, d.N);
  fence_async_smem();
  const float dtq = tid < valid ? dt[b * dts.b + h * dts.h + (s0 + tid) * dts.s] : 0.0f;
  if (tid < d.Q) sdt[tid] = dtq;
  block_cum(dtq * Aneg[b * d.a_sb + h], cum, warp_sum, d.Q);
  const float cum_last = cum[d.Q - 1];

  const int wg = tid / 128, nt = d.Q / kRows;
  const Frag f = frag();
  const bf16* xb = x + b * xs.b + s0 * xs.s + h * xs.h;
  float* dBrow = dBh + row0 * ldn + h * d.N;
  float chunk_end = 0.0f;  // this thread's share of sum_j w_j dt_j B_j . (x_j ds)
  for (int k = 0; k < 2; ++k) {
    const int t = tile_of(wg, k, nt);
    if (t < 0) continue;
    uint32_t xa[16];  // x_j as the A operand of x ds and x dy^T
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int j = t * kRows + f.r0 + 8 * (r & 1), p = 16 * kk + 8 * (r >> 1) + f.c0;
        xa[4 * kk + r] = (j < valid && p < d.P) ? *reinterpret_cast<const uint32_t*>(xb + j * xs.s + p) : 0u;
      }
    }
    fence_regs(xa);
    const float cj[2] = {cum[t * kRows + f.r0], cum[t * kRows + f.r0 + 8]};
    const float dtj[2] = {sdt[t * kRows + f.r0], sdt[t * kRows + f.r0 + 8]};
    const float wj[2] = {expf(cum_last - cj[0]), expf(cum_last - cj[1])};
    // the state terms: dB = (w dt) o (x ds) and dxdt = w o (B ds^T); dw_j = dt_j B_j . (x_j ds)
    float dxa[32], dB[kNp / 2];
#pragma unroll
    for (int e = 0; e < kNp / 2; ++e) dB[e] = 0.0f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs<kNp>(dB, xa + 4 * kk, nmajor(sDhi, kPp, 0, kk));
      wgmma_rs<kNp>(dB, xa + 4 * kk, nmajor(sDlo, kPp, 0, kk));
    }
#pragma unroll
    for (int kk = 0; kk < kNp / 16; ++kk) {
      wgmma_ss_n64(dxa, kmajor(sB, d.Q, t * kRows, kk), kmajor(sDhi, kPp, 0, kk), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < kNp / 16; ++kk) {
      wgmma_ss_n64(dxa, kmajor(sB, d.Q, t * kRows, kk), kmajor(sDlo, kPp, 0, kk), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dB);
    fence_regs(dxa);
    float dot[2] = {0.0f, 0.0f};
#pragma unroll
    for (int e = 0; e < kNp / 2; ++e) {
      const int r = (e >> 1) & 1;
      dot[r] += dB[e] * bf16_at(sB, d.Q, t * kRows + acc_row(f, e), acc_col(f, e));
      dB[e] *= wj[r] * dtj[r];
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) dxa[e] *= wj[(e >> 1) & 1];
    float wdw[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) wdw[r] = wj[r] * dtj[r] * quad_sum(dot[r]);
    // S^T and dM^T against the output tiles u >= t: dxdt += M^T dy, dB += dS^T C
    float rowz[2] = {0.0f, 0.0f};
    for (int u = t; u < nt; ++u) {
      float sc[32], dm[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) dm[e] = 0.0f;
      wgmma_fence();
      ss_scores<kNp>(sc, sB, sC, d.Q, t, u);  // S^T: rows j, columns i
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_rs_n64_kmajor(dm, xa + 4 * kk, kmajor(sYhi, d.Q, u * kRows, kk));
        wgmma_rs_n64_kmajor(dm, xa + 4 * kk, kmajor(sYlo, d.Q, u * kRows, kk));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dm);
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int r = (e >> 1) & 1, j = t * kRows + acc_row(f, e), i = u * kRows + acc_col(f, e);
        float m = 0.0f, ds = 0.0f;
        if (i >= j) {
          const float L = exp2_ftz((cum[i] - cj[r]) * kLog2e);
          const float dM = dm[e] * dtj[r];
          m = sc[e] * L;
          rowz[r] += dM * m;
          ds = dM * L;
        }
        sc[e] = m;
        dm[e] = ds;
      }
      uint32_t hi[16], lo[16];
      split_frag(sc, hi, lo);
      fence_regs(hi);
      fence_regs(lo);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_rs_n64(dxa, hi + 4 * kk, nmajor(sYhi, d.Q, u * kRows, kk));
        wgmma_rs_n64(dxa, hi + 4 * kk, nmajor(sYlo, d.Q, u * kRows, kk));
        wgmma_rs_n64(dxa, lo + 4 * kk, nmajor(sYhi, d.Q, u * kRows, kk));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dxa);
      fence_regs(hi);
      fence_regs(lo);
      split_frag(dm, hi, lo);
      fence_regs(hi);
      fence_regs(lo);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t desc = nmajor(sC, d.Q, u * kRows, kk);
        wgmma_rs<kNp>(dB, hi + 4 * kk, desc);
        wgmma_rs<kNp>(dB, lo + 4 * kk, desc);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dB);
      fence_regs(hi);
      fence_regs(lo);
    }
    // dx = dt dxdt; ddt's share x . dxdt (x from its A fragment: register 4 kk
    // + r holds accumulator elements 8 kk + 2 r and + 1); dcum -= rowsum(dM o M)
    // + w dw
    float xdot[2] = {0.0f, 0.0f};
    bf16* dxb = dx + row0 * ld + h * d.P;
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      const int e = 2 * n, r = (e >> 1) & 1;
      const int j = t * kRows + acc_row(f, e), p = acc_col(f, e);
      const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xa[n]));
      xdot[r] += xv.x * dxa[e] + xv.y * dxa[e + 1];
      if (j < valid && p < d.P) {
        *reinterpret_cast<uint32_t*>(dxb + j * ld + p) = pack_bf16(dtj[r] * dxa[e], dtj[r] * dxa[e + 1]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int j = t * kRows + f.r0 + 8 * r;
      const float xd = quad_sum(xdot[r]), z = quad_sum(rowz[r]);
      if (f.c0 == 0) {
        chunk_end += wdw[r];
        if (j < valid) {
          ddt[(row0 + j) * d.H + h] = xd;
          float* slot = dcum + (row0 + j) * d.H + h;
          *slot = *slot - z - wdw[r];
        }
      }
    }
#pragma unroll
    for (int e = 0; e < kNp / 2; e += 2) {
      const int j = t * kRows + acc_row(f, e), n = acc_col(f, e);
      if (j < valid && n < d.N) {
        *reinterpret_cast<float2*>(dBrow + j * ldn + n) = make_float2(dB[e], dB[e + 1]);
      }
    }
  }
  const float tot = block_sum(chunk_end, red);
  if (tid == 0) dcumQ[bch] += tot;
}

// ---------------------------------------------------------------------------
// 5. finish, 6. heads, 7. dA
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
ssd_bwd_finish(const float* __restrict__ dt, const float* __restrict__ Aneg,
               const float* __restrict__ dcum, const float* __restrict__ dcumQ,
               float* __restrict__ ddt, float* __restrict__ dA_part, Dims d, Strides dts) {
  __shared__ float da[kMaxChunk];
  __shared__ float warp_sum[8];
  __shared__ float red[8];
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int s0 = c * d.Q, valid = min(d.Q, d.S - s0);
  const long long bch = (static_cast<long long>(b) * d.chunks + c) * d.H + h;
  const long long row0 = static_cast<long long>(b) * d.S + s0;
  // thread t holds row Q - 1 - t: the scan of the reversed rows is da
  const int q = d.Q - 1 - tid;
  float v = 0.0f;
  if (q >= 0 && q < valid) v = dcum[(row0 + q) * d.H + h];
  if (tid == 0) v += dcumQ[bch];
  block_cum(v, da, warp_sum, d.Q);
  float part = 0.0f;
  if (q >= 0 && q < valid) {
    const float a = da[tid];
    const float dtq = dt[b * dts.b + h * dts.h + (s0 + q) * dts.s];
    float* slot = ddt + (row0 + q) * d.H + h;
    *slot = *slot + a * Aneg[b * d.a_sb + h];
    part = a * dtq;
  }
  const float tot = block_sum(part, red);
  if (tid == 0) dA_part[bch] = tot;
}

// dB, dC (B, S, G, N) in bf16 = the f32 per-head (B, S, H, N) summed over
// each group's heads in order; blockIdx.y picks dB or dC. Four columns a thread.
__global__ void __launch_bounds__(kThreads)
ssd_bwd_heads(const float* __restrict__ dBh, const float* __restrict__ dCh, bf16* __restrict__ dB,
              bf16* __restrict__ dC, long long rows, int H, int G, int N) {
  const long long idx = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const int n4 = N / 4;
  if (idx >= rows * G * n4) return;
  const int c4 = static_cast<int>(idx % n4);
  const long long rg = idx / n4;
  const int g = static_cast<int>(rg % G);
  const long long row = rg / G;
  const int rep = H / G;
  const float* src = (blockIdx.y ? dCh : dBh) + (row * H + static_cast<long long>(g) * rep) * N + 4 * c4;
  float4 s = *reinterpret_cast<const float4*>(src);
  for (int k = 1; k < rep; ++k) {
    const float4 v = *reinterpret_cast<const float4*>(src + static_cast<long long>(k) * N);
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  bf16* out = (blockIdx.y ? dC : dB) + (row * G + g) * N + 4 * c4;
  *reinterpret_cast<uint2*>(out) = make_uint2(pack_bf16(s.x, s.y), pack_bf16(s.z, s.w));
}

// dA (groups, H): each group of batch rows' chunk shares summed in order.
__global__ void ssd_bwd_dA(const float* __restrict__ dA_part, float* __restrict__ dA, int batch,
                           int chunks, int H, int groups) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= groups * H) return;
  const int h = idx % H, grp = idx / H, per = batch / groups;
  float s = 0.0f;
  for (int b = grp * per; b < (grp + 1) * per; ++b) {
    for (int c = 0; c < chunks; ++c) s += dA_part[(static_cast<long long>(b) * chunks + c) * H + h];
  }
  dA[idx] = s;
}

// Allow the three tiled passes the shared memory of the largest chunk, once
// per device: the attribute is the same for every call.
template <int kNp>
cudaError_t allow_smem() {
  constexpr int kMaxDevices = 64;
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < kMaxDevices && done[dev])) return err;
  err = cudaFuncSetAttribute(ssd_bwd_direct<kNp>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(direct_smem(kMaxChunk, kNp)));
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(ssd_bwd_rows<kNp>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(rows_smem(kMaxChunk, kNp)));
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(ssd_bwd_cols<kNp>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(cols_smem(kMaxChunk, kNp)));
  }
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

struct Scratch {
  float *direct, *decay, *dCh, *dBh, *dcum, *dcumQ, *dA_part;
  bf16* ds;
};

template <int kNp>
int launch(const bf16* x, const float* dt, const float* A, const bf16* Bm, const bf16* Cm,
           const float* dy, const bf16* split, bf16* dx, float* ddt, float* dA, bf16* dB, bf16* dC,
           const Scratch& s, int batch, int groups, Dims d, Strides xs, Strides dts, Strides bs,
           Strides cs, cudaStream_t stream) {
  cudaError_t err = allow_smem<kNp>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(d.chunks, d.H, batch);
  ssd_bwd_direct<kNp><<<grid, kThreads, direct_smem(d.Q, kNp), stream>>>(
      Cm, dt, A, dy, s.direct, s.decay, d, cs, dts);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_carry<<<batch * d.H, kCarryThreads, 0, stream>>>(s.direct, s.decay, split, s.ds, s.dcumQ,
                                                           d.chunks, d.H, d.P * d.N);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_rows<kNp><<<grid, kThreads, rows_smem(d.Q, kNp), stream>>>(
      x, dt, A, Bm, Cm, dy, split, s.dCh, s.dcum, d, xs, dts, bs, cs);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_cols<kNp><<<grid, kThreads, cols_smem(d.Q, kNp), stream>>>(
      x, dt, A, Bm, Cm, dy, s.ds, s.dBh, dx, ddt, s.dcum, s.dcumQ, d, xs, dts, bs, cs);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_finish<<<grid, kThreads, 0, stream>>>(dt, A, s.dcum, s.dcumQ, ddt, s.dA_part, d, dts);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const long long rows = static_cast<long long>(batch) * d.S;
  const long long units = rows * d.G * (d.N / 4);
  ssd_bwd_heads<<<dim3(static_cast<unsigned>((units + kThreads - 1) / kThreads), 2), kThreads, 0,
                  stream>>>(s.dBh, s.dCh, dB, dC, rows, d.H, d.G, d.N);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_dA<<<(groups * d.H + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      s.dA_part, dA, batch, d.chunks, d.H, groups);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, B, C: bf16 views (last dimension contiguous, 16-byte rows); dt (B, S,
// H) f32 view; A (H,) f32 with a_sb = 0, or (B, H) with a_sb = H; dy (B, S,
// H, P) f32 contiguous; split_states (B, chunks, H, 2, P, N) bf16, the
// forward's entering states. Outputs (all contiguous): dx (B, S, H, P) bf16,
// ddt (B, S, H) f32, dA (groups, H) f32, dB and dC (B, S, G, N) bf16.
// Scratch as the wrapper allocates it: direct (B, chunks, H, P, N) f32,
// decay, dcumQ, dA_part (B, chunks, H) f32, dCh, dBh (B, S, H, N) f32, dcum
// (B, S, H) f32, ds (B, chunks, H, 2, P, N) bf16.
extern "C" int ssd_scan_backward_launch(
    const void* x, const void* dt, const void* A, const void* Bm, const void* Cm, const void* dy,
    const void* split_states, void* dx, void* ddt, void* dA, void* dB, void* dC, void* direct,
    void* decay, void* dcumQ, void* dA_part, void* dCh, void* dBh, void* dcum, void* ds,
    int batch, int S, int H, int P, int G, int N, int Q, int groups, long long x_sb,
    long long x_ss, long long x_sh, long long dt_sb, long long dt_ss, long long dt_sh,
    long long b_sb, long long b_ss, long long b_sg, long long c_sb, long long c_ss,
    long long c_sg, long long a_sb, void* stream) {
  if (G <= 0 || H % G || batch <= 0 || S <= 0 || H > 65535 || batch > 65535 || groups <= 0 ||
      (a_sb != 0 && a_sb != H) ||
      batch % groups || P % 8 || N % 8 || P > kPp || N > kMaxState || Q % kRows || Q > kMaxChunk ||
      Q <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int chunks = (S + Q - 1) / Q;
  const Dims d{S, H, P, G, N, Q, chunks, a_sb};
  const Strides xs{x_sb, x_ss, x_sh}, dts{dt_sb, dt_ss, dt_sh}, bs{b_sb, b_ss, b_sg},
      cs{c_sb, c_ss, c_sg};
  const Scratch s{static_cast<float*>(direct), static_cast<float*>(decay),
                  static_cast<float*>(dCh),    static_cast<float*>(dBh),
                  static_cast<float*>(dcum),   static_cast<float*>(dcumQ),
                  static_cast<float*>(dA_part), static_cast<bf16*>(ds)};
  const auto* xb = static_cast<const bf16*>(x);
  const auto* bb = static_cast<const bf16*>(Bm);
  const auto* cb = static_cast<const bf16*>(Cm);
  const auto* dtf = static_cast<const float*>(dt);
  const auto* Af = static_cast<const float*>(A);
  const auto* dyf = static_cast<const float*>(dy);
  const auto* sp = static_cast<const bf16*>(split_states);
  auto* dxb = static_cast<bf16*>(dx);
  auto* ddtf = static_cast<float*>(ddt);
  auto* dAf = static_cast<float*>(dA);
  auto* dBb = static_cast<bf16*>(dB);
  auto* dCb = static_cast<bf16*>(dC);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return N <= 64 ? launch<64>(xb, dtf, Af, bb, cb, dyf, sp, dxb, ddtf, dAf, dBb, dCb, s, batch,
                              groups, d, xs, dts, bs, cs, st)
                 : launch<128>(xb, dtf, Af, bb, cb, dyf, sp, dxb, ddtf, dAf, dBb, dCb, s, batch,
                               groups, d, xs, dts, bs, cs, st);
}
