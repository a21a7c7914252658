// Chunked Mamba2 SSD (state-space duality) scan on Hopper (sm_90a), its four
// chunk products on the tensor cores.
//
// Replaces the Pallas TPU kernel repro/kernels/mamba2/mamba2.py (`ssd_chunked`,
// body `_kernel`), and with it the chunk scan of
// repro/models/ssm.py:mamba2_apply_chunked, whose state in and out it also
// carries.  For every (batch b, head h), with the (P x N) float32 state S
// carried across chunks of Q steps, the per-step log-decay ld = dt * a (<= 0,
// one scalar per head and step) and, within a chunk, cum its inclusive
// prefix sum:
//
//   att[t,s] = exp(cum[t] - cum[s]) (C[t] . B[s]) dt[s]      for s <= t
//   y[t,:]   = sum_{s<=t} att[t,s] x[s,:] + exp(cum[t]) S C[t]
//   S        = exp(cum_last) S + sum_s x[s,:] (B[s] dt[s] exp(cum_last - cum[s]))^T
//
// Mamba2 decays, then adds: y[t] reads the state that already holds x[t], so
// both sides use the inclusive cum.  Every exponent evaluated is a sum of
// log-decays (s <= t), so every factor is <= 1; above the diagonal the
// exponent is positive and its value is never used.
//
// Design:
// - Row p of the state and column p of y depend only on column p of x, so a
//   (b, h) is split over `split` blocks of PB = P / split columns, chosen by
//   ssd_split from B * H, P, the input type and the SM count (the wrapper's
//   ops.kernel_split is the same rule): the smallest split that gives
//   kBlocksPerSm blocks an SM, with slices of 16 to 64 columns for bf16 and
//   of 32 for float32.  At zamba2's B 4, H 80 that is 1 block a (b, h) for
//   bf16 and 2 for float32; at B 1, 4 and 2.  Each block recomputes the
//   chunk's prefix sums, C B^T and att, and owns its slice of x, y and S.
// - Four warps a block.  A loop over chunks inside the block takes the place
//   of the TPU's sequential grid axis.  While a chunk computes, the next
//   one's x slice, B and C (bf16 kept bf16) are copied into a second stage by
//   cp.async, and dt two chunks ahead, read in place through the model's
//   (batch, token) strides (16-byte aligned, which ssd_fwd checks) and group
//   g = h / (H / G).  Every stage holds 64 rows; those past Q or T are
//   zero-filled with dt = 0, so a ragged last chunk leaves the state as the
//   reference's zero padding does, and every loop has fixed bounds.
// - Warp w owns rows 16 w .. 16 w + 15 of the chunk: C B^T on the 2 w + 2
//   column tiles at or below the diagonal (10 of 16), att in registers,
//   C S^T scaled by exp(cum), then att x into the same accumulator (the
//   accumulator of C B^T is the A fragment of att x, with the k order
//   permuted to match), and the y rows.  After a barrier, warp w owns state
//   rows 16 w .. 16 w + 15: dS^T = (B w)^T x added to the decayed state in
//   shared memory.  Two barriers a chunk: one for the staged chunk and the
//   state, one before the state changes.  Only that update and C S^T sit on
//   the chain from chunk to chunk; C B^T, att x and dS need only the chunk.
// - The prefix sums of the log-decays are summed in order by one lane, as the
//   plain version's cumsum is: a warp-shuffle scan reorders the sum, and its
//   rounding alone put 2 of 21 million outputs past atol 5e-5 on the card.
//   Warp 0, whose row tile has the least work, sums the next chunk's during
//   this one, so no other warp waits on it.
// - Products: mma.sync.m16n8k8 with TF32 operands and a float32 accumulator.
//   A float32 operand v is split into hi = rna(v) and lo = rna(v - hi) and
//   the product summed as lo * hi + hi * lo + hi * hi (the low * low term
//   dropped: "3xTF32", CUTLASS's OpMultiplyAddFastF32 scheme); rna is two
//   integer instructions, not sm_90's four-instruction cvt.rna.tf32.f32.  bf16
//   x, B and C are widened by a 16-bit shift in the fragment load (ldmatrix,
//   with .trans where the operand is read down its columns) and are exact in
//   TF32, so with bf16 inputs C B^T takes one pass and att x, C S^T and dS
//   two; with float32 inputs every product takes three.  No product of a
//   float32 operand is ever made in one TF32 pass: that fails the float32
//   check (tests/test_torch_ssd.py emulates both).
// - Shared memory is laid out so that each fragment load is free of bank
//   conflicts: bf16 rows unpadded, their 16-byte chunks XOR-swizzled by row;
//   float32 rows padded (x by 4, B and C by 8 floats; the float32 route reads
//   B down its columns with 2-way conflicts); the state with rows n and n + 1
//   interleaved, one float2 a B fragment of C S^T.  Per block at P = N = 64:
//   bf16 PB = 64 (the served split) 68,352 bytes, three blocks an SM; bf16
//   PB = 32 51,968, four; bf16 PB = 16 43,776, five; float32 PB = 32
//   103,168, two.  ex2.approx gives att's exponentials (the others are
//   expf).
// - y (B, T, H, P) is float32, written as float2 per lane.
//
// Bound on an H100 SXM: at B = 4, T = 1024, H = 80, P = N = 64, G = 1,
// Q = 64 a call with bf16 x, B and C from a zero state reads x (42 MB), B and
// C (0.5 MB each) and dt (1.3 MB), and writes y (84 MB) and the final state
// (5.2 MB): 133 MB, 0.040 ms at 3.35 TB/s.  Its TF32 passes (C B^T and att x
// below the diagonal, C S^T and dS in full) are 14.8 GFLOP, 0.030 ms at
// 495 TFLOP/s dense TF32, so bytes bound it, then the passes; the same
// products on the float32 pipes would be 8 GFLOP, 0.12 ms at 67 TFLOP/s.  In
// float32 (176 MB, 24.3 GFLOP in three passes) it is 0.053 ms, bound by
// bytes.  The split's error at that shape, against the plain version on an
// H100 (chip_smoke.py): relative norm error 1.6e-7 for y with bf16 inputs,
// 5.5e-7 with float32 inputs (max abs 3.4e-5 and 7.6e-5 at |y| up to 100
// and 128); on the CPU, with TF32 rounding emulated, one pass of TF32 misses
// the 1e-5 norm check more than tenfold.  Both types take the tensor-core
// route; the kernel time and what holds it back are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

// Warps that share a row tile, each owning PB / kHalves of the block's
// columns and each recomputing the tile's C B^T.  2 measured slower than 1
// at every timed shape; with 1, the warp's first column (always 0) still
// comes from the warp index at run time, which measured faster on the served
// shape than a constant 0 (PERF.md, tools/kernel_ab.py on both edits).
constexpr int kHalves = 1;
constexpr int kWarps = 4 * kHalves;  // four row tiles of 16 a 64-row chunk
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxChunk = 64;
constexpr int kBlocksPerSm = 2;  // the split's target (ops.BLOCKS_PER_SM)
constexpr int kMaxResident = 16 / kWarps;  // blocks an SM the register budget is set for

// The column slices a block takes, by input type: at most 64 columns for
// bf16 and 32 for float32 (a float32 block of 64 columns leaves one block an
// SM), at least 16 for bf16 and 32 for float32 (float32's three passes make
// the C B^T every block recomputes dear), or all of P when P is narrower.
template <typename T>
constexpr int kWidest = sizeof(T) == 2 ? 64 : 32;
template <typename T>
constexpr int kNarrowest = sizeof(T) == 2 ? 16 : 32;
template <typename T, int PB, int P>
constexpr bool kTakes = PB >= 16 && PB <= kWidest<T> && (PB >= kNarrowest<T> || PB == P);

// ------------------------------------------------------- staged operands --

// A staged (kMaxChunk x W) operand of type T.  bf16: rows of W elements, the
// 16-byte chunks of row r XOR-swizzled by r / (8 / (W / 8)), so the eight rows
// an ldmatrix reads fall in eight different bank groups.  float32: rows padded
// by PAD floats.
//
// Fragment loads, for lane (g = lane / 4, q = lane % 4), with the k order
// permuted so that k = q reads element 2 q and k = q + 4 element 2 q + 1 of
// the eight (the same permutation on both operands of a product):
//   rows_a(r0, k0): a = M[r0+g][k0+2q], M[r0+g+8][k0+2q], M[r0+g][k0+2q+1],
//                       M[r0+g+8][k0+2q+1]  (A of a product along the rows)
//   rows_b(r0, k0): b = M[r0+g][k0+2q], M[r0+g][k0+2q+1]; NM k-steps k0 + 8 m
//   cols_a(k0, c0): a = M[k0+2q][c0+g], M[k0+2q][c0+g+8], M[k0+2q+1][c0+g],
//                       M[k0+2q+1][c0+g+8]  (A of a product down the columns)
//   cols_b(k0, c0): b = M[k0+2q][c0+g], M[k0+2q+1][c0+g]; NM column tiles
//                   c0 + 8 m
template <typename T, int W, int PAD>
struct Tile {
  static constexpr bool kBf16 = sizeof(T) == 2;
  static constexpr int kStride = kBf16 ? W : W + PAD;
  static constexpr int kBytes = kMaxChunk * kStride * static_cast<int>(sizeof(T));
  static_assert(!kBf16 || (W >= 16 && W <= 64), "bf16 rows of 2 to 8 chunks");
  const T* p;

  static __device__ __forceinline__ int off(int r, int c) {
    if constexpr (kBf16) {
      constexpr int kChunks = W / 8, kGroup = 8 / kChunks;
      return r * W + ((((c >> 3) ^ (r / kGroup)) & (kChunks - 1)) << 3) + (c & 7);
    } else {
      return r * kStride + c;
    }
  }

  __device__ __forceinline__ void rows_a(float (&a)[4], int r0, int k0) const {
    const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
    if constexpr (kBf16) {
      uint32_t r[2];
      ldsm<2, false>(r, p + off(r0 + (lane & 15), k0));
      a[0] = bf_lo(r[0]);
      a[2] = bf_hi(r[0]);
      a[1] = bf_lo(r[1]);
      a[3] = bf_hi(r[1]);
    } else {
      const float2 u = *reinterpret_cast<const float2*>(p + off(r0 + g, k0 + 2 * q));
      const float2 v = *reinterpret_cast<const float2*>(p + off(r0 + g + 8, k0 + 2 * q));
      a[0] = u.x;
      a[1] = v.x;
      a[2] = u.y;
      a[3] = v.y;
    }
  }

  template <int NM>
  __device__ __forceinline__ void rows_b(float (&b)[NM][2], int r0, int k0) const {
    const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
    if constexpr (kBf16) {
      uint32_t r[NM];
      ldsm<NM, false>(r, p + off(r0 + (lane & 7), k0 + 8 * ((lane >> 3) % NM)));
#pragma unroll
      for (int m = 0; m < NM; ++m) {
        b[m][0] = bf_lo(r[m]);
        b[m][1] = bf_hi(r[m]);
      }
    } else {
#pragma unroll
      for (int m = 0; m < NM; ++m) {
        const float2 u = *reinterpret_cast<const float2*>(p + off(r0 + g, k0 + 8 * m + 2 * q));
        b[m][0] = u.x;
        b[m][1] = u.y;
      }
    }
  }

  __device__ __forceinline__ void cols_a(float (&a)[4], int k0, int c0) const {
    const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
    if constexpr (kBf16) {
      uint32_t r[2];
      ldsm<2, true>(r, p + off(k0 + (lane & 7), c0 + 8 * ((lane >> 3) & 1)));
      a[0] = bf_lo(r[0]);
      a[2] = bf_hi(r[0]);
      a[1] = bf_lo(r[1]);
      a[3] = bf_hi(r[1]);
    } else {
      a[0] = p[off(k0 + 2 * q, c0 + g)];
      a[1] = p[off(k0 + 2 * q, c0 + g + 8)];
      a[2] = p[off(k0 + 2 * q + 1, c0 + g)];
      a[3] = p[off(k0 + 2 * q + 1, c0 + g + 8)];
    }
  }

  template <int NM>
  __device__ __forceinline__ void cols_b(float (&b)[NM][2], int k0, int c0) const {
    const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
    if constexpr (kBf16) {
      uint32_t r[NM];
      ldsm<NM, true>(r, p + off(k0 + (lane & 7), c0 + 8 * ((lane >> 3) % NM)));
#pragma unroll
      for (int m = 0; m < NM; ++m) {
        b[m][0] = bf_lo(r[m]);
        b[m][1] = bf_hi(r[m]);
      }
    } else {
#pragma unroll
      for (int m = 0; m < NM; ++m) {
        b[m][0] = p[off(k0 + 2 * q, c0 + 8 * m + g)];
        b[m][1] = p[off(k0 + 2 * q + 1, c0 + 8 * m + g)];
      }
    }
  }
};

// Byte layout of a block's dynamic shared memory: two stages of x (64 x PB),
// B and C (64 x NS); the state S (N x PB floats, rows n and n + 1
// interleaved: S[n][p] at (n / 2) * SP2 + 2 p + n % 2, so one float2 is the
// B fragment of C S^T); three chunks of dt (staged two chunks ahead); two
// chunks of prefix sums and dS weights (computed one chunk ahead), 64 each.
template <typename T, int PB, int N>
struct Cfg {
  static constexpr bool kSplitIn = sizeof(T) == 4;  // float32 inputs carry a low part
  static constexpr int NS = N < 16 ? 16 : N;         // staged width of B and C
  using XT = Tile<T, PB, 4>;
  using BT = Tile<T, NS, 8>;
  static constexpr int kX = XT::kBytes;
  static constexpr int kB = BT::kBytes;
  static constexpr int kStage = kX + 2 * kB;
  static constexpr int SP2 = 2 * (PB + 4);  // floats a pair of state rows
  static constexpr int kState = 2 * kStage;
  static constexpr int kDt = kState + (N / 2) * SP2 * 4;
  static constexpr int kCum = kDt + 3 * kMaxChunk * 4;      // [2][64] prefix sums
  static constexpr int kW = kCum + 2 * kMaxChunk * 4;       // [2][64] dS weights
  static constexpr int kBytes = kW + 2 * kMaxChunk * 4;
  // blocks an SM's 228 KB hold (1 KB of it reserved a block), at most kMaxResident
  static constexpr int kFit = 233472 / (kBytes + 1024);
  static constexpr int kMinBlocks = kFit < 1 ? 1 : kFit < kMaxResident ? kFit : kMaxResident;
  static_assert(kX % 16 == 0 && kB % 16 == 0 && ((N / 2) * SP2 * 4) % 16 == 0,
                "16-byte sections");
  static __device__ __forceinline__ int st_off(int n, int p) {
    return (n >> 1) * SP2 + 2 * p + (n & 1);
  }
};

// Start the copies of chunk rows [t0, t0 + Q) of the block's x slice, B and
// C into a stage: all 64 rows, those past Q or past T zero-filled.
template <typename T, int PB, int N>
__device__ __forceinline__ void stage_chunk(unsigned char* buf, const T* x_base,
                                            const T* b_base, const T* c_base, int64_t x_st,
                                            int64_t b_st, int64_t c_st, int t0, int T_len,
                                            int Q) {
  using C = Cfg<T, PB, N>;
  constexpr int kE = 16 / static_cast<int>(sizeof(T));  // elements a copy
  constexpr int XC = PB / kE, BC = N / kE;              // copies a row
  T* sx = reinterpret_cast<T*>(buf);
  T* sb = reinterpret_cast<T*>(buf + C::kX);
  T* sc = reinterpret_cast<T*>(buf + C::kX + C::kB);
#pragma unroll
  for (int k = 0; k < (kMaxChunk * XC + kThreads - 1) / kThreads; ++k) {
    const int e = threadIdx.x + k * kThreads;
    if (e >= kMaxChunk * XC) break;
    const int r = e / XC, i = (e - r * XC) * kE;
    const bool ok = r < Q && t0 + r < T_len;
    cp_async16(sx + C::XT::off(r, i), ok ? x_base + (t0 + r) * x_st + i : x_base, ok);
  }
#pragma unroll
  for (int k = 0; k < (kMaxChunk * BC + kThreads - 1) / kThreads; ++k) {
    const int e = threadIdx.x + k * kThreads;
    if (e >= kMaxChunk * BC) break;
    const int r = e / BC, i = (e - r * BC) * kE;
    const bool ok = r < Q && t0 + r < T_len;
    cp_async16(sb + C::BT::off(r, i), ok ? b_base + (t0 + r) * b_st + i : b_base, ok);
    cp_async16(sc + C::BT::off(r, i), ok ? c_base + (t0 + r) * c_st + i : c_base, ok);
  }
}

// Warp 0: start the copies of the chunk's dt (rows past Q or T zero-filled).
__device__ __forceinline__ void stage_dt(float* sdt, const float* dt_base, int H, int t0,
                                         int T_len, int Q) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = lane; r < kMaxChunk; r += 32) {
    const bool ok = r < Q && t0 + r < T_len;
    cp_async4(sdt + r, ok ? dt_base + static_cast<int64_t>(t0 + r) * H : dt_base, ok);
  }
}

// Warp 0: the chunk's log-decays summed in order by one lane, as the plain
// version's cumsum does (no fused multiply-add: dt * a rounds first; a
// reordered sum misses the float32 check), then the dS weights
// w = dt exp(cum_last - cum).  Rows past Q have dt = 0.
__device__ __forceinline__ void chunk_scan(const float* sdt, float a_h, int Q, float* s_cum,
                                           float* s_w) {
  const int lane = threadIdx.x & 31;
  if (lane == 0) {
    float run = 0.0f;
#pragma unroll
    for (int t = 0; t < kMaxChunk; t += 4) {
      const float4 d = *reinterpret_cast<const float4*>(sdt + t);
      float4 cs;
      run = __fadd_rn(run, __fmul_rn(d.x, a_h));
      cs.x = run;
      run = __fadd_rn(run, __fmul_rn(d.y, a_h));
      cs.y = run;
      run = __fadd_rn(run, __fmul_rn(d.z, a_h));
      cs.z = run;
      run = __fadd_rn(run, __fmul_rn(d.w, a_h));
      cs.w = run;
      *reinterpret_cast<float4*>(s_cum + t) = cs;
    }
  }
  __syncwarp();
  const float last = s_cum[Q - 1];
  s_w[lane] = sdt[lane] * expf(last - s_cum[lane]);
  s_w[lane + 32] = sdt[lane + 32] * expf(last - s_cum[lane + 32]);
}

// Row tile W of the chunk (rows 16 W .. 16 W + 15): C B^T on its 2 W + 2
// column tiles at or below the diagonal, into att.
template <typename T, int PB, int N, int W>
__device__ __forceinline__ void tile_cbt(float (&att)[8][4], const typename Cfg<T, PB, N>::BT& sb,
                                         const typename Cfg<T, PB, N>::BT& sc) {
  constexpr bool kS = Cfg<T, PB, N>::kSplitIn;
  constexpr int JN = 2 * W + 2;
  // k-steps one load of B covers (two for float32: its parts take registers)
  constexpr int KG = N / 8 < (kS ? 2 : 4) ? N / 8 : (kS ? 2 : 4);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) att[j][e] = 0.0f;
#pragma unroll
  for (int k0 = 0; k0 < N; k0 += 8 * KG) {
    Parts<4> af[KG];
#pragma unroll
    for (int m = 0; m < KG; ++m) {
      float av[4];
      sc.rows_a(av, 16 * W, k0 + 8 * m);
      af[m] = parts<kS>(av);
    }
#pragma unroll
    for (int j = 0; j < JN; ++j) {
      float bv[KG][2];
      sb.template rows_b<KG>(bv, 8 * j, k0);
#pragma unroll
      for (int m = 0; m < KG; ++m) mma_parts<kS, kS>(att[j], af[m], parts<kS>(bv[m]));
    }
  }
}

// Row tile W, after the prefix sums: att from C B^T, then y = att x +
// exp(cum) C S^T for the warp's PB / kHalves columns from c0, stored.
template <typename T, int PB, int N, int W>
__device__ __forceinline__ void tile_y(float (&att)[8][4], const typename Cfg<T, PB, N>::XT& sx,
                                       const typename Cfg<T, PB, N>::BT& sc, const float* st,
                                       const float* s_cum, const float* sdt, float* y_base,
                                       int64_t y_st, int c0, int t0, int Q, int T_len) {
  using C = Cfg<T, PB, N>;
  constexpr bool kS = C::kSplitIn;
  constexpr int JN = 2 * W + 2, r0 = 16 * W;
  constexpr int PW = PB / kHalves;       // the warp's columns
  constexpr int PG = PW < 32 ? PW : 32;  // columns of y a pass holds
  constexpr int NQ = PG / 8;
  const int lane = threadIdx.x & 31, gi = lane >> 2, tq = lane & 3;
  // att[t, s] = exp(cum[t] - cum[s]) (C B^T)[t, s] dt[s] for s <= t, with
  // t = r0 + gi (+ 8) and s = 8 j + 2 tq (+ 1): the accumulator's layout;
  // only the two diagonal tiles hold pairs s > t
  const int ta = r0 + gi, tb = ta + 8;
  const float cta = s_cum[ta], ctb = s_cum[tb];
#pragma unroll
  for (int j = 0; j < JN; ++j) {
    const int s = 8 * j + 2 * tq;
    const float2 cs = *reinterpret_cast<const float2*>(s_cum + s);
    const float2 ds = *reinterpret_cast<const float2*>(sdt + s);
    const float v0 = ex2((cta - cs.x) * kLog2e) * att[j][0] * ds.x;
    const float v1 = ex2((cta - cs.y) * kLog2e) * att[j][1] * ds.y;
    const float v2 = ex2((ctb - cs.x) * kLog2e) * att[j][2] * ds.x;
    const float v3 = ex2((ctb - cs.y) * kLog2e) * att[j][3] * ds.y;
    if (j < 2 * W) {
      att[j][0] = v0;
      att[j][1] = v1;
      att[j][2] = v2;
      att[j][3] = v3;
    } else {
      att[j][0] = s <= ta ? v0 : 0.0f;
      att[j][1] = s + 1 <= ta ? v1 : 0.0f;
      att[j][2] = s <= tb ? v2 : 0.0f;
      att[j][3] = s + 1 <= tb ? v3 : 0.0f;
    }
  }
  const float ea = expf(cta), eb = expf(ctb);
  const bool ok_a = ta < Q && t0 + ta < T_len, ok_b = tb < Q && t0 + tb < T_len;
#pragma unroll
  for (int pp = 0; pp < PW; pp += PG) {
    const int pg = c0 + pp;
    float acc[NQ][4];
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][e] = 0.0f;
    // C S^T, scaled by exp(cum[t]): the B fragment (S[k0 + 2 tq][p],
    // S[k0 + 2 tq + 1][p]) is one float2
#pragma unroll
    for (int k0 = 0; k0 < N; k0 += 8) {
      float av[4];
      sc.rows_a(av, r0, k0);
      const Parts<4> af = parts<kS>(av);
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const float2 sv2 =
            *reinterpret_cast<const float2*>(st + C::st_off(k0 + 2 * tq, pg + 8 * q + gi));
        const float sv[2] = {sv2.x, sv2.y};
        mma_parts<kS, true>(acc[q], af, parts<true>(sv));
      }
    }
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      acc[q][0] *= ea;
      acc[q][1] *= ea;
      acc[q][2] *= eb;
      acc[q][3] *= eb;
    }
    // + att x: the accumulator of tile j is the A fragment of k-step j
    // (k = tq reads s = 8 j + 2 tq, k = tq + 4 reads s + 1)
#pragma unroll
    for (int j = 0; j < JN; ++j) {
      const float av[4] = {att[j][0], att[j][2], att[j][1], att[j][3]};
      const Parts<4> af = parts<true>(av);
      float xv[NQ][2];
      sx.template cols_b<NQ>(xv, 8 * j, pg);
#pragma unroll
      for (int q = 0; q < NQ; ++q) mma_parts<true, kS>(acc[q], af, parts<kS>(xv[q]));
    }
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int col = pg + 8 * q + 2 * tq;
      if (ok_a)
        *reinterpret_cast<float2*>(y_base + (t0 + ta) * y_st + col) =
            make_float2(acc[q][0], acc[q][1]);
      if (ok_b)
        *reinterpret_cast<float2*>(y_base + (t0 + tb) * y_st + col) =
            make_float2(acc[q][2], acc[q][3]);
    }
  }
}

// S <- exp(cum_last) S + dS for rows n0 .. n0 + 15 of the state and the
// warp's PB / kHalves columns from c0, with dS^T = (B w)^T x,
// w = dt exp(cum_last - cum)
template <typename T, int PB, int N>
__device__ __forceinline__ void state_rows(int n0, int c0, const typename Cfg<T, PB, N>::XT& sx,
                                           const typename Cfg<T, PB, N>::BT& sb, float* st,
                                           const float* s_w, float decay) {
  using C = Cfg<T, PB, N>;
  constexpr bool kS = C::kSplitIn;
  constexpr int PW = PB / kHalves;          // the warp's columns
  constexpr int NQ = PW < 32 ? PW / 8 : 4;  // column tiles one load of x covers
  const int lane = threadIdx.x & 31, gi = lane >> 2, tq = lane & 3;
  float dsv[PW / 8][4];
#pragma unroll
  for (int q = 0; q < PW / 8; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) dsv[q][e] = 0.0f;
#pragma unroll
  for (int k0 = 0; k0 < kMaxChunk; k0 += 8) {
    float bv[4];
    sb.cols_a(bv, k0, n0);
    const float2 w = *reinterpret_cast<const float2*>(s_w + k0 + 2 * tq);
    const float bw[4] = {bv[0] * w.x, bv[1] * w.x, bv[2] * w.y, bv[3] * w.y};
    const Parts<4> af = parts<true>(bw);
#pragma unroll
    for (int q0 = 0; q0 < PW / 8; q0 += NQ) {
      float xv[NQ][2];
      sx.template cols_b<NQ>(xv, k0, c0 + 8 * q0);
#pragma unroll
      for (int q = 0; q < NQ; ++q) mma_parts<true, kS>(dsv[q0 + q], af, parts<kS>(xv[q]));
    }
  }
  // the accumulator holds (n0 + gi (+ 8), 8 q + 2 tq (+ 1))
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int n = n0 + gi + 8 * half;
    if (n < N) {
#pragma unroll
      for (int q = 0; q < PW / 8; ++q) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float* sp = st + C::st_off(n, c0 + 8 * q + 2 * tq + e);
          *sp = decay * *sp + dsv[q][2 * half + e];
        }
      }
    }
  }
}

// ----------------------------------------------------------------- kernel --

template <typename T, int PB, int N>
__global__ void __launch_bounds__(kThreads, (Cfg<T, PB, N>::kMinBlocks))
ssd_kernel(const T* __restrict__ x, const T* __restrict__ bm, const T* __restrict__ cm,
           const float* __restrict__ dt, const float* __restrict__ a,
           const float* __restrict__ state_in, float* __restrict__ y,
           float* __restrict__ state_out, int T_len, int H, int G, int Q, int split,
           int a_batch, int64_t x_sb, int64_t x_st, int64_t b_sb, int64_t b_st, int64_t c_sb,
           int64_t c_st) {
  using C = Cfg<T, PB, N>;
  constexpr int NS = C::NS;
  extern __shared__ __align__(16) unsigned char smem[];
  float* st = reinterpret_cast<float*>(smem + C::kState);
  float* s_dt = reinterpret_cast<float*>(smem + C::kDt);    // [3][64]
  float* s_cum = reinterpret_cast<float*>(smem + C::kCum);  // [2][64]
  float* s_w = reinterpret_cast<float*>(smem + C::kW);      // [2][64]
  const int tid = threadIdx.x, warp = tid >> 5;

  const int bh = blockIdx.x / split;
  const int p0 = (blockIdx.x - bh * split) * PB;
  const int P = PB * split;
  const int b = bh / H, h = bh - b * H;
  const int grp = h / (H / G);
  const float a_h = a[static_cast<int64_t>(b / a_batch) * H + h];
  const T* x_base = x + b * x_sb + static_cast<int64_t>(h) * P + p0;
  const T* b_base = bm + b * b_sb + static_cast<int64_t>(grp) * N;
  const T* c_base = cm + b * c_sb + static_cast<int64_t>(grp) * N;
  const float* dt_base = dt + static_cast<int64_t>(b) * T_len * H + h;
  float* y_base = y + (static_cast<int64_t>(b) * T_len * H + h) * P + p0;
  const int64_t y_st = static_cast<int64_t>(H) * P;
  const int64_t state_off = (static_cast<int64_t>(bh) * P + p0) * N;
  const int nch = (T_len + Q - 1) / Q;

  stage_chunk<T, PB, N>(smem, x_base, b_base, c_base, x_st, b_st, c_st, 0, T_len, Q);
  if (warp == 0) {
    stage_dt(s_dt, dt_base, H, 0, T_len, Q);
    if (nch > 1) stage_dt(s_dt + kMaxChunk, dt_base, H, Q, T_len, Q);
  }
  cp_async_commit();
  if constexpr (N < NS) {  // B and C columns past N, never copied into: zeros
    constexpr int kE = 16 / static_cast<int>(sizeof(T));
    constexpr int kPad = (NS - N) / kE;  // 16-byte chunks a row
    for (int e = tid; e < 2 * 2 * kMaxChunk * kPad; e += kThreads) {
      const int i = e % kPad, r = (e / kPad) % kMaxChunk, op = e / (kPad * kMaxChunk);
      T* base = reinterpret_cast<T*>(smem + (op >> 1) * C::kStage + C::kX + (op & 1) * C::kB);
      *reinterpret_cast<uint4*>(base + C::BT::off(r, N + i * kE)) = make_uint4(0, 0, 0, 0);
    }
  }
  for (int e = tid; e < PB * N; e += kThreads) {
    const int pl = e / N, n = e - pl * N;
    st[C::st_off(n, pl)] = state_in != nullptr ? state_in[state_off + e] : 0.0f;
  }
  cp_async_wait_all();
  __syncthreads();
  if (warp == 0) chunk_scan(s_dt, a_h, Q, s_cum, s_w);

  // Chunk c: its x, B, C in stage c % 2, dt in ring slot c % 3, prefix sums
  // and dS weights in slot c % 2.  Warp 0, whose row tile is the smallest,
  // also stages dt two chunks ahead and sums the next chunk's log-decays.
  for (int c = 0; c < nch; ++c) {
    const int t0 = c * Q;
    const unsigned char* cur = smem + (c & 1) * C::kStage;
    cp_async_wait_all();
    __syncthreads();  // the chunk is staged, the state updated, the other stage free
    if (c + 1 < nch)
      stage_chunk<T, PB, N>(smem + ((c + 1) & 1) * C::kStage, x_base, b_base, c_base, x_st,
                            b_st, c_st, t0 + Q, T_len, Q);
    if (warp == 0 && c + 2 < nch)
      stage_dt(s_dt + ((c + 2) % 3) * kMaxChunk, dt_base, H, t0 + 2 * Q, T_len, Q);
    cp_async_commit();
    const typename C::XT sx{reinterpret_cast<const T*>(cur)};
    const typename C::BT sb{reinterpret_cast<const T*>(cur + C::kX)};
    const typename C::BT sc{reinterpret_cast<const T*>(cur + C::kX + C::kB)};
    const float* sdt = s_dt + (c % 3) * kMaxChunk;
    const float* cum = s_cum + (c & 1) * kMaxChunk;

    // warp w: row tile w % 4 and the columns from c0 (kHalves warps a row
    // tile each compute its C B^T)
    const int tile = warp & 3, c0 = (warp >> 2) * (PB / kHalves);
    float att[8][4];
    if (tile == 0) {
      tile_cbt<T, PB, N, 0>(att, sb, sc);
      tile_y<T, PB, N, 0>(att, sx, sc, st, cum, sdt, y_base, y_st, c0, t0, Q, T_len);
      if (warp == 0 && c + 1 < nch)
        chunk_scan(s_dt + ((c + 1) % 3) * kMaxChunk, a_h, Q, s_cum + ((c + 1) & 1) * kMaxChunk,
                   s_w + ((c + 1) & 1) * kMaxChunk);
    } else if (tile == 1) {
      tile_cbt<T, PB, N, 1>(att, sb, sc);
      tile_y<T, PB, N, 1>(att, sx, sc, st, cum, sdt, y_base, y_st, c0, t0, Q, T_len);
    } else if (tile == 2) {
      tile_cbt<T, PB, N, 2>(att, sb, sc);
      tile_y<T, PB, N, 2>(att, sx, sc, st, cum, sdt, y_base, y_st, c0, t0, Q, T_len);
    } else {
      tile_cbt<T, PB, N, 3>(att, sb, sc);
      tile_y<T, PB, N, 3>(att, sx, sc, st, cum, sdt, y_base, y_st, c0, t0, Q, T_len);
    }
    __syncthreads();  // every warp has read the state
    if (tile < NS / 16)  // warp w owns state rows 16 (w % 4) .. and its columns
      state_rows<T, PB, N>(16 * tile, c0, sx, sb, st, s_w + (c & 1) * kMaxChunk,
                           expf(cum[Q - 1]));
  }
  __syncthreads();
  for (int e = tid; e < PB * N; e += kThreads) {
    const int pl = e / N, n = e - pl * N;
    state_out[state_off + e] = st[C::st_off(n, pl)];
  }
}

template <typename T, int PB, int N>
cudaError_t launch(const void* x, const void* bm, const void* cm, const float* dt,
                   const float* a, const float* state_in, float* y, float* state_out, int B,
                   int T_len, int H, int G, int Q, int split, int a_batch,
                   const int64_t* strides, cudaStream_t stream) {
  constexpr int smem = Cfg<T, PB, N>::kBytes;
  auto kernel = ssd_kernel<T, PB, N>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kernel<<<B * H * split, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(bm), static_cast<const T*>(cm), dt, a,
      state_in, y, state_out, T_len, H, G, Q, split, a_batch, strides[0], strides[1],
      strides[2], strides[3], strides[4], strides[5]);
  return cudaGetLastError();
}

// the instantiation for P = PB * split columns of type T
template <typename T, int P, int N>
cudaError_t launch_split(int split, const void* x, const void* bm, const void* cm,
                         const float* dt, const float* a, const float* state_in, float* y,
                         float* state_out, int B, int T_len, int H, int G, int Q,
                         int a_batch, const int64_t* strides, cudaStream_t stream) {
  if constexpr (kTakes<T, P, P>) {
    if (split == 1)
      return launch<T, P, N>(x, bm, cm, dt, a, state_in, y, state_out, B, T_len, H, G, Q, 1,
                             a_batch, strides, stream);
  }
  if constexpr (kTakes<T, P / 2, P>) {
    if (split == 2)
      return launch<T, P / 2, N>(x, bm, cm, dt, a, state_in, y, state_out, B, T_len, H, G, Q,
                                 2, a_batch, strides, stream);
  }
  if constexpr (kTakes<T, P / 4, P>) {
    if (split == 4)
      return launch<T, P / 4, N>(x, bm, cm, dt, a, state_in, y, state_out, B, T_len, H, G, Q,
                                 4, a_batch, strides, stream);
  }
  return cudaErrorInvalidValue;
}

template <int P, int N>
cudaError_t launch_typed(int dtype, int split, const void* x, const void* bm, const void* cm,
                         const float* dt, const float* a, const float* state_in, float* y,
                         float* state_out, int B, int T_len, int H, int G, int Q,
                         int a_batch, const int64_t* strides, cudaStream_t stream) {
  if (dtype == 0)
    return launch_split<float, P, N>(split, x, bm, cm, dt, a, state_in, y, state_out, B, T_len,
                                     H, G, Q, a_batch, strides, stream);
  if (dtype == 1)
    return launch_split<__nv_bfloat16, P, N>(split, x, bm, cm, dt, a, state_in, y, state_out,
                                             B, T_len, H, G, Q, a_batch, strides, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// The number of blocks a (b, h) is split over, by its P columns, for inputs
// of `dtype` (0 float32, 1 bfloat16): the smallest of 1, 2, 4 whose slices
// are at most the type's widest and that gives kBlocksPerSm blocks an SM
// over B * H (b, h) pairs, else the largest whose slices are at least the
// type's narrowest.  ops.kernel_split is the same rule.
extern "C" int ssd_split(int64_t bh, int64_t p, int64_t dtype, int64_t sm_count) {
  const int64_t widest = dtype == 1 ? kWidest<__nv_bfloat16> : kWidest<float>;
  const int64_t narrowest = dtype == 1 ? kNarrowest<__nv_bfloat16> : kNarrowest<float>;
  int split = p > widest ? static_cast<int>(p / widest) : 1;
  while (split < 4 && p / (2 * split) >= narrowest && bh * split < kBlocksPerSm * sm_count)
    split *= 2;
  return split;
}

// The products' TF32 passes for inputs of `dtype` (0 float32, 1 bfloat16):
// 3 (every operand split) or 2 (the float32 operand of each product split);
// 0 for a type the kernel does not take.  ops.kernel_route names them.
extern "C" int ssd_route(int64_t dtype) { return dtype == 0 ? 3 : dtype == 1 ? 2 : 0; }

// x (B, T, H, P), bm and cm (B, T, G, N): float32 (dtype 0) or bfloat16
// (dtype 1), each token's (H, P) / (G, N) block contiguous, read through the
// (batch, token) element strides x_sb, x_st, b_sb, b_st, c_sb, c_st given in
// `strides`, 16-byte aligned (pointers and strides in bytes); dt (B, T, H)
// float32, contiguous; a (B / a_batch, H) float32, batch element b reading
// row b / a_batch (a_batch = B: one a for the batch; a vmapped call folds its
// peers into the batch, each peer's a a row); state_in (B, H, P, N) float32
// or null (zero state); y (B, T, H, P) and state_out (B, H, P, N) float32,
// contiguous.  Q = chunk length, 1 <= Q <= 64; G divides H.  Launches on
// `stream` and returns the launch's cudaError_t (0 on success).
extern "C" int ssd_fwd(const void* x, const void* bm, const void* cm, const float* dt,
                       const float* a, const float* state_in, float* y, float* state_out,
                       int64_t dtype, int64_t B, int64_t T, int64_t H, int64_t G, int64_t P,
                       int64_t N, int64_t Q, int64_t a_batch, const int64_t* strides,
                       void* stream) {
  if (B < 1 || T < 1 || H < 1 || G < 1 || H % G != 0 || Q < 1 || Q > kMaxChunk ||
      a_batch < 1 || B % a_batch != 0 ||
      B * H * 4 > 0x7fffffff || T > 0x7fffffff || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t es = dtype == 1 ? 2 : 4;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(bm) |
                         reinterpret_cast<uintptr_t>(cm);
  bool aligned = ptrs % 16 == 0;
  for (int i = 0; i < 6; ++i) aligned = aligned && (strides[i] * es) % 16 == 0;
  if (!aligned) return static_cast<int>(cudaErrorMisalignedAddress);
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int split = ssd_split(B * H, P, dtype, sms);
  auto s = static_cast<cudaStream_t>(stream);
  const int b = static_cast<int>(B), t = static_cast<int>(T), h = static_cast<int>(H),
            g = static_cast<int>(G), q = static_cast<int>(Q), d = static_cast<int>(dtype),
            ab = static_cast<int>(a_batch);
  switch (P * 1000 + N) {
    case 64064:
      return static_cast<int>(launch_typed<64, 64>(d, split, x, bm, cm, dt, a, state_in, y,
                                                   state_out, b, t, h, g, q, ab, strides, s));
    case 64032:
      return static_cast<int>(launch_typed<64, 32>(d, split, x, bm, cm, dt, a, state_in, y,
                                                   state_out, b, t, h, g, q, ab, strides, s));
    case 32016:
      return static_cast<int>(launch_typed<32, 16>(d, split, x, bm, cm, dt, a, state_in, y,
                                                   state_out, b, t, h, g, q, ab, strides, s));
    case 16008:
      return static_cast<int>(launch_typed<16, 8>(d, split, x, bm, cm, dt, a, state_in, y,
                                                  state_out, b, t, h, g, q, ab, strides, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
