// Chunked RWKV6 (Finch) WKV with data-dependent per-channel decay, on Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/rwkv6/rwkv6.py (`wkv6_chunked`,
// body `_kernel`), and with it the chunk scan of
// repro/models/ssm.py:rwkv6_time_mix_chunked, whose state in and out it also
// carries.  For every (batch b, head h), with the (DK x DK) float32 state S
// carried across chunks of Q tokens and, within a chunk, cum the inclusive
// prefix sum of the log-decays ld (<= 0) and cum_ex[t] = cum[t - 1] (0 at
// t = 0):
//
//   att[t,s] = sum_i r[t,i] k[s,i] exp(cum_ex[t,i] - cum[s,i])   for s < t
//   att[t,t] = sum_i r[t,i] u[i] k[t,i]                            (the bonus)
//   y[t,:]   = sum_{s<=t} att[t,s] v[s,:] + (r[t,:] * exp(cum_ex[t,:])) S
//   S        = exp(cum_last) * S + (k * exp(cum_last - cum))^T v
//
// Every exponent evaluated is a sum of log-decays, so every factor is <= 1:
// for s >= t the difference cum_ex[t] - cum[s] can be large and positive
// (ld reaches -e^4 a step), and it is never evaluated, not even to be masked.
// r, k, v and the output are float32 or bf16 (the served type: read as they
// are, the output rounded to nearest even once); ld, u and S are float32 and
// every sum is taken in float32 on the float32 pipes.  The exps are __expf
// (ex2.approx of x log2(e)): against expf, on an NVIDIA H100 80GB HBM3 at
// 700.00 W (tools/kernel_ab.py with --old a copy of this file using expf),
// 8.6% faster at B 4, T 1024 float32, 7.8% with bf16 operands, 4.5% at
// B 1, T 4096; the outputs differ by at most one float32 step (1.5e-5 at
// |out| ~ 130), by nothing at a log-decay of -50 a step, and in bf16 by one
// rounding step of the output (0.125).  Its relative error grows with |x|
// (about |x| 2^-24) and it flushes results under 2^-126 to zero: terms that
// small lie far below the 1e-3 tolerance.
//
// Design.  The only value carried from chunk to chunk is the (DK x DK)
// state; everything else of a chunk (prefix sums, the att weights, the
// decayed r and k) comes from the chunk alone.  One CTA per (b, h) walks
// the chunks with S in registers: 256 threads at DK = 64, two CTAs an SM,
// so that the serving prefill's 256 heads are resident at once.  The served
// chunk (16) has an instantiation of its own, whose loops over the chunk
// unroll (29% faster than the general one at B 4, T 1024); at that chunk,
// where the heads leave SMs free (B * H at most the SM count, as at B 1),
// it runs 512 threads, each holding half as much (9.7% faster than 256 at
// B 1, T 4096; both measured as the exps above).  A chunk passes four
// barriers:
// 1. wait for the chunk, staged by cp.async (16 bytes a copy) while the
//    last one was computed; rows past T are zero (ld = 0, k = v = 0, so the
//    state passes through a ragged last chunk unchanged, as the reference's
//    padding does, and no row past T is written).
// 2. the inclusive prefix sums of ld, all threads: parts of each channel on
//    neighbouring lanes, a serial sum within a part and a shuffle scan of
//    the part totals.
// 3. att over the 2 x 2 tiles of (t, s) pairs on or below the diagonal,
//    from a tile table, 16 channels a lane (8 at 512 threads) and the lanes
//    of a tile reduced by shuffles: each loaded row of r, k and the prefix
//    sums serves two pairs.  The lanes of the diagonal tiles also decay r
//    and k of their rows.
// 4. the next chunk's copies are issued; the threads hold S in row slices
//    (at 256 threads: 8 slices of 8 rows, one a warp, 2 columns a thread);
//    every thread of a slice holds the same rows, so its loads of the
//    decayed r and k are broadcasts.  For each row t a thread sums its
//    rows' share of (r * exp(cum_ex)) S and its slice's share of the
//    att[t,s] v[s,:] terms into a partial y of its slice (16 rows a slab, in
//    registers); it decays and updates its part of S; after the barrier the
//    slices' partials of each y[t,j] are summed and written once in the
//    output's type.  Nothing of the state leaves the registers until the
//    end.
// The r, k and ld rows are swizzled in 16-byte chunks (swz) so that the att
// lanes of neighbouring tiles hit different banks.  The (B, T, H, DK)
// layout is read and written in place: element (b, t, h, i) sits at
// ((b T + t) H + h) DK + i; no transposed copy is made.
//
// Bound on an H100 SXM: at B = 4, T = 1024, H = 64, DK = 64, Q = 16 a call
// from a zero state must read four (B, T, H, DK) float32 inputs and write one
// (67 MB each) and write the final state (4 MB): 340 MB, 0.10 ms at
// 3.35 TB/s.  It does about 5.5 GFLOP (an exp counted as one operation),
// 0.08 ms at 67 TFLOP/s float32: it is bound by bytes.  With bf16 r, k, v
// and output it moves about 205 MB (0.061 ms) and is bound by operations,
// 0.082 ms.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxChunk = 64;
constexpr int kSlab = 16;  // rows of y whose partial sums are held at once

// A CTA's threads hold S in row slices: a thread holds columns_of(dk)
// columns of dk / row_slices(dk, threads) rows, the threads of a slice the
// same rows (at dk = 64 and 256 threads: 8 slices of 8 rows, one a warp, 2
// columns a thread; 512 threads: 16 slices of 4 rows).
__host__ __device__ constexpr int columns_of(int dk) { return dk > 32 ? dk / 32 : 1; }
__host__ __device__ constexpr int row_slices(int dk, int threads) {
  return threads / (dk / columns_of(dk));
}
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Element (t, i) of a staged [Q][DK] array of T in shared memory: each row
// is DK * sizeof(T) bytes in 16-byte chunks, and the chunk index is XORed
// with a permutation of the row's position among the rows that share banks,
// in which lines 4m + 0/1 and 4m + 2/3 differ in bit 2: the att lanes of
// neighbouring tiles, which read one chunk of rows 2b and 2b + 2, then hit
// different banks.
template <typename T, int DK>
__device__ __forceinline__ int swz(int t, int i) {
  constexpr int kRowBytes = DK * static_cast<int>(sizeof(T));
  constexpr int kPerChunk = 16 / static_cast<int>(sizeof(T));  // elements a chunk
  constexpr int kRowsPerLine = kRowBytes >= 128 ? 1 : 128 / kRowBytes;
  constexpr int kChunksPerLine = kRowBytes >= 128 ? 8 : kRowBytes / 16;
  const int c = i / kPerChunk, line = t / kRowsPerLine;
  const int f = kChunksPerLine == 8
                    ? (((line & 2) << 1) | ((line & 1) << 1) | ((line >> 2) & 1))
                    : line % kChunksPerLine;
  return t * DK + ((c ^ f) * kPerChunk) + i % kPerChunk;
}

// Channels i0 .. i0 + 3 (i0 a multiple of 4) of row t, as float32.
template <int DK>
__device__ __forceinline__ float4 load4(const float* a, int t, int i0) {
  return *reinterpret_cast<const float4*>(a + swz<float, DK>(t, i0));
}
template <int DK>
__device__ __forceinline__ float4 load4(const __nv_bfloat16* a, int t, int i0) {
  const uint2 w = *reinterpret_cast<const uint2*>(a + swz<__nv_bfloat16, DK>(t, i0));
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__host__ __device__ __forceinline__ int align16(int bytes) { return (bytes + 15) & ~15; }

// Byte offsets of a CTA's dynamic shared memory at chunk q with NT threads:
// two stages of r, k ([Q][DK] TI, swizzled), ld ([Q][DK] float32, swizzled;
// the prefix sums overwrite it) and v ([Q][DK] TI); the decayed r and k
// ([Q][DK] float32); att ([Q][Q]); the row slices' partial sums of y
// ([row_slices][kSlab][DK] float32); u, the last prefix sums and their exp
// (DK each); and the 2 x 2 tiles of (t, s) pairs on or below the diagonal
// (at most Q (Q + 1) / 2 shorts).
struct Layout {
  int r, k, ld, v, stage, rd, kd, att, part, u, last, dec, tiles, total;
};

template <typename TI, int DK>
__host__ __device__ __forceinline__ Layout layout(int q, int threads) {
  const int in = align16(q * DK * static_cast<int>(sizeof(TI)));
  Layout l;
  l.r = 0;
  l.k = l.r + in;
  l.ld = l.k + in;
  l.v = l.ld + align16(q * DK * 4);
  l.stage = l.v + in;
  l.rd = 2 * l.stage;
  l.kd = l.rd + align16(q * DK * 4);
  l.att = l.kd + align16(q * DK * 4);
  l.part = l.att + align16(q * q * 4);
  l.u = l.part + row_slices(DK, threads) * kSlab * DK * 4;
  l.last = l.u + align16(DK * 4);
  l.dec = l.last + align16(DK * 4);
  l.tiles = l.dec + align16(DK * 4);
  l.total = l.tiles + align16(q * (q + 1));
  return l;
}

// Stage chunk rows [t0, t0 + Q) of r, k, ld and v by cp.async, 16 bytes a
// copy, all threads; rows past T are zero (ld = 0, k = v = 0: the state
// passes through a ragged last chunk unchanged, as the reference's padding
// does).
template <typename TI, int DK>
__device__ __forceinline__ void stage_chunk(unsigned char* st, const Layout& L,
                                            const TI* __restrict__ r, const TI* __restrict__ k,
                                            const TI* __restrict__ v,
                                            const float* __restrict__ ld, int64_t base,
                                            int64_t row_stride, int t0, int T, int Q) {
  constexpr int kIn = 16 / static_cast<int>(sizeof(TI));  // TI elements a copy
  constexpr int kRowCopies = DK / kIn;
  TI* sr = reinterpret_cast<TI*>(st + L.r);
  TI* sk = reinterpret_cast<TI*>(st + L.k);
  float* sl = reinterpret_cast<float*>(st + L.ld);
  TI* sv = reinterpret_cast<TI*>(st + L.v);
  const int64_t chunk_base = base + static_cast<int64_t>(t0) * row_stride;
  for (int e = threadIdx.x; e < Q * kRowCopies; e += blockDim.x) {
    const int t = e / kRowCopies, i = (e % kRowCopies) * kIn;
    const bool ok = t0 + t < T;
    const int64_t src = chunk_base + t * row_stride + i;
    const int dst = swz<TI, DK>(t, i);
    cp_async16(sr + dst, ok ? r + src : r, ok);
    cp_async16(sk + dst, ok ? k + src : k, ok);
    cp_async16(sv + t * DK + i, ok ? v + src : v, ok);
  }
  for (int e = threadIdx.x; e < Q * (DK / 4); e += blockDim.x) {
    const int t = e / (DK / 4), i = (e % (DK / 4)) * 4;
    const bool ok = t0 + t < T;
    cp_async16(sl + swz<float, DK>(t, i), ok ? ld + chunk_base + t * row_stride + i : ld, ok);
  }
}

// NT threads (4 * DK: two CTAs an SM; 8 * DK at DK = 64 and QC = 16: one
// CTA an SM, for grids that leave SMs free); QC the chunk length when it is
// the served one (16: every loop over the chunk unrolls), or 0 for q.
template <typename TI, int DK, int QC, int NT>
__global__ void __launch_bounds__(NT, NT >= 512 ? 1 : 2)
wkv6_kernel(const TI* __restrict__ r, const TI* __restrict__ k, const TI* __restrict__ v,
            const float* __restrict__ ld, const float* __restrict__ u,
            const float* __restrict__ state_in, TI* __restrict__ out,
            float* __restrict__ state_out, int T, int H, int q, int u_batch) {
  constexpr int kThreads = NT;
  const int Q = QC > 0 ? QC : q;
  constexpr int CW = columns_of(DK);         // columns of S a thread holds
  constexpr int NRS = row_slices(DK, NT);    // row slices
  constexpr int kParts = NT / DK;            // parts of a channel's prefix sum
  constexpr int LPS = kThreads / NRS;        // threads of a row slice
  constexpr int RW = DK / NRS;               // rows of S a thread holds
  // channels of one att unit: 16, or 8 for 512 threads (more units in
  // flight where one CTA has the SM)
  constexpr int kItemCh = NT >= 512 ? 8 : 16;
  constexpr int kItems = DK / kItemCh;       // att units a tile, on neighbouring lanes
  static_assert(LPS * CW == DK && RW % 4 == 0 && CW <= 2 && kParts <= 32, "thread layout");

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int tid = threadIdx.x;
  // rows [row0, row0 + RW) and columns [col0, col0 + CW) of S: the threads
  // of a row slice share their rows, so their loads of r and k broadcast
  const int slice = tid / LPS, row0 = slice * RW, col0 = (tid % LPS) * CW;
  const int64_t row_stride = static_cast<int64_t>(H) * DK;  // one token
  const int64_t base = (static_cast<int64_t>(b) * T * H + h) * DK;
  const int64_t state_off = static_cast<int64_t>(bh) * DK * DK;

  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout<TI, DK>(Q, NT);
  float* s_rd = reinterpret_cast<float*>(smem + L.rd);  // [Q][DK] r * exp(cum_ex)
  float* s_kd = reinterpret_cast<float*>(smem + L.kd);  // [Q][DK] k * exp(last - cum)
  float* s_att = reinterpret_cast<float*>(smem + L.att);  // [Q][Q], s <= t
  float* s_part = reinterpret_cast<float*>(smem + L.part);  // [NRS][kSlab][DK]
  float* s_u = reinterpret_cast<float*>(smem + L.u);
  float* s_last = reinterpret_cast<float*>(smem + L.last);
  float* s_dec = reinterpret_cast<float*>(smem + L.dec);
  // the 2 x 2 tiles (rows 2a, 2a + 1 of t; 2b, 2b + 1 of s) on or below
  // the diagonal, a << 8 | b, the diagonal ones first
  uint16_t* s_tiles = reinterpret_cast<uint16_t*>(smem + L.tiles);
  const int t2 = (Q + 1) / 2, tiles = t2 * (t2 + 1) / 2;

  float S[RW][CW];
#pragma unroll
  for (int m = 0; m < RW; ++m)
#pragma unroll
    for (int c = 0; c < CW; ++c)
      S[m][c] = state_in != nullptr
                    ? state_in[state_off + static_cast<int64_t>(row0 + m) * DK + col0 + c]
                    : 0.0f;
  if (tid < DK) s_u[tid] = u[(static_cast<int64_t>(b / u_batch) * H + h) * DK + tid];
  for (int a = tid; a < t2; a += kThreads) {
    s_tiles[a] = static_cast<uint16_t>(a << 8 | a);
    for (int c = 0; c < a; ++c)
      s_tiles[t2 + a * (a - 1) / 2 + c] = static_cast<uint16_t>(a << 8 | c);
  }

  const int nc = (T + Q - 1) / Q;
  // inclusive prefix sums of ld over a chunk, in place: kParts parts of each
  // channel on neighbouring lanes, a serial sum within a part and a shuffle
  // scan of the part totals
  auto prefix_sums = [&](float* ls) {
    auto sl = [&](int t, int ch) -> float& { return ls[swz<float, DK>(t, ch)]; };
    const int ch = tid / kParts, part = tid % kParts;
    const int rows = (Q + kParts - 1) / kParts, ta = min(Q, part * rows),
              tb = min(Q, ta + rows);
    float run = 0.0f;
    for (int t = ta; t < tb; ++t) run += sl(t, ch);
    float incl = run;
#pragma unroll
    for (int off = 1; off < kParts; off <<= 1) {
      const float y = __shfl_up_sync(kFull, incl, off);
      if (part >= off) incl += y;
    }
    float acc = __shfl_up_sync(kFull, incl, 1);
    if (part == 0) acc = 0.0f;
    for (int t = ta; t < tb; ++t) {
      acc += sl(t, ch);
      sl(t, ch) = acc;
    }
    if (ta < tb && tb == Q) s_last[ch] = acc;
  };
  stage_chunk<TI, DK>(smem, L, r, k, v, ld, base, row_stride, 0, T, Q);
  cp_async_commit();
  for (int n = 0; n < nc; ++n) {
    const int t0 = n * Q;
    unsigned char* st = smem + (n & 1) * L.stage;
    const TI* sr = reinterpret_cast<const TI*>(st + L.r);
    const TI* sk = reinterpret_cast<const TI*>(st + L.k);
    float* sl = reinterpret_cast<float*>(st + L.ld);  // ld, then cum
    const TI* sv = reinterpret_cast<const TI*>(st + L.v);
    cp_async_wait_all();
    __syncthreads();  // this chunk has landed; every thread is done with the last one
    prefix_sums(sl);
    __syncthreads();

    // att and the decays.  A unit is one 2 x 2 tile of (t, s) pairs and 8
    // channels (2 groups of 4, kItems groups apart); the kItems units of a
    // tile sit on neighbouring lanes, read the 16-byte chunks of one row
    // together, and are reduced by shuffles.  Each loaded row
    // serves two pairs.  The units of a diagonal tile (t = s = 2a, 2a + 1)
    // also decay r and k of their two rows.
    for (int e0 = 0; e0 < tiles * kItems; e0 += kThreads) {
      const int e = e0 + tid;
      float sum[4] = {};  // pairs (ta, sa), (ta, sb), (tb, sa), (tb, sb)
      int ta = 0, sa = 0;
      if (e < tiles * kItems) {
        const int ab = s_tiles[e / kItems], c = e % kItems;
        ta = 2 * (ab >> 8), sa = 2 * (ab & 0xff);
        const int tb = ta + 1, sb = sa + 1;
        const bool tb_ok = tb < Q, sb_ok = sb < Q;
        const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
        for (int g = 0; g < kItemCh; g += 4) {
          const int i = 4 * c + g * kItems;
          const float4 ra = load4<DK>(sr, ta, i), rb = tb_ok ? load4<DK>(sr, tb, i) : z;
          const float4 ka = load4<DK>(sk, sa, i), kb = sb_ok ? load4<DK>(sk, sb, i) : z;
          // cum_ex of rows ta and tb: cum of rows ta - 1 and ta
          const float4 xa = ta > 0 ? load4<DK>(sl, ta - 1, i) : z, xb = load4<DK>(sl, ta, i);
          const float4 ca = load4<DK>(sl, sa, i), cb = sb_ok ? load4<DK>(sl, sb, i) : z;
          const float ra_[4] = {ra.x, ra.y, ra.z, ra.w}, rb_[4] = {rb.x, rb.y, rb.z, rb.w};
          const float ka_[4] = {ka.x, ka.y, ka.z, ka.w}, kb_[4] = {kb.x, kb.y, kb.z, kb.w};
          const float xa_[4] = {xa.x, xa.y, xa.z, xa.w}, xb_[4] = {xb.x, xb.y, xb.z, xb.w};
          const float ca_[4] = {ca.x, ca.y, ca.z, ca.w}, cb_[4] = {cb.x, cb.y, cb.z, cb.w};
          if (ta != sa) {  // every pair below the diagonal
#pragma unroll
            for (int n = 0; n < 4; ++n) {
              sum[0] = fmaf(ra_[n] * ka_[n], __expf(xa_[n] - ca_[n]), sum[0]);
              sum[1] = fmaf(ra_[n] * kb_[n], __expf(xa_[n] - cb_[n]), sum[1]);
              sum[2] = fmaf(rb_[n] * ka_[n], __expf(xb_[n] - ca_[n]), sum[2]);
              sum[3] = fmaf(rb_[n] * kb_[n], __expf(xb_[n] - cb_[n]), sum[3]);
            }
          } else {  // (ta, ta) and (tb, tb) the bonus, (tb, ta) below, (ta, tb) above
            const float4 uu = *reinterpret_cast<const float4*>(s_u + i);
            const float4 la = *reinterpret_cast<const float4*>(s_last + i);
            const float u_[4] = {uu.x, uu.y, uu.z, uu.w};
#pragma unroll
            for (int n = 0; n < 4; ++n) {
              sum[0] = fmaf(ra_[n] * u_[n], ka_[n], sum[0]);
              sum[2] = fmaf(rb_[n] * ka_[n], __expf(xb_[n] - ca_[n]), sum[2]);
              sum[3] = fmaf(rb_[n] * u_[n], kb_[n], sum[3]);
            }
            const float4 rda = make_float4(ra.x * __expf(xa.x), ra.y * __expf(xa.y),
                                           ra.z * __expf(xa.z), ra.w * __expf(xa.w));
            const float4 rdb = make_float4(rb.x * __expf(xb.x), rb.y * __expf(xb.y),
                                           rb.z * __expf(xb.z), rb.w * __expf(xb.w));
            const float4 kda =
                make_float4(ka.x * __expf(la.x - ca.x), ka.y * __expf(la.y - ca.y),
                            ka.z * __expf(la.z - ca.z), ka.w * __expf(la.w - ca.w));
            const float4 kdb =
                make_float4(kb.x * __expf(la.x - cb.x), kb.y * __expf(la.y - cb.y),
                            kb.z * __expf(la.z - cb.z), kb.w * __expf(la.w - cb.w));
            *reinterpret_cast<float4*>(s_rd + ta * DK + i) = rda;
            *reinterpret_cast<float4*>(s_kd + ta * DK + i) = kda;
            if (tb_ok) {
              *reinterpret_cast<float4*>(s_rd + tb * DK + i) = rdb;
              *reinterpret_cast<float4*>(s_kd + tb * DK + i) = kdb;
            }
          }
        }
      }
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int o = 1; o < kItems; o <<= 1) sum[n] += __shfl_xor_sync(kFull, sum[n], o);
      if (e < tiles * kItems && e % kItems == 0) {
        const int tb = ta + 1, sb = sa + 1;
        s_att[ta * Q + sa] = sum[0];
        if (ta != sa) s_att[ta * Q + sb] = sum[1];
        if (tb < Q) {
          s_att[tb * Q + sa] = sum[2];
          if (sb < Q) s_att[tb * Q + sb] = sum[3];
        }
      }
    }
    if (tid < DK) s_dec[tid] = __expf(s_last[tid]);
    __syncthreads();
    // the next chunk's copies, into the stage the last chunk used, run while
    // this one's outputs and state update are computed
    if (n + 1 < nc)
      stage_chunk<TI, DK>(smem + ((n + 1) & 1) * L.stage, L, r, k, v, ld, base, row_stride,
                          t0 + Q, T, Q);
    cp_async_commit();

    // y, kSlab rows at a time: each row slice adds its rows' share of
    // (r * exp(cum_ex)) S and its share of sum_{s<=t} att[t,s] v[s,:]
    // (s = slice, slice + NRS, ...) into part[slice]; after the state update
    // the slices' partials are summed and written once
    for (int ts = 0; ts < Q; ts += kSlab) {
      const int nt = min(kSlab, Q - ts);
      float acc[kSlab][CW];
#pragma unroll
      for (int tt = 0; tt < kSlab; ++tt) {
#pragma unroll
        for (int c = 0; c < CW; ++c) acc[tt][c] = 0.0f;
        if (tt < nt) {
          const float* a = s_rd + (ts + tt) * DK + row0;
#pragma unroll
          for (int m = 0; m < RW; m += 4) {
            const float4 x = *reinterpret_cast<const float4*>(a + m);
#pragma unroll
            for (int c = 0; c < CW; ++c) {
              acc[tt][c] = fmaf(x.x, S[m][c], acc[tt][c]);
              acc[tt][c] = fmaf(x.y, S[m + 1][c], acc[tt][c]);
              acc[tt][c] = fmaf(x.z, S[m + 2][c], acc[tt][c]);
              acc[tt][c] = fmaf(x.w, S[m + 3][c], acc[tt][c]);
            }
          }
        }
      }
      // this slice's att . v terms: each v[s, :] of the slice loaded once
      for (int s = slice; s < ts + nt; s += NRS) {
        float vs[CW];
#pragma unroll
        for (int c = 0; c < CW; ++c) vs[c] = to_f(sv[s * DK + col0 + c]);
#pragma unroll
        for (int tt = 0; tt < kSlab; ++tt) {
          const int t = ts + tt;
          if (tt < nt && t >= s) {
            const float at = s_att[t * Q + s];
#pragma unroll
            for (int c = 0; c < CW; ++c) acc[tt][c] = fmaf(at, vs[c], acc[tt][c]);
          }
        }
      }
#pragma unroll
      for (int tt = 0; tt < kSlab; ++tt) {
        if (tt < nt) {
          float* p = s_part + (slice * kSlab + tt) * DK + col0;
#pragma unroll
          for (int c = 0; c < CW; ++c) p[c] = acc[tt][c];
        }
      }
      if (ts + nt == Q) {  // the last slab: the state update, while others finish
#pragma unroll
        for (int m = 0; m < RW; ++m) {
          const float d = s_dec[row0 + m];
#pragma unroll
          for (int c = 0; c < CW; ++c) S[m][c] *= d;
        }
#pragma unroll 2
        for (int s = 0; s < Q; ++s) {
          float vs[CW];
#pragma unroll
          for (int c = 0; c < CW; ++c) vs[c] = to_f(sv[s * DK + col0 + c]);
          const float* a = s_kd + s * DK + row0;
#pragma unroll
          for (int m = 0; m < RW; m += 4) {
            const float4 x = *reinterpret_cast<const float4*>(a + m);
#pragma unroll
            for (int c = 0; c < CW; ++c) {
              S[m][c] = fmaf(x.x, vs[c], S[m][c]);
              S[m + 1][c] = fmaf(x.y, vs[c], S[m + 1][c]);
              S[m + 2][c] = fmaf(x.z, vs[c], S[m + 2][c]);
              S[m + 3][c] = fmaf(x.w, vs[c], S[m + 3][c]);
            }
          }
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int e = tid; e < nt * DK; e += kThreads) {
        const int tt = e / DK, jj = e % DK;
        float y = 0.0f;
#pragma unroll
        for (int sl2 = 0; sl2 < NRS; ++sl2) y += s_part[(sl2 * kSlab + tt) * DK + jj];
        if (t0 + ts + tt < T)
          out[base + static_cast<int64_t>(t0 + ts + tt) * row_stride + jj] = from_f<TI>(y);
      }
      if (ts + nt < Q) __syncthreads();  // the next slab's partials reuse s_part
    }
  }
#pragma unroll
  for (int m = 0; m < RW; ++m)
#pragma unroll
    for (int c = 0; c < CW; ++c)
      state_out[state_off + static_cast<int64_t>(row0 + m) * DK + col0 + c] = S[m][c];
}

template <typename TI, int DK, int QC, int NT>
cudaError_t launch(const void* r, const void* k, const void* v, const float* ld, const float* u,
                   const float* state_in, void* out, float* state_out, int B, int T, int H, int Q,
                   int u_batch, cudaStream_t stream) {
  auto kernel = wkv6_kernel<TI, DK, QC, NT>;
  const int smem = layout<TI, DK>(Q, NT).total;
  // all of the SM's shared memory for CTAs: two fit at the serving prefill's
  // shape, so that its whole grid is resident
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kernel<<<B * H, NT, smem, stream>>>(static_cast<const TI*>(r), static_cast<const TI*>(k),
                                      static_cast<const TI*>(v), ld, u, state_in,
                                      static_cast<TI*>(out), state_out, T, H, Q, u_batch);
  return cudaGetLastError();
}

// The served shape (DK = 64, chunk 16) runs an instantiation with the chunk
// fixed, 512 threads where the heads leave SMs free (one CTA an SM, B * H at
// most the SM count; 109 KB of shared memory in float32), 256 otherwise;
// other chunks run the general one at 256 threads (up to 218 KB in float32
// at chunk 64: at 512 threads the row slices' partial sums would double and
// exceed a CTA's 227 KB from chunk 59 on).
template <typename TI>
cudaError_t dispatch(int64_t dk, const void* r, const void* k, const void* v, const float* ld,
                     const float* u, const float* state_in, void* out, float* state_out, int B,
                     int T, int H, int Q, int ub, cudaStream_t s) {
  switch (dk) {
    case 16:
      return launch<TI, 16, 0, 64>(r, k, v, ld, u, state_in, out, state_out, B, T, H, Q, ub, s);
    case 32:
      return launch<TI, 32, 0, 128>(r, k, v, ld, u, state_in, out, state_out, B, T, H, Q, ub,
                                    s);
    case 64: break;
    default: return cudaErrorInvalidValue;
  }
  if (Q != 16)
    return launch<TI, 64, 0, 256>(r, k, v, ld, u, state_in, out, state_out, B, T, H, Q, ub, s);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  return static_cast<int64_t>(B) * H <= sms
             ? launch<TI, 64, 16, 512>(r, k, v, ld, u, state_in, out, state_out, B, T, H, Q, ub,
                                       s)
             : launch<TI, 64, 16, 256>(r, k, v, ld, u, state_in, out, state_out, B, T, H, Q, ub,
                                       s);
}

}  // namespace

// r, k, v, out: (B, T, H, DK) contiguous and 16-byte aligned, float32
// (bf16 == 0) or bf16 (bf16 != 0); ld: (B, T, H, DK) float32, 16-byte aligned;
// u: (B / u_batch, H, DK) float32, batch element b reading row b / u_batch
// (u_batch = B: one u for the batch; a vmapped call folds its peers into the
// batch, each peer's u a row); state_in: (B, H, DK, DK) float32 or null (zero state);
// state_out: (B, H, DK, DK) float32.  DK in {16, 32, 64}; Q = chunk length,
// 1 <= Q <= 64.  Launches on `stream` and returns the launch's cudaError_t
// (0 on success, cudaErrorInvalidValue for arguments it refuses).
extern "C" int wkv6_fwd(const void* r, const void* k, const void* v, const float* ld,
                        const float* u, const float* state_in, void* out, float* state_out,
                        int64_t B, int64_t T, int64_t H, int64_t DK, int64_t Q,
                        int64_t u_batch, int bf16, void* stream) {
  if (B < 1 || T < 1 || H < 1 || Q < 1 || Q > kMaxChunk || B * H > 0x7fffffff ||
      T > 0x7fffffff || u_batch < 1 || B % u_batch != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t any = reinterpret_cast<uintptr_t>(r) | reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(ld) |
                        reinterpret_cast<uintptr_t>(out);
  if (any % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const int b = static_cast<int>(B), t = static_cast<int>(T), h = static_cast<int>(H),
            q = static_cast<int>(Q), ub = static_cast<int>(u_batch);
  const cudaError_t err =
      bf16 ? dispatch<__nv_bfloat16>(DK, r, k, v, ld, u, state_in, out, state_out, b, t, h, q,
                                     ub, s)
           : dispatch<float>(DK, r, k, v, ld, u, state_in, out, state_out, b, t, h, q, ub, s);
  return static_cast<int>(err);
}
