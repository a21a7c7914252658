// Backward of the chunked RWKV6 (Finch) WKV (wkv6.cu), on Hopper (sm_90a): a
// chunked form whose chunk products run on the tensor cores.
//
// The Pallas TPU kernel repro/kernels/rwkv6/rwkv6.py (`wkv6_chunked`) has no
// backward: the reference trains through its jnp chunk scan
// (repro/models/ssm.py:rwkv6_time_mix_chunked), which JAX differentiates.
// The port runs the forward as a hand-written kernel, so this kernel is its
// backward; ref.wkv6_bwd_ref is its plain version (the token recurrence) and
// ref.wkv6_bwd_chunked_ref the plain form of this decomposition.
//
// Per (batch b, head h), with the (DK x DK) state S, o_t = r_t^T (S_{t-1} +
// diag(u) k_t v_t^T), S_t = diag(exp(ld_t)) S_{t-1} + k_t v_t^T, chunks of
// Q = 64 tokens cut into four sub-chunks of 16, and per channel i, within a
// sub-chunk, c the inclusive prefix sum of the log-decays (restarted at every
// sub-chunk), c_ex[t] = c[t - 1] (0 at its first token), ct its last entry,
// w = exp(ct), r^ = r o exp(c_ex) and k^ = k o exp(ct - c).  Given do and dS_T:
//
//   1. each sub-chunk's prefix sums c, per channel, in token order (in both
//      kernels below, by the same code);
//   2. wkv6_bwd_states: for each (b, h) a pass over the sub-chunks, S <-
//      diag(w) S + k^T v from the state in, writing S_c at every chunk's
//      start, and a reverse pass, G <- diag(w) G + r^T do from dS_T, writing
//      G_{c+1} at every chunk's end (the G left is dS_0), each sub-chunk's
//      product (DK x 16 by 16 x DK) on the tensor cores;
//   3. wkv6_bwd_chunk, in parallel over (b, h, chunk): the same two passes
//      over the chunk's four sub-chunks, from S_c and G_{c+1}, give each
//      sub-chunk J's starting state S_J and ending gradient M_J, and with
//      dAtt = do v^T and E[t,s] = exp(c_ex_t - c_s) for s < t in one
//      sub-chunk:
//        dr~ = exp(c_ex) o (do S_J^T) + sum_{s<t} dAtt[t,s] (k_s o E[t,s])
//        dk~ = exp(ct - c) o (v M_J^T) + sum_{t>s} dAtt[t,s] (r_t o E[t,s])
//        dv  = k^ M_J + A^T do, A[t,s] = r_t . (k_s o E[t,s]) (s < t),
//              A[t,t] = r_t . (u o k_t)
//        dr = dr~ + u o k (v . do), dk = dk~ + r o u (v . do)
//      and the log-decays' gradient, restarted at the chunk's end e:
//        dld_t = rowsum(G_{c+1} o S_{c+1}) + sum_{m=t..e} (r_m o dr~_m -
//                k_m o dk~_m) - r_t o dr~_t,
//      summed in reverse token order by one thread a channel;
//   4. wkv6_bwd_du: du = sum_t r o k (v . do), the chunks' partials summed
//      over the chunks and the batch elements that share a row of u, in order.
//
// The sub-chunks are the tokens' factorisation: across two sub-chunks
// exp(c_ex_t - c_s) splits at the boundaries between them into factors that
// are each <= 1 (r^, k^ and the sub-chunks' w, carried by the state and its
// gradient), so those products run on the tensor cores; only the pairs within
// one sub-chunk (120 of 16 x 16) go to the float32 pipes, their decay a
// running product of exp(ld) down each column of the pairs.  Every exponent
// is a sum of log-decays, <= 0: no positive exponent is evaluated, not even
// to be masked, so a log-decay of -50 a step stays finite; the prefix sums
// restart every 16 tokens, so no exponent is the difference of two long
// sums.  No running sum spans more than a chunk: dld restarts at every
// chunk's end from the direct inner product (the token loop summed it over
// the whole sequence).  No atomics anywhere: two calls are equal bit for bit.
//
// Design:
// - Step 2 takes one block of 4 warps a (b, h) and pass (512 at rwkv6-7b's
//   trained shape, B 4 = 2 peers x batch 2, T 1024, H 64, DK 64), warp w
//   holding rows 16 w .. 16 w + 15 of the state in registers (at DK 32 and
//   16, two and one warps hold it), each sub-chunk's k or r, v or do and
//   log-decays staged by cp.async five (bf16) or three (float32) sub-chunks
//   ahead.
// - Step 3 takes one block of 8 warps a (b, h, chunk), 4,096 there (the
//   token loop ran 256 blocks).  It stages the chunk's r, k, v, do and
//   log-decays, all 64 rows, those past T zero-filled (ld = 0, r = k = v =
//   do = 0: they change nothing).  Warps 2 J and 2 J + 1 take sub-chunk J's
//   pairs s < t, 32 channels each, a channel a lane: dAtt's diagonal block
//   on the tensor cores, then the pairs on the float32 pipes, A's columns
//   summed across the lanes by reduce-scatters of 16 values in 16 shuffles,
//   two columns a reduction.  Then, in four steps, warps 0-3 take the
//   forward pass's sub-chunk J = step (S_J, dr~) and warps 4-7 the reverse
//   pass's J = 3 - step (M_J, dk~), warp w holding rows 16 (w % 4) .. of the
//   state, the products along its columns taking the state's own
//   accumulator as the B operand (its layout, with the k order permuted, is
//   the B fragment's), so dr~, dk~ and their epilogues need no exchange
//   between warps; dv, which sums over the state's rows, reads M_J and k^_J
//   from shared memory on all eight warps, an 8-column tile each.
// - Products: mma.sync.m16n8k8 TF32 (tf32_mma.cuh, tf32_tiles.cuh, as
//   ssd_bwd.cu): every float32 operand (the decayed r^ and k^, the states, A,
//   float32 inputs) split in two for 3xTF32, bf16 r, k, v and do widened
//   exactly; do v^T with bf16 operands in one exact pass.  Not wgmma: each
//   warp's products chain through its own rows of the state.
// - Shared memory of step 3 at DK 64: 112 KB with bf16 inputs (two blocks an
//   SM), 144 KB in float32 (one).
// - Scratch (ops.bwd_scratch): S_c and G_{c+1} of every chunk, 2 (T / 64)
//   DK^2 float32 a (b, h) (134 MB at the trained shape, written by step 2 and
//   read by step 3), and the chunks' partials of du.
//
// Bound on an H100 SXM (chip_smoke.py:wkv6_bwd_work, the work of the
// function, whatever computes it): at the trained rwkv6-7b shape with bf16
// r, k, v, do and a state in a call reads r, k, v, do (bf16, 33.6 MB each)
// and ld (float32, 67 MB) and writes dr, dk, dv (bf16) and dld (float32),
// with the states: 377 MB, 0.11 ms at 3.35 TB/s; the token recurrence's
// 12 DK^2 + 34 DK operations a token and head, 13.5 GFLOP, would take 0.20 ms
// on the float32 pipes.  This design moves more: step 2 reads the inputs
// once each way and writes the scratch (about 400 MB: it is bound by those
// bytes), step 3 reads the inputs and the scratch again and writes the
// gradients (about 500 MB); step 3 is bound by the instructions it issues
// (its phases' times add up), not by bytes or the tensor cores.  The times
// are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../mamba2/csrc/tf32_tiles.cuh"

namespace {

constexpr int kQ = 64;          // tokens a chunk (ref.BWD_Q)
constexpr int kSub = 16;        // tokens a sub-chunk (ref.BWD_SUB)
constexpr int kNs = kQ / kSub;  // sub-chunks a chunk
constexpr int kThreads = 128;   // step 2: four warps, a row tile of the state each
constexpr int kChunkWarps = 8;  // step 3: two a sub-chunk's pairs, then four a pass
constexpr int kChunkThreads = 32 * kChunkWarps;
constexpr unsigned kFull = 0xffffffffu;

// The inclusive prefix sums, in log2 units, of channel i's 16 log-decays in
// rows r0 .. r0 + 15 of a float32 operand layout L, in token order, in place.
template <typename L>
__device__ __forceinline__ void prefix16(float* l, int r0, int i) {
  float v[kSub];
#pragma unroll
  for (int t = 0; t < kSub; ++t) v[t] = l[L::off(r0 + t, i)];
  float run = 0.0f;
#pragma unroll
  for (int t = 0; t < kSub; ++t) {
    run = fmaf(v[t], kLog2e, run);
    l[L::off(r0 + t, i)] = run;
  }
}

// Rows 16 w .. 16 w + 15 (w the warp) of a DK x DK float32 matrix in the
// accumulator layout of NT 8-column tiles: load from or store to global memory.
template <int DK, int NT>
__device__ __forceinline__ void load_rows(float (&m)[NT][4], const float* src, int i0) {
  const int lane = threadIdx.x & 31, gi = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const float2 a = *reinterpret_cast<const float2*>(src + (i0 + gi) * DK + 8 * nt + 2 * tq);
    const float2 b =
        *reinterpret_cast<const float2*>(src + (i0 + gi + 8) * DK + 8 * nt + 2 * tq);
    m[nt][0] = a.x;
    m[nt][1] = a.y;
    m[nt][2] = b.x;
    m[nt][3] = b.y;
  }
}

template <int DK, int NT>
__device__ __forceinline__ void store_rows(const float (&m)[NT][4], float* dst, int i0) {
  const int lane = threadIdx.x & 31, gi = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    *reinterpret_cast<float2*>(dst + (i0 + gi) * DK + 8 * nt + 2 * tq) =
        make_float2(m[nt][0], m[nt][1]);
    *reinterpret_cast<float2*>(dst + (i0 + gi + 8) * DK + 8 * nt + 2 * tq) =
        make_float2(m[nt][2], m[nt][3]);
  }
}

// rows i0 + g and i0 + g + 8 of the accumulator times wa and wb
template <int NT>
__device__ __forceinline__ void scale_rows(float (&m)[NT][4], float wa, float wb) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    m[nt][0] *= wa;
    m[nt][1] *= wa;
    m[nt][2] *= wb;
    m[nt][3] *= wb;
  }
}

// m (rows i0 .., NT column tiles) += X^T Y over the 16 rows t0 .. of a
// sub-chunk: X the decayed k^ or r^, given at the A fragment's positions by
// xa(t, i), and Y (v or do) staged in the operand layout YT.
template <bool kS, int NT, typename YT, typename XA>
__device__ __forceinline__ void add_outer(float (&m)[NT][4], const YT& ys, int t0, int i0,
                                          XA xa) {
  constexpr int NQ = NT < 4 ? NT : 4;
  const int lane = threadIdx.x & 31, gi = lane >> 2, tq = lane & 3;
  const int ia = i0 + gi, ib = ia + 8;
#pragma unroll
  for (int k0 = 0; k0 < kSub; k0 += 8) {
    const int ta = t0 + k0 + 2 * tq, tb = ta + 1;
    const float av[4] = {xa(ta, ia), xa(ta, ib), xa(tb, ia), xa(tb, ib)};
    const Parts<4> af = split<true>(av);
#pragma unroll
    for (int q0 = 0; q0 < NT; q0 += NQ) {
      float bv[NQ][2];
      ys.template cols_b<NQ>(bv, t0 + k0, 8 * q0);
      Parts<2> bp[NQ];
#pragma unroll
      for (int q = 0; q < NQ; ++q) bp[q] = split<kS>(bv[q]);
      mma_group<true, kS, NQ>(m + q0, af, bp);
    }
  }
}

// d (16 rows t0 .. x the 16 columns i0 ..) = X M^T: X (do or v, rows t0 ..)
// staged in XT, M the state's rows i0 .. in registers, taken as the B
// operand as they stand (k over M's columns).
template <bool kS, int NT, typename XT>
__device__ __forceinline__ void times_rows_t(float (&d)[2][4], const XT& xs, int t0,
                                             const float (&m)[NT][4]) {
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[n][e] = 0.0f;
#pragma unroll
  for (int jt = 0; jt < NT; ++jt) {
    float av[4];
    xs.rows_a(av, t0, 8 * jt);
    const Parts<4> af = split<kS>(av);
    const float b0[2] = {m[jt][0], m[jt][1]}, b1[2] = {m[jt][2], m[jt][3]};
    const Parts<2> bp[2] = {split<true>(b0), split<true>(b1)};
    mma_group<kS, true, 2>(d, af, bp);
  }
}

// ------------------------------------------------ step 2: chunk boundaries --

template <typename T, int DK>
struct StateCfg {
  using XT = Op<T, kSub, DK>;      // a sub-chunk's k or r, and v or do
  using LT = Op<float, kSub, DK>;  // its log-decays, then their prefix sums
  static constexpr int kY = XT::kBytes, kL = 2 * XT::kBytes, kStage = kL + LT::kBytes;
  // sub-chunks in flight, 48 KB at DK 64 either way: four blocks an SM
  static constexpr int kStages = sizeof(T) == 2 ? 6 : 4;
  static constexpr int kBytes = kStages * kStage;
  static constexpr int kRowWarps = DK / 16, NT = DK / 8;
};

// One (b, h) and one pass: the forward pass (S_c from k and v) or the reverse
// one (G_{c+1} from r and do), sub-chunk by sub-chunk.
template <typename T, int DK>
__global__ void __launch_bounds__(kThreads)
wkv6_bwd_states(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                const float* __restrict__ ld, const T* __restrict__ dout,
                const float* __restrict__ state_in, const float* __restrict__ dstate_out,
                float* __restrict__ sbuf, float* __restrict__ gbuf,
                float* __restrict__ dstate_in, int T_len, int H) {
  using C = StateCfg<T, DK>;
  using LT = typename C::LT;
  constexpr bool kS = sizeof(T) == 4;
  constexpr int NT = C::NT;
  extern __shared__ __align__(16) unsigned char smem[];
  const int reverse = blockIdx.x & 1, bh = blockIdx.x >> 1;
  const int b = bh / H, h = bh - b * H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gi = lane >> 2;
  const int i0 = 16 * warp;
  const bool owner = warp < C::kRowWarps;
  const int nc = (T_len + kQ - 1) / kQ, nsub = nc * kNs;
  const int64_t row = static_cast<int64_t>(H) * DK;
  const int64_t base = (static_cast<int64_t>(b) * T_len * H + h) * DK;
  const int64_t st_off = static_cast<int64_t>(bh) * DK * DK;
  const T* xsrc = (reverse ? r : k) + base;
  const T* ysrc = (reverse ? dout : v) + base;
  const float* lsrc = ld + base;
  float* out = (reverse ? gbuf : sbuf) + static_cast<int64_t>(bh) * nc * DK * DK;

  // the sub-chunk of step i into stage i % kStages; rows past T (a whole
  // sub-chunk, in the last chunk) zero-filled, read from nowhere
  auto stage_step = [&](int i) {
    const int n = reverse ? nsub - 1 - i : i;
    unsigned char* buf = smem + (i % C::kStages) * C::kStage;
    const int t0 = n * kSub, valid = T_len - t0 < kSub ? T_len - t0 : kSub;
    const int64_t off = t0 < T_len ? t0 * row : 0;
    stage<typename C::XT>(buf, xsrc + off, row, kSub, DK, valid);
    stage<typename C::XT>(buf + C::kY, ysrc + off, row, kSub, DK, valid);
    stage<LT>(buf + C::kL, lsrc + off, row, kSub, DK, valid);
    cp_async_commit();
  };

  float s[NT][4];
  const float* init = reverse ? dstate_out : state_in;
  if (owner && init != nullptr) {
    load_rows<DK, NT>(s, init + st_off, i0);
  } else {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.0f;
  }
  // one copy group a step, empty past the last sub-chunk, so that waiting
  // for all but the newest kStages - 1 groups always finds step's complete
#pragma unroll
  for (int i = 0; i < C::kStages - 1; ++i) {
    if (i < nsub) stage_step(i);
    else cp_async_commit();
  }
  for (int step = 0; step < nsub; ++step) {
    const int n = reverse ? nsub - 1 - step : step;
    if (step + C::kStages - 1 < nsub) stage_step(step + C::kStages - 1);
    else cp_async_commit();
    cp_async_wait_group<C::kStages - 1>();
    __syncthreads();  // sub-chunk n staged
    unsigned char* buf = smem + (step % C::kStages) * C::kStage;
    float* sl = reinterpret_cast<float*>(buf + C::kL);
    if (tid < DK) prefix16<LT>(sl, 0, tid);
    __syncthreads();
    if (owner) {
      if (n % kNs == (reverse ? kNs - 1 : 0)) store_rows<DK, NT>(s, out + (n / kNs) * DK * DK, i0);
      const typename C::XT xs{reinterpret_cast<const T*>(buf)};
      const typename C::XT ys{reinterpret_cast<const T*>(buf + C::kY)};
      scale_rows<NT>(s, ex2(sl[LT::off(kSub - 1, i0 + gi)]),
                     ex2(sl[LT::off(kSub - 1, i0 + gi + 8)]));
      if (reverse) {  // r^ = r o exp(c_ex)
        add_outer<kS, NT>(s, ys, 0, i0, [&](int t, int i) {
          return xs.at(t, i) * ex2(t > 0 ? sl[LT::off(t - 1, i)] : 0.0f);
        });
      } else {  // k^ = k o exp(ct - c)
        add_outer<kS, NT>(s, ys, 0, i0, [&](int t, int i) {
          return xs.at(t, i) * ex2(sl[LT::off(kSub - 1, i)] - sl[LT::off(t, i)]);
        });
      }
    }
    __syncthreads();  // the stage is free
  }
  if (reverse && owner && dstate_in != nullptr) store_rows<DK, NT>(s, dstate_in + st_off, i0);
}

// ------------------------------------------- step 3: within every chunk --

template <typename T, int DK>
struct ChunkCfg {
  static constexpr bool kS = sizeof(T) == 4;  // float32 inputs carry a low part
  static constexpr int kRowWarps = DK / 16, NT = DK / 8;
  using IT = Op<T, kQ, DK>;          // r, k, v, do
  using FT = Op<float, kQ, DK>;      // ld then c; the pairs' dr~ then r o dr~; dk~, k o dk~
  using MT = Op<float, DK, DK>;      // M_J (and, before, each warp's block of dAtt)
  using KT = Op<float, kSub, DK>;    // k^ of a sub-chunk
  using AT = Op<float, kSub, kSub>;  // a block of A (two halves of the channels) or dAtt
  static constexpr int kMBytes =
      MT::kBytes > kChunkWarps * AT::kBytes ? MT::kBytes : kChunkWarps * AT::kBytes;
  static constexpr int kR = 0, kK = kR + IT::kBytes, kV = kK + IT::kBytes, kDo = kV + IT::kBytes,
                       kLc = kDo + IT::kBytes, kDr = kLc + FT::kBytes, kDk = kDr + FT::kBytes,
                       kM = kDk + FT::kBytes, kKh = kM + kMBytes, kAf = kKh + KT::kBytes,
                       kVdo = kAf + 2 * kNs * AT::kBytes, kU = kVdo + kQ * 4, kF = kU + DK * 4,
                       kDu = kF + DK * 4, kBytes = kDu + kNs * DK * 4;
};

// What the warps of step 3 read and write.
template <typename T, int DK>
struct Chunk {
  using C = ChunkCfg<T, DK>;
  using FT = typename C::FT;
  typename C::IT rs, ks, vs, dos;
  float *lcp, *ddr, *ddk, *mbuf, *kh, *af, *vdo, *u, *f, *dup;
  const float *sc, *ge;   // S_c and G_{c+1} of the chunk
  T *dr, *dk, *dv;        // (b, t0, h, 0)
  int64_t row;            // the token stride, H DK
  int valid;              // rows of the chunk before T

  __device__ __forceinline__ float lc(int t, int i) const { return lcp[FT::off(t, i)]; }
  __device__ __forceinline__ float2 lc2(int t, int i) const {  // c at (t, i), (t, i + 1)
    return *reinterpret_cast<const float2*>(lcp + FT::off(t, i));
  }
  __device__ __forceinline__ float lce(int t, int i) const {
    return (t & (kSub - 1)) ? lcp[FT::off(t - 1, i)] : 0.0f;
  }
  __device__ __forceinline__ float tail(int t, int i) const {  // ct - c, <= 0
    return lcp[FT::off(t | (kSub - 1), i)] - lcp[FT::off(t, i)];
  }
};

// One round of reduce16: lanes l and l ^ (2 kHalf) exchange halves of v[0 ..
// 2 kHalf), each keeping the half that bit of its lane selects, summed.
template <int kHalf>
__device__ __forceinline__ void fold(float (&v)[kSub], int lane) {
  const bool up = lane & (2 * kHalf);
#pragma unroll
  for (int m = 0; m < kHalf; ++m) {
    const float send = up ? v[m] : v[m + kHalf];
    const float keep = up ? v[m + kHalf] : v[m];
    v[m] = keep + __shfl_xor_sync(kFull, send, 2 * kHalf);
  }
}

// The sum over the warp of v[s], s = 0 .. 15, by a reduce-scatter of 16
// shuffles in a fixed order: lane l returns the total of s = l >> 1.
__device__ __forceinline__ float reduce16(float (&v)[kSub]) {
  const int lane = threadIdx.x & 31;
  fold<8>(v, lane);
  fold<4>(v, lane);
  fold<2>(v, lane);
  fold<1>(v, lane);
  return v[0] + __shfl_xor_sync(kFull, v[0], 1);
}

// Step q of A's columns below the diagonal, in the order 0, 14, 1, 13, ..,
// 6, 8, 7, 15: column p (t = p + 1 .. 15) and column 14 - p (t = 15 - p ..
// 15) fill the 16 values of one reduction, column 7 one alone, and column 15
// has no pair below the diagonal.  For each pair s < t of the column the
// decay E = exp(c_ex_t - c_s) = wd_{s+1} .. wd_{t-1} (wd_m = exp(ld_m), a
// running product down the column, no exp): the pairs' parts of dr~ (drs,
// over s) and dk~ (over t, stored), this half's part of A[t][s]; and the
// column's row of du.
template <int Q, typename Ch>
__device__ __forceinline__ void column_q(const Ch& ch, const float (&rr)[kSub],
                                         const float (&wd)[kSub], float (&drs)[kSub],
                                         float (&part)[kSub], float& du, const float* datt,
                                         float* af, int t0, int ci, bool on) {
  using AT = typename Ch::C::AT;
  using FT = typename Ch::FT;
  constexpr bool kSecond = (Q & 1) && Q < kSub - 1;
  constexpr int kCol = Q == kSub - 1 ? kSub - 1 : kSecond ? kSub - 2 - Q / 2 : Q / 2;
  constexpr int kSlot0 = kSecond ? 0 : -kCol - 1;  // t's slot: t + kSlot0
  if constexpr (!kSecond) {
#pragma unroll
    for (int t = 0; t < kSub; ++t) part[t] = 0.0f;
  }
  const float ks = on ? ch.ks.at(t0 + kCol, ci) : 0.0f;
  float dks = 0.0f, e = 1.0f, dc[kSub];  // dAtt's column kCol: row kCol of the transposed block
#pragma unroll
  for (int t4 = (kCol + 1) / 4 * 4; t4 < kSub; t4 += 4) {
    const float4 q4 = *reinterpret_cast<const float4*>(datt + AT::off(kCol, t4));
    dc[t4] = q4.x;
    dc[t4 + 1] = q4.y;
    dc[t4 + 2] = q4.z;
    dc[t4 + 3] = q4.w;
  }
#pragma unroll
  for (int t = kCol + 1; t < kSub; ++t) {
    const float d = dc[t];
    if (t > kCol + 1) e *= wd[t - 1];
    const float ke = ks * e;
    part[t + kSlot0] = rr[t] * ke;
    drs[t] = fmaf(d, ke, drs[t]);
    dks = fmaf(d, rr[t] * e, dks);
  }
  if (on) ch.ddk[FT::off(t0 + kCol, ci)] = dks;
  du = fmaf(rr[kCol] * ks, datt[AT::off(kCol, kCol)], du);
  if constexpr (kSecond || Q == kSub - 2) {
    constexpr int kFirst = Q / 2;  // the first column of the two
    const float av = reduce16(part);  // this half's part of slot lane >> 1
    const int lane = threadIdx.x & 31, slot = lane >> 1;
    if (!(lane & 1)) {
      if (slot < kSub - 1 - kFirst) {
        af[AT::off(slot + kFirst + 1, kFirst)] = av;
      } else if (kSecond) {
        af[AT::off(slot, kSub - 2 - kFirst)] = av;
      }
    }
  }
}

template <int Q>
struct Columns {
  template <typename... A>
  static __device__ __forceinline__ void run(A&&... a) {
    column_q<Q>(a...);
    Columns<Q + 1>::run(a...);
  }
};
template <>
struct Columns<kSub> {
  template <typename... A>
  static __device__ __forceinline__ void run(A&&...) {}
};

// Warp w, sub-chunk J = w / 2's pairs s <= t for channels 32 (w % 2) + lane:
// dAtt's diagonal block (do v^T) on the tensor cores (each warp its own
// copy, transposed), its diagonal v . do; A's diagonal (the bonus r_t . (u
// o k_t)); then A's columns below it, the pairs' parts of dr~ and dk~ and
// the partial of du (Columns).
template <typename T, int DK>
__device__ __forceinline__ void pairs(const Chunk<T, DK>& ch, int w) {
  using C = ChunkCfg<T, DK>;
  using AT = typename C::AT;
  using FT = typename C::FT;
  constexpr bool kS = C::kS;
  const int lane = threadIdx.x & 31, gi = lane >> 2, tq = lane & 3;
  const int J = w >> 1, half = w & 1, t0 = kSub * J;
  float* datt = ch.mbuf + w * kSub * AT::kStride;
  float* af = ch.af + (half * kNs + J) * kSub * AT::kStride;
  {
    float d[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) d[n][e] = 0.0f;
#pragma unroll
    for (int k0 = 0; k0 < DK; k0 += 8) {
      float av[4];
      ch.dos.rows_a(av, t0, k0);
      const Parts<4> ap = split<kS>(av);
      Parts<2> bp[2];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        float bv[2];
        ch.vs.rows_b(bv, t0 + 8 * n, k0);
        bp[n] = split<kS>(bv);
      }
      mma_group<kS, kS, 2>(d, ap, bp);
    }
#pragma unroll
    for (int n = 0; n < 2; ++n) {  // transposed: datt[s][t] = dAtt[t][s]
      const int sc = 8 * n + 2 * tq;
      datt[AT::off(sc, gi)] = d[n][0];
      datt[AT::off(sc + 1, gi)] = d[n][1];
      datt[AT::off(sc, gi + 8)] = d[n][2];
      datt[AT::off(sc + 1, gi + 8)] = d[n][3];
    }
  }
  __syncwarp();
  if (half == 0 && lane < kSub) ch.vdo[t0 + lane] = datt[AT::off(lane, lane)];

  const int ci = lane + 32 * half;
  const bool on = ci < DK;
  const float uu = on ? ch.u[ci] : 0.0f;
  float du = 0.0f, rr[kSub], wd[kSub], drs[kSub];  // wd_t = exp(ld_t) = exp(c_t - c_ex_t)
#pragma unroll
  for (int t = 0; t < kSub; ++t) {
    rr[t] = on ? ch.rs.at(t0 + t, ci) : 0.0f;
    wd[t] = on ? ex2(ch.lc(t0 + t, ci) - ch.lce(t0 + t, ci)) : 1.0f;
    drs[t] = 0.0f;
  }
  // A's entries above the diagonal are 0; the rest are written below
#pragma unroll
  for (int e = lane; e < kSub * kSub; e += 32) af[AT::off(e / kSub, e % kSub)] = 0.0f;
  __syncwarp();
  // A's diagonal, the bonus r_t . (u o k_t)
  {
    float part[kSub];
#pragma unroll
    for (int t = 0; t < kSub; ++t) part[t] = rr[t] * uu * (on ? ch.ks.at(t0 + t, ci) : 0.0f);
    const float a = reduce16(part);
    if (!(lane & 1)) af[AT::off(lane >> 1, lane >> 1)] = a;
  }
  // A's columns below the diagonal two at a time (Columns)
  float part[kSub];
  Columns<0>::run(ch, rr, wd, drs, part, du, datt, af, t0, ci, on);
  if (on) {
#pragma unroll
    for (int t = 0; t < kSub; ++t) ch.ddr[FT::off(t0 + t, ci)] = drs[t];
    ch.dup[J * DK + ci] = du;
  }
}

// The epilogue of dr~ (kDr) or dk~ at the positions of d (rows t0 + g (+ 8),
// columns i0 + 8 n + 2 q (+ 1)): times exp(c_ex) or exp(ct - c), plus the
// pairs' part; the output (plus the bonus term) stored in T, and r o dr~ or
// k o dk~ left in place of the pairs' part for dld.  dk~'s also writes k^ =
// k o exp(ct - c) there (the warps of the pass cover sub-chunk t0 .. once).
template <bool kDr, typename T, int DK>
__device__ __forceinline__ void finish_rows(const Chunk<T, DK>& ch, const float (&d)[2][4],
                                            int t0, int i0) {
  using FT = typename ChunkCfg<T, DK>::FT;
  using KT = typename ChunkCfg<T, DK>::KT;
  const int lane = threadIdx.x & 31, gi = lane >> 2, tq = lane & 3;
  float* part = kDr ? ch.ddr : ch.ddk;
  T* out = kDr ? ch.dr : ch.dk;
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    const int i = i0 + 8 * n + 2 * tq;
    const float2 uu = *reinterpret_cast<const float2*>(ch.u + i);
    const float2 ct = kDr ? make_float2(0.0f, 0.0f) : ch.lc2(t0 + kSub - 1, i);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int t = t0 + gi + 8 * hh, at = FT::off(t, i);
      float2 g;  // exp(c_ex) or exp(ct - c)
      if constexpr (kDr) {
        const float2 c = (t & (kSub - 1)) ? ch.lc2(t - 1, i) : make_float2(0.0f, 0.0f);
        g = make_float2(ex2(c.x), ex2(c.y));
      } else {
        const float2 c = ch.lc2(t, i);
        g = make_float2(ex2(ct.x - c.x), ex2(ct.y - c.y));
      }
      const float2 pp = *reinterpret_cast<const float2*>(part + at);
      const float f0 = fmaf(g.x, d[n][2 * hh], pp.x), f1 = fmaf(g.y, d[n][2 * hh + 1], pp.y);
      const float2 rv = ch.rs.at2(t, i), kv = ch.ks.at2(t, i);
      const float2 bo = kDr ? kv : rv, mu = kDr ? rv : kv;
      const float vd = ch.vdo[t];
      // the bonus: u o k (v . do) for dr, r o u (v . do) for dk
      const float o0 = fmaf(bo.x * uu.x, vd, f0), o1 = fmaf(bo.y * uu.y, vd, f1);
      *reinterpret_cast<float2*>(part + at) = make_float2(mu.x * f0, mu.y * f1);
      if constexpr (!kDr)
        *reinterpret_cast<float2*>(ch.kh + KT::off(t - t0, i)) =
            make_float2(kv.x * g.x, kv.y * g.y);
      if (t < ch.valid) store2(out + t * ch.row + i, o0, o1);
    }
  }
}

template <typename T, int DK>
__global__ void __launch_bounds__(kChunkThreads, 2)
wkv6_bwd_chunk(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
               const float* __restrict__ ld, const float* __restrict__ u,
               const T* __restrict__ dout, const float* __restrict__ sbuf,
               const float* __restrict__ gbuf, T* __restrict__ dr, T* __restrict__ dk,
               T* __restrict__ dv, float* __restrict__ dld, float* __restrict__ du_part,
               int T_len, int H, int u_batch) {
  using C = ChunkCfg<T, DK>;
  using FT = typename C::FT;
  using MT = typename C::MT;
  using KT = typename C::KT;
  using AT = typename C::AT;
  constexpr bool kS = C::kS;
  constexpr int NT = C::NT;
  extern __shared__ __align__(16) unsigned char smem[];
  const int nc = (T_len + kQ - 1) / kQ;
  const int blk = blockIdx.x, bh = blk / nc, ch_i = blk - bh * nc;
  const int b = bh / H, h = bh - b * H;
  const int t_begin = ch_i * kQ, valid = T_len - t_begin < kQ ? T_len - t_begin : kQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gi = lane >> 2, tq = lane & 3;
  const int64_t row = static_cast<int64_t>(H) * DK;
  const int64_t tok = ((static_cast<int64_t>(b) * T_len + t_begin) * H + h) * DK;

  stage<typename C::IT>(smem + C::kR, r + tok, row, kQ, DK, valid);
  stage<typename C::IT>(smem + C::kK, k + tok, row, kQ, DK, valid);
  stage<typename C::IT>(smem + C::kV, v + tok, row, kQ, DK, valid);
  stage<typename C::IT>(smem + C::kDo, dout + tok, row, kQ, DK, valid);
  stage<FT>(smem + C::kLc, ld + tok, row, kQ, DK, valid);
  cp_async_commit();
  float* s_u = reinterpret_cast<float*>(smem + C::kU);
  if (tid < DK) s_u[tid] = u[(static_cast<int64_t>(b / u_batch) * H + h) * DK + tid];
  cp_async_wait_all();
  __syncthreads();

  const Chunk<T, DK> ch{{reinterpret_cast<const T*>(smem + C::kR)},
                        {reinterpret_cast<const T*>(smem + C::kK)},
                        {reinterpret_cast<const T*>(smem + C::kV)},
                        {reinterpret_cast<const T*>(smem + C::kDo)},
                        reinterpret_cast<float*>(smem + C::kLc),
                        reinterpret_cast<float*>(smem + C::kDr),
                        reinterpret_cast<float*>(smem + C::kDk),
                        reinterpret_cast<float*>(smem + C::kM),
                        reinterpret_cast<float*>(smem + C::kKh),
                        reinterpret_cast<float*>(smem + C::kAf),
                        reinterpret_cast<float*>(smem + C::kVdo),
                        s_u,
                        reinterpret_cast<float*>(smem + C::kF),
                        reinterpret_cast<float*>(smem + C::kDu),
                        sbuf + static_cast<int64_t>(blk) * DK * DK,
                        gbuf + static_cast<int64_t>(blk) * DK * DK,
                        dr + tok,
                        dk + tok,
                        dv + tok,
                        row,
                        valid};

  for (int e = tid; e < kNs * DK; e += kChunkThreads) {
    const int j = e / DK;
    prefix16<FT>(ch.lcp, kSub * j, e - j * DK);
  }
  __syncthreads();
  pairs<T, DK>(ch, warp);
  __syncthreads();

  // warps 0-3 the forward pass (S_J, dr~), 4-7 the reverse one (M_J, dk~,
  // from M_3 = G_{c+1}), each warp w % 4 holding rows 16 (w % 4) .. of the
  // state (at DK 32 and 16, the first two or one); step it takes the forward
  // pass's sub-chunk it and the reverse pass's 3 - it, then dv of 3 - it on
  // all eight warps, a column tile each, then M_{J-1}
  const int wr = warp & 3, i0 = 16 * wr, grp = warp >> 2;
  const bool owner = wr < C::kRowWarps;
  float m[NT][4];
  if (owner) load_rows<DK, NT>(m, grp == 0 ? ch.sc : ch.ge, i0);
#pragma unroll 1
  for (int it = 0; it < kNs; ++it) {
    const int jr = kNs - 1 - it, t0r = kSub * jr;
    if (owner) {
      float d[2][4];
      if (grp == 0) {
        const int t0 = kSub * it;
        times_rows_t<kS, NT>(d, ch.dos, t0, m);
        finish_rows<true, T, DK>(ch, d, t0, i0);
        scale_rows<NT>(m, ex2(ch.lc(t0 + kSub - 1, i0 + gi)),
                       ex2(ch.lc(t0 + kSub - 1, i0 + gi + 8)));
        add_outer<kS, NT>(m, ch.vs, t0, i0, [&](int t, int i) {
          return ch.ks.at(t, i) * ex2(ch.tail(t, i));
        });
      } else {
        times_rows_t<kS, NT>(d, ch.vs, t0r, m);
        finish_rows<false, T, DK>(ch, d, t0r, i0);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          *reinterpret_cast<float2*>(ch.mbuf + MT::off(i0 + gi, 8 * nt + 2 * tq)) =
              make_float2(m[nt][0], m[nt][1]);
          *reinterpret_cast<float2*>(ch.mbuf + MT::off(i0 + gi + 8, 8 * nt + 2 * tq)) =
              make_float2(m[nt][2], m[nt][3]);
        }
      }
    }
    __syncthreads();  // M_J and k^_J in place
    if (owner) {
      // dv of rows t0r .., columns jc .. jc + 7: k^_J M_J + A_J^T do_J, A_J
      // the sum of its two halves
      const int jc = i0 + 8 * grp;
      const MT ms{ch.mbuf};
      const KT khs{ch.kh};
      const AT a0{ch.af + jr * kSub * AT::kStride}, a1{ch.af + (kNs + jr) * kSub * AT::kStride};
      float acc[1][4] = {{0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
      for (int k0 = 0; k0 < DK; k0 += 8) {
        float av[4], bv[1][2];
        khs.rows_a(av, 0, k0);
        ms.template cols_b<1>(bv, k0, jc);
        const Parts<2> bp[1] = {split<true>(bv[0])};
        mma_group<true, true, 1>(acc, split<true>(av), bp);
      }
#pragma unroll
      for (int k0 = 0; k0 < kSub; k0 += 8) {
        float av[4], a1v[4], bv[1][2];
        a0.cols_a(av, k0, 0);
        a1.cols_a(a1v, k0, 0);
#pragma unroll
        for (int e = 0; e < 4; ++e) av[e] += a1v[e];
        ch.dos.template cols_b<1>(bv, t0r + k0, jc);
        const Parts<2> bp[1] = {split<kS>(bv[0])};
        mma_group<true, kS, 1>(acc, split<true>(av), bp);
      }
      const int j = jc + 2 * tq, sa = t0r + gi, sb = sa + 8;
      if (sa < valid) store2(ch.dv + sa * row + j, acc[0][0], acc[0][1]);
      if (sb < valid) store2(ch.dv + sb * row + j, acc[0][2], acc[0][3]);
      if (grp == 1 && jr > 0) {  // M_{J-1} = diag(w_J) M_J + r^_J^T do_J
        scale_rows<NT>(m, ex2(ch.lc(t0r + kSub - 1, i0 + gi)),
                       ex2(ch.lc(t0r + kSub - 1, i0 + gi + 8)));
        add_outer<kS, NT>(m, ch.dos, t0r, i0, [&](int t, int i) {
          return ch.rs.at(t, i) * ex2(ch.lce(t, i));
        });
      }
    }
    __syncthreads();  // M_J and k^_J read
  }
  if (owner && grp == 0) {  // rowsum(G_{c+1} o S_{c+1})
    float g[NT][4];
    load_rows<DK, NT>(g, ch.ge, i0);
    float fa = 0.0f, fb = 0.0f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      fa = fmaf(g[nt][0], m[nt][0], fa);
      fa = fmaf(g[nt][1], m[nt][1], fa);
      fb = fmaf(g[nt][2], m[nt][2], fb);
      fb = fmaf(g[nt][3], m[nt][3], fb);
    }
    fa = quad_sum(fa);
    fb = quad_sum(fb);
    if (tq == 0) {
      ch.f[i0 + gi] = fa;
      ch.f[i0 + gi + 8] = fb;
    }
  }
  __syncthreads();

  // dld: each channel's tokens in four segments of 16, a thread each: the
  // segment's sum of r o dr~ - k o dk~, then the run from the chunk's end
  // through the segments above it, then the segment's tokens in reverse
  const int ci = tid % DK, seg = tid / DK;
  float* sums = ch.kh;  // free again
  if (seg < kNs) {
    float p = 0.0f;
#pragma unroll
    for (int t = kSub - 1; t >= 0; --t) {
      const int at = FT::off(kSub * seg + t, ci);
      p += ch.ddr[at] - ch.ddk[at];
    }
    sums[seg * DK + ci] = p;
  }
  __syncthreads();
  if (seg < kNs) {
    float run = ch.f[ci];
    for (int sg = kNs - 1; sg > seg; --sg) run += sums[sg * DK + ci];
    float* out = dld + tok + ci;
#pragma unroll
    for (int t = kSub - 1; t >= 0; --t) {
      const int tt = kSub * seg + t, at = FT::off(tt, ci);
      const float dl = run - ch.ddk[at];
      if (tt < valid) out[tt * row] = dl;
      run = dl + ch.ddr[at];
    }
  }
  if (tid < DK)
    du_part[static_cast<int64_t>(blk) * DK + tid] =
        ((ch.dup[tid] + ch.dup[DK + tid]) + ch.dup[2 * DK + tid]) + ch.dup[3 * DK + tid];
}

// ----------------------------------------------------------- step 4: du --

// du (B / u_batch, H, DK) = the sum of the chunks' partials (B, H, nc, DK) of
// the batch elements that share each row, in batch then chunk order
__global__ void wkv6_bwd_du(const float* __restrict__ du_part, float* __restrict__ du,
                            int64_t rows, int H, int DK, int u_batch, int nc) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t hdk = static_cast<int64_t>(H) * DK;
  if (e >= rows * hdk) return;
  const int64_t g = e / hdk, hi = e - g * hdk, h = hi / DK, i = hi - h * DK;
  float s = 0.0f;
  for (int j = 0; j < u_batch; ++j) {
    const float* src = du_part + (((g * u_batch + j) * H + h) * nc) * DK + i;
    for (int c = 0; c < nc; ++c) s += src[static_cast<int64_t>(c) * DK];
  }
  du[e] = s;
}

unsigned blocks_of(int64_t n) { return static_cast<unsigned>((n + 255) / 256); }

template <typename TI, int DK>
cudaError_t launch(const void* r, const void* k, const void* v, const float* ld, const float* u,
                   const float* state_in, const void* dout, const float* dstate_out, void* dr,
                   void* dk, void* dv, float* dld, float* du, float* scratch, float* dstate_in,
                   int B, int T, int H, int u_batch, cudaStream_t stream) {
  const int nc = (T + kQ - 1) / kQ, bh = B * H;
  float* sbuf = scratch;
  float* gbuf = sbuf + static_cast<int64_t>(bh) * nc * DK * DK;
  float* du_part = gbuf + static_cast<int64_t>(bh) * nc * DK * DK;
  const TI *rt = static_cast<const TI*>(r), *kt = static_cast<const TI*>(k),
           *vt = static_cast<const TI*>(v), *dot = static_cast<const TI*>(dout);

  auto states = wkv6_bwd_states<TI, DK>;
  constexpr int kStateBytes = StateCfg<TI, DK>::kBytes;
  cudaError_t err =
      cudaFuncSetAttribute(states, cudaFuncAttributeMaxDynamicSharedMemorySize, kStateBytes);
  if (err != cudaSuccess) return err;
  states<<<bh * 2, kThreads, kStateBytes, stream>>>(rt, kt, vt, ld, dot, state_in, dstate_out,
                                                    sbuf, gbuf, dstate_in, T, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto chunk = wkv6_bwd_chunk<TI, DK>;
  constexpr int kChunkBytes = ChunkCfg<TI, DK>::kBytes;
  err = cudaFuncSetAttribute(chunk, cudaFuncAttributeMaxDynamicSharedMemorySize, kChunkBytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(chunk, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  chunk<<<bh * nc, kChunkThreads, kChunkBytes, stream>>>(
      rt, kt, vt, ld, u, dot, sbuf, gbuf, static_cast<TI*>(dr), static_cast<TI*>(dk),
      static_cast<TI*>(dv), dld, du_part, T, H, u_batch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int64_t rows = B / u_batch;
  wkv6_bwd_du<<<blocks_of(rows * H * DK), 256, 0, stream>>>(du_part, du, rows, H, DK, u_batch,
                                                           nc);
  return cudaGetLastError();
}

template <typename TI>
cudaError_t dispatch(int64_t DK, const void* r, const void* k, const void* v, const float* ld,
                     const float* u, const float* state_in, const void* dout,
                     const float* dstate_out, void* dr, void* dk, void* dv, float* dld,
                     float* du, float* scratch, float* dstate_in, int B, int T, int H,
                     int u_batch, cudaStream_t s) {
  switch (DK) {
    case 16:
      return launch<TI, 16>(r, k, v, ld, u, state_in, dout, dstate_out, dr, dk, dv, dld, du,
                            scratch, dstate_in, B, T, H, u_batch, s);
    case 32:
      return launch<TI, 32>(r, k, v, ld, u, state_in, dout, dstate_out, dr, dk, dv, dld, du,
                            scratch, dstate_in, B, T, H, u_batch, s);
    case 64:
      return launch<TI, 64>(r, k, v, ld, u, state_in, dout, dstate_out, dr, dk, dv, dld, du,
                            scratch, dstate_in, B, T, H, u_batch, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// r, k, v, dout, dr, dk, dv: (B, T, H, DK) contiguous, float32 (bf16 == 0) or
// bf16 (bf16 != 0); ld, dld: (B, T, H, DK) float32; u: (B / u_batch, H, DK)
// float32, batch element b reading row b / u_batch; state_in (B, H, DK, DK)
// float32 or null (zero state); dstate_out (B, H, DK, DK) float32 or null (no
// gradient of the final state); du (B / u_batch, H, DK) float32; scratch
// float32 of B H ceil(T / 64) (2 DK^2 + DK) (ops.bwd_scratch: the chunks'
// S_c, G_{c+1} and partials of du); dstate_in (B, H, DK, DK) float32 or null
// (not written).  All 16-byte aligned; DK in {16, 32, 64}.  Launches on
// `stream` (the chunk boundaries, the chunks, then du's sum) and returns the
// launches' cudaError_t (0 on success, cudaErrorInvalidValue or
// cudaErrorMisalignedAddress for arguments it refuses).
extern "C" int wkv6_bwd(const void* r, const void* k, const void* v, const float* ld,
                        const float* u, const float* state_in, const void* dout,
                        const float* dstate_out, void* dr, void* dk, void* dv, float* dld,
                        float* du, float* scratch, float* dstate_in, int64_t B, int64_t T,
                        int64_t H, int64_t DK, int64_t u_batch, int bf16, void* stream) {
  if (B < 1 || T < 1 || H < 1 || u_batch < 1 || B % u_batch != 0 ||
      B * H * ((T + kQ - 1) / kQ) > 0x7fffffff || T > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t ptrs =
      reinterpret_cast<uintptr_t>(r) | reinterpret_cast<uintptr_t>(k) |
      reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(ld) |
      reinterpret_cast<uintptr_t>(u) | reinterpret_cast<uintptr_t>(state_in) |
      reinterpret_cast<uintptr_t>(dout) | reinterpret_cast<uintptr_t>(dstate_out) |
      reinterpret_cast<uintptr_t>(dr) | reinterpret_cast<uintptr_t>(dk) |
      reinterpret_cast<uintptr_t>(dv) | reinterpret_cast<uintptr_t>(dld) |
      reinterpret_cast<uintptr_t>(scratch) | reinterpret_cast<uintptr_t>(dstate_in);
  if (ptrs % 16 != 0) return static_cast<int>(cudaErrorMisalignedAddress);
  auto s = static_cast<cudaStream_t>(stream);
  const int b = static_cast<int>(B), t = static_cast<int>(T), h = static_cast<int>(H),
            ub = static_cast<int>(u_batch);
  const cudaError_t err =
      bf16 ? dispatch<__nv_bfloat16>(DK, r, k, v, ld, u, state_in, dout, dstate_out, dr, dk, dv,
                                     dld, du, scratch, dstate_in, b, t, h, ub, s)
           : dispatch<float>(DK, r, k, v, ld, u, state_in, dout, dstate_out, dr, dk, dv, dld,
                             du, scratch, dstate_in, b, t, h, ub, s);
  return static_cast<int>(err);
}
