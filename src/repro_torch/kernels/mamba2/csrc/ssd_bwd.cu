// Backward of the chunked Mamba2 SSD (ssd.cu), on Hopper (sm_90a): a chunked
// form whose chunk products run on the tensor cores.
//
// The Pallas TPU kernel repro/kernels/mamba2/mamba2.py (`ssd_chunked`) has no
// backward: the reference trains through its jnp chunk scan
// (repro/models/ssm.py:mamba2_apply_chunked), which JAX differentiates.  The
// port runs the forward as a hand-written kernel, so this kernel is its
// backward; ref.ssd_bwd_ref is its plain version (the token recurrence) and
// ref.ssd_bwd_chunked_ref the plain form of this decomposition.
//
// Per (batch b, head h), with the (P x N) state S, chunks of Q = 64 tokens,
// the log-decays l = dt a and, within a chunk, cum their inclusive prefix sum
// (cl its last entry), e_s = exp(cl - cum_s), w_s = dt_s e_s, and
// E[t,s] = exp(cum_t - cum_s) for s <= t (0 above the diagonal): the forward
// gives y_t = sum_{s<=t} E[t,s] (C_t . B_s) dt_s x_s + exp(cum_t) S_c C_t and
// S_{c+1} = exp(cl) S_c + sum_s w_s x_s B_s^T.  Given dy and dS_T:
//
//   1. each chunk's prefix sums cum, by one thread a (b, h, chunk), in order;
//   2. the chunk-start states and chunk-end gradients: for each (b, h) a
//      pass over the T / Q chunks, S_{c+1} = exp(cl) S_c + X^T (B o w) from
//      the state in, and a reverse pass G_c = exp(cl) G_{c+1} + (dY o
//      exp(cum))^T C from dS_T, each chunk's product (a P x Q by Q x N one) on
//      the tensor cores; S_c and G_{c+1} are kept for step 3, and G_0 is dS_0;
//   3. within a chunk (in parallel over (b, h, chunk)), with dAtt = dY X^T:
//        dC  = exp(cum) o (dY S_c) + (dAtt o E o dt_s) B
//        dxr = e o (B G_{c+1}^T) + (E o C B^T)^T dY,   dx = dt o dxr
//        dB  = w o (X G_{c+1}) + (dAtt o E o dt_s)^T C
//      (dB and dC per head), and the log-decays' gradient from those products:
//        dcum_t = C_t . dC_t - dt_t x_t . dxr_t  (the row sums minus the
//                 column sums of dAtt o att, plus the state terms)
//                 + [t = Q - 1] <G_{c+1}, S_{c+1}>,
//        <G_{c+1}, S_{c+1}> = exp(cl) <G_{c+1}, S_c> + sum_s dt_s x_s . (e_s G_{c+1} B_s),
//        dl_t = sum_{t' >= t in the chunk} dcum_t',
//        ddt_t = x_t . dxr_t + a dl_t,  da = sum_t dt_t dl_t;
//   4. dB and dC summed over each group's heads, da over the chunks and the
//      batch elements that share a row of a, by two small kernels.
//
// No running sum spans more than a chunk: dl restarts at every chunk's end
// from the direct inner product, so the cancellation of a sequence-long sum
// (ref.ssd_bwd_ref restarts every 16 tokens for it) does not arise, and every
// exponent is a sum of log-decays cum_t - cum_s with s <= t (or cum_t, cl -
// cum_s, cl), <= 0: no exp(-cum) alone, so a log-decay of -50 a step stays
// finite.  dl is summed within the chunk in a fixed order by one lane, as
// ssd.cu's prefix sums are; no atomics anywhere, so two calls are equal bit
// for bit.
//
// Design:
// - Step 2 takes one block of 8 warps a (b, h) and pass (320 at zamba2's
//   trained shape, B 2 = 2 peers x batch 1, H 80, T 1024), the state's P x N
//   in registers (warp w: rows 16 (w % 4) .., half of the columns at P = N
//   = 64), each chunk's x or dy, B or C, dt and cum staged by cp.async two
//   chunks ahead of the one it computes.
// - Step 3 takes one block of 4 warps a (b, h, chunk), 2,560 there (the token
//   loop ran 160).  It stages the chunk's x, dy, B, C, S_c and G_{c+1} with
//   cp.async, all 64 rows, those past T zero-filled (dt = 0: they change
//   nothing, as the forward's zero padding), x, B and C read in place
//   through the model's (batch, token) strides.  Warp w owns rows 16 w ..
//   16 w + 15 of the chunk twice: as rows t of dAtt (the w + 1 pairs of
//   8-column tiles at or below the diagonal) for dC, and as rows s of the
//   transposed products C B^T and X dY^T (the 4 - w pairs at or above it)
//   for dx and dB, recomputed rather than exchanged through shared memory.
//   Each masked pair is taken into its accumulator at once, as an A operand
//   straight from registers (the accumulator's layout, with the k order
//   permuted, is the A fragment's, as in ssd.cu).  The row tile is a run-time
//   index, not a template argument: four unrolled copies of the code, one a
//   warp, overflowed the instruction cache and ran at half the speed.
// - Products: mma.sync.m16n8k8 TF32 with float32 operands split 3xTF32 and
//   bf16 x, B and C widened exactly (tf32_mma.cuh), as ssd.cu: every product
//   with dy (float32, from the model) or a float32 intermediate takes the
//   split (its low part left to the tensor cores' truncation, `split`); one
//   TF32 pass fails the float32 check (tests/test_torch_ssm_train.py emulates
//   both).  The passes of a product run across a group of tiles (`mma_group`)
//   so that no two on one accumulator are back to back.  Not wgmma: a
//   warpgroup takes a 64-row tile as one, while here each warp's 16 rows take
//   their own share of the masked triangles, kept in registers and handed on
//   as A operands; a wgmma form is left open.
// - Shared memory free of bank conflicts on the fragment loads: bf16 rows
//   with their 16-byte chunks XOR-swizzled by row (ldmatrix); float32 rows of
//   32 or 64 with their 8-float groups XOR-swizzled by (r & 3) ^ ((r >> 2) &
//   1), which serves the float2 row fragments and the scalar column fragments
//   alike (narrower float32 rows padded).  Step 3 at P = N = 64: 75 KB a
//   block with bf16 x, B and C (three blocks an SM), 99 KB in float32 (two).
// - Scratch (ops.bwd_scratch): the chunks' cum, S_c and G_{c+1}, 2 (T / 64)
//   P N float32 a (b, h) (84 MB at zamba2's trained shape, where the token
//   loop kept 165 MB of states), the per-head dB and dC (B, T, H, N) float32
//   and the (B, H, T / 64) partials of da.
//
// Bound on an H100 SXM (chip_smoke.py:ssd_bwd_work, the work of the
// function, whatever computes it): at zamba2's trained shape with bf16 x, B,
// C and a state in, 96 MB read and written once, 0.027 ms at 3.35 TB/s; the
// token recurrence's 8.5 GFLOP would take 0.13 ms on the float32 pipes.  This
// design moves more (its scratch is written and read again) and does more
// (eleven chunk products in 2 or 3 TF32 passes, as many again in step 2's
// and the recomputed transposes); its time is in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_tiles.cuh"

namespace {

constexpr int kQ = 64;  // tokens a chunk (ref.BWD_Q)
constexpr int kWarps = 4;  // one 16-row tile of the chunk each
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

// The chunk's 64 dt (stride H), rows from `valid` on zero.
__device__ __forceinline__ void stage_dt(float* sdt, const float* dt_base, int H, int valid) {
  for (int r = threadIdx.x; r < kQ; r += blockDim.x) {
    const bool ok = r < valid;
    cp_async4(sdt + r, ok ? dt_base + static_cast<int64_t>(r) * H : dt_base, ok);
  }
}

// The byte layout of step 3's dynamic shared memory.
template <typename T, int P, int N>
struct Cfg {
  static constexpr bool kS = sizeof(T) == 4;  // float32 inputs carry a low part
  static constexpr int NS = N < 16 ? 16 : N;  // staged width of B and C
  static constexpr int NT = N / 8, PT = P / 8;  // column tiles of N and of P
  using XT = Op<T, kQ, P>;
  using YT = Op<float, kQ, P>;
  using BT = Op<T, kQ, NS>;
  using ST = Op<float, P, N>;
  // x, dy, B, C, S_c, G_{c+1}, dt, cum, the rows' C . dC, x . dxr and
  // x . (e G B), and the warps' partials of <G, S_c>
  static constexpr int kX = 0, kY = kX + XT::kBytes, kB = kY + YT::kBytes, kC = kB + BT::kBytes,
                       kS0 = kC + BT::kBytes, kG = kS0 + ST::kBytes, kDt = kG + ST::kBytes;
  static constexpr int kGradBytes = kDt + 5 * kQ * 4 + 16;
  // blocks an SM's 228 KB hold (1 KB of it reserved a block), at most 4
  static constexpr int kFit = 233472 / (kGradBytes + 1024);
  static constexpr int kGradBlocks = kFit < 1 ? 1 : kFit < 4 ? kFit : 4;
};

// ------------------------------- steps 1 and 2: the chunk-start states --

// Each chunk's prefix sums of its log-decays, by one thread a (b, h, chunk),
// in order, as ssd.cu sums them (no fused multiply-add); rows past T have
// dt = 0.  Thread e is chunk c of (b, h) for e = (b nc + c) H + h, so a
// warp's loads of one token's dt are contiguous.
__global__ void __launch_bounds__(256)
chunk_cums(const float* __restrict__ dt, const float* __restrict__ a, float* __restrict__ cum,
           int B, int T_len, int H, int a_batch) {
  const int nc = (T_len + kQ - 1) / kQ;
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= static_cast<int64_t>(B) * nc * H) return;
  const int h = static_cast<int>(e % H), c = static_cast<int>(e / H % nc);
  const int b = static_cast<int>(e / (static_cast<int64_t>(H) * nc));
  const float a_h = a[static_cast<int64_t>(b / a_batch) * H + h];
  const int t0 = c * kQ, valid = T_len - t0 < kQ ? T_len - t0 : kQ;
  const float* src = dt + (static_cast<int64_t>(b) * T_len + t0) * H + h;
  float* dst = cum + ((static_cast<int64_t>(b) * H + h) * nc + c) * kQ;
  float v[kQ];
#pragma unroll
  for (int t = 0; t < kQ; ++t) v[t] = t < valid ? src[static_cast<int64_t>(t) * H] : 0.0f;
  float run = 0.0f;
#pragma unroll
  for (int t = 0; t < kQ; t += 4) {
    float4 out;
    run = __fadd_rn(run, __fmul_rn(v[t], a_h));
    out.x = run;
    run = __fadd_rn(run, __fmul_rn(v[t + 1], a_h));
    out.y = run;
    run = __fadd_rn(run, __fmul_rn(v[t + 2], a_h));
    out.z = run;
    run = __fadd_rn(run, __fmul_rn(v[t + 3], a_h));
    out.w = run;
    *reinterpret_cast<float4*>(dst + t) = out;
  }
}

// A block of steps 1-2 owns one (b, h) and one pass: the forward pass (S_c,
// from x and B) or the reverse one (G_{c+1}, from dy and C).  Its byte
// layout: kStages stages of a chunk's x or dy, B or C, dt and prefix sums.
template <typename T, int P, int N>
struct StateCfg {
  static constexpr int NS = N < 16 ? 16 : N;
  using XT = Op<T, kQ, P>;
  using YT = Op<float, kQ, P>;
  using BT = Op<T, kQ, NS>;
  static constexpr int kB = YT::kBytes, kDt = kB + BT::kBytes, kCum = kDt + kQ * 4;
  static constexpr int kStages = 3;  // chunks in flight: two staged ahead of the one computed
  static constexpr int kStage = kCum + kQ * 4, kBytes = kStages * kStage;
  // 8 warps: row tiles of P, and groups of the state's column tiles
  static constexpr int kWarps = 8, kRowTiles = P / 16, kGroups = kWarps / kRowTiles;
  static constexpr int NT = N / 8, NTW = NT < kGroups ? 1 : NT / kGroups;
};

// Steps 1 and 2 for one (b, h): chunk by chunk, U_c (or L_c) on the tensor
// cores, then S_{c+1} = exp(cl) S_c + U_c (G_c = exp(cl) G_{c+1} + L_c) in
// registers, S_c (G_{c+1}) written; the next two chunks' operands are
// staged while one computes.  Warp w owns state rows 16 (w % R) .. and column tiles
// NTW (w / R) .. (R row tiles of P).
template <typename T, int P, int N>
__global__ void __launch_bounds__(256, 3)
chunk_states(const T* __restrict__ x, const T* __restrict__ bm, const T* __restrict__ cm,
             const float* __restrict__ dt, const float* __restrict__ dy,
             const float* __restrict__ state_in, const float* __restrict__ dstate_out,
             const float* __restrict__ cum, float* __restrict__ sbuf, float* __restrict__ gbuf,
             float* __restrict__ dstate_in, int T_len, int H, int G, int64_t x_sb, int64_t x_st,
             int64_t b_sb, int64_t b_st, int64_t c_sb, int64_t c_st) {
  using C = StateCfg<T, P, N>;
  constexpr bool kS = sizeof(T) == 4;
  constexpr int NTW = C::NTW;
  extern __shared__ __align__(16) unsigned char smem[];
  const int reverse = blockIdx.x & 1, bh = blockIdx.x >> 1;
  const int b = bh / H, h = bh - b * H, grp = h / (H / G);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gi = lane >> 2, tq = lane & 3;
  const int p0 = 16 * (warp % C::kRowTiles), n0 = 8 * NTW * (warp / C::kRowTiles);
  const bool owner = n0 < N;
  const int nc = (T_len + kQ - 1) / kQ;
  const int64_t bth = static_cast<int64_t>(b) * T_len * H + h;  // (b, 0, h) of (B, T, H)
  const int64_t st_off = static_cast<int64_t>(bh) * P * N;
  float* out = (reverse ? gbuf : sbuf) + static_cast<int64_t>(bh) * nc * P * N;

  // the chunk of step i, staged into stage i % kStages
  auto stage_step = [&](int i) {
    const int c = reverse ? nc - 1 - i : i;
    unsigned char* buf = smem + (i % C::kStages) * C::kStage;
    const int t0 = c * kQ, valid = T_len - t0 < kQ ? T_len - t0 : kQ;
    if (reverse) {
      stage<typename C::YT>(buf, dy + (bth + static_cast<int64_t>(t0) * H) * P,
                            static_cast<int64_t>(H) * P, kQ, P, valid);
      stage<typename C::BT>(buf + C::kB,
                            cm + b * c_sb + t0 * c_st + static_cast<int64_t>(grp) * N, c_st, kQ,
                            N, valid);
    } else {
      stage<typename C::XT>(buf, x + b * x_sb + t0 * x_st + static_cast<int64_t>(h) * P, x_st,
                            kQ, P, valid);
      stage<typename C::BT>(buf + C::kB,
                            bm + b * b_sb + t0 * b_st + static_cast<int64_t>(grp) * N, b_st, kQ,
                            N, valid);
    }
    stage_dt(reinterpret_cast<float*>(buf + C::kDt), dt + bth + static_cast<int64_t>(t0) * H,
             H, valid);
    stage<Op<float, 1, kQ>>(buf + C::kCum, cum + (static_cast<int64_t>(bh) * nc + c) * kQ, kQ,
                            1, kQ, 1);
    cp_async_commit();
  };

  // the state's entries of this thread: rows p0 + gi (+ 8), columns
  // n0 + 8 i + 2 tq (+ 1)
  float s[NTW][4];
  const float* init = reverse ? dstate_out : state_in;
#pragma unroll
  for (int i = 0; i < NTW; ++i) {
    const int n = n0 + 8 * i + 2 * tq;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int64_t at = st_off + (p0 + gi + 8 * (e >> 1)) * N + n + (e & 1);
      s[i][e] = init != nullptr && owner ? init[at] : 0.0f;
    }
  }
  stage_step(0);
  if (nc > 1) stage_step(1);
  for (int step = 0; step < nc; ++step) {
    const int c = reverse ? nc - 1 - step : step;
    if (step + 2 < nc) {
      stage_step(step + 2);
      cp_async_wait_group<2>();
    } else if (step + 1 < nc) {
      cp_async_wait_group<1>();
    } else {
      cp_async_wait_group<0>();
    }
    __syncthreads();  // chunk c staged
    const unsigned char* buf = smem + (step % C::kStages) * C::kStage;
    const float* s_dt = reinterpret_cast<const float*>(buf + C::kDt);
    const float* s_cum = reinterpret_cast<const float*>(buf + C::kCum);
    if (owner) {
      const float cl = s_cum[kQ - 1], decay = expf(cl);
      float acc[NTW][4];
#pragma unroll
      for (int i = 0; i < NTW; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
      const typename C::BT bs{reinterpret_cast<const T*>(buf + C::kB)};
      // U = X^T (B o w) or L = (dY o exp(cum))^T C: rows p, k over the
      // chunk's rows, columns n; the float32 factor on the operand that is
      // float32 already (bf16 x, B and C stay exact: two TF32 passes)
#pragma unroll 2
      for (int k0 = 0; k0 < kQ; k0 += 8) {
        const int r = k0 + 2 * tq;  // the fragments' rows r and r + 1
        float av[4], bv[NTW][2];
        bs.template cols_b<NTW>(bv, k0, n0);
        Parts<2> bp[NTW];
        if (reverse) {
          const float f0 = expf(s_cum[r]), f1 = expf(s_cum[r + 1]);
          const typename C::YT ys{reinterpret_cast<const float*>(buf)};
          ys.cols_a(av, k0, p0);
          av[0] *= f0;
          av[1] *= f0;
          av[2] *= f1;
          av[3] *= f1;
#pragma unroll
          for (int i = 0; i < NTW; ++i) bp[i] = split<kS>(bv[i]);
          mma_group<true, kS, NTW>(acc, split<true>(av), bp);
        } else {
          const float f0 = s_dt[r] * expf(cl - s_cum[r]);
          const float f1 = s_dt[r + 1] * expf(cl - s_cum[r + 1]);
#pragma unroll
          for (int i = 0; i < NTW; ++i) {
            const float sv[2] = {bv[i][0] * f0, bv[i][1] * f1};
            bp[i] = split<true>(sv);
          }
          const typename C::XT xs{reinterpret_cast<const T*>(buf)};
          xs.cols_a(av, k0, p0);
          mma_group<kS, true, NTW>(acc, split<kS>(av), bp);
        }
      }
#pragma unroll
      for (int i = 0; i < NTW; ++i) {
        const int n = n0 + 8 * i + 2 * tq;
        float* slot = out + static_cast<int64_t>(c) * P * N + (p0 + gi) * N + n;
        *reinterpret_cast<float2*>(slot) = make_float2(s[i][0], s[i][1]);
        *reinterpret_cast<float2*>(slot + 8 * N) = make_float2(s[i][2], s[i][3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][e] = decay * s[i][e] + acc[i][e];
      }
    }
    __syncthreads();  // the stage is free
  }
  if (reverse && owner && dstate_in != nullptr) {
#pragma unroll
    for (int i = 0; i < NTW; ++i) {
      const int n = n0 + 8 * i + 2 * tq;
      float* at = dstate_in + st_off + (p0 + gi) * N + n;
      *reinterpret_cast<float2*>(at) = make_float2(s[i][0], s[i][1]);
      *reinterpret_cast<float2*>(at + 8 * N) = make_float2(s[i][2], s[i][3]);
    }
  }
}

// ------------------------------------------ step 3: within every chunk --

// What a warp of step 3 reads and writes.
template <typename T, int P, int N>
struct Chunk {
  typename Cfg<T, P, N>::XT xs;
  typename Cfg<T, P, N>::YT ys;
  typename Cfg<T, P, N>::BT bs, cs;
  typename Cfg<T, P, N>::ST ss, gs;  // S_c, G_{c+1}
  const float *dt, *cum;
  float *cdc, *xdxr, *xst;  // per row: C . dC, x . dxr, x . (e G B)
  T* dx;                    // (b, t0, h, 0) of dx
  float *db, *dc;           // (b, t0, h, 0) of the per-head dB, dC
  int64_t x_st, bc_st;      // their token strides: H P, H N
  int valid;                // rows of the chunk before T
};

// the masked factor of a Q x Q tile entry, 0 where the pair is not causal
__device__ __forceinline__ float causal(bool live, float v) { return live ? v : 0.0f; }

// The A fragment of a product whose k runs over the columns of an
// accumulator tile (the k order permuted, as ssd.cu's att x), split
__device__ __forceinline__ Parts<4> acc_as_a(const float (&d)[4]) {
  const float av[4] = {d[0], d[2], d[1], d[3]};
  return split<true>(av);
}

// Rows 16 w .. 16 w + 15 of the chunk (w the warp) as rows t:
// dC = exp(cum) o (dY S_c) + (dAtt o E o dt_s) B, stored, and C . dC.  The
// masked dAtt is made a pair of 8-column tiles at a time, at or below the
// diagonal (w + 1 pairs), and each pair is taken into dC at once.
template <typename T, int P, int N>
__device__ __forceinline__ void rows_dc(const Chunk<T, P, N>& k, int w) {
  using C = Cfg<T, P, N>;
  constexpr bool kS = C::kS;
  constexpr int NT = C::NT, NQ = NT < 4 ? NT : 4;
  const int lane = threadIdx.x & 31, gi = lane >> 2, tq = lane & 3;
  const int r0 = 16 * w, ta = r0 + gi, tb = ta + 8;
  float acc[NT][4];
#pragma unroll
  for (int q = 0; q < NT; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[q][e] = 0.0f;
  // dY S_c
#pragma unroll 2
  for (int k0 = 0; k0 < P; k0 += 8) {
    float av[4];
    k.ys.rows_a(av, r0, k0);
    const Parts<4> af = split<true>(av);
#pragma unroll
    for (int q0 = 0; q0 < NT; q0 += NQ) {
      float sv[NQ][2];
      k.ss.template cols_b<NQ>(sv, k0, 8 * q0);
      Parts<2> bp[NQ];
#pragma unroll
      for (int q = 0; q < NQ; ++q) bp[q] = split<true>(sv[q]);
      mma_group<true, true, NQ>(acc + q0, af, bp);
    }
  }
  const float cta = k.cum[ta], ctb = k.cum[tb];
  const float ea = expf(cta), eb = expf(ctb);
#pragma unroll
  for (int q = 0; q < NT; ++q) {
    acc[q][0] *= ea;
    acc[q][1] *= ea;
    acc[q][2] *= eb;
    acc[q][3] *= eb;
  }
  for (int jp = 0; jp <= w; ++jp) {
    float d[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) d[i][e] = 0.0f;
    // dAtt = dY X^T on columns s = 16 jp .. 16 jp + 15
#pragma unroll 2
    for (int k0 = 0; k0 < P; k0 += 8) {
      float av[4];
      k.ys.rows_a(av, r0, k0);
      const Parts<4> af = split<true>(av);
      Parts<2> bp[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float bv[2];
        k.xs.rows_b(bv, 16 * jp + 8 * i, k0);
        bp[i] = split<kS>(bv);
      }
      mma_group<true, kS, 2>(d, af, bp);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int s = 16 * jp + 8 * i + 2 * tq;
      const float2 cs = *reinterpret_cast<const float2*>(k.cum + s);
      const float2 ds = *reinterpret_cast<const float2*>(k.dt + s);
      d[i][0] = causal(s <= ta, d[i][0] * ex2((cta - cs.x) * kLog2e) * ds.x);
      d[i][1] = causal(s + 1 <= ta, d[i][1] * ex2((cta - cs.y) * kLog2e) * ds.y);
      d[i][2] = causal(s <= tb, d[i][2] * ex2((ctb - cs.x) * kLog2e) * ds.x);
      d[i][3] = causal(s + 1 <= tb, d[i][3] * ex2((ctb - cs.y) * kLog2e) * ds.y);
    }
    // + (dAtt o E o dt_s) B over these 16 s
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const Parts<4> af = acc_as_a(d[i]);
#pragma unroll
      for (int q0 = 0; q0 < NT; q0 += NQ) {
        float bv[NQ][2];
        k.bs.template cols_b<NQ>(bv, 16 * jp + 8 * i, 8 * q0);
        Parts<2> bp[NQ];
#pragma unroll
        for (int q = 0; q < NQ; ++q) bp[q] = split<kS>(bv[q]);
        mma_group<true, kS, NQ>(acc + q0, af, bp);
      }
    }
  }
  float ca = 0.0f, cb = 0.0f;
#pragma unroll
  for (int q = 0; q < NT; ++q) {
    const int n = 8 * q + 2 * tq;
    ca = fmaf(k.cs.at(ta, n), acc[q][0], ca);
    ca = fmaf(k.cs.at(ta, n + 1), acc[q][1], ca);
    cb = fmaf(k.cs.at(tb, n), acc[q][2], cb);
    cb = fmaf(k.cs.at(tb, n + 1), acc[q][3], cb);
    if (ta < k.valid) store2(k.dc + ta * k.bc_st + n, acc[q][0], acc[q][1]);
    if (tb < k.valid) store2(k.dc + tb * k.bc_st + n, acc[q][2], acc[q][3]);
  }
  ca = quad_sum(ca);
  cb = quad_sum(cb);
  if (tq == 0) {
    k.cdc[ta] = ca;
    k.cdc[tb] = cb;
  }
}

// A pair of 8-column tiles (t = 16 jp ..) of rows s = 16 w .. at or above
// the diagonal, times exp(cum_t - cum_s) (and dt_s with kDt), 0 for t < s.
template <bool kDt>
__device__ __forceinline__ void mask_upper(float (&m)[2][4], int w, int jp, const float* cum,
                                           const float* dt) {
  const int lane = threadIdx.x & 31, gi = lane >> 2, tq = lane & 3;
  const int sa = 16 * w + gi, sb = sa + 8;
  const float csa = cum[sa], csb = cum[sb];
  const float da = kDt ? dt[sa] : 1.0f, db = kDt ? dt[sb] : 1.0f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = 16 * jp + 8 * i + 2 * tq;
    const float2 ct = *reinterpret_cast<const float2*>(cum + t);
    m[i][0] = causal(t >= sa, m[i][0] * ex2((ct.x - csa) * kLog2e) * da);
    m[i][1] = causal(t + 1 >= sa, m[i][1] * ex2((ct.y - csa) * kLog2e) * da);
    m[i][2] = causal(t >= sb, m[i][2] * ex2((ct.x - csb) * kLog2e) * db);
    m[i][3] = causal(t + 1 >= sb, m[i][3] * ex2((ct.y - csb) * kLog2e) * db);
  }
}

// Rows 16 w .. 16 w + 15 as rows s: dxr = e o (B G^T) + (E o C B^T)^T dY,
// dx = dt o dxr stored, x . (e G B) and x . dxr; the masked C B^T a pair of
// tiles at a time, at or above the diagonal (4 - w pairs).
template <typename T, int P, int N>
__device__ __forceinline__ void rows_dx(const Chunk<T, P, N>& k, int w) {
  using C = Cfg<T, P, N>;
  constexpr bool kS = C::kS;
  constexpr int PT = C::PT, PQ = PT < 4 ? PT : 4;
  const int lane = threadIdx.x & 31, gi = lane >> 2, tq = lane & 3;
  const int r0 = 16 * w, sa = r0 + gi, sb = sa + 8;
  float acc[PT][4];
#pragma unroll
  for (int q = 0; q < PT; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[q][e] = 0.0f;
  // B G^T: k over n, column tile q of P reads rows 8 q .. of G
#pragma unroll
  for (int k0 = 0; k0 < N; k0 += 8) {
    float av[4];
    k.bs.rows_a(av, r0, k0);
    const Parts<4> af = split<kS>(av);
#pragma unroll
    for (int q0 = 0; q0 < PT; q0 += PQ) {
      Parts<2> bp[PQ];
#pragma unroll
      for (int q = 0; q < PQ; ++q) {
        float gv[2];
        k.gs.rows_b(gv, 8 * (q0 + q), k0);
        bp[q] = split<true>(gv);
      }
      mma_group<kS, true, PQ>(acc + q0, af, bp);
    }
  }
  const float cl = k.cum[kQ - 1];
  const float ea = expf(cl - k.cum[sa]), eb = expf(cl - k.cum[sb]);
  float xa = 0.0f, xb = 0.0f;
#pragma unroll
  for (int q = 0; q < PT; ++q) {
    const int p = 8 * q + 2 * tq;
    acc[q][0] *= ea;
    acc[q][1] *= ea;
    acc[q][2] *= eb;
    acc[q][3] *= eb;
    xa = fmaf(k.xs.at(sa, p), acc[q][0], xa);
    xa = fmaf(k.xs.at(sa, p + 1), acc[q][1], xa);
    xb = fmaf(k.xs.at(sb, p), acc[q][2], xb);
    xb = fmaf(k.xs.at(sb, p + 1), acc[q][3], xb);
  }
  xa = quad_sum(xa);
  xb = quad_sum(xb);
  if (tq == 0) {
    k.xst[sa] = xa;
    k.xst[sb] = xb;
  }
  for (int jp = w; jp < 4; ++jp) {
    float m[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) m[i][e] = 0.0f;
    // B C^T on columns t = 16 jp .. 16 jp + 15
#pragma unroll
    for (int k0 = 0; k0 < N; k0 += 8) {
      float av[4];
      k.bs.rows_a(av, r0, k0);
      const Parts<4> af = split<kS>(av);
      Parts<2> bp[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float cv[2];
        k.cs.rows_b(cv, 16 * jp + 8 * i, k0);
        bp[i] = split<kS>(cv);
      }
      mma_group<kS, kS, 2>(m, af, bp);
    }
    mask_upper<false>(m, w, jp, k.cum, k.dt);
    // + (E o C B^T)^T dY over these 16 t
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const Parts<4> af = acc_as_a(m[i]);
#pragma unroll
      for (int q0 = 0; q0 < PT; q0 += PQ) {
        float yv[PQ][2];
        k.ys.template cols_b<PQ>(yv, 16 * jp + 8 * i, 8 * q0);
        Parts<2> bp[PQ];
#pragma unroll
        for (int q = 0; q < PQ; ++q) bp[q] = split<true>(yv[q]);
        mma_group<true, true, PQ>(acc + q0, af, bp);
      }
    }
  }
  const float da = k.dt[sa], db = k.dt[sb];
  xa = 0.0f;
  xb = 0.0f;
#pragma unroll
  for (int q = 0; q < PT; ++q) {
    const int p = 8 * q + 2 * tq;
    xa = fmaf(k.xs.at(sa, p), acc[q][0], xa);
    xa = fmaf(k.xs.at(sa, p + 1), acc[q][1], xa);
    xb = fmaf(k.xs.at(sb, p), acc[q][2], xb);
    xb = fmaf(k.xs.at(sb, p + 1), acc[q][3], xb);
    if (sa < k.valid) store2(k.dx + sa * k.x_st + p, da * acc[q][0], da * acc[q][1]);
    if (sb < k.valid) store2(k.dx + sb * k.x_st + p, db * acc[q][2], db * acc[q][3]);
  }
  xa = quad_sum(xa);
  xb = quad_sum(xb);
  if (tq == 0) {
    k.xdxr[sa] = xa;
    k.xdxr[sb] = xb;
  }
}

// Rows 16 w .. 16 w + 15 as rows s: dB = w o (X G) + (E o dt_s o X dY^T) C,
// stored (per head); the masked X dY^T a pair of tiles at a time.
template <typename T, int P, int N>
__device__ __forceinline__ void rows_db(const Chunk<T, P, N>& k, int w) {
  using C = Cfg<T, P, N>;
  constexpr bool kS = C::kS;
  constexpr int NT = C::NT, NQ = NT < 4 ? NT : 4;
  const int lane = threadIdx.x & 31, gi = lane >> 2, tq = lane & 3;
  const int r0 = 16 * w, sa = r0 + gi, sb = sa + 8;
  float acc[NT][4];
#pragma unroll
  for (int q = 0; q < NT; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[q][e] = 0.0f;
  // X G
#pragma unroll 2
  for (int k0 = 0; k0 < P; k0 += 8) {
    float av[4];
    k.xs.rows_a(av, r0, k0);
    const Parts<4> af = split<kS>(av);
#pragma unroll
    for (int q0 = 0; q0 < NT; q0 += NQ) {
      float gv[NQ][2];
      k.gs.template cols_b<NQ>(gv, k0, 8 * q0);
      Parts<2> bp[NQ];
#pragma unroll
      for (int q = 0; q < NQ; ++q) bp[q] = split<true>(gv[q]);
      mma_group<kS, true, NQ>(acc + q0, af, bp);
    }
  }
  const float cl = k.cum[kQ - 1];
  const float wa = k.dt[sa] * expf(cl - k.cum[sa]), wb = k.dt[sb] * expf(cl - k.cum[sb]);
#pragma unroll
  for (int q = 0; q < NT; ++q) {
    acc[q][0] *= wa;
    acc[q][1] *= wa;
    acc[q][2] *= wb;
    acc[q][3] *= wb;
  }
  for (int jp = w; jp < 4; ++jp) {
    float m[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) m[i][e] = 0.0f;
    // X dY^T on columns t = 16 jp .. 16 jp + 15
#pragma unroll 2
    for (int k0 = 0; k0 < P; k0 += 8) {
      float av[4];
      k.xs.rows_a(av, r0, k0);
      const Parts<4> af = split<kS>(av);
      Parts<2> bp[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float yv[2];
        k.ys.rows_b(yv, 16 * jp + 8 * i, k0);
        bp[i] = split<true>(yv);
      }
      mma_group<kS, true, 2>(m, af, bp);
    }
    mask_upper<true>(m, w, jp, k.cum, k.dt);
    // + (E o dt_s o X dY^T) C over these 16 t
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const Parts<4> af = acc_as_a(m[i]);
#pragma unroll
      for (int q0 = 0; q0 < NT; q0 += NQ) {
        float cv[NQ][2];
        k.cs.template cols_b<NQ>(cv, 16 * jp + 8 * i, 8 * q0);
        Parts<2> bp[NQ];
#pragma unroll
        for (int q = 0; q < NQ; ++q) bp[q] = split<kS>(cv[q]);
        mma_group<true, kS, NQ>(acc + q0, af, bp);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < NT; ++q) {
    const int n = 8 * q + 2 * tq;
    if (sa < k.valid) store2(k.db + sa * k.bc_st + n, acc[q][0], acc[q][1]);
    if (sb < k.valid) store2(k.db + sb * k.bc_st + n, acc[q][2], acc[q][3]);
  }
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(kThreads, (Cfg<T, P, N>::kGradBlocks))
chunk_grad(const T* __restrict__ x, const T* __restrict__ bm, const T* __restrict__ cm,
           const float* __restrict__ dt, const float* __restrict__ a,
           const float* __restrict__ dy, const float* __restrict__ cum,
           const float* __restrict__ sbuf, const float* __restrict__ gbuf, T* __restrict__ dx,
           float* __restrict__ db_part, float* __restrict__ dc_part, float* __restrict__ ddt,
           float* __restrict__ da_part, int T_len, int H, int G, int a_batch, int64_t x_sb,
           int64_t x_st, int64_t b_sb, int64_t b_st, int64_t c_sb, int64_t c_st) {
  using C = Cfg<T, P, N>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_dt = reinterpret_cast<float*>(smem + C::kDt);
  float* s_cum = s_dt + kQ;
  float* s_cdc = s_cum + kQ;
  float* s_xdxr = s_cdc + kQ;
  float* s_xst = s_xdxr + kQ;
  float* s_red = s_xst + kQ;
  const int nc = (T_len + kQ - 1) / kQ;
  const int bh = blockIdx.x / nc, ch = blockIdx.x - bh * nc;
  const int b = bh / H, h = bh - b * H, grp = h / (H / G);
  const int t0 = ch * kQ, valid = T_len - t0 < kQ ? T_len - t0 : kQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float a_h = a[static_cast<int64_t>(b / a_batch) * H + h];
  const int64_t bth = static_cast<int64_t>(b) * T_len * H + h;  // (b, 0, h) of (B, T, H)
  const int64_t tok = bth + static_cast<int64_t>(t0) * H;       // (b, t0, h)
  const int64_t blk = static_cast<int64_t>(blockIdx.x);

  stage<typename C::XT>(smem + C::kX, x + b * x_sb + t0 * x_st + static_cast<int64_t>(h) * P,
                        x_st, kQ, P, valid);
  stage<typename C::YT>(smem + C::kY, dy + tok * P, static_cast<int64_t>(H) * P, kQ, P, valid);
  stage<typename C::BT>(smem + C::kB, bm + b * b_sb + t0 * b_st + static_cast<int64_t>(grp) * N,
                        b_st, kQ, N, valid);
  stage<typename C::BT>(smem + C::kC, cm + b * c_sb + t0 * c_st + static_cast<int64_t>(grp) * N,
                        c_st, kQ, N, valid);
  stage<typename C::ST>(smem + C::kS0, sbuf + blk * P * N, N, P, N, P);
  stage<typename C::ST>(smem + C::kG, gbuf + blk * P * N, N, P, N, P);
  stage_dt(s_dt, dt + tok, H, valid);
  stage<Op<float, 1, kQ>>(reinterpret_cast<unsigned char*>(s_cum), cum + blk * kQ, kQ, 1, kQ,
                          1);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  const Chunk<T, P, N> k{{reinterpret_cast<const T*>(smem + C::kX)},
                         {reinterpret_cast<const float*>(smem + C::kY)},
                         {reinterpret_cast<const T*>(smem + C::kB)},
                         {reinterpret_cast<const T*>(smem + C::kC)},
                         {reinterpret_cast<const float*>(smem + C::kS0)},
                         {reinterpret_cast<const float*>(smem + C::kG)},
                         s_dt,
                         s_cum,
                         s_cdc,
                         s_xdxr,
                         s_xst,
                         dx + tok * P,
                         db_part + tok * N,
                         dc_part + tok * N,
                         static_cast<int64_t>(H) * P,
                         static_cast<int64_t>(H) * N,
                         valid};
  {  // the warps' partials of <G_{c+1}, S_c>, each thread's entries in order
    float f = 0.0f;
    for (int e = tid; e < P * N; e += kThreads) {
      const int r = e / N, c = e - r * N;
      f = fmaf(k.gs.at(r, c), k.ss.at(r, c), f);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) f += __shfl_xor_sync(kFull, f, o);
    if (lane == 0) s_red[warp] = f;
  }
  rows_dc<T, P, N>(k, warp);
  rows_dx<T, P, N>(k, warp);
  rows_db<T, P, N>(k, warp);
  __syncthreads();
  if (tid == 0) {  // the chunk's log-decay gradient, in order by one lane
    const float cl = s_cum[kQ - 1];
    float run = expf(cl) * (((s_red[0] + s_red[1]) + s_red[2]) + s_red[3]);
    for (int s = 0; s < kQ; ++s) run = fmaf(s_dt[s], s_xst[s], run);  // <G, S_{c+1}>
    float da = 0.0f;
    float* ddt_base = ddt + tok;
    for (int t = kQ - 1; t >= 0; --t) {
      run += s_cdc[t] - s_dt[t] * s_xdxr[t];
      if (t < valid) ddt_base[static_cast<int64_t>(t) * H] = fmaf(a_h, run, s_xdxr[t]);
      da = fmaf(s_dt[t], run, da);
    }
    da_part[blk] = da;
  }
}

// ------------------------------------------------------ step 4: the sums --

// out (B, T, G, N) in TO = the sum over each group's H / G heads of part
// (B, T, H, N), in head order
template <typename TO>
__global__ void group_reduce(const float* __restrict__ part, TO* __restrict__ out,
                             int64_t rows, int G, int per, int N) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= rows * G * N) return;
  const int64_t bt = e / (static_cast<int64_t>(G) * N);
  const int g = static_cast<int>(e / N % G), n = static_cast<int>(e % N);
  const float* src = part + (bt * G * per + static_cast<int64_t>(g) * per) * N + n;
  float s = 0.0f;
  for (int j = 0; j < per; ++j) s += src[static_cast<int64_t>(j) * N];
  if constexpr (sizeof(TO) == 2) {
    out[e] = __float2bfloat16_rn(s);
  } else {
    out[e] = s;
  }
}

// da (B / a_batch, H) = the sum of the chunk partials (B, H, nc) of the batch
// elements that share each row, in batch then chunk order
__global__ void da_reduce(const float* __restrict__ da_part, float* __restrict__ da,
                          int64_t rows, int H, int a_batch, int nc) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= rows * H) return;
  const int64_t g = e / H, h = e - g * H;
  float s = 0.0f;
  for (int j = 0; j < a_batch; ++j) {
    const float* src = da_part + ((g * a_batch + j) * H + h) * nc;
    for (int c = 0; c < nc; ++c) s += src[c];
  }
  da[e] = s;
}

unsigned blocks_of(int64_t n) { return static_cast<unsigned>((n + 255) / 256); }

template <typename T, int P, int N>
cudaError_t launch(const void* x, const void* bm, const void* cm, const float* dt,
                   const float* a, const float* state_in, const float* dy,
                   const float* dstate_out, void* dx, void* db, void* dc, float* ddt, float* da,
                   float* db_part, float* dc_part, float* da_part, float* ckpt,
                   float* dstate_in, int B, int T_len, int H, int G, int a_batch,
                   const int64_t* st,
                   cudaStream_t stream) {
  using C = Cfg<T, P, N>;
  const int nc = (T_len + kQ - 1) / kQ, bh = B * H;
  float* cum = ckpt;
  float* sbuf = cum + static_cast<int64_t>(bh) * nc * kQ;
  float* gbuf = sbuf + static_cast<int64_t>(bh) * nc * P * N;
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(bm);
  const T* ct = static_cast<const T*>(cm);

  chunk_cums<<<blocks_of(static_cast<int64_t>(B) * nc * H), 256, 0, stream>>>(dt, a, cum, B,
                                                                              T_len, H, a_batch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto states = chunk_states<T, P, N>;
  constexpr int kStateBytes = StateCfg<T, P, N>::kBytes;
  err = cudaFuncSetAttribute(states, cudaFuncAttributeMaxDynamicSharedMemorySize, kStateBytes);
  if (err != cudaSuccess) return err;
  states<<<bh * 2, 256, kStateBytes, stream>>>(xt, bt, ct, dt, dy, state_in, dstate_out, cum,
                                               sbuf, gbuf, dstate_in, T_len, H, G, st[0], st[1],
                                               st[2], st[3], st[4], st[5]);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto grad = chunk_grad<T, P, N>;
  err = cudaFuncSetAttribute(grad, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kGradBytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(grad, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  grad<<<bh * nc, kThreads, C::kGradBytes, stream>>>(
      xt, bt, ct, dt, a, dy, cum, sbuf, gbuf, static_cast<T*>(dx), db_part, dc_part, ddt,
      da_part, T_len, H, G, a_batch, st[0], st[1], st[2], st[3], st[4], st[5]);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int64_t rows = static_cast<int64_t>(B) * T_len;
  group_reduce<T><<<blocks_of(rows * G * N), 256, 0, stream>>>(db_part, static_cast<T*>(db),
                                                                 rows, G, H / G, N);
  group_reduce<T><<<blocks_of(rows * G * N), 256, 0, stream>>>(dc_part, static_cast<T*>(dc),
                                                                 rows, G, H / G, N);
  da_reduce<<<blocks_of(static_cast<int64_t>(B / a_batch) * H), 256, 0, stream>>>(
      da_part, da, B / a_batch, H, a_batch, nc);
  return cudaGetLastError();
}

template <int P, int N>
cudaError_t launch_typed(int dtype, const void* x, const void* bm, const void* cm,
                         const float* dt, const float* a, const float* state_in, const float* dy,
                         const float* dstate_out, void* dx, void* db, void* dc, float* ddt,
                         float* da, float* db_part, float* dc_part, float* da_part,
                         float* ckpt, float* dstate_in, int B, int T, int H, int G, int a_batch,
                         const int64_t* st, cudaStream_t s) {
  if (dtype == 0)
    return launch<float, P, N>(x, bm, cm, dt, a, state_in, dy, dstate_out, dx, db, dc, ddt, da,
                               db_part, dc_part, da_part, ckpt, dstate_in, B, T, H, G, a_batch,
                               st, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, P, N>(x, bm, cm, dt, a, state_in, dy, dstate_out, dx, db, dc,
                                       ddt, da, db_part, dc_part, da_part, ckpt, dstate_in, B, T,
                                       H, G, a_batch, st, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// x (B, T, H, P), bm and cm (B, T, G, N): float32 (dtype 0) or bfloat16
// (dtype 1), each token's (H, P) / (G, N) block contiguous, read through the
// (batch, token) element strides x_sb, x_st, b_sb, b_st, c_sb, c_st given in
// `strides`, 16-byte aligned (pointers and strides in bytes); dt (B, T, H)
// float32 contiguous; a (B / a_batch, H) float32, batch element b reading row
// b / a_batch; state_in (B, H, P, N) float32 or null (zero state); dy (B, T,
// H, P) float32 contiguous; dstate_out (B, H, P, N) float32 or null (no
// gradient of the final state).  Writes dx (B, T, H, P) in x's type, db and
// dc (B, T, G, N) in bm's type, ddt (B, T, H) and da (B / a_batch, H)
// float32, and dstate_in (B, H, P, N) float32 unless null; db_part and
// dc_part (B, T, H, N), da_part (B H ceil(T / 64)) and ckpt (B H ceil(T /
// 64) (64 + 2 P N): the chunks' cum, S_c and G_{c+1}) are float32 scratch.
// All outputs contiguous; G divides H.  Launches on `stream` (the three chunk
// kernels, then the three sums) and returns the launches' cudaError_t (0 on
// success, cudaErrorInvalidValue or cudaErrorMisalignedAddress for arguments
// it refuses).
extern "C" int ssd_bwd(const void* x, const void* bm, const void* cm, const float* dt,
                       const float* a, const float* state_in, const float* dy,
                       const float* dstate_out, void* dx, void* db, void* dc, float* ddt,
                       float* da, float* db_part, float* dc_part, float* da_part, float* ckpt,
                       float* dstate_in, int64_t dtype, int64_t B, int64_t T, int64_t H,
                       int64_t G, int64_t P, int64_t N, int64_t a_batch, const int64_t* strides,
                       void* stream) {
  if (B < 1 || T < 1 || H < 1 || G < 1 || H % G != 0 || a_batch < 1 || B % a_batch != 0 ||
      B * H * ((T + kQ - 1) / kQ) > 0x7fffffff || T > 0x7fffffff || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t es = dtype == 1 ? 2 : 4;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(bm) |
                         reinterpret_cast<uintptr_t>(cm) | reinterpret_cast<uintptr_t>(dy) |
                         reinterpret_cast<uintptr_t>(ckpt) | reinterpret_cast<uintptr_t>(state_in) |
                         reinterpret_cast<uintptr_t>(dstate_out) |
                         reinterpret_cast<uintptr_t>(dstate_in);
  bool aligned = ptrs % 16 == 0;
  for (int i = 0; i < 6; ++i) aligned = aligned && (strides[i] * es) % 16 == 0;
  if (!aligned) return static_cast<int>(cudaErrorMisalignedAddress);
  auto s = static_cast<cudaStream_t>(stream);
  const int b = static_cast<int>(B), t = static_cast<int>(T), h = static_cast<int>(H),
            g = static_cast<int>(G), ab = static_cast<int>(a_batch), d = static_cast<int>(dtype);
  switch (P * 1000 + N) {
    case 64064:
      return static_cast<int>(launch_typed<64, 64>(d, x, bm, cm, dt, a, state_in, dy, dstate_out,
                                                   dx, db, dc, ddt, da, db_part, dc_part,
                                                   da_part, ckpt, dstate_in, b, t, h, g, ab,
                                                   strides, s));
    case 64032:
      return static_cast<int>(launch_typed<64, 32>(d, x, bm, cm, dt, a, state_in, dy, dstate_out,
                                                   dx, db, dc, ddt, da, db_part, dc_part,
                                                   da_part, ckpt, dstate_in, b, t, h, g, ab,
                                                   strides, s));
    case 32016:
      return static_cast<int>(launch_typed<32, 16>(d, x, bm, cm, dt, a, state_in, dy, dstate_out,
                                                   dx, db, dc, ddt, da, db_part, dc_part,
                                                   da_part, ckpt, dstate_in, b, t, h, g, ab,
                                                   strides, s));
    case 16008:
      return static_cast<int>(launch_typed<16, 8>(d, x, bm, cm, dt, a, state_in, dy, dstate_out,
                                                  dx, db, dc, ddt, da, db_part, dc_part,
                                                  da_part, ckpt, dstate_in, b, t, h, g, ab,
                                                  strides, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
