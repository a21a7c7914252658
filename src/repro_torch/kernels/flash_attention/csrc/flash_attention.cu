// Flash attention forward (causal, sliding-window or non-causal; grouped
// KV heads) on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention/
// flash_attention.py (`flash_attention`, body `_kernel`) and its GQA wrapper
// ops.py:gqa_flash_attention.  For query row i of head h, with kh = h / group:
//
//   s[i, j] = scale * q[i, h] . k[j, kh]      for every visible key j
//   o[i, h] = sum_j softmax_j(s[i, :]) v[j, kh]
//
// where key j is visible to row i if j < S, j <= i (causal) and i - j <
// window (window > 0).  As on the TPU the S x S matrix never exists: each
// block keeps the running row max m, the running denominator l and an
// unnormalized float32 accumulator, rescaled as every KV tile arrives
// (online softmax), and divides by max(l, 1e-30) at the end.
//
// Three codes, chosen by (dtype, D) alone (`route`, and `kernel_route` in
// ops.py): bf16 at D = 128, 80 and 64 on wgmma + TMA; bf16 at D = 32 on
// mma.sync; float32 on the float32 pipes.  All three:
// - visit only the KV tiles that hold a visible key, from the tile of
//   max(0, q0 - window + 1) to the tile of the last query row (causal) or
//   the last key; dead tiles are never visited, and only tiles that hold a
//   dead (q, k) pair evaluate the mask; the heaviest query tiles go first.
// - read q, k, v and write o through their (batch, seq, head) strides, query
//   head h reading KV head h / group in place, so the model's (B, S, H, D) /
//   (B, S, Kh, D) layouts and the reference's (B, H, S, D) layout need no
//   copy and no repeat of the KV heads.
// - give a key that is not visible probability exactly 0, read keys past S
//   as zeros and never write rows past S: S need not be a multiple of a tile.
//
// wgmma + TMA (bf16, D = 128, 80 and 64; `flash_wgmma_kernel`; the Hopper
// pieces in hopper.cuh, shared with the backward):
// - a persistent grid, one block of 384 threads an SM, walks the work items
//   (128-row query tile, head, batch row), heaviest query tiles first.
//   Warp 0 produces: TMA loads of Q (two buffers, so the next item's Q
//   arrives during this one) and of 128-key K and V tiles through a ring of
//   two stages with full / empty mbarriers; it keeps 40 registers
//   (setmaxnreg), the consumers 232.
// - two consumer warpgroups own 64 query rows each: S = Q K^T by wgmma
//   m64n128k16 with Q and K in swizzled shared memory; the online softmax in
//   float32 registers (max on the raw scores, the scale * log2(e) folded into
//   one FFMA before ex2.approx, -inf for keys that are not visible, tested
//   against each row's visible range); P converted to bf16 in registers as
//   wgmma's A operand against V read MN-major (the transpose bit), by
//   m64n128k16, m64n96k16 or m64n64k16 at D = 128, 80 and 64.  One
//   reciprocal a row at the end.
// - operands through 4-d tensor maps (D, heads, S, B) built on the host from
//   the strides each call (cuTensorMapEncodeTiled, reached through the
//   runtime's driver entry point): D = 128 as two 64-column chunks in the
//   128-byte swizzle, D = 64 as one; D = 80 in three 32-column chunks in the 64-byte
//   swizzle, its 160-byte rows fitting no swizzle, so TMA zero-fills
//   columns 80..95 (20% more tensor work, no extra bytes read).
//
// mma.sync (bf16, D = 32; `flash_bf16_kernel`): one block of 128
// threads per (64-row query tile, head, batch row); K and V tiles of 64 rows
// in two cp.async stages; mma.sync.m16n8k16 as in FlashAttention-2, a warp
// owning 16 query rows, K's fragments by ldmatrix, V's by ldmatrix.trans;
// masked scores become the reference's finite NEG_INF (-0.7 FLT_MAX) and
// their probability exactly 0.
//
// float32 (`flash_f32_kernel`): the same tiling on the float32 pipes (no
// TF32, no bf16): thread (ty, tx) holds rows 4 ty .. 4 ty + 3 and columns
// tx + 8 j of the score tile and of the output; row statistics by shuffles
// over the 8 lanes of a row.
//
// Row log-sum-exp (`flash_attention_fwd_lse`): where the caller passes a
// (B, H, S) float32 buffer, every route also writes lse_i = log sum_j
// exp(s[i, j]) over the visible keys, from the row's final max and
// denominator, for the backward (flash_attention_bwd.cu).  With a null
// pointer (`flash_attention_fwd`, the served prefill) nothing more is
// written: the test on the pointer is one branch a row at the end.
//
// Bound on an H100 SXM: the serving prefill's shape (B 4, S 1024, H 32,
// Kh 8, D 128, causal) has 67,174,400 live (q, k) pairs; at 4 D operations a
// pair that is 34.4 GFLOP, 0.0348 ms at 989 TFLOP/s (bf16 dense tensor
// rate), against 83.9 MB of q, k, v and o (0.025 ms at 3.35 TB/s): it is
// bound by operations, hence wgmma for the served widths.

#include <float.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kBQ = 64;  // query rows per block
constexpr int kBK = 64;  // key rows per staged tile
constexpr float kNegInf = -0.7f * FLT_MAX;
constexpr double kLog2e = 1.4426950408889634;
constexpr float kLn2 = 0.6931471805599453f;
static_assert(kBQ <= kBK, "the bf16 kernel stages Q in the slot of one K tile");

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // (B, H, S) row log-sum-exp, or nullptr
  // strides in elements: batch, sequence, head
  int64_t q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh;
  int S, group, causal, window;
  int H, B;  // query heads and batch rows (the wgmma kernel's work items)
  float scale;  // float32 path: the softmax scale; bf16 path: scale * log2(e)
};

// First and last KV tile of BK keys that hold a key visible to some row of
// the query tile of BQ rows starting at q0.
template <int BQ = kBQ, int BK = kBK>
__device__ __forceinline__ void kv_tiles(int q0, const Params& p, int& lo, int& hi) {
  const int q_last = min(q0 + BQ, p.S) - 1;
  const int k_first = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int k_last = p.causal ? q_last : p.S - 1;
  lo = k_first / BK;
  hi = k_last / BK;
}

// Whether the KV tile of BK keys at k0 holds a (q, k) pair that is not
// visible to the BQ query rows from q0.
template <int BQ = kBQ, int BK = kBK>
__device__ __forceinline__ bool tile_needs_mask(int q0, int k0, const Params& p) {
  const int q_last = min(q0 + BQ, p.S) - 1;
  return k0 + BK > p.S || (p.causal && k0 + BK - 1 > q0) ||
         (p.window > 0 && q_last - k0 >= p.window);
}

__device__ __forceinline__ bool visible(int qpos, int kpos, const Params& p) {
  return kpos < p.S && (!p.causal || kpos <= qpos) && (p.window <= 0 || qpos - kpos < p.window);
}

// ---------------------------------------------------------------------------
// float32: the float32 pipes
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads) flash_f32_kernel(Params p) {
  constexpr int PQ = D + 1;   // padded row of staged Q and K: conflict-free column reads
  constexpr int PP = kBK + 1;
  constexpr int C = D / 8;    // output columns per thread
  extern __shared__ float smem_f32[];
  float* sQ = smem_f32;        // [kBQ][PQ]
  float* sK = sQ + kBQ * PQ;   // [kBK][PQ]
  float* sV = sK + kBK * PQ;   // [kBK][D]
  float* sP = sV + kBK * D;    // [kBQ][PP] probabilities

  const int n_q = (p.S + kBQ - 1) / kBQ;
  const int q0 = (n_q - 1 - static_cast<int>(blockIdx.x)) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z, kh = h / p.group;
  const float* qp = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kp = static_cast<const float*>(p.k) + b * p.k_sb + kh * p.k_sh;
  const float* vp = static_cast<const float*>(p.v) + b * p.v_sb + kh * p.v_sh;
  float* op = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;
  const int tid = threadIdx.x, ty = tid / 8, tx = tid % 8;

  for (int x = tid; x < kBQ * D; x += kThreads) {
    const int r = x / D, c = x % D, s = q0 + r;
    sQ[r * PQ + c] = s < p.S ? qp[s * p.q_ss + c] : 0.0f;
  }

  float m[4], l[4], acc[4][C];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.0f;
  }

  int t_lo, t_hi;
  kv_tiles(q0, p, t_lo, t_hi);
  for (int t = t_lo; t <= t_hi; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's K and V have been read
    for (int x = tid; x < kBK * D; x += kThreads) {
      const int r = x / D, c = x % D, s = k0 + r;
      const bool ok = s < p.S;
      sK[r * PQ + c] = ok ? kp[s * p.k_ss + c] : 0.0f;
      sV[r * D + c] = ok ? vp[s * p.v_ss + c] : 0.0f;
    }
    __syncthreads();

    float sc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) sc[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty * 4 + i) * PQ + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = sK[(tx + 8 * j) * PQ + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

    const bool need_mask = tile_needs_mask(q0, k0, p);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float s = sc[i][j] * p.scale;
        if (need_mask && !visible(qpos, k0 + tx + 8 * j, p)) s = kNegInf;
        sc[i][j] = s;
        mx = fmaxf(mx, s);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float alpha = expf(m[i] - mx);
      m[i] = mx;
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float pe = sc[i][j] > kNegInf ? expf(sc[i][j] - mx) : 0.0f;
        rs += pe;
        sP[(ty * 4 + i) * PP + tx + 8 * j] = pe;
      }
      l[i] = l[i] * alpha + rs;  // this thread's share; summed over the row's lanes at the end
#pragma unroll
      for (int c = 0; c < C; ++c) acc[i][c] *= alpha;
    }
    __syncwarp();  // a row's probabilities come from the 8 lanes of its own warp

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[4], vv[C];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(ty * 4 + i) * PP + kk];
#pragma unroll
      for (int c = 0; c < C; ++c) vv[c] = sV[kk * D + tx + 8 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < C; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float lt = l[i];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    lt += __shfl_xor_sync(0xffffffffu, lt, 4);
    const int qpos = q0 + ty * 4 + i;
    if (qpos < p.S) {
      const float denom = fmaxf(lt, 1e-30f);
#pragma unroll
      for (int c = 0; c < C; ++c) op[qpos * p.o_ss + tx + 8 * c] = acc[i][c] / denom;
      if (p.lse != nullptr && tx == 0)
        p.lse[(static_cast<int64_t>(b) * p.H + h) * p.S + qpos] = m[i] + logf(denom);
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores (mma.sync m16n8k16, float32 accumulate)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* ptr) {
  return *reinterpret_cast<const uint32_t*>(ptr);
}

// c += a (16 x 16, row) * b (16 x 8, col)
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 bf16 matrices from shared memory, each transposed; lane L gives
// the address of row L % 8 of matrix L / 8.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                                  uint32_t& r3, const __nv_bfloat16* ptr) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

// Four 8 x 8 bf16 matrices from shared memory; lane L gives the address of
// row L % 8 of matrix L / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                            uint32_t& r3, const __nv_bfloat16* ptr) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

// 16 bytes from global to shared memory without passing through registers;
// `valid` false writes 16 zero bytes and reads nothing.
__device__ __forceinline__ void cp_async16(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           bool valid) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start the copies of `rows` rows from row `first` of a (seq, D) slice with
// sequence stride `ss` into smem rows of P elements, 16 bytes a copy; rows
// past S are zero-filled.
template <int D, int P>
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           int64_t ss, int first, int rows, int S) {
  constexpr int CH = D / 8;
  for (int x = threadIdx.x; x < rows * CH; x += kThreads) {
    const int r = x / CH, c = x % CH, s = first + r;
    cp_async16(dst + r * P + c * 8, s < S ? src + s * ss + c * 8 : src, s < S);
  }
}

// At least 3 blocks an SM: at D = 128 the kernel otherwise takes 171
// registers a thread, which leaves room for 2 blocks (8 warps) only; capped
// at 168 it spills 44 bytes and runs 15% faster at the serving shapes.
template <int D>
__global__ void __launch_bounds__(kThreads, 3) flash_bf16_kernel(Params p) {
  // padded row: 16-byte aligned, and the 8 rows a fragment load or an
  // ldmatrix phase touches fall in 8 distinct 4-bank groups
  constexpr int P = D + 8;
  constexpr int KS = D / 16;  // k-steps of Q K^T
  constexpr int NT = D / 8;   // n-tiles of the output
  // two stages of (K tile, V tile), [kBK][P] each; Q is staged in stage 1
  // before the loop and read into registers before stage 1 is first filled
  extern __shared__ __align__(16) unsigned char smem_bf16[];
  __nv_bfloat16* stage0 = reinterpret_cast<__nv_bfloat16*>(smem_bf16);
  __nv_bfloat16* sQ = stage0 + 2 * kBK * P;

  const int n_q = (p.S + kBQ - 1) / kBQ;
  const int q0 = (n_q - 1 - static_cast<int>(blockIdx.x)) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z, kh = h / p.group;
  const __nv_bfloat16* qp = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kp = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + kh * p.k_sh;
  const __nv_bfloat16* vp = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + kh * p.v_sh;
  __nv_bfloat16* op = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;  // fragment row group, thread in group

  int t_lo, t_hi;
  kv_tiles(q0, p, t_lo, t_hi);
  stage_bf16<D, P>(sQ, qp, p.q_ss, q0, kBQ, p.S);
  stage_bf16<D, P>(stage0, kp, p.k_ss, t_lo * kBK, kBK, p.S);
  stage_bf16<D, P>(stage0 + kBK * P, vp, p.v_ss, t_lo * kBK, kBK, p.S);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const int r0 = warp * 16 + g;  // this thread's rows in the tile: r0 and r0 + 8
  uint32_t qf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const __nv_bfloat16* qr = sQ + r0 * P + kk * 16 + 2 * tq;
    qf[kk][0] = lds32(qr);
    qf[kk][1] = lds32(qr + 8 * P);
    qf[kk][2] = lds32(qr + 8);
    qf[kk][3] = lds32(qr + 8 * P + 8);
  }
  __syncthreads();  // every warp holds its Q fragments: stage 1 may be filled

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  const int qrow[2] = {q0 + r0, q0 + r0 + 8};

  const int mi = lane >> 3, ri = lane & 7;  // ldmatrix: matrix and row this lane addresses
  for (int t = t_lo; t <= t_hi; ++t) {
    const int k0 = t * kBK;
    __nv_bfloat16* sK = stage0 + ((t - t_lo) & 1) * 2 * kBK * P;
    __nv_bfloat16* sV = sK + kBK * P;
    if (t < t_hi) {  // the next tile's copies run while this tile is computed
      __nv_bfloat16* nK = stage0 + ((t + 1 - t_lo) & 1) * 2 * kBK * P;
      stage_bf16<D, P>(nK, kp, p.k_ss, k0 + kBK, kBK, p.S);
      stage_bf16<D, P>(nK + kBK * P, vp, p.v_ss, k0 + kBK, kBK, p.S);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile's copies (all but the newest group) have landed
    __syncthreads();

    // scores: 8 n-tiles of 8 keys; element e of tile j is row qrow[e / 2],
    // key k0 + 8 j + 2 tq + e % 2.  K's B fragments come from ldmatrix, two
    // n-tiles (each with both 8-column halves of the k-step) per load.
    float sc[kBK / 8][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int j = 0; j < kBK / 8; j += 2) {
        uint32_t b0, b1, b2, b3;
        ldmatrix_x4(b0, b1, b2, b3, sK + ((j + (mi >> 1)) * 8 + ri) * P + kk * 16 + (mi & 1) * 8);
        mma16816(sc[j], qf[kk], b0, b1);
        mma16816(sc[j + 1], qf[kk], b2, b3);
      }
    }

    const bool need_mask = tile_needs_mask(q0, k0, p);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float s = sc[j][e] * p.scale;  // log2 domain
        if (need_mask && !visible(qrow[e >> 1], k0 + j * 8 + 2 * tq + (e & 1), p)) s = kNegInf;
        sc[j][e] = s;
        mx[e >> 1] = fmaxf(mx[e >> 1], s);
      }
    float alpha[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      alpha[i] = exp2f(m[i] - mx[i]);
      m[i] = mx[i];
    }
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = sc[j][e] > kNegInf ? exp2f(sc[j][e] - mx[e >> 1]) : 0.0f;
        rs[e >> 1] += pe;
        sc[j][e] = pe;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rs[i];  // quad-summed at the end
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // o += p v: the score tiles 2 kk and 2 kk + 1 are the A fragment of
    // k-step kk; V's B fragments come transposed from ldmatrix, two n-tiles
    // per load
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                             pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                             pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                             pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
      const __nv_bfloat16* vrow = sV + (kk * 16 + (mi & 1) * 8 + ri) * P + (mi >> 1) * 8;
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t b0, b1, b2, b3;
        ldmatrix_x4_trans(b0, b1, b2, b3, vrow + n * 8);
        mma16816(acc[n], a, b0, b1);
        mma16816(acc[n + 1], a, b2, b3);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float lt = l[i];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    if (qrow[i] < p.S) {
      const float denom = fmaxf(lt, 1e-30f);
      __nv_bfloat16* orow = op + qrow[i] * p.o_ss + 2 * tq;
#pragma unroll
      for (int n = 0; n < NT; ++n)
        *reinterpret_cast<uint32_t*>(orow + n * 8) =
            pack_bf16(acc[n][2 * i] / denom, acc[n][2 * i + 1] / denom);
      if (p.lse != nullptr && tq == 0)  // m is in the log2 domain
        p.lse[(static_cast<int64_t>(b) * p.H + h) * p.S + qrow[i]] = (m[i] + log2f(denom)) * kLn2;
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16 at D = 128, 80 and 64: wgmma + TMA, warp-specialized
// ---------------------------------------------------------------------------

constexpr int kWgBM = 128;       // query rows a block: two consumer warpgroups of 64
constexpr int kWgBN = 128;       // keys a staged K / V tile
// K / V tiles in flight.  At D = 64 (97 KB a block) neither a third stage
// (no faster at the LM round's shape) nor two blocks an SM (ptxas cannot fit
// m64n128k16's 64 accumulators in the 80 registers a thread that leaves)
// helps.
constexpr int kWgStages = 2;
constexpr int kWgThreads = 384;  // one producer warpgroup, two consumer warpgroups
constexpr int kWgConsumers = 256;

template <int D>
constexpr size_t wg_smem_bytes() {
  using L = WgLayout<D>;
  constexpr size_t q_bytes = static_cast<size_t>(kWgBM) * L::kChunks * L::kRowBytes;
  constexpr size_t tile_bytes = static_cast<size_t>(kWgBN) * L::kChunks * L::kRowBytes;
  // two Q buffers, the K / V stages, the barriers, and slack to align the base to 1024
  return 2 * q_bytes + kWgStages * 2 * tile_bytes + 8 * (4 + 3 * kWgStages) + 1024;
}

// Warp 0 of warpgroup 0 loads (Q once, then K and V tiles through a ring of
// kWgStages stages with full / empty barriers); warpgroups 1 and 2 each own
// 64 query rows: S = Q K^T by wgmma from shared memory, the online softmax
// in registers, O += P V by wgmma with P as bf16 registers and V read
// MN-major from shared memory.
template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v, Params p) {
  using L = WgLayout<D>;
  constexpr int DP = L::kChunk * L::kChunks;  // staged width
  constexpr int kStepsPerChunk = L::kChunk / 16;
  constexpr uint32_t kQChunk = kWgBM * L::kRowBytes, kKVChunk = kWgBN * L::kRowBytes;
  constexpr uint32_t kQBytes = kQChunk * L::kChunks, kTileBytes = kKVChunk * L::kChunks;
  constexpr uint32_t kSbo = 8 * L::kRowBytes;  // 8 rows of a chunk
  extern __shared__ unsigned char smem_wg[];
  const uint32_t base = (smem_u32(smem_wg) + 1023) & ~1023u;  // the swizzle atoms' alignment
  const uint32_t s_q = base;             // two Q buffers, kQBytes each
  const uint32_t s_kv = base + 2 * kQBytes;  // stage s: K at s_kv + 2 s kTileBytes, V after it
  const uint32_t bars = s_kv + kWgStages * 2 * kTileBytes;
  auto q_full = [&](int qs) { return bars + 8 * qs; };
  auto q_empty = [&](int qs) { return bars + 8 * (2 + qs); };
  auto full_k = [&](int s) { return bars + 8 * (4 + s); };
  auto full_v = [&](int s) { return bars + 8 * (4 + kWgStages + s); };
  auto empty = [&](int s) { return bars + 8 * (4 + 2 * kWgStages + s); };

  // Work items (query tile, head, batch row), the heaviest query tiles first
  // across all heads; consecutive items share a KV head, so its K and V are
  // read from L2.  Block x takes items x, x + gridDim.x, ...
  const int n_q = (p.S + kWgBM - 1) / kWgBM;
  const int heads = p.H, items = n_q * heads * p.B;
  auto item_of = [&](int item, int& q0, int& h, int& b) {
    const int hb = item % (heads * p.B);
    q0 = (n_q - 1 - item / (heads * p.B)) * kWgBM;
    h = hb % heads;
    b = hb / heads;
  };

  if (threadIdx.x == 0) {
    for (int qs = 0; qs < 2; ++qs) {
      mbar_init(q_full(qs), 1);
      mbar_init(q_empty(qs), kWgConsumers);
    }
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty(s), kWgConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {  // producer
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      int ring = 0, n = 0;  // K / V tiles and items loaded so far
      for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
        int q0, h, b;
        item_of(item, q0, h, b);
        const int kh = h / p.group, qs = n & 1;
        int t_lo, t_hi;
        kv_tiles<kWgBM, kWgBN>(q0, p, t_lo, t_hi);
        mbar_wait(q_empty(qs), ((n >> 1) & 1) ^ 1);
        mbar_expect_tx(q_full(qs), kQBytes);
        for (int c = 0; c < L::kChunks; ++c)
          tma_load_4d(s_q + qs * kQBytes + c * kQChunk, &tm_q, c * L::kChunk, h, q0, b,
                      q_full(qs));
        for (int t = t_lo; t <= t_hi; ++t, ++ring) {
          const int s = ring % kWgStages;
          mbar_wait(empty(s), ((ring / kWgStages) & 1) ^ 1);
          const uint32_t s_k = s_kv + 2 * s * kTileBytes, s_v = s_k + kTileBytes;
          mbar_expect_tx(full_k(s), kTileBytes);
          for (int c = 0; c < L::kChunks; ++c)
            tma_load_4d(s_k + c * kKVChunk, &tm_k, c * L::kChunk, kh, t * kWgBN, b, full_k(s));
          mbar_expect_tx(full_v(s), kTileBytes);
          for (int c = 0; c < L::kChunks; ++c)
            tma_load_4d(s_v + c * kKVChunk, &tm_v, c * L::kChunk, kh, t * kWgBN, b, full_v(s));
        }
      }
    }
  } else {  // consumers
    setmaxnreg_inc<232>();
    const int cw = wg - 1;  // rows q0 + 64 cw .. q0 + 64 cw + 63
    const int ct = threadIdx.x - 128 * wg, warp = ct / 32, lane = ct % 32;
    const int g = lane >> 2, tq = lane & 3;
    int ring = 0, n = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
      int q0, h, b;
      item_of(item, q0, h, b);
      const int qs = n & 1;
      const uint32_t s_qi = s_q + qs * kQBytes;
      int t_lo, t_hi;
      kv_tiles<kWgBM, kWgBN>(q0, p, t_lo, t_hi);
      const int wq0 = q0 + 64 * cw;
      const int qrow[2] = {wq0 + 16 * warp + g, wq0 + 16 * warp + g + 8};
      float o[DP / 2];
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) o[i] = 0.0f;
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};  // raw score max, sum
      mbar_wait(q_full(qs), (n >> 1) & 1);

      for (int t = t_lo; t <= t_hi; ++t, ++ring) {
        const int s = ring % kWgStages;
        const uint32_t parity = (ring / kWgStages) & 1;
        const int k0 = t * kWgBN;
        const uint32_t s_k = s_kv + 2 * s * kTileBytes, s_v = s_k + kTileBytes;

        // scores: sc[4 j + e] is row qrow[e / 2], key k0 + 8 j + 2 tq + e % 2
        float sc[kWgBN / 2] = {};  // overwritten by the first k-step (accumulate 0)
        mbar_wait(full_k(s), parity);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < DP / 16; ++ks) {
          const uint32_t off = (ks % kStepsPerChunk) * 32;  // 16 columns a step
          const uint64_t da = wg_desc(s_qi + (ks / kStepsPerChunk) * kQChunk +
                                          64 * cw * L::kRowBytes + off,
                                      16, kSbo, L::kDescLayout);
          const uint64_t db =
              wg_desc(s_k + (ks / kStepsPerChunk) * kKVChunk + off, 16, kSbo, L::kDescLayout);
          wgmma_ss<kWgBN>(sc, da, db, ks > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_operands(sc);

        // online softmax in the log2 domain, two FA3 economies: the row max is
        // taken on the raw scores (scale > 0) and the scale folds into the
        // exponent's one FFMA; a key that is not visible scores -inf, so its
        // probability is exactly 0 with no compare.  The mask, where a tile
        // needs one, tests each column against the row's visible range.
        if (tile_needs_mask<64, kWgBN>(wq0, k0, p)) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int hi = min(p.S - 1, p.causal ? qrow[r] : p.S - 1) - k0 - 2 * tq;
            const int lo = (p.window > 0 ? qrow[r] - p.window + 1 : 0) - k0 - 2 * tq;
#pragma unroll
            for (int j = 0; j < kWgBN / 8; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int col = 8 * j + e;
                if (col < lo || col > hi) sc[4 * j + 2 * r + e] = -INFINITY;
              }
          }
        }
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int j = 0; j < kWgBN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * j + e]);
        float alpha[2], bias[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          // a row with no visible key yet keeps max -inf: its p and alpha stay finite
          alpha[r] = mx[r] == -INFINITY ? 1.0f : ex2_approx((m[r] - mx[r]) * p.scale);
          bias[r] = mx[r] == -INFINITY ? 0.0f : mx[r] * p.scale;
          m[r] = mx[r];
        }
        uint32_t pa[kWgBN / 16][4];  // P as the A fragments of the 16-key steps
#pragma unroll
        for (int j = 0; j < kWgBN / 8; ++j) {
          float pe[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            pe[e] = ex2_approx(fmaf(sc[4 * j + e], p.scale, -bias[e >> 1]));
            rs[e >> 1] += pe[e];
          }
          pa[j / 2][2 * (j & 1)] = pack_bf16(pe[0], pe[1]);
          pa[j / 2][2 * (j & 1) + 1] = pack_bf16(pe[2], pe[3]);
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];  // quad-summed at the end
#pragma unroll
        for (int c = 0; c < DP / 8; ++c) {
          o[4 * c] *= alpha[0];
          o[4 * c + 1] *= alpha[0];
          o[4 * c + 2] *= alpha[1];
          o[4 * c + 3] *= alpha[1];
        }

        mbar_wait(full_v(s), parity);
        fence_operands(o);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kWgBN / 16; ++kk)
          wgmma_rs<DP>(o, pa[kk], wg_desc(s_v + kk * 16 * L::kRowBytes, kKVChunk, kSbo,
                                          L::kDescLayout));
        wgmma_commit();
        wgmma_wait<0>();
        fence_operands(o);
        mbar_arrive(empty(s));
      }
      mbar_arrive(q_empty(qs));  // the producer may load the item after next's Q

      __nv_bfloat16* op = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float lt = l[r];
        lt += __shfl_xor_sync(0xffffffffu, lt, 1);
        lt += __shfl_xor_sync(0xffffffffu, lt, 2);
        if (qrow[r] < p.S) {
          if (p.lse != nullptr && tq == 0)  // m is the raw score max, p.scale scale * log2(e)
            p.lse[(static_cast<int64_t>(b) * p.H + h) * p.S + qrow[r]] =
                (m[r] * p.scale + log2f(fmaxf(lt, 1e-30f))) * kLn2;
          const float inv = 1.0f / fmaxf(lt, 1e-30f);  // one division a row
          __nv_bfloat16* orow = op + qrow[r] * p.o_ss + 2 * tq;
#pragma unroll
          for (int c = 0; c < D / 8; ++c)  // staged columns past D are not written
            *reinterpret_cast<uint32_t*>(orow + c * 8) =
                pack_bf16(o[4 * c + 2 * r] * inv, o[4 * c + 2 * r + 1] * inv);
        }
      }
    }
  }
}

template <int D>
cudaError_t launch_wgmma(const Params& p, int B, int H, int KH, cudaStream_t stream) {
  using L = WgLayout<D>;
  CUtensorMap tq, tk, tv;
  cudaError_t err;
  if ((err = make_map(&tq, p.q, D, H, p.S, B, p.q_sh, p.q_ss, p.q_sb, L::kChunk, kWgBM,
                      L::kSwizzle)) != cudaSuccess ||
      (err = make_map(&tk, p.k, D, KH, p.S, B, p.k_sh, p.k_ss, p.k_sb, L::kChunk, kWgBN,
                      L::kSwizzle)) != cudaSuccess ||
      (err = make_map(&tv, p.v, D, KH, p.S, B, p.v_sh, p.v_ss, p.v_sb, L::kChunk, kWgBN,
                      L::kSwizzle)) != cudaSuccess)
    return err;
  // the persistent grid: one block an SM (the shared memory allows no more),
  // at most one a work item.  The shared-memory limit and the SM count are
  // set and asked once per device.
  constexpr size_t smem = wg_smem_bytes<D>();
  static int sms[kMaxDevices] = {};
  int count = 0;
  if ((err = prepare_persistent(flash_wgmma_kernel<D>, smem, sms, count)) != cudaSuccess)
    return err;
  const int64_t items = static_cast<int64_t>((p.S + kWgBM - 1) / kWgBM) * H * B;
  if (items > 0x7fffffff) return cudaErrorInvalidValue;
  const int grid = static_cast<int>(items < count ? items : count);
  flash_wgmma_kernel<D><<<grid, kWgThreads, smem, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

// Which code runs a call: 0 float32 (float32 pipes), 1 bf16 on mma.sync
// (D = 32), 2 bf16 on wgmma + TMA (D = 64, 80, 128).
int route(int dtype, int d) { return dtype == 0 ? 0 : (d == 64 || d == 80 || d == 128) ? 2 : 1; }

size_t smem_bytes(int dtype, int d) {
  if (route(dtype, d) == 2)
    return d == 128 ? wg_smem_bytes<128>() : d == 80 ? wg_smem_bytes<80>() : wg_smem_bytes<64>();
  if (dtype == 0)
    return sizeof(float) * (static_cast<size_t>(kBQ + kBK) * (d + 1) +
                            static_cast<size_t>(kBK) * d + static_cast<size_t>(kBQ) * (kBK + 1));
  return sizeof(__nv_bfloat16) * static_cast<size_t>(4 * kBK) * (d + 8);  // two K, V stages
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, size_t smem, const Params& p, int n_q, int H, int B,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(n_q, H, B), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(int dtype, const Params& p, int n_q, int H, int B, int KH,
                     cudaStream_t stream) {
  const size_t smem = smem_bytes(dtype, D);
  if (dtype == 0) return launch(flash_f32_kernel<D>, smem, p, n_q, H, B, stream);
  if constexpr (D == 64 || D == 80 || D == 128) {
    return launch_wgmma<D>(p, B, H, KH, stream);
  } else {
    return launch(flash_bf16_kernel<D>, smem, p, n_q, H, B, stream);
  }
}

}  // namespace

// Dynamic shared memory in bytes a block takes for `dtype` (0 float32,
// 1 bfloat16) at head width d (ptxas reports none for it).
extern "C" int64_t flash_attention_smem_bytes(int64_t dtype, int64_t d) {
  return static_cast<int64_t>(smem_bytes(static_cast<int>(dtype), static_cast<int>(d)));
}

// The code a call of `dtype` at head width d runs: 0 float32, 1 bf16 on
// mma.sync (D = 32), 2 bf16 on wgmma + TMA (D = 64, 80, 128).
extern "C" int64_t flash_attention_route(int64_t dtype, int64_t d) {
  return route(static_cast<int>(dtype), static_cast<int>(d));
}

// lse: nullptr, or a (B, H, S) float32 buffer, contiguous, that receives
// each row's log-sum-exp of the scaled visible scores (natural log).
static int forward(const void* q, const void* k, const void* v, void* o, float* lse, int64_t dtype,
            int64_t B, int64_t S, int64_t H, int64_t KH, int64_t D, const int64_t* strides,
            int64_t causal, int64_t window, double scale, void* stream) {
  if (B < 1 || S < 1 || H < 1 || KH < 1 || H % KH != 0 || B > 65535 || H > 65535 ||
      S > 0x7fffffff - kBQ || window < 0 || window > 0x7fffffff || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = lse;
  p.q_sb = strides[0], p.q_ss = strides[1], p.q_sh = strides[2];
  p.k_sb = strides[3], p.k_ss = strides[4], p.k_sh = strides[5];
  p.v_sb = strides[6], p.v_ss = strides[7], p.v_sh = strides[8];
  p.o_sb = strides[9], p.o_ss = strides[10], p.o_sh = strides[11];
  p.S = static_cast<int>(S);
  p.H = static_cast<int>(H);
  p.B = static_cast<int>(B);
  p.group = static_cast<int>(H / KH);
  p.causal = causal != 0;
  p.window = static_cast<int>(window);
  p.scale = static_cast<float>(dtype == 0 ? scale : scale * kLog2e);
  const int n_q = static_cast<int>((S + kBQ - 1) / kBQ);
  const int d = static_cast<int>(dtype), h = static_cast<int>(H), b = static_cast<int>(B);
  const int kh = static_cast<int>(KH);
  auto s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return static_cast<int>(launch_d<32>(d, p, n_q, h, b, kh, s));
    case 64: return static_cast<int>(launch_d<64>(d, p, n_q, h, b, kh, s));
    case 80: return static_cast<int>(launch_d<80>(d, p, n_q, h, b, kh, s));
    case 128: return static_cast<int>(launch_d<128>(d, p, n_q, h, b, kh, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// q, o: (B, S, H, D); k, v: (B, S, KH, D), all of one type (dtype 0 float32,
// 1 bfloat16), read and written through `strides`: 12 int64 element strides,
// (batch, sequence, head) of q, k, v and o in turn; the head axis has unit
// stride.  For bf16 every stride is a multiple of 8 and every pointer 16-byte
// aligned.  causal: 0 or 1; window: 0 for none.  Launches on `stream` and
// returns the launch's cudaError_t (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int64_t dtype, int64_t B, int64_t S, int64_t H, int64_t KH,
                                   int64_t D, const int64_t* strides, int64_t causal,
                                   int64_t window, double scale, void* stream) {
  return forward(q, k, v, o, nullptr, dtype, B, S, H, KH, D, strides, causal, window, scale,
                 stream);
}

// flash_attention_fwd's arguments and contract, with `lse` a (B, H, S)
// float32 buffer, contiguous, that receives each row's log-sum-exp of the
// scaled visible scores (natural log), which the backward reads.
extern "C" int flash_attention_fwd_lse(const void* q, const void* k, const void* v, void* o,
                                       float* lse, int64_t dtype, int64_t B, int64_t S,
                                       int64_t H, int64_t KH, int64_t D, const int64_t* strides,
                                       int64_t causal, int64_t window, double scale,
                                       void* stream) {
  return forward(q, k, v, o, lse, dtype, B, S, H, KH, D, strides, causal, window, scale,
                 stream);
}
