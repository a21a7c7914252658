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
// Design (simple first):
// - one block of 128 threads (4 warps) per (64-row query tile, head h,
//   batch row b); the heaviest causal tiles are scheduled first.
// - the block loops only over the KV tiles that hold a visible key, from the
//   tile of max(0, q0 - window + 1) to the tile of the last query row
//   (causal) or the last key; dead tiles are never visited, and only tiles
//   that hold a dead (q, k) pair evaluate the mask.
// - K and V tiles of 64 rows are staged in shared memory, Q once per block
//   (bf16: two stages filled by cp.async, the next tile's copies in flight
//   while this one is computed, Q staged in the second stage before the
//   loop); query head h reads KV head h / group in place: q, k, v and o are read
//   and written through their (batch, seq, head) strides, so the model's
//   (B, S, H, D) / (B, S, Kh, D) layouts and the reference's (B, H, S, D)
//   layout need no copy and no repeat of the KV heads.
// - masked scores become the reference's finite NEG_INF (-0.7 FLT_MAX) and
//   their probability is set to exactly 0, so no inf is ever formed (no
//   inf - inf), keys past S contribute exactly 0 (their staged rows are
//   zero too), and rows past S are never written: S need not be a multiple
//   of the tile.
// - bfloat16: tensor cores through mma.sync.m16n8k16 (bf16 in, float32
//   accumulate), as in FlashAttention-2: a warp owns 16 query rows, holds
//   its Q fragments in registers, computes its 16 x 64 score tile with the
//   K tile as the B operand (fragments by ldmatrix), does the row max / row
//   sum with two quad
//   shuffles, and feeds the probabilities back as bf16 A fragments against V
//   (read transposed by ldmatrix.trans).  Probabilities are rounded to bf16
//   for the second product, the sum l is kept in float32.
// - float32: the same tiling on the float32 pipes (no TF32, no bf16): thread
//   (ty, tx) holds rows 4 ty .. 4 ty + 3 and columns tx + 8 j of the score
//   tile and of the output; row statistics by shuffles over the 8 lanes of
//   a row.
//
// Bound on an H100 SXM: the serving prefill's shape (B 4, S 1024, H 32,
// Kh 8, D 128, causal) has 67,174,400 live (q, k) pairs; at 4 D operations a
// pair that is 34.4 GFLOP, 0.0348 ms at 989 TFLOP/s (bf16 dense tensor
// rate), against 83.9 MB of q, k, v and o (0.025 ms at 3.35 TB/s): it is
// bound by operations, hence the tensor-core path for bf16.  What the simple
// design leaves on the table: mma.sync instead of wgmma (and no TMA or
// warp specialization), 64 query rows per block (each K and V tile is
// staged once per 64 rows), 12 warps an SM, and a __syncthreads pair per
// KV tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBQ = 64;  // query rows per block
constexpr int kBK = 64;  // key rows per staged tile
constexpr float kNegInf = -0.7f * FLT_MAX;
constexpr double kLog2e = 1.4426950408889634;
static_assert(kBQ <= kBK, "the bf16 kernel stages Q in the slot of one K tile");

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  // strides in elements: batch, sequence, head
  int64_t q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh;
  int S, group, causal, window;
  float scale;  // float32 path: the softmax scale; bf16 path: scale * log2(e)
};

// First and last KV tile that hold a key visible to some row of the query
// tile starting at q0.
__device__ __forceinline__ void kv_tiles(int q0, const Params& p, int& lo, int& hi) {
  const int q_last = min(q0 + kBQ, p.S) - 1;
  const int k_first = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int k_last = p.causal ? q_last : p.S - 1;
  lo = k_first / kBK;
  hi = k_last / kBK;
}

// Whether the KV tile at k0 holds a (q, k) pair that is not visible.
__device__ __forceinline__ bool tile_needs_mask(int q0, int k0, const Params& p) {
  const int q_last = min(q0 + kBQ, p.S) - 1;
  return k0 + kBK > p.S || (p.causal && k0 + kBK - 1 > q0) ||
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
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores (mma.sync m16n8k16, float32 accumulate)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* ptr) {
  return *reinterpret_cast<const uint32_t*>(ptr);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
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
    }
  }
}

size_t smem_bytes(int dtype, int d) {
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
cudaError_t launch_d(int dtype, const Params& p, int n_q, int H, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes(dtype, D);
  if (dtype == 0) return launch(flash_f32_kernel<D>, smem, p, n_q, H, B, stream);
  return launch(flash_bf16_kernel<D>, smem, p, n_q, H, B, stream);
}

}  // namespace

// Dynamic shared memory in bytes a block takes for `dtype` (0 float32,
// 1 bfloat16) at head width d (ptxas reports none for it).
extern "C" int64_t flash_attention_smem_bytes(int64_t dtype, int64_t d) {
  return static_cast<int64_t>(smem_bytes(static_cast<int>(dtype), static_cast<int>(d)));
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
  if (B < 1 || S < 1 || H < 1 || KH < 1 || H % KH != 0 || B > 65535 || H > 65535 ||
      S > 0x7fffffff - kBQ || window < 0 || window > 0x7fffffff || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.q_sb = strides[0], p.q_ss = strides[1], p.q_sh = strides[2];
  p.k_sb = strides[3], p.k_ss = strides[4], p.k_sh = strides[5];
  p.v_sb = strides[6], p.v_ss = strides[7], p.v_sh = strides[8];
  p.o_sb = strides[9], p.o_ss = strides[10], p.o_sh = strides[11];
  p.S = static_cast<int>(S);
  p.group = static_cast<int>(H / KH);
  p.causal = causal != 0;
  p.window = static_cast<int>(window);
  p.scale = static_cast<float>(dtype == 0 ? scale : scale * kLog2e);
  const int n_q = static_cast<int>((S + kBQ - 1) / kBQ);
  const int d = static_cast<int>(dtype), h = static_cast<int>(H), b = static_cast<int>(B);
  auto s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return static_cast<int>(launch_d<32>(d, p, n_q, h, b, s));
    case 64: return static_cast<int>(launch_d<64>(d, p, n_q, h, b, s));
    case 80: return static_cast<int>(launch_d<80>(d, p, n_q, h, b, s));
    case 128: return static_cast<int>(launch_d<128>(d, p, n_q, h, b, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
