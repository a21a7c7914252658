// Flash attention backward (causal, sliding-window or non-causal; grouped
// KV heads) on Hopper (sm_90a).
//
// The Pallas TPU kernel repro/kernels/flash_attention/flash_attention.py
// (`flash_attention`) has no backward: the reference differentiates its jnp
// forms.  This is the backward of the port's forward (flash_attention.cu),
// which it needs to train through the kernel; it replaces no TPU kernel.
// From the forward's output o and its float32 row log-sum-exp lse (B, H, S),
// for query row i of head h, key j of KV head kh = h / group, visible as in
// the forward (j <= i when causal, i - j < window when windowed):
//
//   p[i, j]  = exp(scale q_i . k_j - lse_i)          (0 where not visible)
//   delta_i  = sum_d do[i, d] o[i, d]
//   dv_j     = sum_{h in group} sum_i p[i, j] do_i
//   ds[i, j] = p[i, j] (do_i . v_j - delta_i)
//   dq_i     = scale sum_j ds[i, j] k_j
//   dk_j     = scale sum_{h in group} sum_i ds[i, j] q_i
//
// Three kernels a call, none with atomics, so every output element is
// written by one thread in a fixed order and a call gives the same bits
// each time:
// - `delta_*_kernel`: rowsum(do o) into a float32 scratch,
//   and beside it lse log2(e): rows of S padded with zeros to a multiple of
//   128, so the wgmma route's TMA boxes of 64 or 128 rows start aligned and
//   lie in the buffer at any S.
// - `dkdv_*_kernel`: a block owns a tile of keys of one KV head and walks
//   its G query heads and, for each, the query tiles that see any of its
//   keys, accumulating dk and dv in float32 registers; it recomputes p and
//   dp for each (key tile, query tile) pair.
// - `dq_*_kernel`: a block owns a tile of query rows of one head and walks
//   the KV tiles they see (the forward's range), accumulating dq.
// S and dP are computed twice (once in each of the last two kernels): 14 D
// operations a visible (q, k) pair against the 10 D the five products need;
// a single pass would have to sum dq across key tiles, which without
// floating-point atomics needs a second pass over a (tiles, S, H, D)
// scratch anyway.
//
// Three codes, chosen by (dtype, D) alone (`route`, and `bwd_kernel_route`
// in ops.py):
//
// wgmma + TMA (bf16 at D = 64 and 128, the trained widths;
// `dkdv_wgmma_kernel`, `dq_wgmma_kernel`; the Hopper pieces in hopper.cuh,
// shared with the forward): each a persistent grid of 384-thread blocks,
// one an SM.  Warp 0 produces by TMA through 4-d tensor maps of the
// operands' strides (and 1-d maps of the padded lse and delta) into
// mbarrier rings, keeping 40 registers (setmaxnreg); two consumer
// warpgroups of 64 rows each, 232 registers, run every product on wgmma
// with float32 accumulators: the score-like products (S^T = K Q^T and
// dP^T = V dO^T for dk / dv; S = Q K^T and dP = dO V^T for dq) by m64nNk16
// with both operands in swizzled shared memory, the exponentials of S
// while dP's products run; the gradient products (dv += P^T dO,
// dk += dS^T Q, dq += dS K) by m64nDk16 with P^T / dS^T / dS converted to
// bf16 in registers as the A operand and the other operand read MN-major
// (the transpose bit), as the forward's P V.  dk / dv blocks own 128 keys
// and stage Q and dO tiles of N = 64 rows (128 at D = 64); dq blocks own
// 128 query rows and stage K and V tiles of N = 64 keys (128 at D = 64).
// Only tiles that hold a dead (q, k) pair evaluate the mask, setting -inf
// from each row's visible range.  The first key tiles (causal: the most
// query tiles) and the last query tiles (the most key tiles) go first, and
// a block takes its items in snake order over the sorted list.
//
// mma.sync (bf16 at D = 32 and 80): mma.sync.m16n8k16 and float32
// accumulation, a warp owning 16 rows of the block's 64-row tile; A
// fragments read from shared memory, B fragments by ldmatrix (.trans where
// the operand is [k][n] in memory), P and dS converted to bf16 in registers
// as the A operand of the second products, as in FlashAttention-2.  Tiles
// staged by cp.async, synchronously.
//
// float32 on the float32 pipes with the forward's float32 tiling (thread
// (ty, tx) holds rows 4 ty .. 4 ty + 3 and columns tx + 8 j).
//
// Every code: rows and keys past S read as zeros, are masked to p = 0, and
// are never written: S need not be a multiple of a tile.
//
// Bound on an H100 SXM: at the LM round's shape (B 16, S 1024, H 9, Kh 3,
// D 64, causal) there are 75.5 M visible (q, k) pairs; the five products
// take 10 D = 640 operations a pair, 48.3 GFLOP, 0.049 ms at 989 TFLOP/s
// (bf16 dense tensor rate), against 57 MB of q, k, v, o, do, lse, dq, dk,
// dv (0.017 ms at 3.35 TB/s): bound by operations, hence wgmma.

#include "hopper.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 64;  // keys of a dk / dv block, query rows of a dq block
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kRowPad = 128;  // the scratch rows' length is a multiple of this

int64_t padded_rows(int64_t S) { return (S + kRowPad - 1) / kRowPad * kRowPad; }

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;  // (B, H, S), natural log
  float* delta;      // (B, H, sp) scratch: rowsum(do o), 0 in the padding
  float* lse2;       // (B, H, sp) scratch after it: lse log2(e), 0 in the padding
  void* dq;          // (B, S, H, D), contiguous
  void* dk;          // (B, S, KH, D), contiguous
  void* dv;          // (B, S, KH, D), contiguous
  // strides in elements: batch, sequence, head
  int64_t q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh;
  int64_t do_sb, do_ss, do_sh;
  int S, H, KH, B, group, causal, window;
  int sp;  // S rounded up to kRowPad: the scratch rows' length
  float scale;  // the softmax scale
};

__device__ __forceinline__ bool visible(int qpos, int kpos, const BwdParams& p) {
  return qpos < p.S && kpos < p.S && (!p.causal || kpos <= qpos) &&
         (p.window <= 0 || qpos - kpos < p.window);
}

// The query tiles of BQ rows holding a row that sees a key of the BK keys
// from k0.
template <int BQ, int BK>
__device__ __forceinline__ void q_tiles(int k0, const BwdParams& p, int& lo, int& hi) {
  const int k_last = min(k0 + BK, p.S) - 1;
  int q_last = p.S - 1;
  if (p.window > 0) q_last = min(q_last, k_last + p.window - 1);
  lo = p.causal ? k0 / BQ : 0;
  hi = q_last / BQ;
}

// The KV tiles of BK keys holding a key that a row of the BQ query rows
// from q0 sees (the forward's range).
template <int BQ, int BK>
__device__ __forceinline__ void kv_tiles(int q0, const BwdParams& p, int& lo, int& hi) {
  const int q_last = min(q0 + BQ, p.S) - 1;
  lo = (p.window > 0 ? max(0, q0 - p.window + 1) : 0) / BK;
  hi = (p.causal ? q_last : p.S - 1) / BK;
}

// ---------------------------------------------------------------------------
// delta = rowsum(do o) and lse log2(e), a row of the padded scratch each
// ---------------------------------------------------------------------------

// float32: one warp a row.
__global__ void __launch_bounds__(kThreads) delta_f32_kernel(BwdParams p, int D, int64_t rows) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int s = static_cast<int>(row % p.sp);
  const int64_t bh = row / p.sp;
  if (s >= p.S) {  // the padding: probability 0 and finite in every product
    if (lane == 0) p.delta[row] = p.lse2[row] = 0.0f;
    return;
  }
  const int h = static_cast<int>(bh % p.H), b = static_cast<int>(bh / p.H);
  const float* o = static_cast<const float*>(p.o) + b * p.o_sb + s * p.o_ss + h * p.o_sh;
  const float* g = static_cast<const float*>(p.dout) + b * p.do_sb + s * p.do_ss + h * p.do_sh;
  float acc = 0.0f;
  for (int c = lane; c < D; c += 32) acc = fmaf(o[c], g[c], acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    p.delta[row] = acc;
    p.lse2[row] = p.lse[bh * p.S + s] * kLog2e;
  }
}

// bf16: delta_lanes<D>() lanes a row, 8 elements (16 bytes) a lane (the
// operands' strides are multiples of 8 elements), the rest of the warp on
// the next rows; block (x, h, b) takes rows x delta_block_rows<D>() .. of
// head h, batch row b, the padding past S included.  Small blocks, many
// waves of them: larger ones (several rows a lane group) leave a partial
// last wave at the LM round's shape.
template <int D>
__host__ __device__ constexpr int delta_lanes() { return D / 8 <= 4 ? 4 : D / 8 <= 8 ? 8 : 16; }
template <int D>
__host__ __device__ constexpr int delta_block_rows() { return kThreads / delta_lanes<D>(); }

template <int D>
__global__ void __launch_bounds__(kThreads) delta_bf16_kernel(BwdParams p) {
  constexpr int kLanes = delta_lanes<D>();
  const int sub = threadIdx.x % kLanes, h = blockIdx.y, b = blockIdx.z;
  const int s = blockIdx.x * delta_block_rows<D>() + threadIdx.x / kLanes;
  float acc = 0.0f;
  if (s < p.S && sub * 8 < D) {
    const uint4 ov = *reinterpret_cast<const uint4*>(
        static_cast<const __nv_bfloat16*>(p.o) + b * p.o_sb + s * p.o_ss + h * p.o_sh + sub * 8);
    const uint4 gv = *reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(p.dout) +
                                                     b * p.do_sb + s * p.do_ss + h * p.do_sh +
                                                     sub * 8);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 x = __bfloat1622float2(o2[e]), y = __bfloat1622float2(g2[e]);
      acc = fmaf(x.x, y.x, acc);
      acc = fmaf(x.y, y.y, acc);
    }
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (s < p.sp && sub == 0) {
    const int64_t bh = static_cast<int64_t>(b) * p.H + h;
    const bool pad = s >= p.S;  // the padding: probability 0 and finite in every product
    p.delta[bh * p.sp + s] = pad ? 0.0f : acc;
    p.lse2[bh * p.sp + s] = pad ? 0.0f : p.lse[bh * p.S + s] * kLog2e;
  }
}

// ---------------------------------------------------------------------------
// float32: the float32 pipes
// ---------------------------------------------------------------------------

// Rows `first` .. first + 63 of a (seq, D) float32 slice into smem rows of
// PD floats; rows past S are zero.
template <int D, int PD>
__device__ __forceinline__ void stage_f32(float* dst, const float* src, int64_t ss, int first,
                                          int S) {
  for (int x = threadIdx.x; x < kTile * D; x += kThreads) {
    const int r = x / D, c = x % D, s = first + r;
    dst[r * PD + c] = s < S ? src[s * ss + c] : 0.0f;
  }
}

// lse (as is, or times log2(e)) and delta of rows `first` .. first + 63 of
// one head; rows past S read 0.
__device__ __forceinline__ void stage_rows(float* s_lse, float* s_delta, const BwdParams& p,
                                           int64_t bh, int first, float lse_mul) {
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    const int s = first + r;
    s_lse[r] = s < p.S ? p.lse[bh * p.S + s] * lse_mul : 0.0f;
    s_delta[r] = s < p.S ? p.delta[bh * p.sp + s] : 0.0f;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) dkdv_f32_kernel(BwdParams p) {
  constexpr int PD = D + 1, PP = kTile + 1, C = D / 8;
  extern __shared__ float smem_f32[];
  float* sK = smem_f32;          // [64][PD]
  float* sV = sK + kTile * PD;   // [64][PD]
  float* sQ = sV + kTile * PD;   // [64][PD]
  float* sG = sQ + kTile * PD;   // [64][PD] do
  float* sP = sG + kTile * PD;   // [64 keys][PP] p^T
  float* sS = sP + kTile * PP;   // [64 keys][PP] ds^T
  float* sL = sS + kTile * PP;   // [64] lse
  float* sD = sL + kTile;        // [64] delta

  const int k0 = blockIdx.x * kTile, kh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid / 8, tx = tid % 8;
  stage_f32<D, PD>(sK, static_cast<const float*>(p.k) + b * p.k_sb + kh * p.k_sh, p.k_ss, k0,
                   p.S);
  stage_f32<D, PD>(sV, static_cast<const float*>(p.v) + b * p.v_sb + kh * p.v_sh, p.v_ss, k0,
                   p.S);
  float dk[4][C], dv[4][C];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c) dk[i][c] = dv[i][c] = 0.0f;

  int t_lo, t_hi;
  q_tiles<kTile, kTile>(k0, p, t_lo, t_hi);
  for (int gi = 0; gi < p.group; ++gi) {
    const int h = kh * p.group + gi;
    const int64_t bh = static_cast<int64_t>(b) * p.H + h;
    const float* qp = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
    const float* gp = static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh;
    for (int t = t_lo; t <= t_hi; ++t) {
      const int q0 = t * kTile;
      __syncthreads();  // the previous tile's Q, do, p and ds have been read
      stage_f32<D, PD>(sQ, qp, p.q_ss, q0, p.S);
      stage_f32<D, PD>(sG, gp, p.do_ss, q0, p.S);
      stage_rows(sL, sD, p, bh, q0, 1.0f);
      __syncthreads();

      // s^T and dp^T: rows are keys 4 ty + i, columns queries tx + 8 j
      float st[4][8], dpt[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) st[i][j] = dpt[i][j] = 0.0f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kv[4], vv[4], qv[8], gv[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kv[i] = sK[(ty * 4 + i) * PD + d];
          vv[i] = sV[(ty * 4 + i) * PD + d];
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          qv[j] = sQ[(tx + 8 * j) * PD + d];
          gv[j] = sG[(tx + 8 * j) * PD + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            st[i][j] = fmaf(kv[i], qv[j], st[i][j]);
            dpt[i][j] = fmaf(vv[i], gv[j], dpt[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int r = ty * 4 + i, c = tx + 8 * j;
          const float pe = visible(q0 + c, k0 + r, p) ? expf(st[i][j] * p.scale - sL[c]) : 0.0f;
          sP[r * PP + c] = pe;
          sS[r * PP + c] = pe * (dpt[i][j] - sD[c]);
        }
      __syncthreads();

      // dv[r] += sum_c p^T[r, c] do[c]; dk[r] += sum_c ds^T[r, c] q[c]
#pragma unroll 4
      for (int c = 0; c < kTile; ++c) {
        float pv[4], sv[4], gv[C], qv[C];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = sP[(ty * 4 + i) * PP + c];
          sv[i] = sS[(ty * 4 + i) * PP + c];
        }
#pragma unroll
        for (int n = 0; n < C; ++n) {
          gv[n] = sG[c * PD + tx + 8 * n];
          qv[n] = sQ[c * PD + tx + 8 * n];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int n = 0; n < C; ++n) {
            dv[i][n] = fmaf(pv[i], gv[n], dv[i][n]);
            dk[i][n] = fmaf(sv[i], qv[n], dk[i][n]);
          }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kpos = k0 + ty * 4 + i;
    if (kpos < p.S) {
      const int64_t row = ((static_cast<int64_t>(b) * p.S + kpos) * p.KH + kh) * D;
      float* dkp = static_cast<float*>(p.dk) + row;
      float* dvp = static_cast<float*>(p.dv) + row;
#pragma unroll
      for (int n = 0; n < C; ++n) {
        dkp[tx + 8 * n] = dk[i][n] * p.scale;
        dvp[tx + 8 * n] = dv[i][n];
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) dq_f32_kernel(BwdParams p) {
  constexpr int PD = D + 1, PP = kTile + 1, C = D / 8;
  extern __shared__ float smem_f32[];
  float* sQ = smem_f32;          // [64][PD]
  float* sG = sQ + kTile * PD;   // [64][PD] do
  float* sK = sG + kTile * PD;   // [64][PD]
  float* sV = sK + kTile * PD;   // [64][PD]
  float* sS = sV + kTile * PD;   // [64 rows][PP] ds
  float* sL = sS + kTile * PP;   // [64] lse
  float* sD = sL + kTile;        // [64] delta

  const int n_q = (p.S + kTile - 1) / kTile;
  const int q0 = (n_q - 1 - static_cast<int>(blockIdx.x)) * kTile;  // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z, kh = h / p.group;
  const int64_t bh = static_cast<int64_t>(b) * p.H + h;
  const int tid = threadIdx.x, ty = tid / 8, tx = tid % 8;
  const float* kp = static_cast<const float*>(p.k) + b * p.k_sb + kh * p.k_sh;
  const float* vp = static_cast<const float*>(p.v) + b * p.v_sb + kh * p.v_sh;
  stage_f32<D, PD>(sQ, static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh, p.q_ss, q0,
                   p.S);
  stage_f32<D, PD>(sG, static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh, p.do_ss,
                   q0, p.S);
  stage_rows(sL, sD, p, bh, q0, 1.0f);
  float dq[4][C];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c) dq[i][c] = 0.0f;

  int t_lo, t_hi;
  kv_tiles<kTile, kTile>(q0, p, t_lo, t_hi);
  for (int t = t_lo; t <= t_hi; ++t) {
    const int k0 = t * kTile;
    __syncthreads();  // the previous tile's K, V and ds have been read
    stage_f32<D, PD>(sK, kp, p.k_ss, k0, p.S);
    stage_f32<D, PD>(sV, vp, p.v_ss, k0, p.S);
    __syncthreads();

    float sc[4][8], dp[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) sc[i][j] = dp[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], gv[4], kv[8], vv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = sQ[(ty * 4 + i) * PD + d];
        gv[i] = sG[(ty * 4 + i) * PD + d];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        kv[j] = sK[(tx + 8 * j) * PD + d];
        vv[j] = sV[(tx + 8 * j) * PD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
          dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int r = ty * 4 + i, c = tx + 8 * j;
        const float pe = visible(q0 + r, k0 + c, p) ? expf(sc[i][j] * p.scale - sL[r]) : 0.0f;
        sS[r * PP + c] = pe * (dp[i][j] - sD[r]);
      }
    __syncwarp();  // a row's ds comes from the 8 lanes of its own warp

#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float sv[4], kv[C];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = sS[(ty * 4 + i) * PP + c];
#pragma unroll
      for (int n = 0; n < C; ++n) kv[n] = sK[c * PD + tx + 8 * n];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int n = 0; n < C; ++n) dq[i][n] = fmaf(sv[i], kv[n], dq[i][n]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty * 4 + i;
    if (qpos < p.S) {
      float* dqp =
          static_cast<float*>(p.dq) + ((static_cast<int64_t>(b) * p.S + qpos) * p.H + h) * D;
#pragma unroll
      for (int n = 0; n < C; ++n) dqp[tx + 8 * n] = dq[i][n] * p.scale;
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

// Four 8 x 8 bf16 matrices from shared memory (.trans: each transposed);
// lane L gives the address of row L % 8 of matrix L / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                            uint32_t& r3, const __nv_bfloat16* ptr) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                                  uint32_t& r3, const __nv_bfloat16* ptr) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

// 16 bytes from global to shared memory; `valid` false writes 16 zero bytes
// and reads nothing.
__device__ __forceinline__ void cp_async16(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           bool valid) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// Copies of `rows` rows from row `first` of a (seq, D) bf16 slice with
// sequence stride `ss` into smem rows of P elements, 16 bytes a copy; rows
// past S are zero-filled.  The caller commits and waits.
template <int D, int P>
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           int64_t ss, int first, int rows, int S) {
  constexpr int CH = D / 8;
  for (int x = threadIdx.x; x < rows * CH; x += kThreads) {
    const int r = x / CH, c = x % CH, s = first + r;
    cp_async16(dst + r * P + c * 8, s < S ? src + s * ss + c * 8 : src, s < S);
  }
}

__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
}

// The A fragment of k-step kk of a 16-row tile at row r0 of a [rows][P]
// bf16 smem array (row-major, k contiguous).
template <int P>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* base, int r0,
                                       int kk, int g, int tq) {
  const __nv_bfloat16* r = base + (r0 + g) * P + kk * 16 + 2 * tq;
  a[0] = lds32(r);
  a[1] = lds32(r + 8 * P);
  a[2] = lds32(r + 8);
  a[3] = lds32(r + 8 * P + 8);
}

// acc (16 x 8 NT) += A (16 rows from r0 of `a_base`, width D) * M^T, M a
// [8 NT][P] smem array (n rows, k contiguous): the products s = q k^T and
// dp = do v^T, and their transposes.
template <int D, int P, int NT>
__device__ __forceinline__ void mma_abt(float (&acc)[NT][4], const __nv_bfloat16* a_base, int r0,
                                        const __nv_bfloat16* m, int lane) {
  const int g = lane >> 2, tq = lane & 3, mi = lane >> 3, ri = lane & 7;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    load_a<P>(a, a_base, r0, kk, g, tq);
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t b0, b1, b2, b3;
      ldmatrix_x4(b0, b1, b2, b3, m + ((j + (mi >> 1)) * 8 + ri) * P + kk * 16 + (mi & 1) * 8);
      mma16816(acc[j], a, b0, b1);
      mma16816(acc[j + 1], a, b2, b3);
    }
  }
}

// acc (16 x D) += X (16 x 16 KS, bf16 A fragments in registers) * M, M a
// [16 KS][P] smem array (k rows, n contiguous, read .trans): the products
// dv += p^T do, dk += ds^T q and dq += ds k.
template <int D, int P, int KS>
__device__ __forceinline__ void mma_xm(float (&acc)[D / 8][4], const uint32_t (&x)[KS][4],
                                       const __nv_bfloat16* m, int lane) {
  const int mi = lane >> 3, ri = lane & 7;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const __nv_bfloat16* row = m + (kk * 16 + (mi & 1) * 8 + ri) * P + (mi >> 1) * 8;
#pragma unroll
    for (int n = 0; n < D / 8; n += 2) {
      uint32_t b0, b1, b2, b3;
      ldmatrix_x4_trans(b0, b1, b2, b3, row + n * 8);
      mma16816(acc[n], x[kk], b0, b1);
      mma16816(acc[n + 1], x[kk], b2, b3);
    }
  }
}

// A 16 x 8 NT float32 accumulator tile as the bf16 A fragments of its
// NT / 2 16-column k-steps.
template <int NT>
__device__ __forceinline__ void to_a(uint32_t (&x)[NT / 2][4], const float (&c)[NT][4]) {
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    x[kk][0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
    x[kk][1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
    x[kk][2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    x[kk][3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

// A warp's 16 x D float32 accumulator tile, times `mul`, as bf16 rows r and
// r + 8 (r = row0 + g) of a contiguous output with `row_stride` elements
// between rows; rows at or past `rows` are not written.
template <int D>
__device__ __forceinline__ void store_tile(__nv_bfloat16* out, int64_t row_stride, int row0,
                                           int rows, const float (&acc)[D / 8][4], float mul,
                                           int lane) {
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = row0 + g + 8 * e;
    if (r >= rows) continue;
    __nv_bfloat16* o = out + r * row_stride + 2 * tq;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(o + n * 8) =
          pack_bf16(acc[n][2 * e] * mul, acc[n][2 * e + 1] * mul);
  }
}

// Query rows a dk / dv block stages at a time: 64 at D <= 64, 32 above
// (registers: dk and dv take D float32 a thread).
template <int D>
__host__ __device__ constexpr int dkdv_bq() { return D <= 64 ? 64 : 32; }
// Keys a dq block stages at a time, by the same rule.
template <int D>
__host__ __device__ constexpr int dq_bk() { return D <= 64 ? 64 : 32; }

template <int D>
__global__ void __launch_bounds__(kThreads) dkdv_bf16_kernel(BwdParams p) {
  constexpr int P = D + 8;  // padded row: 16-byte aligned, ldmatrix rows in distinct banks
  constexpr int BQ = dkdv_bq<D>(), NQ = BQ / 8;
  extern __shared__ __align__(16) unsigned char smem_bf16[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_bf16);  // [64][P]
  __nv_bfloat16* sV = sK + kTile * P;                                 // [64][P]
  __nv_bfloat16* sQ = sV + kTile * P;                                 // [BQ][P]
  __nv_bfloat16* sG = sQ + BQ * P;                                    // [BQ][P] do
  float* sL = reinterpret_cast<float*>(sG + BQ * P);                  // [64] lse * log2(e)
  float* sD = sL + kTile;                                             // [64] delta

  const int k0 = blockIdx.x * kTile, kh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, tq = lane & 3;
  const int r0 = warp * 16;  // this warp's keys in the tile: r0 + g and r0 + g + 8
  stage_bf16<D, P>(sK, static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + kh * p.k_sh,
                   p.k_ss, k0, kTile, p.S);
  stage_bf16<D, P>(sV, static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + kh * p.v_sh,
                   p.v_ss, k0, kTile, p.S);
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.0f;
  const float scale2 = p.scale * kLog2e;

  int t_lo, t_hi;
  q_tiles<BQ, kTile>(k0, p, t_lo, t_hi);
  for (int gi = 0; gi < p.group; ++gi) {
    const int h = kh * p.group + gi;
    const int64_t bh = static_cast<int64_t>(b) * p.H + h;
    const __nv_bfloat16* qp = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
    const __nv_bfloat16* gp =
        static_cast<const __nv_bfloat16*>(p.dout) + b * p.do_sb + h * p.do_sh;
    for (int t = t_lo; t <= t_hi; ++t) {
      const int q0 = t * BQ;
      __syncthreads();  // every warp is done with the previous Q and do
      stage_bf16<D, P>(sQ, qp, p.q_ss, q0, BQ, p.S);
      stage_bf16<D, P>(sG, gp, p.do_ss, q0, BQ, p.S);
      stage_rows(sL, sD, p, bh, q0, kLog2e);
      stage_wait();

      // s^T = k q^T and dp^T = v do^T: element e of n-tile j is key
      // k0 + r0 + g + 8 (e / 2), query q0 + 8 j + 2 tq + e % 2
      float st[NQ][4], dpt[NQ][4];
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.0f;
      mma_abt<D, P, NQ>(st, sK, r0, sQ, lane);
      mma_abt<D, P, NQ>(dpt, sV, r0, sG, lane);
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + 2 * tq + (e & 1);
          const bool vis = visible(q0 + c, k0 + r0 + g + 8 * (e >> 1), p);
          const float pe = vis ? exp2f(st[j][e] * scale2 - sL[c]) : 0.0f;
          st[j][e] = pe;
          dpt[j][e] = pe * (dpt[j][e] - sD[c]);
        }
      uint32_t pa[NQ / 2][4], sa[NQ / 2][4];
      to_a<NQ>(pa, st);
      to_a<NQ>(sa, dpt);
      mma_xm<D, P, NQ / 2>(dv, pa, sG, lane);
      mma_xm<D, P, NQ / 2>(dk, sa, sQ, lane);
    }
  }
  const int64_t row_stride = static_cast<int64_t>(p.KH) * D;
  const int64_t base = (static_cast<int64_t>(b) * p.S * p.KH + kh) * D;
  store_tile<D>(static_cast<__nv_bfloat16*>(p.dk) + base + k0 * row_stride, row_stride, r0,
                p.S - k0, dk, p.scale, lane);
  store_tile<D>(static_cast<__nv_bfloat16*>(p.dv) + base + k0 * row_stride, row_stride, r0,
                p.S - k0, dv, 1.0f, lane);
}

template <int D>
__global__ void __launch_bounds__(kThreads) dq_bf16_kernel(BwdParams p) {
  constexpr int P = D + 8;
  constexpr int BK = dq_bk<D>(), NK = BK / 8;
  extern __shared__ __align__(16) unsigned char smem_bf16[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_bf16);  // [64][P]
  __nv_bfloat16* sG = sQ + kTile * P;                                 // [64][P] do
  __nv_bfloat16* sK = sG + kTile * P;                                 // [BK][P]
  __nv_bfloat16* sV = sK + BK * P;                                    // [BK][P]
  float* sL = reinterpret_cast<float*>(sV + BK * P);                  // [64] lse * log2(e)
  float* sD = sL + kTile;                                             // [64] delta

  const int n_q = (p.S + kTile - 1) / kTile;
  const int q0 = (n_q - 1 - static_cast<int>(blockIdx.x)) * kTile;  // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z, kh = h / p.group;
  const int64_t bh = static_cast<int64_t>(b) * p.H + h;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, tq = lane & 3;
  const int r0 = warp * 16;  // this warp's rows in the tile: r0 + g and r0 + g + 8
  const __nv_bfloat16* kp = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + kh * p.k_sh;
  const __nv_bfloat16* vp = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + kh * p.v_sh;
  stage_bf16<D, P>(sQ, static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh,
                   p.q_ss, q0, kTile, p.S);
  stage_bf16<D, P>(sG, static_cast<const __nv_bfloat16*>(p.dout) + b * p.do_sb + h * p.do_sh,
                   p.do_ss, q0, kTile, p.S);
  stage_rows(sL, sD, p, bh, q0, kLog2e);
  float dq[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.0f;
  const float scale2 = p.scale * kLog2e;

  int t_lo, t_hi;
  kv_tiles<kTile, BK>(q0, p, t_lo, t_hi);
  for (int t = t_lo; t <= t_hi; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // every warp is done with the previous K and V
    stage_bf16<D, P>(sK, kp, p.k_ss, k0, BK, p.S);
    stage_bf16<D, P>(sV, vp, p.v_ss, k0, BK, p.S);
    stage_wait();

    // s = q k^T and dp = do v^T: element e of n-tile j is row
    // q0 + r0 + g + 8 (e / 2), key k0 + 8 j + 2 tq + e % 2
    float sc[NK][4], dp[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.0f;
    mma_abt<D, P, NK>(sc, sQ, r0, sK, lane);
    mma_abt<D, P, NK>(dp, sG, r0, sV, lane);
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + g + 8 * (e >> 1);
        const bool vis = visible(q0 + r, k0 + 8 * j + 2 * tq + (e & 1), p);
        const float pe = vis ? exp2f(sc[j][e] * scale2 - sL[r]) : 0.0f;
        dp[j][e] = pe * (dp[j][e] - sD[r]);
      }
    uint32_t sa[NK / 2][4];
    to_a<NK>(sa, dp);
    mma_xm<D, P, NK / 2>(dq, sa, sK, lane);
  }
  const int64_t row_stride = static_cast<int64_t>(p.H) * D;
  store_tile<D>(static_cast<__nv_bfloat16*>(p.dq) + (static_cast<int64_t>(b) * p.S * p.H + h) * D +
                    q0 * row_stride,
                row_stride, r0, p.S - q0, dq, p.scale, lane);
}

// ---------------------------------------------------------------------------
// bfloat16 at D = 64 and 128: wgmma + TMA, warp-specialized
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 384;  // one producer warpgroup, two consumer warpgroups
constexpr int kWgConsumers = 256;
constexpr int kKvBN = 128;  // keys a dK / dV block: two consumer warpgroups of 64
constexpr int kQBM = 128;   // query rows a dQ block: two consumer warpgroups of 64

// The staged tiles and stages in flight at head width D: kKvBM query rows
// a Q / dO tile of the dK / dV kernel, kQBN keys a K / V tile of the dQ
// kernel.  At D = 128, 64 each: the dK and dV accumulators take 128
// registers a thread, the score-like products 32 each.  At D = 64 the
// gradient accumulators are half as large, so the tiles double (128),
// which halves the barriers, waits and row loads per product.
template <int D>
struct BwdTuning {
  static constexpr int kKvBM = 64, kQBN = 64, kKvStages = 3, kQStages = 2;
};
template <>
struct BwdTuning<64> {
  static constexpr int kKvBM = 128, kQBN = 128, kKvStages = 3, kQStages = 3;
};

template <int D>
constexpr size_t dkdv_wg_smem() {
  using L = WgLayout<D>;
  constexpr int bm = BwdTuning<D>::kKvBM, st = BwdTuning<D>::kKvStages;
  constexpr size_t k_bytes = static_cast<size_t>(kKvBN) * L::kChunks * L::kRowBytes;
  constexpr size_t q_bytes = static_cast<size_t>(bm) * L::kChunks * L::kRowBytes;
  // K and V, the Q / dO stages, their lse and delta rows, the barriers, and
  // slack to align the base to 1024
  return 2 * k_bytes + st * (2 * q_bytes + 2 * bm * sizeof(float)) + 8 * (2 + 2 * st) + 1024;
}

template <int D>
constexpr size_t dq_wg_smem() {
  using L = WgLayout<D>;
  constexpr int bn = BwdTuning<D>::kQBN, st = BwdTuning<D>::kQStages;
  constexpr size_t q_bytes = static_cast<size_t>(kQBM) * L::kChunks * L::kRowBytes;
  constexpr size_t k_bytes = static_cast<size_t>(bn) * L::kChunks * L::kRowBytes;
  // two (Q, dO) buffers, the K / V stages, the barriers, and the slack
  return 4 * q_bytes + st * 2 * k_bytes + 8 * (4 + 2 * st) + 1024;
}

// Item `r` of block blockIdx.x in a persistent grid of `grid` blocks: round
// r takes items r grid .. r grid + grid - 1, the block the x-th of them in
// even rounds and the x-th from the end in odd ones, so that over a list
// sorted heaviest first a block that drew a heavy item draws a light one
// next.
__device__ __forceinline__ int snake_item(int r, int grid) {
  const int x = static_cast<int>(blockIdx.x);
  return r * grid + ((r & 1) ? grid - 1 - x : x);
}

// Whether the BM query rows from q0 and the BN keys from k0 hold a (q, k)
// pair that is not visible (or lies past S).
__device__ __forceinline__ bool pair_tile_needs_mask(int q0, int bm, int k0, int bn,
                                                     const BwdParams& p) {
  return q0 + bm > p.S || k0 + bn > p.S || (p.causal && k0 + bn - 1 > q0) ||
         (p.window > 0 && q0 + bm - 1 - k0 >= p.window);
}

// dK and dV: a persistent grid walks the items (128-key tile, KV head,
// batch row), first key tiles first (under a causal mask the most query
// tiles see them).  Warp 0 loads the item's K and V once (one buffer, freed
// when both consumer warpgroups are done with the item), then for each of
// the group's G query heads and each query tile that sees the keys, the
// 64-row Q and dO tiles and their lse and delta rows through a ring of
// stages.  Consumer warpgroup cw owns keys k0 + 64 cw .. + 63:
//   S^T = K Q^T and dP^T = V dO^T by wgmma m64n64k16 from shared memory;
//   P^T = exp2(S^T scale log2(e) - lse log2(e)), 0 where not visible, and
//   dS^T = P^T (dP^T - delta), both converted to bf16 in registers as
//   wgmma's A operand: dV += P^T dO and dK += dS^T Q, dO and Q read MN-major
//   (the transpose bit), by m64nDk16.
// dK and dV stay in float32 registers for the item and are written once.
template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_do,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v,
                  const __grid_constant__ CUtensorMap tm_lse,
                  const __grid_constant__ CUtensorMap tm_delta, BwdParams p) {
  using L = WgLayout<D>;
  constexpr int kStages = BwdTuning<D>::kKvStages, kKvBM = BwdTuning<D>::kKvBM;
  constexpr int kStepsPerChunk = L::kChunk / 16;
  constexpr uint32_t kKChunk = kKvBN * L::kRowBytes, kKBytes = kKChunk * L::kChunks;
  constexpr uint32_t kQChunk = kKvBM * L::kRowBytes, kQBytes = kQChunk * L::kChunks;
  constexpr uint32_t kRowsBytes = kKvBM * sizeof(float);
  constexpr uint32_t kSbo = 8 * L::kRowBytes;  // 8 rows of a chunk
  extern __shared__ unsigned char smem_wg[];
  const uint32_t base = (smem_u32(smem_wg) + 1023) & ~1023u;  // the swizzle atoms' alignment
  const unsigned char* gbase = smem_wg + (base - smem_u32(smem_wg));
  const uint32_t s_k = base, s_v = base + kKBytes;
  const uint32_t s_st = base + 2 * kKBytes;              // stage s: Q, then dO
  const uint32_t s_rows = s_st + kStages * 2 * kQBytes;  // stage s: lse, then delta
  const uint32_t bars = s_rows + kStages * 2 * kRowsBytes;
  auto st_q = [&](int s) { return s_st + 2 * s * kQBytes; };
  auto st_do = [&](int s) { return s_st + (2 * s + 1) * kQBytes; };
  auto st_lse = [&](int s) { return s_rows + 2 * s * kRowsBytes; };
  auto st_delta = [&](int s) { return s_rows + (2 * s + 1) * kRowsBytes; };
  const uint32_t kv_full = bars, kv_empty = bars + 8;
  auto full = [&](int s) { return bars + 8 * (2 + s); };
  auto empty = [&](int s) { return bars + 8 * (2 + kStages + s); };

  const int slots = p.KH * p.B, items = ((p.S + kKvBN - 1) / kKvBN) * slots;
  auto item_of = [&](int item, int& k0, int& kh, int& b) {
    const int r = item % slots;
    k0 = (item / slots) * kKvBN;
    kh = r % p.KH;
    b = r / p.KH;
  };
  const int grid = static_cast<int>(gridDim.x);

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, kWgConsumers);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kWgConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {  // producer
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      int ring = 0, n = 0;  // Q / dO tiles and items loaded so far
      for (int r = 0; r * grid < items; ++r) {
        const int item = snake_item(r, grid);
        if (item >= items) continue;
        int k0, kh, b;
        item_of(item, k0, kh, b);
        int t_lo, t_hi;
        q_tiles<kKvBM, kKvBN>(k0, p, t_lo, t_hi);
        mbar_wait(kv_empty, (n & 1) ^ 1);
        mbar_expect_tx(kv_full, 2 * kKBytes);
        for (int c = 0; c < L::kChunks; ++c) {
          tma_load_4d(s_k + c * kKChunk, &tm_k, c * L::kChunk, kh, k0, b, kv_full);
          tma_load_4d(s_v + c * kKChunk, &tm_v, c * L::kChunk, kh, k0, b, kv_full);
        }
        for (int gi = 0; gi < p.group; ++gi) {
          const int h = kh * p.group + gi;
          const int row0 = (b * p.H + h) * p.sp;  // (b, h)'s first lse / delta element
          for (int t = t_lo; t <= t_hi; ++t, ++ring) {
            const int s = ring % kStages;
            mbar_wait(empty(s), ((ring / kStages) & 1) ^ 1);
            mbar_expect_tx(full(s), 2 * kQBytes + 2 * kRowsBytes);
            for (int c = 0; c < L::kChunks; ++c) {
              tma_load_4d(st_q(s) + c * kQChunk, &tm_q, c * L::kChunk, h, t * kKvBM, b, full(s));
              tma_load_4d(st_do(s) + c * kQChunk, &tm_do, c * L::kChunk, h, t * kKvBM, b,
                          full(s));
            }
            tma_load_1d(st_lse(s), &tm_lse, row0 + t * kKvBM, full(s));  // lse log2(e)
            tma_load_1d(st_delta(s), &tm_delta, row0 + t * kKvBM, full(s));
          }
        }
        ++n;
      }
    }
  } else {  // consumers
    setmaxnreg_inc<232>();
    const int cw = wg - 1;
    const int ct = threadIdx.x - 128 * wg, warp = ct / 32, lane = ct % 32;
    const int g = lane >> 2, tq = lane & 3;
    const float scale2 = p.scale * kLog2e;
    int ring = 0, n = 0;
    for (int r = 0; r * grid < items; ++r) {
      const int item = snake_item(r, grid);
      if (item >= items) continue;
      int k0, kh, b;
      item_of(item, k0, kh, b);
      int t_lo, t_hi;
      q_tiles<kKvBM, kKvBN>(k0, p, t_lo, t_hi);
      const int wk0 = k0 + 64 * cw;  // this warpgroup's keys
      const int krow[2] = {wk0 + 16 * warp + g, wk0 + 16 * warp + g + 8};
      float dk[D / 2], dv[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.0f;
      mbar_wait(kv_full, n & 1);

      for (int gi = 0; gi < p.group; ++gi) {
        for (int t = t_lo; t <= t_hi; ++t, ++ring) {
          const int s = ring % kStages;
          const int q0 = t * kKvBM;
          mbar_wait(full(s), (ring / kStages) & 1);

          // S^T and dP^T: element 4 j + e is key krow[e / 2], query
          // q0 + 8 j + 2 tq + e % 2
          float st[kKvBM / 2] = {}, dpt[kKvBM / 2] = {};  // overwritten (accumulate 0)
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < D / 16; ++ks) {
            const uint32_t off = (ks / kStepsPerChunk) * kKChunk + (ks % kStepsPerChunk) * 32;
            const uint32_t qoff = (ks / kStepsPerChunk) * kQChunk + (ks % kStepsPerChunk) * 32;
            wgmma_ss<kKvBM>(st, wg_desc(s_k + off + 64 * cw * L::kRowBytes, 16, kSbo,
                                        L::kDescLayout),
                            wg_desc(st_q(s) + qoff, 16, kSbo, L::kDescLayout), ks > 0);
          }
          wgmma_commit();
#pragma unroll
          for (int ks = 0; ks < D / 16; ++ks) {
            const uint32_t off = (ks / kStepsPerChunk) * kKChunk + (ks % kStepsPerChunk) * 32;
            const uint32_t qoff = (ks / kStepsPerChunk) * kQChunk + (ks % kStepsPerChunk) * 32;
            wgmma_ss<kKvBM>(dpt, wg_desc(s_v + off + 64 * cw * L::kRowBytes, 16, kSbo,
                                         L::kDescLayout),
                            wg_desc(st_do(s) + qoff, 16, kSbo, L::kDescLayout), ks > 0);
          }
          wgmma_commit();

          // P^T in place of S^T while dP^T's products run, then dS^T =
          // P^T (dP^T - delta) in place of dP^T; both as the bf16 A fragments
          // of the 16-query steps
          const float* lse = reinterpret_cast<const float*>(gbase + (st_lse(s) - base));
          const float* delta = reinterpret_cast<const float*>(gbase + (st_delta(s) - base));
          wgmma_wait<1>();
          fence_operands(st);
          // where the tile needs a mask, a query that does not see the key
          // (or lies past S) scores -inf, tested against each key's range
          // of visible queries: its probability is then exactly 0
          if (pair_tile_needs_mask(q0, kKvBM, wk0, 64, p)) {
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int k = krow[r];
              const int last = p.window > 0 ? min(p.S - 1, k + p.window - 1) : p.S - 1;
              const int lo = (p.causal ? k : 0) - q0 - 2 * tq;
              const int hi = (k < p.S ? last : -1) - q0 - 2 * tq;
#pragma unroll
              for (int j = 0; j < kKvBM / 8; ++j)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  const int col = 8 * j + e;
                  if (col < lo || col > hi) st[4 * j + 2 * r + e] = -INFINITY;
                }
            }
          }
#pragma unroll
          for (int j = 0; j < kKvBM / 8; ++j) {
            const float2 l2 = *reinterpret_cast<const float2*>(lse + 8 * j + 2 * tq);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              st[4 * j + e] = ex2_approx(fmaf(st[4 * j + e], scale2, -(e & 1 ? l2.y : l2.x)));
          }
          wgmma_wait<0>();
          fence_operands(dpt);
#pragma unroll
          for (int j = 0; j < kKvBM / 8; ++j) {
            const float2 d2 = *reinterpret_cast<const float2*>(delta + 8 * j + 2 * tq);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              dpt[4 * j + e] = st[4 * j + e] * (dpt[4 * j + e] - (e & 1 ? d2.y : d2.x));
          }
          uint32_t pa[kKvBM / 16][4], sa[kKvBM / 16][4];
#pragma unroll
          for (int j = 0; j < kKvBM / 8; ++j) {
            pa[j / 2][2 * (j & 1)] = pack_bf16(st[4 * j], st[4 * j + 1]);
            pa[j / 2][2 * (j & 1) + 1] = pack_bf16(st[4 * j + 2], st[4 * j + 3]);
            sa[j / 2][2 * (j & 1)] = pack_bf16(dpt[4 * j], dpt[4 * j + 1]);
            sa[j / 2][2 * (j & 1) + 1] = pack_bf16(dpt[4 * j + 2], dpt[4 * j + 3]);
          }

          // dV += P^T dO and dK += dS^T Q, dO and Q read MN-major
          fence_operands(dv);
          fence_operands(dk);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kKvBM / 16; ++kk)
            wgmma_rs<D>(dv, pa[kk], wg_desc(st_do(s) + kk * 16 * L::kRowBytes, kQChunk, kSbo,
                                            L::kDescLayout));
#pragma unroll
          for (int kk = 0; kk < kKvBM / 16; ++kk)
            wgmma_rs<D>(dk, sa[kk], wg_desc(st_q(s) + kk * 16 * L::kRowBytes, kQChunk, kSbo,
                                            L::kDescLayout));
          wgmma_commit();
          wgmma_wait<0>();
          fence_operands(dv);
          fence_operands(dk);
          mbar_arrive(empty(s));
        }
      }
      mbar_arrive(kv_empty);  // the producer may load the next item's K and V

      const int64_t row_stride = static_cast<int64_t>(p.KH) * D;
      const int64_t head = (static_cast<int64_t>(b) * p.S * p.KH + kh) * D;
      __nv_bfloat16* dkp = static_cast<__nv_bfloat16*>(p.dk) + head;
      __nv_bfloat16* dvp = static_cast<__nv_bfloat16*>(p.dv) + head;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (krow[e] >= p.S) continue;
        const int64_t at = krow[e] * row_stride + 2 * tq;
#pragma unroll
        for (int c = 0; c < D / 8; ++c) {
          *reinterpret_cast<uint32_t*>(dkp + at + c * 8) =
              pack_bf16(dk[4 * c + 2 * e] * p.scale, dk[4 * c + 2 * e + 1] * p.scale);
          *reinterpret_cast<uint32_t*>(dvp + at + c * 8) =
              pack_bf16(dv[4 * c + 2 * e], dv[4 * c + 2 * e + 1]);
        }
      }
      ++n;
    }
  }
}

// dQ: a persistent grid walks the items (128-row query tile, head, batch
// row), heaviest query tiles first, as the forward.  Warp 0 loads the
// item's Q and dO (two buffers, so the next item's arrive during this one),
// then the 64-key K and V tiles the rows see through a ring of stages.
// Consumer warpgroup cw owns rows q0 + 64 cw .. + 63, their lse and delta
// in registers:
//   S = Q K^T and dP = dO V^T by wgmma m64n64k16 from shared memory;
//   dS = P (dP - delta), P = exp2(S scale log2(e) - lse log2(e)), 0 where
//   not visible; dQ += dS K with dS as bf16 registers and K read MN-major.
template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_do,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v, BwdParams p) {
  using L = WgLayout<D>;
  constexpr int kStages = BwdTuning<D>::kQStages, kQBN = BwdTuning<D>::kQBN;
  constexpr int kStepsPerChunk = L::kChunk / 16;
  constexpr uint32_t kQChunk = kQBM * L::kRowBytes, kQBytes = kQChunk * L::kChunks;
  constexpr uint32_t kKChunk = kQBN * L::kRowBytes, kKBytes = kKChunk * L::kChunks;
  constexpr uint32_t kSbo = 8 * L::kRowBytes;
  extern __shared__ unsigned char smem_wg[];
  const uint32_t base = (smem_u32(smem_wg) + 1023) & ~1023u;
  const uint32_t s_qd = base;                 // buffer qs: Q, then dO
  const uint32_t s_kv = base + 4 * kQBytes;   // stage s: K, then V
  const uint32_t bars = s_kv + kStages * 2 * kKBytes;
  auto buf_q = [&](int qs) { return s_qd + 2 * qs * kQBytes; };
  auto buf_do = [&](int qs) { return s_qd + (2 * qs + 1) * kQBytes; };
  auto st_k = [&](int s) { return s_kv + 2 * s * kKBytes; };
  auto st_v = [&](int s) { return s_kv + (2 * s + 1) * kKBytes; };
  auto qd_full = [&](int qs) { return bars + 8 * qs; };
  auto qd_empty = [&](int qs) { return bars + 8 * (2 + qs); };
  auto full = [&](int s) { return bars + 8 * (4 + s); };
  auto empty = [&](int s) { return bars + 8 * (4 + kStages + s); };

  const int n_q = (p.S + kQBM - 1) / kQBM;
  const int heads = p.H, items = n_q * heads * p.B;
  auto item_of = [&](int item, int& q0, int& h, int& b) {
    const int hb = item % (heads * p.B);
    q0 = (n_q - 1 - item / (heads * p.B)) * kQBM;
    h = hb % heads;
    b = hb / heads;
  };
  const int grid = static_cast<int>(gridDim.x);

  if (threadIdx.x == 0) {
    for (int qs = 0; qs < 2; ++qs) {
      mbar_init(qd_full(qs), 1);
      mbar_init(qd_empty(qs), kWgConsumers);
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
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
      for (int r = 0; r * grid < items; ++r) {
        const int item = snake_item(r, grid);
        if (item >= items) continue;
        int q0, h, b;
        item_of(item, q0, h, b);
        const int kh = h / p.group, qs = n & 1;
        int t_lo, t_hi;
        kv_tiles<kQBM, kQBN>(q0, p, t_lo, t_hi);
        mbar_wait(qd_empty(qs), ((n >> 1) & 1) ^ 1);
        mbar_expect_tx(qd_full(qs), 2 * kQBytes);
        for (int c = 0; c < L::kChunks; ++c) {
          tma_load_4d(buf_q(qs) + c * kQChunk, &tm_q, c * L::kChunk, h, q0, b, qd_full(qs));
          tma_load_4d(buf_do(qs) + c * kQChunk, &tm_do, c * L::kChunk, h, q0, b, qd_full(qs));
        }
        for (int t = t_lo; t <= t_hi; ++t, ++ring) {
          const int s = ring % kStages;
          mbar_wait(empty(s), ((ring / kStages) & 1) ^ 1);
          mbar_expect_tx(full(s), 2 * kKBytes);
          for (int c = 0; c < L::kChunks; ++c) {
            tma_load_4d(st_k(s) + c * kKChunk, &tm_k, c * L::kChunk, kh, t * kQBN, b, full(s));
            tma_load_4d(st_v(s) + c * kKChunk, &tm_v, c * L::kChunk, kh, t * kQBN, b, full(s));
          }
        }
        ++n;
      }
    }
  } else {  // consumers
    setmaxnreg_inc<232>();
    const int cw = wg - 1;
    const int ct = threadIdx.x - 128 * wg, warp = ct / 32, lane = ct % 32;
    const int g = lane >> 2, tq = lane & 3;
    const float scale2 = p.scale * kLog2e;
    int ring = 0, n = 0;
    for (int r = 0; r * grid < items; ++r) {
      const int item = snake_item(r, grid);
      if (item >= items) continue;
      int q0, h, b;
      item_of(item, q0, h, b);
      const int qs = n & 1;
      int t_lo, t_hi;
      kv_tiles<kQBM, kQBN>(q0, p, t_lo, t_hi);
      const int wq0 = q0 + 64 * cw;
      const int qrow[2] = {wq0 + 16 * warp + g, wq0 + 16 * warp + g + 8};
      const int64_t bh = static_cast<int64_t>(b) * p.H + h;
      float lse2[2], dl[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool in = qrow[e] < p.S;
        lse2[e] = in ? p.lse2[bh * p.sp + qrow[e]] : 0.0f;
        dl[e] = in ? p.delta[bh * p.sp + qrow[e]] : 0.0f;
      }
      float dq[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dq[i] = 0.0f;
      mbar_wait(qd_full(qs), (n >> 1) & 1);

      for (int t = t_lo; t <= t_hi; ++t, ++ring) {
        const int s = ring % kStages;
        const int k0 = t * kQBN;
        mbar_wait(full(s), (ring / kStages) & 1);

        // S and dP: element 4 j + e is row qrow[e / 2], key k0 + 8 j + 2 tq + e % 2
        float sc[kQBN / 2] = {}, dp[kQBN / 2] = {};  // overwritten (accumulate 0)
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks) {
          const uint32_t qoff = (ks / kStepsPerChunk) * kQChunk + (ks % kStepsPerChunk) * 32 +
                                64 * cw * L::kRowBytes;
          const uint32_t koff = (ks / kStepsPerChunk) * kKChunk + (ks % kStepsPerChunk) * 32;
          wgmma_ss<kQBN>(sc, wg_desc(buf_q(qs) + qoff, 16, kSbo, L::kDescLayout),
                         wg_desc(st_k(s) + koff, 16, kSbo, L::kDescLayout), ks > 0);
        }
        wgmma_commit();
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks) {
          const uint32_t qoff = (ks / kStepsPerChunk) * kQChunk + (ks % kStepsPerChunk) * 32 +
                                64 * cw * L::kRowBytes;
          const uint32_t koff = (ks / kStepsPerChunk) * kKChunk + (ks % kStepsPerChunk) * 32;
          wgmma_ss<kQBN>(dp, wg_desc(buf_do(qs) + qoff, 16, kSbo, L::kDescLayout),
                         wg_desc(st_v(s) + koff, 16, kSbo, L::kDescLayout), ks > 0);
        }
        wgmma_commit();

        // P in place of S while dP's products run, then dS = P (dP - delta);
        // where the tile needs a mask, a key the row does not see (or past
        // S) scores -inf, tested against each row's range of visible keys
        wgmma_wait<1>();
        fence_operands(sc);
        if (pair_tile_needs_mask(wq0, 64, k0, kQBN, p)) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int hi = min(p.S - 1, p.causal ? qrow[r] : p.S - 1) - k0 - 2 * tq;
            const int lo = (p.window > 0 ? qrow[r] - p.window + 1 : 0) - k0 - 2 * tq;
#pragma unroll
            for (int j = 0; j < kQBN / 8; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int col = 8 * j + e;
                if (col < lo || col > hi) sc[4 * j + 2 * r + e] = -INFINITY;
              }
          }
        }
#pragma unroll
        for (int j = 0; j < kQBN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sc[4 * j + e] = ex2_approx(fmaf(sc[4 * j + e], scale2, -lse2[e >> 1]));
        wgmma_wait<0>();
        fence_operands(dp);
        uint32_t sa[kQBN / 16][4];  // dS as the A fragments of the 16-key steps
#pragma unroll
        for (int j = 0; j < kQBN / 8; ++j) {
          float se[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) se[e] = sc[4 * j + e] * (dp[4 * j + e] - dl[e >> 1]);
          sa[j / 2][2 * (j & 1)] = pack_bf16(se[0], se[1]);
          sa[j / 2][2 * (j & 1) + 1] = pack_bf16(se[2], se[3]);
        }
        fence_operands(dq);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kQBN / 16; ++kk)
          wgmma_rs<D>(dq, sa[kk], wg_desc(st_k(s) + kk * 16 * L::kRowBytes, kKChunk, kSbo,
                                          L::kDescLayout));
        wgmma_commit();
        wgmma_wait<0>();
        fence_operands(dq);
        mbar_arrive(empty(s));
      }
      mbar_arrive(qd_empty(qs));  // the producer may load the item after next's Q and dO

      const int64_t row_stride = static_cast<int64_t>(p.H) * D;
      __nv_bfloat16* dqp =
          static_cast<__nv_bfloat16*>(p.dq) + (static_cast<int64_t>(b) * p.S * p.H + h) * D;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (qrow[e] >= p.S) continue;
        __nv_bfloat16* row = dqp + qrow[e] * row_stride + 2 * tq;
#pragma unroll
        for (int c = 0; c < D / 8; ++c)
          *reinterpret_cast<uint32_t*>(row + c * 8) =
              pack_bf16(dq[4 * c + 2 * e] * p.scale, dq[4 * c + 2 * e + 1] * p.scale);
      }
      ++n;
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// Which code runs a call: 0 float32 (float32 pipes), 1 bf16 on mma.sync
// (D = 32, 80), 2 bf16 on wgmma + TMA (D = 64, 128).
int route(int dtype, int d) { return dtype == 0 ? 0 : (d == 64 || d == 128) ? 2 : 1; }

size_t dkdv_smem(int dtype, int d) {
  if (dtype == 0)
    return sizeof(float) * (4 * static_cast<size_t>(kTile) * (d + 1) +
                            2 * static_cast<size_t>(kTile) * (kTile + 1) + 2 * kTile);
  const size_t bq = d <= 64 ? 64 : 32;
  return sizeof(__nv_bfloat16) * (2 * kTile + 2 * bq) * (d + 8) + sizeof(float) * 2 * kTile;
}

size_t dq_smem(int dtype, int d) {
  if (dtype == 0)
    return sizeof(float) * (4 * static_cast<size_t>(kTile) * (d + 1) +
                            static_cast<size_t>(kTile) * (kTile + 1) + 2 * kTile);
  const size_t bk = d <= 64 ? 64 : 32;
  return sizeof(__nv_bfloat16) * (2 * kTile + 2 * bk) * (d + 8) + sizeof(float) * 2 * kTile;
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, size_t smem, dim3 grid, const BwdParams& p,
                   cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// The two persistent kernels of the wgmma route, after delta_bf16_kernel: dK
// and dV, then dQ, each at most one block an SM and one a work item.
template <int D>
cudaError_t launch_wgmma(const BwdParams& p, cudaStream_t stream) {
  using L = WgLayout<D>;
  CUtensorMap tq, tdo, tk, tv, tlse, tdelta;
  const int64_t rows = static_cast<int64_t>(p.B) * p.H * p.sp;  // of the padded scratch
  cudaError_t err;
  auto maps = [&](int q_rows, int k_rows) {
    cudaError_t e;
    if ((e = make_map(&tq, p.q, D, p.H, p.S, p.B, p.q_sh, p.q_ss, p.q_sb, L::kChunk, q_rows,
                      L::kSwizzle)) != cudaSuccess ||
        (e = make_map(&tdo, p.dout, D, p.H, p.S, p.B, p.do_sh, p.do_ss, p.do_sb, L::kChunk,
                      q_rows, L::kSwizzle)) != cudaSuccess ||
        (e = make_map(&tk, p.k, D, p.KH, p.S, p.B, p.k_sh, p.k_ss, p.k_sb, L::kChunk, k_rows,
                      L::kSwizzle)) != cudaSuccess)
      return e;
    return make_map(&tv, p.v, D, p.KH, p.S, p.B, p.v_sh, p.v_ss, p.v_sb, L::kChunk, k_rows,
                    L::kSwizzle);
  };
  constexpr int kKvBM = BwdTuning<D>::kKvBM, kQBN = BwdTuning<D>::kQBN;
  static_assert(kRowPad % kKvBM == 0, "a row box never crosses a padded row");
  if ((err = maps(kKvBM, kKvBN)) != cudaSuccess ||
      (err = make_map_1d(&tlse, p.lse2, rows, kKvBM)) != cudaSuccess ||
      (err = make_map_1d(&tdelta, p.delta, rows, kKvBM)) != cudaSuccess)
    return err;
  static int sms_kv[kMaxDevices] = {}, sms_q[kMaxDevices] = {};
  int count = 0;
  if ((err = prepare_persistent(dkdv_wgmma_kernel<D>, dkdv_wg_smem<D>(), sms_kv, count)) !=
      cudaSuccess)
    return err;
  const int64_t kv_items = static_cast<int64_t>((p.S + kKvBN - 1) / kKvBN) * p.KH * p.B;
  dkdv_wgmma_kernel<D><<<static_cast<int>(kv_items < count ? kv_items : count), kWgThreads,
                         dkdv_wg_smem<D>(), stream>>>(tq, tdo, tk, tv, tlse, tdelta, p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = maps(kQBM, kQBN)) != cudaSuccess ||
      (err = prepare_persistent(dq_wgmma_kernel<D>, dq_wg_smem<D>(), sms_q, count)) !=
          cudaSuccess)
    return err;
  const int64_t q_items = static_cast<int64_t>((p.S + kQBM - 1) / kQBM) * p.H * p.B;
  dq_wgmma_kernel<D><<<static_cast<int>(q_items < count ? q_items : count), kWgThreads,
                       dq_wg_smem<D>(), stream>>>(tq, tdo, tk, tv, p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(int dtype, const BwdParams& p, int B, cudaStream_t stream) {
  const int64_t rows = static_cast<int64_t>(B) * p.H * p.sp;  // of the padded scratch
  if (dtype == 0) {
    const int64_t per_block = kThreads / 32;
    delta_f32_kernel<<<static_cast<unsigned>((rows + per_block - 1) / per_block), kThreads, 0,
                       stream>>>(p, D, rows);
  } else {
    const dim3 grid((p.sp + delta_block_rows<D>() - 1) / delta_block_rows<D>(), p.H, B);
    delta_bf16_kernel<D><<<grid, kThreads, 0, stream>>>(p);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const unsigned n_t = static_cast<unsigned>((p.S + kTile - 1) / kTile);
  const dim3 g_kv(n_t, p.KH, B), g_q(n_t, p.H, B);
  if (dtype == 0) {
    if ((err = launch(dkdv_f32_kernel<D>, dkdv_smem(0, D), g_kv, p, stream)) != cudaSuccess)
      return err;
    return launch(dq_f32_kernel<D>, dq_smem(0, D), g_q, p, stream);
  }
  if constexpr (D == 64 || D == 128) {
    return launch_wgmma<D>(p, stream);
  } else {
    if ((err = launch(dkdv_bf16_kernel<D>, dkdv_smem(1, D), g_kv, p, stream)) != cudaSuccess)
      return err;
    return launch(dq_bf16_kernel<D>, dq_smem(1, D), g_q, p, stream);
  }
}

}  // namespace

// The code a call of `dtype` (0 float32, 1 bfloat16) runs at head width d:
// 0 float32 pipes, 1 bf16 on mma.sync (D = 32, 80), 2 bf16 on wgmma + TMA
// (D = 64, 128).
extern "C" int64_t flash_attention_bwd_route(int64_t dtype, int64_t d) {
  return route(static_cast<int>(dtype), static_cast<int>(d));
}

// The float32 elements of the scratch a call at (B, H, S) takes: delta and
// lse log2(e), (B, H, S rounded up to 64) each.
extern "C" int64_t flash_attention_bwd_scratch(int64_t B, int64_t H, int64_t S) {
  return 2 * B * H * padded_rows(S);
}

// q, o, dout, dq: (B, S, H, D); k, v, dk, dv: (B, S, KH, D), all of one type
// (dtype 0 float32, 1 bfloat16).  q, k, v, o and dout are read through
// `strides`: 15 int64 element strides, (batch, sequence, head) of q, k, v, o
// and dout in turn, the head axis of unit stride; for bf16 every stride a
// multiple of 8 and every pointer 16-byte aligned.  dq, dk, dv are written
// contiguous.  lse: the forward's (B, H, S) float32 row log-sum-exp,
// contiguous; delta: a float32 scratch of flash_attention_bwd_scratch(B, H,
// S) elements.  causal: 0 or 1; window:
// 0 for none.  Launches three kernels on `stream` and returns the first
// failing launch's cudaError_t (0 on success).
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const float* lse, float* delta, void* dq,
                                   void* dk, void* dv, int64_t dtype, int64_t B, int64_t S,
                                   int64_t H, int64_t KH, int64_t D, const int64_t* strides,
                                   int64_t causal, int64_t window, double scale,
                                   void* stream) {
  if (B < 1 || S < 1 || H < 1 || KH < 1 || H % KH != 0 || B > 65535 || H > 65535 ||
      S > 0x7fffffff - kTile || B * H * padded_rows(S) > 0x7fffffff || window < 0 ||
      window > 0x7fffffff ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  BwdParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
  p.lse2 = delta + B * H * padded_rows(S);
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.q_sb = strides[0], p.q_ss = strides[1], p.q_sh = strides[2];
  p.k_sb = strides[3], p.k_ss = strides[4], p.k_sh = strides[5];
  p.v_sb = strides[6], p.v_ss = strides[7], p.v_sh = strides[8];
  p.o_sb = strides[9], p.o_ss = strides[10], p.o_sh = strides[11];
  p.do_sb = strides[12], p.do_ss = strides[13], p.do_sh = strides[14];
  p.S = static_cast<int>(S);
  p.sp = static_cast<int>(padded_rows(S));
  p.H = static_cast<int>(H);
  p.KH = static_cast<int>(KH);
  p.B = static_cast<int>(B);
  p.group = static_cast<int>(H / KH);
  p.causal = causal != 0;
  p.window = static_cast<int>(window);
  p.scale = static_cast<float>(scale);
  const int d = static_cast<int>(dtype), b = static_cast<int>(B);
  auto s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return static_cast<int>(launch_d<32>(d, p, b, s));
    case 64: return static_cast<int>(launch_d<64>(d, p, b, s));
    case 80: return static_cast<int>(launch_d<80>(d, p, b, s));
    case 128: return static_cast<int>(launch_d<128>(d, p, b, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
