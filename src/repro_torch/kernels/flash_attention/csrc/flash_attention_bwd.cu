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
// - `delta_kernel`: rowsum(do o), one warp a row, into a float32 scratch.
// - `dkdv_*_kernel`: a block owns 64 keys of one KV head and walks its G
//   query heads and, for each, the query tiles that see any of its keys,
//   accumulating dk and dv in float32 registers; it recomputes p and dp for
//   each (key tile, query tile) pair.
// - `dq_*_kernel`: a block owns 64 query rows of one head and walks the KV
//   tiles they see (the forward's range), accumulating dq.
// S and dP are computed twice (once in each of the last two kernels): 14 D
// operations a visible (q, k) pair against the 10 D the five products need.
//
// bf16 (every head width: 32, 64, 80, 128) on the tensor cores with
// mma.sync.m16n8k16 and float32 accumulation, a warp owning 16 rows of the
// block's tile; A fragments read from shared memory, B fragments by
// ldmatrix (.trans where the operand is [k][n] in memory), P and dS
// converted to bf16 in registers as the A operand of the second products,
// as in FlashAttention-2.  Tiles staged by cp.async, synchronously (no
// pipelining: a simple kernel first).  float32 on the float32 pipes with the
// forward's float32 tiling (thread (ty, tx) holds rows 4 ty .. 4 ty + 3 and
// columns tx + 8 j).  Rows and keys past S read as zeros, are masked to
// p = 0, and are never written: S need not be a multiple of a tile.
//
// Bound on an H100 SXM: at the LM round's shape (B 16, S 1024, H 9, Kh 3,
// D 64, causal) there are 75.5 M visible (q, k) pairs; the five products
// take 10 D = 640 operations a pair, 48.3 GFLOP, 0.049 ms at 989 TFLOP/s
// (bf16 dense tensor rate), against 57 MB of q, k, v, o, do, lse, dq, dk,
// dv (0.017 ms at 3.35 TB/s): bound by operations.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 64;  // keys of a dk / dv block, query rows of a dq block
constexpr float kLog2e = 1.4426950408889634f;

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;  // (B, H, S), natural log
  float* delta;      // (B, H, S) scratch: rowsum(do o)
  void* dq;          // (B, S, H, D), contiguous
  void* dk;          // (B, S, KH, D), contiguous
  void* dv;          // (B, S, KH, D), contiguous
  // strides in elements: batch, sequence, head
  int64_t q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh;
  int64_t do_sb, do_ss, do_sh;
  int S, H, KH, group, causal, window;
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

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// ---------------------------------------------------------------------------
// delta = rowsum(do o), one warp a row
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads) delta_kernel(BwdParams p, int D, int64_t rows) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int s = static_cast<int>(row % p.S);
  const int64_t bh = row / p.S;
  const int h = static_cast<int>(bh % p.H), b = static_cast<int>(bh / p.H);
  const T* o = static_cast<const T*>(p.o) + b * p.o_sb + s * p.o_ss + h * p.o_sh;
  const T* g = static_cast<const T*>(p.dout) + b * p.do_sb + s * p.do_ss + h * p.do_sh;
  float acc = 0.0f;
  for (int c = lane; c < D; c += 32) acc = fmaf(to_f(o[c]), to_f(g[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) p.delta[row] = acc;
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
    s_delta[r] = s < p.S ? p.delta[bh * p.S + s] : 0.0f;
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
// host side
// ---------------------------------------------------------------------------

// Which code runs a call: 0 float32 (float32 pipes), 1 bf16 on mma.sync.
int route(int dtype) { return dtype == 0 ? 0 : 1; }

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

template <int D>
cudaError_t launch_d(int dtype, const BwdParams& p, int B, cudaStream_t stream) {
  const int64_t rows = static_cast<int64_t>(B) * p.H * p.S;
  const unsigned n_delta = static_cast<unsigned>((rows + kThreads / 32 - 1) / (kThreads / 32));
  if (dtype == 0) {
    delta_kernel<float><<<n_delta, kThreads, 0, stream>>>(p, D, rows);
  } else {
    delta_kernel<__nv_bfloat16><<<n_delta, kThreads, 0, stream>>>(p, D, rows);
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
  if ((err = launch(dkdv_bf16_kernel<D>, dkdv_smem(1, D), g_kv, p, stream)) != cudaSuccess)
    return err;
  return launch(dq_bf16_kernel<D>, dq_smem(1, D), g_q, p, stream);
}

}  // namespace

// The code a call of `dtype` (0 float32, 1 bfloat16) runs at head width d:
// 0 float32 pipes, 1 bf16 on mma.sync (every width).
extern "C" int64_t flash_attention_bwd_route(int64_t dtype, int64_t d) {
  (void)d;
  return route(static_cast<int>(dtype));
}

// q, o, dout, dq: (B, S, H, D); k, v, dk, dv: (B, S, KH, D), all of one type
// (dtype 0 float32, 1 bfloat16).  q, k, v, o and dout are read through
// `strides`: 15 int64 element strides, (batch, sequence, head) of q, k, v, o
// and dout in turn, the head axis of unit stride; for bf16 every stride a
// multiple of 8 and every pointer 16-byte aligned.  dq, dk, dv are written
// contiguous.  lse: the forward's (B, H, S) float32 row log-sum-exp,
// contiguous; delta: a (B, H, S) float32 scratch.  causal: 0 or 1; window:
// 0 for none.  Launches three kernels on `stream` and returns the first
// failing launch's cudaError_t (0 on success).
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const float* lse, float* delta, void* dq,
                                   void* dk, void* dv, int64_t dtype, int64_t B, int64_t S,
                                   int64_t H, int64_t KH, int64_t D, const int64_t* strides,
                                   int64_t causal, int64_t window, double scale,
                                   void* stream) {
  if (B < 1 || S < 1 || H < 1 || KH < 1 || H % KH != 0 || B > 65535 || H > 65535 ||
      S > 0x7fffffff - kTile || window < 0 || window > 0x7fffffff ||
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
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.q_sb = strides[0], p.q_ss = strides[1], p.q_sh = strides[2];
  p.k_sb = strides[3], p.k_ss = strides[4], p.k_sh = strides[5];
  p.v_sb = strides[6], p.v_ss = strides[7], p.v_sh = strides[8];
  p.o_sb = strides[9], p.o_ss = strides[10], p.o_sh = strides[11];
  p.do_sb = strides[12], p.do_ss = strides[13], p.do_sh = strides[14];
  p.S = static_cast<int>(S);
  p.H = static_cast<int>(H);
  p.KH = static_cast<int>(KH);
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
