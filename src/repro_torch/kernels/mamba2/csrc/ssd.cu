// Chunked Mamba2 SSD (state-space duality) scan on Hopper (sm_90a).
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
// exponent is positive and is never evaluated.
//
// Design (simple first):
// - one block of 256 threads per (b, h); a loop over chunks inside the block
//   takes the place of the TPU's sequential grid axis.
// - the state lives in shared memory transposed, St[n][p] (16 KB at P = N =
//   64), read from the state given (or zeroed) and written to the final state
//   after the last chunk.
// - per chunk, x (Q x P), B and C (Q x N) are staged in shared memory as
//   float32 (bf16 inputs are widened as they are staged), rows padded by 4
//   floats: 16-byte aligned for float4 reads, and an odd number of 16-byte
//   units apart, so the reads below are free of bank conflicts.  B and C of
//   head h are group h / (H / G), read through the strides: the repeated
//   copy the reference makes is never made.  Rows past Q (up to a multiple of
//   16) and past T are staged as zeros with dt = 0: a ragged last chunk
//   leaves the state as the reference's zero padding does, and writes no row
//   past T.
// - the chunk's log-decays are summed in order by one thread, as a
//   sequential cumsum does.
// - the (Q x Q) weights att: each thread holds a 4 x 4 tile (rows ti + 16 i,
//   columns si + 16 j) and reads float4s of C and B along N.
// - outputs and state update: thread (rg, pg) holds columns 4 pg .. 4 pg + 3
//   of P for the rows rg, rg + RG, ... (RG = 256 / (P / 4)), of y and of St,
//   reading x and St as float4s; the decayed state update is accumulated in
//   registers while the other threads still read the old state, and stored
//   after a barrier.
// - x, B and C are read through (batch, token) strides, with each token's
//   (H, P) or (G, N) block contiguous: the model passes slices of its
//   convolution output in place.  y (B, T, H, P) is float32.
//
// Bound on an H100 SXM: at B = 4, T = 1024, H = 80, P = N = 64, G = 1,
// Q = 64 a call from a zero state in float32 reads x (84 MB), B and C (1.0 MB
// each) and dt (1.3 MB), and writes y (84 MB) and the final state (5.2 MB):
// 176 MB, 0.053 ms at 3.35 TB/s.  Its four chunk products (C B^T and att x
// below the diagonal, C S^T and the state update in full) are about 8 GFLOP,
// 0.12 ms at 67 TFLOP/s float32 (tensor cores are not used: the 5e-5 check
// forbids TF32): it is bound by operations.  What the simple design leaves
// on the table: the products run on the float32 pipes from shared memory,
// C B^T and att x are computed in full and masked, five barriers split each
// chunk, 320 blocks of 256 threads fill the 132 SMs to about a fifth of
// their threads, and nothing overlaps the next chunk's loads with this
// chunk's arithmetic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChunk = 64;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

__host__ __device__ constexpr int padded_rows(int q) { return (q + 15) / 16 * 16; }
// att's row stride: 16 more than a multiple of 32, so the two row groups of a
// warp write and read different banks
__host__ __device__ constexpr int att_stride(int q) { return (q + 15) / 32 * 32 + 16; }

template <int P, int N>
size_t smem_floats(int q) {
  const int r = padded_rows(q);
  return static_cast<size_t>(r) * (P + 4) + 2 * static_cast<size_t>(r) * (N + 4) +
         static_cast<size_t>(N) * (P + 4) + static_cast<size_t>(q) * att_stride(q) + 4 * r;
}

template <int P, int N, typename T>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const T* __restrict__ x, const T* __restrict__ bm, const T* __restrict__ cm,
           const float* __restrict__ dt, const float* __restrict__ a,
           const float* __restrict__ state_in, float* __restrict__ y,
           float* __restrict__ state_out, int T_len, int H, int G, int Q, int64_t x_sb,
           int64_t x_st, int64_t b_sb, int64_t b_st, int64_t c_sb, int64_t c_st) {
  constexpr int XS = P + 4;          // padded row of x and of St
  constexpr int BS = N + 4;          // padded row of B and C
  constexpr int PG = P / 4;          // float4 column groups of a P row
  constexpr int RG = kThreads / PG;  // row groups of the output and state phases
  constexpr int YR = (kMaxChunk + RG - 1) / RG;  // output rows a thread holds
  constexpr int SR = (N + RG - 1) / RG;          // state rows a thread holds
  static_assert(P % 4 == 0 && N % 4 == 0 && PG <= kThreads, "P and N multiples of 4");

  const int R = padded_rows(Q);
  const int AS = att_stride(Q);
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* s_x = smem;              // [R][XS] x
  float* s_b = s_x + R * XS;      // [R][BS] B
  float* s_c = s_b + R * BS;      // [R][BS] C
  float* s_st = s_c + R * BS;     // [N][XS] the state, transposed
  float* s_att = s_st + N * XS;   // [Q][AS] att
  float* s_dt = s_att + Q * AS;   // [R] dt
  float* s_cum = s_dt + R;        // [R] inclusive cumsum of dt * a
  float* s_w = s_cum + R;         // [R] dt * exp(cum_last - cum)
  float* s_ecum = s_w + R;        // [R] exp(cum)

  const int tid = threadIdx.x;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int g = h / (H / G);
  const float a_h = a[h];
  const int64_t state_off = static_cast<int64_t>(blockIdx.x) * P * N;
  const T* x_base = x + b * x_sb + static_cast<int64_t>(h) * P;
  const T* b_base = bm + b * b_sb + static_cast<int64_t>(g) * N;
  const T* c_base = cm + b * c_sb + static_cast<int64_t>(g) * N;
  const float* dt_base = dt + static_cast<int64_t>(b) * T_len * H + h;
  float* y_base = y + (static_cast<int64_t>(b) * T_len * H + h) * P;
  const int64_t y_st = static_cast<int64_t>(H) * P;

  for (int e = tid; e < P * N; e += kThreads) {
    const int p = e / N, n = e % N;
    s_st[n * XS + p] = state_in != nullptr ? state_in[state_off + e] : 0.0f;
  }

  const int pg = tid % PG, rg = tid / PG;  // output / state phases
  const int ti = tid / 16, si = tid % 16;  // the att phase

  for (int t0 = 0; t0 < T_len; t0 += Q) {
    __syncthreads();  // the previous chunk is done with every staged buffer
    for (int e = tid; e < R * P; e += kThreads) {
      const int t = e / P, p = e % P;
      const bool valid = t < Q && t0 + t < T_len;
      s_x[t * XS + p] = valid ? widen(x_base[(t0 + t) * x_st + p]) : 0.0f;
    }
    for (int e = tid; e < R * N; e += kThreads) {
      const int t = e / N, n = e % N;
      const bool valid = t < Q && t0 + t < T_len;
      s_b[t * BS + n] = valid ? widen(b_base[(t0 + t) * b_st + n]) : 0.0f;
      s_c[t * BS + n] = valid ? widen(c_base[(t0 + t) * c_st + n]) : 0.0f;
    }
    if (tid < R) {
      const bool valid = tid < Q && t0 + tid < T_len;
      s_dt[tid] = valid ? dt_base[static_cast<int64_t>(t0 + tid) * H] : 0.0f;
    }
    __syncthreads();

    if (tid == 0) {  // the chunk's log-decays, summed in order
      float run = 0.0f;
      for (int t = 0; t < R; ++t) {
        run += s_dt[t] * a_h;
        s_cum[t] = run;
      }
    }
    __syncthreads();

    if (tid < R) {
      const float cum = s_cum[tid];
      s_w[tid] = s_dt[tid] * expf(s_cum[Q - 1] - cum);
      s_ecum[tid] = expf(cum);
    }
    // att[t, s] for the 4 x 4 tile of rows ti + 16 i and columns si + 16 j
    {
      const int tiles = R / 16;
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
      for (int n = 0; n < N; n += 4) {
        float4 cv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (i < tiles) {
            cv[i] = *reinterpret_cast<const float4*>(&s_c[(ti + 16 * i) * BS + n]);
            bv[i] = *reinterpret_cast<const float4*>(&s_b[(si + 16 * i) * BS + n]);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (i < tiles && j < tiles) {
              acc[i][j] += cv[i].x * bv[j].x;
              acc[i][j] += cv[i].y * bv[j].y;
              acc[i][j] += cv[i].z * bv[j].z;
              acc[i][j] += cv[i].w * bv[j].w;
            }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ti + 16 * i;
        if (i < tiles && t < Q) {
          const float cum_t = s_cum[t];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int s = si + 16 * j;
            if (j < tiles && s < Q)
              s_att[t * AS + s] = s <= t ? expf(cum_t - s_cum[s]) * acc[i][j] * s_dt[s] : 0.0f;
          }
        }
      }
    }
    __syncthreads();

    // outputs: y[t, 4 pg ..] for the rows rg + RG i
    {
      float4 acc[YR], inter[YR];
#pragma unroll
      for (int i = 0; i < YR; ++i) {
        acc[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        inter[i] = acc[i];
      }
      for (int s = 0; s < Q; ++s) {
        const float4 xv = *reinterpret_cast<const float4*>(&s_x[s * XS + 4 * pg]);
#pragma unroll
        for (int i = 0; i < YR; ++i) {
          const int t = rg + RG * i;
          if (t < Q) {
            const float w = s_att[t * AS + s];
            acc[i].x += w * xv.x;
            acc[i].y += w * xv.y;
            acc[i].z += w * xv.z;
            acc[i].w += w * xv.w;
          }
        }
      }
      for (int n = 0; n < N; ++n) {
        const float4 sv = *reinterpret_cast<const float4*>(&s_st[n * XS + 4 * pg]);
#pragma unroll
        for (int i = 0; i < YR; ++i) {
          const int t = rg + RG * i;
          if (t < Q) {
            const float cv = s_c[t * BS + n];
            inter[i].x += cv * sv.x;
            inter[i].y += cv * sv.y;
            inter[i].z += cv * sv.z;
            inter[i].w += cv * sv.w;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < YR; ++i) {
        const int t = rg + RG * i;
        if (t < Q && t0 + t < T_len) {
          const float e = s_ecum[t];
          const float4 out = make_float4(acc[i].x + e * inter[i].x, acc[i].y + e * inter[i].y,
                                         acc[i].z + e * inter[i].z, acc[i].w + e * inter[i].w);
          *reinterpret_cast<float4*>(&y_base[(t0 + t) * y_st + 4 * pg]) = out;
        }
      }
    }

    // state update: St[n, 4 pg ..] for the rows rg + RG i, kept in registers
    // until every thread has read the old state
    float4 nst[SR];
    {
      const float decay = expf(s_cum[Q - 1]);
#pragma unroll
      for (int i = 0; i < SR; ++i) {
        const int n = rg + RG * i;
        nst[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (n < N) {
          const float4 sv = *reinterpret_cast<const float4*>(&s_st[n * XS + 4 * pg]);
          nst[i] = make_float4(decay * sv.x, decay * sv.y, decay * sv.z, decay * sv.w);
        }
      }
      for (int s = 0; s < Q; ++s) {
        const float4 xv = *reinterpret_cast<const float4*>(&s_x[s * XS + 4 * pg]);
        const float w = s_w[s];
#pragma unroll
        for (int i = 0; i < SR; ++i) {
          const int n = rg + RG * i;
          if (n < N) {
            const float bw = s_b[s * BS + n] * w;
            nst[i].x += bw * xv.x;
            nst[i].y += bw * xv.y;
            nst[i].z += bw * xv.z;
            nst[i].w += bw * xv.w;
          }
        }
      }
    }
    __syncthreads();  // every thread has read the old state
#pragma unroll
    for (int i = 0; i < SR; ++i) {
      const int n = rg + RG * i;
      if (n < N) *reinterpret_cast<float4*>(&s_st[n * XS + 4 * pg]) = nst[i];
    }
  }
  __syncthreads();
  for (int e = tid; e < P * N; e += kThreads) {
    const int p = e / N, n = e % N;
    state_out[state_off + e] = s_st[n * XS + p];
  }
}

template <int P, int N, typename T>
cudaError_t launch(const void* x, const void* bm, const void* cm, const float* dt,
                   const float* a, const float* state_in, float* y, float* state_out, int B,
                   int T_len, int H, int G, int Q, const int64_t* strides, cudaStream_t stream) {
  const size_t smem = smem_floats<P, N>(Q) * sizeof(float);
  auto kernel = ssd_kernel<P, N, T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<B * H, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(bm), static_cast<const T*>(cm), dt, a,
      state_in, y, state_out, T_len, H, G, Q, strides[0], strides[1], strides[2], strides[3],
      strides[4], strides[5]);
  return cudaGetLastError();
}

template <int P, int N>
cudaError_t launch_typed(int dtype, const void* x, const void* bm, const void* cm,
                         const float* dt, const float* a, const float* state_in, float* y,
                         float* state_out, int B, int T_len, int H, int G, int Q,
                         const int64_t* strides, cudaStream_t stream) {
  if (dtype == 0)
    return launch<P, N, float>(x, bm, cm, dt, a, state_in, y, state_out, B, T_len, H, G, Q,
                               strides, stream);
  if (dtype == 1)
    return launch<P, N, __nv_bfloat16>(x, bm, cm, dt, a, state_in, y, state_out, B, T_len, H,
                                       G, Q, strides, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// x (B, T, H, P), bm and cm (B, T, G, N): float32 (dtype 0) or bfloat16
// (dtype 1), each token's (H, P) / (G, N) block contiguous, read through the
// (batch, token) element strides x_sb, x_st, b_sb, b_st, c_sb, c_st given in
// `strides`; dt (B, T, H) and a (H,) float32, contiguous; state_in (B, H, P,
// N) float32 or null (zero state); y (B, T, H, P) and state_out (B, H, P, N)
// float32, contiguous.  Q = chunk length, 1 <= Q <= 64; G divides H.
// Launches on `stream` and returns the launch's cudaError_t (0 on success).
extern "C" int ssd_fwd(const void* x, const void* bm, const void* cm, const float* dt,
                       const float* a, const float* state_in, float* y, float* state_out,
                       int64_t dtype, int64_t B, int64_t T, int64_t H, int64_t G, int64_t P,
                       int64_t N, int64_t Q, const int64_t* strides, void* stream) {
  if (B < 1 || T < 1 || H < 1 || G < 1 || H % G != 0 || Q < 1 || Q > kMaxChunk ||
      B * H > 0x7fffffff || T > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const int b = static_cast<int>(B), t = static_cast<int>(T), h = static_cast<int>(H),
            g = static_cast<int>(G), q = static_cast<int>(Q), d = static_cast<int>(dtype);
  switch (P * 1000 + N) {
    case 64064:
      return static_cast<int>(launch_typed<64, 64>(d, x, bm, cm, dt, a, state_in, y, state_out,
                                                   b, t, h, g, q, strides, s));
    case 64032:
      return static_cast<int>(launch_typed<64, 32>(d, x, bm, cm, dt, a, state_in, y, state_out,
                                                   b, t, h, g, q, strides, s));
    case 32016:
      return static_cast<int>(launch_typed<32, 16>(d, x, bm, cm, dt, a, state_in, y, state_out,
                                                   b, t, h, g, q, strides, s));
    case 16008:
      return static_cast<int>(launch_typed<16, 8>(d, x, bm, cm, dt, a, state_in, y, state_out,
                                                  b, t, h, g, q, strides, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
