// Chunked RWKV6 (Finch) WKV with data-dependent per-channel decay, on Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/rwkv6/rwkv6.py (`wkv6_chunked`,
// body `_kernel`), and with it the chunk scan of
// repro/models/ssm.py:rwkv6_time_mix_chunked, whose state in and out it also
// carries.  For every (batch b, head h), with the (DK x DK) float32 state S
// carried across chunks of Q tokens and, within a chunk, cum the inclusive
// prefix sum of the log-decays ld (<= 0) and cum_ex = cum - ld:
//
//   att[t,s] = sum_i r[t,i] k[s,i] exp(cum_ex[t,i] - cum[s,i])   for s < t
//   att[t,t] = sum_i r[t,i] u[i] k[t,i]                            (the bonus)
//   y[t,:]   = sum_{s<=t} att[t,s] v[s,:] + (r[t,:] * exp(cum_ex[t,:])) S
//   S        = exp(cum_last) * S + (k * exp(cum_last - cum))^T v
//
// Every exponent evaluated is a sum of log-decays, so every factor is <= 1:
// for s >= t the difference cum_ex[t] - cum[s] can be large and positive
// (ld reaches -e^4 a step), and it is never evaluated, not even to be masked.
//
// Design (simple first):
// - one block of 256 threads per (b, h); a loop over chunks inside the block
//   takes the place of the TPU's sequential grid axis.
// - S lives in shared memory (16 KB at DK = 64), read from the state given
//   (or zeroed) and written to the final state after the last chunk.
// - per chunk, r, k, v and ld (Q x DK float32) are staged in shared memory,
//   rows padded to DK + 1 floats so that rows t and t + 1 start in different
//   banks; five barriers split the chunk into: stage, prefix sums (one thread
//   per channel), the (Q x Q) weights att (one thread per pair), the decayed
//   r and k in place, the outputs, and the state update.
// - thread (g, j), j = tid % DK, computes output column j for the rows
//   t = g, g + G, ... (G = 256 / DK) and state column j for the rows
//   i = g, g + G, ...: each loaded v[s, j] and S[i, j] is used for every row
//   the thread holds.  The number of output rows per thread is a template
//   argument picked at launch from Q, so the unrolled row loops carry no
//   row the chunk does not have.
// - the (B, T, H, DK) layout is read and written in place: element (b, t, h,
//   i) sits at ((b T + t) H + h) DK + i; no transposed copy is made.
// - a ragged last chunk stages zeros past T (ld = 0, k = v = 0: the state
//   passes through unchanged, as the reference's padding does) and writes no
//   output row past T.
//
// Bound on an H100 SXM: at B = 4, T = 1024, H = 64, DK = 64, Q = 16 a call
// from a zero state must read four (B, T, H, DK) float32 inputs and write one
// (67 MB each) and write the final state (4 MB): 340 MB, 0.10 ms at
// 3.35 TB/s.  It does about 5.5 GFLOP (an exp counted as one operation),
// 0.08 ms at 67 TFLOP/s float32: it is bound by bytes.
// What the simple design leaves on the table: each chunk passes through five
// barriers with one block per (b, h) (256 blocks at the main shape, two per
// SM), the chunk's products run on the float32 pipes from shared memory, and
// nothing overlaps the next chunk's loads with this chunk's arithmetic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChunk = 64;

// ROWS = the output rows a thread holds, ceil(Q / G) rounded up to a power
// of two: the unrolled row loops issue no row that the chunk does not have
// (at Q = 16, DK = 64 a thread holds 4 rows, not kMaxChunk / G = 16).
template <int DK, int ROWS>
__global__ void __launch_bounds__(kThreads)
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ ld,
            const float* __restrict__ u, const float* __restrict__ state_in,
            float* __restrict__ out, float* __restrict__ state_out, int T, int H, int Q) {
  constexpr int P = DK + 1;            // padded row length of the staged chunk
  constexpr int G = kThreads / DK;     // row groups
  constexpr int SROWS = DK / G;        // state rows a thread updates

  extern __shared__ float smem[];
  float* s_r = smem;                 // [Q][P] r, then r * exp(cum_ex)
  float* s_k = s_r + Q * P;          // [Q][P] k, then k * exp(cum_last - cum)
  float* s_v = s_k + Q * P;          // [Q][P] v
  float* s_cx = s_v + Q * P;         // [Q][P] ld, then cum_ex
  float* s_c = s_cx + Q * P;         // [Q][P] cum
  float* s_att = s_c + Q * P;        // [Q][Q + 1] att, the bonus on the diagonal
  float* s_S = s_att + Q * (Q + 1);  // [DK][DK] state
  float* s_u = s_S + DK * DK;        // [DK] bonus u of this head
  float* s_last = s_u + DK;          // [DK] cum of the chunk's last row

  const int tid = threadIdx.x;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int j = tid % DK;
  const int g = tid / DK;
  const int64_t row_stride = static_cast<int64_t>(H) * DK;  // one token
  const int64_t base = (static_cast<int64_t>(b) * T * H + h) * DK;
  const int64_t state_off = static_cast<int64_t>(blockIdx.x) * DK * DK;

  for (int x = tid; x < DK * DK; x += kThreads)
    s_S[x] = state_in != nullptr ? state_in[state_off + x] : 0.0f;
  if (tid < DK) s_u[tid] = u[h * DK + tid];

  for (int t0 = 0; t0 < T; t0 += Q) {
    __syncthreads();  // the previous chunk's state update has read s_k, s_v
    for (int x = tid; x < Q * DK; x += kThreads) {
      const int t = x / DK, i = x % DK;
      const bool valid = t0 + t < T;
      const int64_t off = base + static_cast<int64_t>(t0 + t) * row_stride + i;
      s_r[t * P + i] = valid ? r[off] : 0.0f;
      s_k[t * P + i] = valid ? k[off] : 0.0f;
      s_v[t * P + i] = valid ? v[off] : 0.0f;
      s_cx[t * P + i] = valid ? ld[off] : 0.0f;
    }
    __syncthreads();

    // prefix sums over the chunk, one thread per channel: RWKV reads S_{t-1}
    // and decays after the read, so row t's own decay is in cum but not in
    // cum_ex
    if (tid < DK) {
      float run = 0.0f;
      for (int t = 0; t < Q; ++t) {
        const float l = s_cx[t * P + tid];
        s_cx[t * P + tid] = run;
        run += l;
        s_c[t * P + tid] = run;
      }
      s_last[tid] = run;
    }
    __syncthreads();

    // intra-chunk weights: strictly below the diagonal the decayed r.k, on it
    // the bonus, above it 0 (never an exp there)
    for (int x = tid; x < Q * Q; x += kThreads) {
      const int t = x / Q, s = x % Q;
      float acc = 0.0f;
      if (s < t) {
#pragma unroll 8
        for (int i = 0; i < DK; ++i)
          acc += s_r[t * P + i] * s_k[s * P + i] * expf(s_cx[t * P + i] - s_c[s * P + i]);
      } else if (s == t) {
#pragma unroll 8
        for (int i = 0; i < DK; ++i) acc += s_r[t * P + i] * s_u[i] * s_k[t * P + i];
      }
      s_att[t * (Q + 1) + s] = acc;
    }
    __syncthreads();

    // decay r for the read of the carried state, k for its write
    for (int x = tid; x < Q * DK; x += kThreads) {
      const int t = x / DK, i = x % DK;
      s_r[t * P + i] *= expf(s_cx[t * P + i]);
      s_k[t * P + i] *= expf(s_last[i] - s_c[t * P + i]);
    }
    __syncthreads();

    // outputs: y[t, j] for the rows this thread holds
    float acc[ROWS];
#pragma unroll
    for (int m = 0; m < ROWS; ++m) acc[m] = 0.0f;
    for (int s = 0; s < Q; ++s) {
      const float vs = s_v[s * P + j];
#pragma unroll
      for (int m = 0; m < ROWS; ++m) {
        const int t = g + m * G;
        if (t < Q) acc[m] += s_att[t * (Q + 1) + s] * vs;
      }
    }
    for (int i = 0; i < DK; ++i) {
      const float sij = s_S[i * DK + j];
#pragma unroll
      for (int m = 0; m < ROWS; ++m) {
        const int t = g + m * G;
        if (t < Q) acc[m] += s_r[t * P + i] * sij;
      }
    }
#pragma unroll
    for (int m = 0; m < ROWS; ++m) {
      const int t = g + m * G;
      if (t < Q && t0 + t < T) out[base + static_cast<int64_t>(t0 + t) * row_stride + j] = acc[m];
    }
    __syncthreads();  // every thread has read the state before it changes

    // state update: S[i, j] for the rows this thread holds
    float sacc[SROWS];
#pragma unroll
    for (int n = 0; n < SROWS; ++n) {
      const int i = g + n * G;
      sacc[n] = s_S[i * DK + j] * expf(s_last[i]);
    }
    for (int s = 0; s < Q; ++s) {
      const float vs = s_v[s * P + j];
#pragma unroll
      for (int n = 0; n < SROWS; ++n) sacc[n] += s_k[s * P + g + n * G] * vs;
    }
#pragma unroll
    for (int n = 0; n < SROWS; ++n) s_S[(g + n * G) * DK + j] = sacc[n];
  }
  __syncthreads();
  for (int x = tid; x < DK * DK; x += kThreads) state_out[state_off + x] = s_S[x];
}

size_t smem_bytes(int dk, int q) {
  return sizeof(float) *
         (static_cast<size_t>(5) * q * (dk + 1) + static_cast<size_t>(q) * (q + 1) +
          static_cast<size_t>(dk) * dk + 2 * static_cast<size_t>(dk));
}

// Launches the instantiation whose ROWS is the least power of two with
// ROWS * G >= Q, trying ROWS = 1, 2, 4, ... up to kMaxChunk / G.
template <int DK, int ROWS>
cudaError_t launch(const float* r, const float* k, const float* v, const float* ld,
                   const float* u, const float* state_in, float* out, float* state_out,
                   int B, int T, int H, int Q, cudaStream_t stream) {
  constexpr int G = kThreads / DK;
  if constexpr (ROWS < kMaxChunk / G) {
    if (Q > ROWS * G)
      return launch<DK, 2 * ROWS>(r, k, v, ld, u, state_in, out, state_out, B, T, H, Q, stream);
  }
  const size_t smem = smem_bytes(DK, Q);
  cudaError_t err = cudaFuncSetAttribute(wkv6_kernel<DK, ROWS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  wkv6_kernel<DK, ROWS><<<B * H, kThreads, smem, stream>>>(r, k, v, ld, u, state_in, out,
                                                           state_out, T, H, Q);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory in bytes that a launch at head width dk and chunk q
// takes (ptxas reports none for it).
extern "C" int64_t wkv6_smem_bytes(int64_t dk, int64_t q) {
  return static_cast<int64_t>(smem_bytes(static_cast<int>(dk), static_cast<int>(q)));
}

// r, k, v, ld, out: (B, T, H, DK) float32, contiguous; u: (H, DK) float32;
// state_in: (B, H, DK, DK) float32 or null (zero state); state_out: (B, H,
// DK, DK) float32.  Q = chunk length, 1 <= Q <= 64.  Launches on `stream`
// and returns the launch's cudaError_t (0 on success).
extern "C" int wkv6_f32(const float* r, const float* k, const float* v, const float* ld,
                        const float* u, const float* state_in, float* out, float* state_out,
                        int64_t B, int64_t T, int64_t H, int64_t DK, int64_t Q, void* stream) {
  if (B < 1 || T < 1 || H < 1 || Q < 1 || Q > kMaxChunk || B * H > 0x7fffffff ||
      T > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const int b = static_cast<int>(B), t = static_cast<int>(T), h = static_cast<int>(H),
            q = static_cast<int>(Q);
  switch (DK) {
    case 16: return static_cast<int>(launch<16, 1>(r, k, v, ld, u, state_in, out, state_out, b, t, h, q, s));
    case 32: return static_cast<int>(launch<32, 1>(r, k, v, ld, u, state_in, out, state_out, b, t, h, q, s));
    case 64: return static_cast<int>(launch<64, 1>(r, k, v, ld, u, state_in, out, state_out, b, t, h, q, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
