// Backward of the chunked RWKV6 (Finch) WKV (wkv6.cu), on Hopper (sm_90a).
//
// The Pallas TPU kernel repro/kernels/rwkv6/rwkv6.py (`wkv6_chunked`) has no
// backward: the reference trains through its jnp chunk scan
// (repro/models/ssm.py:rwkv6_time_mix_chunked), which JAX differentiates.
// The port runs the forward as a hand-written kernel, so this kernel is its
// backward; ref.wkv6_bwd_ref is its plain version, the same recurrence.
//
// Per (batch b, head h), with the (DK x DK) state S, w_t = exp(ld_t),
// o_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T), S_t = diag(w_t) S_{t-1} + k_t v_t^T,
// and the incoming gradients do (B, T, H, DK) and dS_T (B, H, DK, DK) or none:
//
//   forward pass, S from the state in:
//     dr_t = S_{t-1} do_t + u k_t (v_t . do_t)
//   reverse pass, G = dL/dS_t from dS_T:
//     dk_t = G v_t + r_t u (v_t . do_t)
//     dv_t = G^T k_t + (r_t . u k_t) do_t
//     G    = diag(w_t) G + r_t do_t^T           (after the step; G_0 = dS_0)
//   dld_t = sum_{m >= t} dc_m, with dc_m = r_{m+1} (S_m do_{m+1}) - k_m (G_m v_m)
//           (+ the rows of dS_T * S_T at m = T): a running sum in the reverse
//           pass, so no S_{t-1} is needed beside G (ref.wkv6_bwd_ref derives it)
//   du    = sum_t r_t k_t (v_t . do_t)
//
// Design: one CTA of 256 threads per (b, h), the state in registers, 4 x 4
// entries a thread at DK = 64 (rows rg * RP .., columns cg * CN ..; cg the
// low 4 bits of the thread index, so a warp holds two row groups).  Tokens
// are staged 16 at a time into shared memory (float32) and walked one by one;
// within a chunk no thread waits on another: a token's row sums (S do, G v)
// are reduced across the row's 16 lanes by shuffles, its column sums (G^T k)
// across the warp's two row groups by one shuffle and across the 8 warps
// after the chunk, and all are kept in shared memory until the chunk's
// epilogue writes dr, dk, dv and (one thread a channel, in token order) the
// running sum of dld and du.  The forward pass writes r * (S do) into the
// dld output, which the reverse pass reads back before it overwrites it.
// Per-CTA partial du go to a scratch and a second kernel sums them over the
// batch elements that share a row of u, in a fixed order: no atomics, so two
// calls are equal bit for bit.  Every sum is float32; dr, dk, dv are written
// in r's type (float32 or bf16), dld, du and dS_0 in float32.
//
// Bound on an H100 SXM (chip_smoke.py:wkv6_bwd_work): at the trained
// rwkv6-7b shape (B 4 = 2 peers x batch 2, T 1024, H 64, DK 64, bf16 r, k, v,
// do, a state in) a call reads r, k, v, do (bf16, 33.6 MB each) and ld
// (float32, 67 MB) and writes dr, dk, dv (bf16) and dld (float32), with the
// states: 377 MB, 0.11 ms at 3.35 TB/s; the two passes do 12 DK^2 + 34 DK
// operations a token and head, 13.5 GFLOP, 0.20 ms at 67 TFLOP/s float32: it
// is bound by operations.  This first design walks the tokens one at a time;
// its time against that bound is in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQ = 16;        // tokens staged a chunk
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kNcg = 16;      // column groups: the low 4 bits of the thread index
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

// Float offsets of the dynamic shared memory: the staged chunk (r, k, v, do,
// w = exp(ld), and the forward pass's r * (S do) for the reverse pass), the
// row sums of a chunk, the warps' column partials, the per-token dots, u and
// the final state's row terms.
template <int DK>
struct Smem {
  static constexpr int r = 0, k = r + kQ * DK, v = k + kQ * DK, dout = v + kQ * DK,
                       w = dout + kQ * DK, q = w + kQ * DK, row = q + kQ * DK,
                       col = row + kQ * DK, vdo = col + kQ * kWarps * DK, ruk = vdo + kQ,
                       u = ruk + kQ, f = u + DK, total = f + DK;
};

template <typename TI, int DK>
__device__ __forceinline__ void stage(float* sm, const TI* __restrict__ r,
                                      const TI* __restrict__ k, const TI* __restrict__ v,
                                      const float* __restrict__ ld, const TI* __restrict__ dout,
                                      const float* q_src, int64_t base, int64_t row_stride,
                                      int t0, int nt) {
  using L = Smem<DK>;
  for (int e = threadIdx.x; e < kQ * DK; e += kThreads) {
    const int t = e / DK, i = e - t * DK;
    const bool ok = t < nt;
    const int64_t off = base + static_cast<int64_t>(t0 + t) * row_stride + i;
    sm[L::r + e] = ok ? to_f(r[off]) : 0.0f;
    sm[L::k + e] = ok ? to_f(k[off]) : 0.0f;
    sm[L::v + e] = ok ? to_f(v[off]) : 0.0f;
    sm[L::dout + e] = ok ? to_f(dout[off]) : 0.0f;
    sm[L::w + e] = ok ? expf(ld[off]) : 1.0f;
    // the reverse pass reads back what this thread wrote in the forward pass
    if (q_src != nullptr) sm[L::q + e] = ok ? q_src[off] : 0.0f;
  }
}

// v_t . do_t and r_t . (u k_t) of the chunk's tokens, one warp a token
template <int DK>
__device__ __forceinline__ void token_dots(float* sm, int nt) {
  using L = Smem<DK>;
  const int lane = threadIdx.x & 31;
  for (int t = threadIdx.x >> 5; t < nt; t += kWarps) {
    float vdo = 0.0f, ruk = 0.0f;
    for (int i = lane; i < DK; i += 32) {
      vdo = fmaf(sm[L::v + t * DK + i], sm[L::dout + t * DK + i], vdo);
      ruk = fmaf(sm[L::r + t * DK + i] * sm[L::u + i], sm[L::k + t * DK + i], ruk);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      vdo += __shfl_xor_sync(kFull, vdo, o);
      ruk += __shfl_xor_sync(kFull, ruk, o);
    }
    if (lane == 0) {
      sm[L::vdo + t] = vdo;
      sm[L::ruk + t] = ruk;
    }
  }
}

template <typename TI, int DK>
__global__ void __launch_bounds__(kThreads, 2)
wkv6_bwd_kernel(const TI* __restrict__ r, const TI* __restrict__ k, const TI* __restrict__ v,
                const float* __restrict__ ld, const float* __restrict__ u,
                const float* __restrict__ state_in, const TI* __restrict__ dout,
                const float* __restrict__ dstate_out, TI* __restrict__ dr,
                TI* __restrict__ dk, TI* __restrict__ dv, float* dld,
                float* __restrict__ du_part, float* __restrict__ dstate_in, int T, int H,
                int u_batch) {
  using L = Smem<DK>;
  constexpr int RP = DK / 16, CN = DK / kNcg;  // rows and columns a thread holds
  extern __shared__ __align__(16) float sm[];
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cg = tid % kNcg, r0 = (tid / kNcg) * RP, c0 = cg * CN;
  const int64_t row_stride = static_cast<int64_t>(H) * DK;
  const int64_t base = (static_cast<int64_t>(b) * T * H + h) * DK;
  const int64_t state_off = static_cast<int64_t>(bh) * DK * DK;
  if (tid < DK) sm[L::u + tid] = u[(static_cast<int64_t>(b / u_batch) * H + h) * DK + tid];

  float S[RP][CN];
#pragma unroll
  for (int a = 0; a < RP; ++a)
#pragma unroll
    for (int c = 0; c < CN; ++c)
      S[a][c] = state_in != nullptr
                    ? state_in[state_off + static_cast<int64_t>(r0 + a) * DK + c0 + c]
                    : 0.0f;

  const int nc = (T + kQ - 1) / kQ;
  // forward pass: dr_t = S_{t-1} do_t + u k_t (v_t . do_t); r * (S do) into dld
  for (int n = 0; n < nc; ++n) {
    const int t0 = n * kQ, nt = min(kQ, T - t0);
    __syncthreads();  // the last chunk's epilogue is done with the stage (and u is in)
    stage<TI, DK>(sm, r, k, v, ld, dout, nullptr, base, row_stride, t0, nt);
    __syncthreads();
    token_dots<DK>(sm, nt);
    for (int t = 0; t < nt; ++t) {
      float p[RP];
#pragma unroll
      for (int a = 0; a < RP; ++a) {
        p[a] = 0.0f;
#pragma unroll
        for (int c = 0; c < CN; ++c) p[a] = fmaf(S[a][c], sm[L::dout + t * DK + c0 + c], p[a]);
      }
#pragma unroll
      for (int a = 0; a < RP; ++a) {
#pragma unroll
        for (int o = 1; o < kNcg; o <<= 1) p[a] += __shfl_xor_sync(kFull, p[a], o);
        if (cg == a) sm[L::row + t * DK + r0 + a] = p[a];
      }
#pragma unroll
      for (int a = 0; a < RP; ++a) {
        const float w = sm[L::w + t * DK + r0 + a], kk = sm[L::k + t * DK + r0 + a];
#pragma unroll
        for (int c = 0; c < CN; ++c)
          S[a][c] = fmaf(w, S[a][c], kk * sm[L::v + t * DK + c0 + c]);
      }
    }
    __syncthreads();
    for (int e = tid; e < nt * DK; e += kThreads) {
      const int t = e / DK, i = e - t * DK;
      const int64_t off = base + static_cast<int64_t>(t0 + t) * row_stride + i;
      const float ds = sm[L::row + e];
      dr[off] = from_f<TI>(ds + sm[L::u + i] * sm[L::k + e] * sm[L::vdo + t]);
      dld[off] = sm[L::r + e] * ds;
    }
  }

  // G from dS_T, and the final state's term of dld at t = T: rows of dS_T * S_T
  float G[RP][CN];
  {
    float f[RP];
#pragma unroll
    for (int a = 0; a < RP; ++a) {
      f[a] = 0.0f;
#pragma unroll
      for (int c = 0; c < CN; ++c) {
        G[a][c] = dstate_out != nullptr
                      ? dstate_out[state_off + static_cast<int64_t>(r0 + a) * DK + c0 + c]
                      : 0.0f;
        f[a] = fmaf(G[a][c], S[a][c], f[a]);
      }
#pragma unroll
      for (int o = 1; o < kNcg; o <<= 1) f[a] += __shfl_xor_sync(kFull, f[a], o);
      if (cg == a) sm[L::f + r0 + a] = f[a];
    }
  }
  __syncthreads();
  float run = tid < DK ? sm[L::f + tid] : 0.0f, du = 0.0f;  // thread i < DK: channel i

  // reverse pass
  for (int n = nc - 1; n >= 0; --n) {
    const int t0 = n * kQ, nt = min(kQ, T - t0);
    __syncthreads();
    stage<TI, DK>(sm, r, k, v, ld, dout, dld, base, row_stride, t0, nt);
    __syncthreads();
    token_dots<DK>(sm, nt);
    for (int t = nt - 1; t >= 0; --t) {
      float p[RP], pc[CN];
#pragma unroll
      for (int a = 0; a < RP; ++a) {
        p[a] = 0.0f;
#pragma unroll
        for (int c = 0; c < CN; ++c) p[a] = fmaf(G[a][c], sm[L::v + t * DK + c0 + c], p[a]);
      }
#pragma unroll
      for (int c = 0; c < CN; ++c) {
        pc[c] = 0.0f;
#pragma unroll
        for (int a = 0; a < RP; ++a) pc[c] = fmaf(G[a][c], sm[L::k + t * DK + r0 + a], pc[c]);
        pc[c] += __shfl_xor_sync(kFull, pc[c], kNcg);  // the warp's two row groups
      }
#pragma unroll
      for (int a = 0; a < RP; ++a) {
#pragma unroll
        for (int o = 1; o < kNcg; o <<= 1) p[a] += __shfl_xor_sync(kFull, p[a], o);
        if (cg == a) sm[L::row + t * DK + r0 + a] = p[a];
      }
      if (lane < kNcg) {
#pragma unroll
        for (int c = 0; c < CN; ++c) sm[L::col + (t * kWarps + warp) * DK + c0 + c] = pc[c];
      }
#pragma unroll
      for (int a = 0; a < RP; ++a) {
        const float w = sm[L::w + t * DK + r0 + a], rr = sm[L::r + t * DK + r0 + a];
#pragma unroll
        for (int c = 0; c < CN; ++c)
          G[a][c] = fmaf(w, G[a][c], rr * sm[L::dout + t * DK + c0 + c]);
      }
    }
    __syncthreads();
    for (int e = tid; e < nt * DK; e += kThreads) {
      const int t = e / DK, i = e - t * DK;
      const int64_t off = base + static_cast<int64_t>(t0 + t) * row_stride + i;
      dk[off] = from_f<TI>(sm[L::row + e] + sm[L::r + e] * sm[L::u + i] * sm[L::vdo + t]);
      float col = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) col += sm[L::col + (t * kWarps + w) * DK + i];
      dv[off] = from_f<TI>(col + sm[L::ruk + t] * sm[L::dout + e]);
    }
    if (tid < DK) {
      for (int t = nt - 1; t >= 0; --t) {
        const int e = t * DK + tid;
        const float g = run - sm[L::k + e] * sm[L::row + e];
        dld[base + static_cast<int64_t>(t0 + t) * row_stride + tid] = g;
        run = g + sm[L::q + e];
        du = fmaf(sm[L::r + e] * sm[L::k + e], sm[L::vdo + t], du);
      }
    }
  }
  if (dstate_in != nullptr) {
#pragma unroll
    for (int a = 0; a < RP; ++a)
#pragma unroll
      for (int c = 0; c < CN; ++c)
        dstate_in[state_off + static_cast<int64_t>(r0 + a) * DK + c0 + c] = G[a][c];
  }
  if (tid < DK) du_part[static_cast<int64_t>(bh) * DK + tid] = du;
}

// du (B / u_batch, H, DK) = the sum of the partials (B, H, DK) of the batch
// elements that share each row, in batch order
__global__ void du_reduce(const float* __restrict__ du_part, float* __restrict__ du,
                          int64_t rows, int64_t hdk, int u_batch) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= rows * hdk) return;
  const int64_t g = e / hdk, i = e - g * hdk;
  float s = 0.0f;
  for (int j = 0; j < u_batch; ++j) s += du_part[(g * u_batch + j) * hdk + i];
  du[e] = s;
}

template <typename TI, int DK>
cudaError_t launch(const void* r, const void* k, const void* v, const float* ld, const float* u,
                   const float* state_in, const void* dout, const float* dstate_out, void* dr,
                   void* dk, void* dv, float* dld, float* du, float* du_part, float* dstate_in,
                   int B, int T, int H, int u_batch, cudaStream_t stream) {
  auto kernel = wkv6_bwd_kernel<TI, DK>;
  const int smem = Smem<DK>::total * static_cast<int>(sizeof(float));
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<B * H, kThreads, smem, stream>>>(
      static_cast<const TI*>(r), static_cast<const TI*>(k), static_cast<const TI*>(v), ld, u,
      state_in, static_cast<const TI*>(dout), dstate_out, static_cast<TI*>(dr),
      static_cast<TI*>(dk), static_cast<TI*>(dv), dld, du_part, dstate_in, T, H, u_batch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t rows = B / u_batch, hdk = static_cast<int64_t>(H) * DK;
  const int64_t blocks = (rows * hdk + 255) / 256;
  du_reduce<<<static_cast<unsigned>(blocks), 256, 0, stream>>>(du_part, du, rows, hdk, u_batch);
  return cudaGetLastError();
}

template <typename TI>
cudaError_t dispatch(int64_t DK, const void* r, const void* k, const void* v, const float* ld,
                     const float* u, const float* state_in, const void* dout,
                     const float* dstate_out, void* dr, void* dk, void* dv, float* dld,
                     float* du, float* du_part, float* dstate_in, int B, int T, int H,
                     int u_batch, cudaStream_t s) {
  switch (DK) {
    case 16:
      return launch<TI, 16>(r, k, v, ld, u, state_in, dout, dstate_out, dr, dk, dv, dld, du,
                            du_part, dstate_in, B, T, H, u_batch, s);
    case 32:
      return launch<TI, 32>(r, k, v, ld, u, state_in, dout, dstate_out, dr, dk, dv, dld, du,
                            du_part, dstate_in, B, T, H, u_batch, s);
    case 64:
      return launch<TI, 64>(r, k, v, ld, u, state_in, dout, dstate_out, dr, dk, dv, dld, du,
                            du_part, dstate_in, B, T, H, u_batch, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// r, k, v, dout, dr, dk, dv: (B, T, H, DK) contiguous, float32 (bf16 == 0) or
// bf16 (bf16 != 0); ld, dld: (B, T, H, DK) float32; u: (B / u_batch, H, DK)
// float32, batch element b reading row b / u_batch; state_in (B, H, DK, DK)
// float32 or null (zero state); dstate_out (B, H, DK, DK) float32 or null (no
// gradient of the final state); du (B / u_batch, H, DK) float32; du_part
// (B, H, DK) float32 scratch; dstate_in (B, H, DK, DK) float32 or null (not
// written).  DK in {16, 32, 64}.  Launches on `stream` (the main kernel, then
// du's reduction) and returns the launches' cudaError_t (0 on success,
// cudaErrorInvalidValue for arguments it refuses).
extern "C" int wkv6_bwd(const void* r, const void* k, const void* v, const float* ld,
                        const float* u, const float* state_in, const void* dout,
                        const float* dstate_out, void* dr, void* dk, void* dv, float* dld,
                        float* du, float* du_part, float* dstate_in, int64_t B, int64_t T,
                        int64_t H, int64_t DK, int64_t u_batch, int bf16, void* stream) {
  if (B < 1 || T < 1 || H < 1 || u_batch < 1 || B % u_batch != 0 || B * H > 0x7fffffff ||
      T > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const int b = static_cast<int>(B), t = static_cast<int>(T), h = static_cast<int>(H),
            ub = static_cast<int>(u_batch);
  const cudaError_t err =
      bf16 ? dispatch<__nv_bfloat16>(DK, r, k, v, ld, u, state_in, dout, dstate_out, dr, dk, dv,
                                     dld, du, du_part, dstate_in, b, t, h, ub, s)
           : dispatch<float>(DK, r, k, v, ld, u, state_in, dout, dstate_out, dr, dk, dv, dld,
                             du, du_part, dstate_in, b, t, h, ub, s);
  return static_cast<int>(err);
}
