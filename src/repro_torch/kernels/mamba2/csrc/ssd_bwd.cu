// Backward of the chunked Mamba2 SSD (ssd.cu), on Hopper (sm_90a).
//
// The Pallas TPU kernel repro/kernels/mamba2/mamba2.py (`ssd_chunked`) has no
// backward: the reference trains through its jnp chunk scan
// (repro/models/ssm.py:mamba2_apply_chunked), which JAX differentiates.  The
// port runs the forward as a hand-written kernel, so this kernel is its
// backward; ref.ssd_bwd_ref is its plain version, the same recurrence.
//
// Per (batch b, head h), with the (P x N) state S, alpha_t = exp(dt_t a),
// S_t = alpha_t S_{t-1} + dt_t x_t B_t^T, y_t = S_t C_t (B and C of head h's
// group), and the incoming gradients dy (B, T, H, P) and dS_T or none:
//
//   forward pass, S from the state in:  dC_t(h) = S_t^T dy_t
//   reverse pass, G = dL/dS_t from dS_T:
//     G    += dy_t C_t^T
//     dx_t  = dt_t G B_t,   dB_t(h) = dt_t G^T x_t
//     G     = alpha_t G                          (G_0 = dS_0)
//   dl_t   = alpha_t <G_t, S_{t-1}> = dl_{t+1} + C_t . dC_t(h) - x_t . dx_t:
//            the log-decay l = dt a's gradient, a running sum in the reverse
//            pass (ref.ssd_bwd_ref derives it), restarted at every chunk's
//            end from the direct alpha <G, S> against the state the forward
//            pass saved there: over a long memory the sum's terms cancel far
//            above dl (da lost 3e-4 of its float32 value over 1024 tokens;
//            restarted every 16 tokens, 4e-6)
//   ddt_t  = x_t . (G_t B_t) + a dl_t,   da = sum_t dt_t dl_t
//
// Memory: the forward saves nothing beyond its operands: the kernel's forward
// pass rebuilds the states, one token at a time, and writes the state at each
// chunk's end but the last to a scratch ((T / 16) P N float32 a (b, h): 165 MB
// at zamba2's 2 peers x batch 1, T 1024, H 80).  Its other scratch is the
// per-head dB and dC, (B, T, H, N) float32 each (42 MB each there), and
// (B, H) partials of da; dB and dC are then summed over each group's heads
// and da over the batch elements that share a row of a by a second and third
// kernel, in a fixed order: no atomics, so two calls are equal bit for bit.
//
// Design: one CTA per (b, h) with the whole P x N float32 state in registers,
// 4 x 4 entries a thread at P = N = 64 (256 threads: column groups cg the low
// bits of the thread index, 16 row groups).  Tokens are staged 16 at a time
// into shared memory (float32) and walked one by one; within a chunk no
// thread waits on another: a row sum (G B) is reduced across the row's lanes
// by shuffles, a column sum (S^T dy, G^T x) across the warp's row groups by
// shuffles and across the warps after the chunk, and all are kept in shared
// memory until the chunk's epilogue (one warp a token) writes dx, the dB and
// dC partials and the per-token dots; one thread then runs the chunk's
// scalar running sum of dl.  The forward pass writes C . dC into the ddt
// output, which the reverse pass reads back before it overwrites it.  x, B
// and C are read through the model's (batch, token) strides, as the forward
// reads them.  Every sum is float32; dx is written in x's type, dB and dC in
// B's, ddt, da and dS_0 in float32.
//
// Bound on an H100 SXM (chip_smoke.py:ssd_bwd_work): at zamba2's trained
// shape (B 2 = 2 peers x batch 1, T 1024, H 80, P = N = 64, one group, bf16
// x, B, C, a state in) a call reads x (bf16, 21 MB), B, C, dt and dy
// (float32, 42 MB) and writes dx (21 MB), dB, dC and ddt, with the states:
// 96 MB, 0.029 ms at 3.35 TB/s; the two passes do 12 P N + 20 (P + N)
// operations a token and head, 8.5 GFLOP, 0.13 ms at 67 TFLOP/s float32: it
// is bound by operations.  This first design walks the tokens one at a time;
// its time against that bound is in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQ = 16;  // tokens staged a chunk
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

// The thread layout of a (P, N) state: NCG column groups of CN columns on the
// low bits of the thread index, NRG row groups of RP rows; a warp holds
// 32 / NCG row groups.
template <int P, int N>
struct Lay {
  static constexpr int NCG = N < 16 ? N : 16, CN = N / NCG;
  static constexpr int NRG = P < 16 ? P : 16, RP = P / NRG;
  static constexpr int kThreads = NRG * NCG, kWarps = kThreads / 32;
  static_assert(kThreads % 32 == 0 && RP <= NCG, "thread layout");
  // float offsets of the dynamic shared memory: the staged chunk (x, dy,
  // B, C, dt, alpha and the forward pass's C . dC), the chunk's row sums
  // G B, the warps' column partials, the per-token x . (G B), the final
  // state's term and the warps' partial sums of it
  static constexpr int x = 0, dy = x + kQ * P, b = dy + kQ * P, c = b + kQ * N,
                       dt = c + kQ * N, al = dt + kQ, cdc = al + kQ, row = cdc + kQ,
                       col = row + kQ * P, xgb = col + kQ * kWarps * N, f = xgb + kQ,
                       total = f + kWarps;
};

template <typename TI, int P, int N>
__device__ __forceinline__ void stage(float* sm, const TI* __restrict__ x_base,
                                      const TI* __restrict__ b_base,
                                      const TI* __restrict__ c_base,
                                      const float* __restrict__ dt_base,
                                      const float* __restrict__ dy_base, const float* cdc_src,
                                      int64_t x_st, int64_t b_st, int64_t c_st, int H, float a_h,
                                      int t0, int nt) {
  using L = Lay<P, N>;
  const int64_t dy_st = static_cast<int64_t>(H) * P;
  for (int e = threadIdx.x; e < kQ * P; e += L::kThreads) {
    const int t = e / P, p = e - t * P;
    const bool ok = t < nt;
    sm[L::x + e] = ok ? to_f(x_base[(t0 + t) * x_st + p]) : 0.0f;
    sm[L::dy + e] = ok ? dy_base[(t0 + t) * dy_st + p] : 0.0f;
  }
  for (int e = threadIdx.x; e < kQ * N; e += L::kThreads) {
    const int t = e / N, n = e - t * N;
    const bool ok = t < nt;
    sm[L::b + e] = ok ? to_f(b_base[(t0 + t) * b_st + n]) : 0.0f;
    sm[L::c + e] = ok ? to_f(c_base[(t0 + t) * c_st + n]) : 0.0f;
  }
  for (int t = threadIdx.x; t < kQ; t += L::kThreads) {
    const bool ok = t < nt;
    const float dt = ok ? dt_base[static_cast<int64_t>(t0 + t) * H] : 0.0f;
    sm[L::dt + t] = dt;
    sm[L::al + t] = expf(dt * a_h);
    // the reverse pass reads back the forward pass's C . dC
    if (cdc_src != nullptr) sm[L::cdc + t] = ok ? cdc_src[static_cast<int64_t>(t0 + t) * H] : 0.0f;
  }
}

template <typename TI, int P, int N>
__global__ void __launch_bounds__(Lay<P, N>::kThreads, 2)
ssd_bwd_kernel(const TI* __restrict__ x, const TI* __restrict__ bm, const TI* __restrict__ cm,
               const float* __restrict__ dt, const float* __restrict__ a,
               const float* __restrict__ state_in, const float* __restrict__ dy,
               const float* __restrict__ dstate_out, TI* __restrict__ dx,
               float* __restrict__ db_part, float* __restrict__ dc_part, float* ddt,
               float* __restrict__ da_part, float* __restrict__ ckpt,
               float* __restrict__ dstate_in, int T, int H, int G,
               int a_batch, int64_t x_sb, int64_t x_st, int64_t b_sb, int64_t b_st,
               int64_t c_sb, int64_t c_st) {
  using L = Lay<P, N>;
  constexpr int RP = L::RP, CN = L::CN, NCG = L::NCG, NW = L::kWarps;
  extern __shared__ __align__(16) float sm[];
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H, grp = h / (H / G);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cg = tid % NCG, r0 = (tid / NCG) * RP, c0 = cg * CN;
  const float a_h = a[static_cast<int64_t>(b / a_batch) * H + h];
  const TI* x_base = x + b * x_sb + static_cast<int64_t>(h) * P;
  const TI* b_base = bm + b * b_sb + static_cast<int64_t>(grp) * N;
  const TI* c_base = cm + b * c_sb + static_cast<int64_t>(grp) * N;
  const int64_t bth = static_cast<int64_t>(b) * T * H + h;  // (b, 0, h) of a (B, T, H) array
  const float* dt_base = dt + bth;
  const float* dy_base = dy + bth * P;
  TI* dx_base = dx + bth * P;
  float* ddt_base = ddt + bth;
  const int64_t state_off = static_cast<int64_t>(bh) * P * N;

  float S[RP][CN];
#pragma unroll
  for (int i = 0; i < RP; ++i)
#pragma unroll
    for (int j = 0; j < CN; ++j)
      S[i][j] = state_in != nullptr
                    ? state_in[state_off + static_cast<int64_t>(r0 + i) * N + c0 + j]
                    : 0.0f;

  const int nc = (T + kQ - 1) / kQ;
  // a thread's entries of the state at the end of chunk ch < nc - 1, in
  // thread order (coalesced)
  auto ckpt_at = [&](int ch, int i, int j) -> float& {
    return ckpt[((static_cast<int64_t>(bh) * (nc - 1) + ch) * (RP * CN) + i * CN + j) *
                    L::kThreads + tid];
  };
  // forward pass: S_t, dC_t(h) = S_t^T dy_t, and C_t . dC_t(h) into ddt
  for (int ch = 0; ch < nc; ++ch) {
    const int t0 = ch * kQ, nt = min(kQ, T - t0);
    __syncthreads();
    stage<TI, P, N>(sm, x_base, b_base, c_base, dt_base, dy_base, nullptr, x_st, b_st, c_st, H,
                    a_h, t0, nt);
    __syncthreads();
    for (int t = 0; t < nt; ++t) {
      const float al = sm[L::al + t], dtt = sm[L::dt + t];
      float pc[CN];
#pragma unroll
      for (int j = 0; j < CN; ++j) pc[j] = 0.0f;
#pragma unroll
      for (int i = 0; i < RP; ++i) {
        const float xs = dtt * sm[L::x + t * P + r0 + i], dyi = sm[L::dy + t * P + r0 + i];
#pragma unroll
        for (int j = 0; j < CN; ++j) {
          S[i][j] = fmaf(al, S[i][j], xs * sm[L::b + t * N + c0 + j]);
          pc[j] = fmaf(S[i][j], dyi, pc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < CN; ++j) {
#pragma unroll
        for (int o = NCG; o < 32; o <<= 1) pc[j] += __shfl_xor_sync(kFull, pc[j], o);
      }
      if (lane < NCG) {
#pragma unroll
        for (int j = 0; j < CN; ++j) sm[L::col + (t * NW + warp) * N + c0 + j] = pc[j];
      }
    }
    if (ch < nc - 1) {
#pragma unroll
      for (int i = 0; i < RP; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) ckpt_at(ch, i, j) = S[i][j];
    }
    __syncthreads();
    for (int t = warp; t < nt; t += NW) {  // one warp a token
      float cdc = 0.0f;
      for (int n = lane; n < N; n += 32) {
        float dc = 0.0f;
#pragma unroll
        for (int w = 0; w < NW; ++w) dc += sm[L::col + (t * NW + w) * N + n];
        dc_part[(bth + static_cast<int64_t>(t0 + t) * H) * N + n] = dc;
        cdc = fmaf(sm[L::c + t * N + n], dc, cdc);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) cdc += __shfl_xor_sync(kFull, cdc, o);
      if (lane == 0) ddt_base[static_cast<int64_t>(t0 + t) * H] = cdc;
    }
  }

  // G from dS_T, and <dS_T, S_T>, the final state's term of dl at t = T
  float gs[RP][CN];
  {
    float f = 0.0f;
#pragma unroll
    for (int i = 0; i < RP; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        gs[i][j] = dstate_out != nullptr
                      ? dstate_out[state_off + static_cast<int64_t>(r0 + i) * N + c0 + j]
                      : 0.0f;
        f = fmaf(gs[i][j], S[i][j], f);
      }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) f += __shfl_xor_sync(kFull, f, o);
    if (lane == 0) sm[L::f + warp] = f;
  }
  __syncthreads();
  float run = 0.0f, da = 0.0f;  // thread 0's
  if (tid == 0) {
    for (int w = 0; w < NW; ++w) run += sm[L::f + w];
  }

  // reverse pass
  for (int ch = nc - 1; ch >= 0; --ch) {
    const int t0 = ch * kQ, nt = min(kQ, T - t0);
    __syncthreads();
    if (ch < nc - 1) {  // gs is alpha G of the next chunk's first token: dl there, directly
      float f = 0.0f;
#pragma unroll
      for (int i = 0; i < RP; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) f = fmaf(gs[i][j], ckpt_at(ch, i, j), f);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) f += __shfl_xor_sync(kFull, f, o);
      if (lane == 0) sm[L::f + warp] = f;
    }
    stage<TI, P, N>(sm, x_base, b_base, c_base, dt_base, dy_base, ddt_base, x_st, b_st, c_st, H,
                    a_h, t0, nt);
    __syncthreads();
    if (tid == 0 && ch < nc - 1) {
      run = 0.0f;
      for (int w = 0; w < NW; ++w) run += sm[L::f + w];
    }
    for (int t = nt - 1; t >= 0; --t) {
      float pr[RP], pc[CN];
#pragma unroll
      for (int j = 0; j < CN; ++j) pc[j] = 0.0f;
#pragma unroll
      for (int i = 0; i < RP; ++i) {
        const float dyi = sm[L::dy + t * P + r0 + i], xi = sm[L::x + t * P + r0 + i];
        pr[i] = 0.0f;
#pragma unroll
        for (int j = 0; j < CN; ++j) {
          gs[i][j] = fmaf(dyi, sm[L::c + t * N + c0 + j], gs[i][j]);
          pr[i] = fmaf(gs[i][j], sm[L::b + t * N + c0 + j], pr[i]);
          pc[j] = fmaf(gs[i][j], xi, pc[j]);
        }
      }
#pragma unroll
      for (int i = 0; i < RP; ++i) {
#pragma unroll
        for (int o = 1; o < NCG; o <<= 1) pr[i] += __shfl_xor_sync(kFull, pr[i], o);
        if (cg == i) sm[L::row + t * P + r0 + i] = pr[i];
      }
#pragma unroll
      for (int j = 0; j < CN; ++j) {
#pragma unroll
        for (int o = NCG; o < 32; o <<= 1) pc[j] += __shfl_xor_sync(kFull, pc[j], o);
      }
      if (lane < NCG) {
#pragma unroll
        for (int j = 0; j < CN; ++j) sm[L::col + (t * NW + warp) * N + c0 + j] = pc[j];
      }
      const float al = sm[L::al + t];
#pragma unroll
      for (int i = 0; i < RP; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) gs[i][j] *= al;
    }
    __syncthreads();
    for (int t = warp; t < nt; t += NW) {  // one warp a token
      const float dtt = sm[L::dt + t];
      const int64_t tok = static_cast<int64_t>(t0 + t) * H;
      float xgb = 0.0f;
      for (int p = lane; p < P; p += 32) {
        const float gb = sm[L::row + t * P + p];
        dx_base[tok * P + p] = from_f<TI>(dtt * gb);
        xgb = fmaf(sm[L::x + t * P + p], gb, xgb);
      }
      for (int n = lane; n < N; n += 32) {
        float gx = 0.0f;
#pragma unroll
        for (int w = 0; w < NW; ++w) gx += sm[L::col + (t * NW + w) * N + n];
        db_part[(bth + tok) * N + n] = dtt * gx;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) xgb += __shfl_xor_sync(kFull, xgb, o);
      if (lane == 0) sm[L::xgb + t] = xgb;
    }
    __syncthreads();
    if (tid == 0) {  // the chunk's running sum of dl, in reverse token order
      for (int t = nt - 1; t >= 0; --t) {
        const float dtt = sm[L::dt + t], xgb = sm[L::xgb + t];
        run += sm[L::cdc + t] - dtt * xgb;
        ddt_base[static_cast<int64_t>(t0 + t) * H] = fmaf(a_h, run, xgb);
        da = fmaf(dtt, run, da);
      }
    }
  }
  if (dstate_in != nullptr) {
#pragma unroll
    for (int i = 0; i < RP; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j)
        dstate_in[state_off + static_cast<int64_t>(r0 + i) * N + c0 + j] = gs[i][j];
  }
  if (tid == 0) da_part[bh] = da;
}

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
  out[e] = from_f<TO>(s);
}

// da (B / a_batch, H) = the sum of the partials (B, H) of the batch elements
// that share each row, in batch order
__global__ void da_reduce(const float* __restrict__ da_part, float* __restrict__ da,
                          int64_t rows, int H, int a_batch) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= rows * H) return;
  const int64_t g = e / H, h = e - g * H;
  float s = 0.0f;
  for (int j = 0; j < a_batch; ++j) s += da_part[(g * a_batch + j) * H + h];
  da[e] = s;
}

unsigned blocks_of(int64_t n) { return static_cast<unsigned>((n + 255) / 256); }

template <typename TI, int P, int N>
cudaError_t launch(const void* x, const void* bm, const void* cm, const float* dt,
                   const float* a, const float* state_in, const float* dy,
                   const float* dstate_out, void* dx, void* db, void* dc, float* ddt, float* da,
                   float* db_part, float* dc_part, float* da_part, float* ckpt,
                   float* dstate_in, int B, int T, int H, int G, int a_batch, const int64_t* st,
                   cudaStream_t stream) {
  using L = Lay<P, N>;
  auto kernel = ssd_bwd_kernel<TI, P, N>;
  const int smem = L::total * static_cast<int>(sizeof(float));
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<B * H, L::kThreads, smem, stream>>>(
      static_cast<const TI*>(x), static_cast<const TI*>(bm), static_cast<const TI*>(cm), dt, a,
      state_in, dy, dstate_out, static_cast<TI*>(dx), db_part, dc_part, ddt, da_part, ckpt,
      dstate_in, T, H, G, a_batch, st[0], st[1], st[2], st[3], st[4], st[5]);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t bt = static_cast<int64_t>(B) * T;
  group_reduce<TI><<<blocks_of(bt * G * N), 256, 0, stream>>>(db_part, static_cast<TI*>(db), bt,
                                                                 G, H / G, N);
  group_reduce<TI><<<blocks_of(bt * G * N), 256, 0, stream>>>(dc_part, static_cast<TI*>(dc), bt,
                                                                 G, H / G, N);
  da_reduce<<<blocks_of(static_cast<int64_t>(B / a_batch) * H), 256, 0, stream>>>(
      da_part, da, B / a_batch, H, a_batch);
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
// `strides`; dt (B, T, H) float32 contiguous; a (B / a_batch, H) float32,
// batch element b reading row b / a_batch; state_in (B, H, P, N) float32 or
// null (zero state); dy (B, T, H, P) float32 contiguous; dstate_out (B, H, P,
// N) float32 or null (no gradient of the final state).  Writes dx (B, T, H,
// P) in x's type, db and dc (B, T, G, N) in bm's type, ddt (B, T, H) and da
// (B / a_batch, H) float32, and dstate_in (B, H, P, N) float32 unless null;
// db_part and dc_part (B, T, H, N), da_part (B, H) and ckpt (B H (ceil(T /
// 16) - 1) P N, at least one element) are float32 scratch.
// All outputs contiguous; G divides H.  Launches on `stream` (the main
// kernel, then the three reductions) and returns the launches' cudaError_t
// (0 on success, cudaErrorInvalidValue for arguments it refuses).
extern "C" int ssd_bwd(const void* x, const void* bm, const void* cm, const float* dt,
                       const float* a, const float* state_in, const float* dy,
                       const float* dstate_out, void* dx, void* db, void* dc, float* ddt,
                       float* da, float* db_part, float* dc_part, float* da_part, float* ckpt,
                       float* dstate_in, int64_t dtype, int64_t B, int64_t T, int64_t H,
                       int64_t G, int64_t P, int64_t N, int64_t a_batch, const int64_t* strides,
                       void* stream) {
  if (B < 1 || T < 1 || H < 1 || G < 1 || H % G != 0 || a_batch < 1 || B % a_batch != 0 ||
      B * H > 0x7fffffff || T > 0x7fffffff || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
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
