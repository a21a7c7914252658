// Fused gossip mix + affinity bias for all K peers of a stacked parameter
// buffer, on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/consensus_mix/consensus_mix.py
// (`consensus_mix_2d`, body `_kernel`) as reached through
// `ops.consensus_mix_stacked`.  For every peer k of the row-major (K, N)
// float32 buffer x, with D padded neighbor slots:
//
//   mixed[k] = self_w[k] * x[k] + sum_s nbr_w[k, s] * x[nbr_idx[k, s]]
//   d[k]     = (sum_s beta[k, s] * x[nbr_idx[k, s]] - x[k]) / T,
//              and d[k] = 0 when sum_s beta[k, s] == 0 (isolated peer)
//
// Two designs; the Python wrapper picks one by the number of peers K alone
// (`ops.takes_tile_path`): the column-tile design (`consensus_mix_tile_f32`,
// the code of tile_mix.cuh, shared with dequant_mix.cu) for K from
// ops.TILE_MIN_PEERS (16: below it the gather design is faster) up to
// kTileMaxPeers (128, whose dense table fits shared memory), the gather
// design (`consensus_mix_f32`) elsewhere.  consensus_mix is dequant_mix with
// no payload and est == x: the tile design stages each tile of x once, takes
// the self term x_k from the staged tile, and writes mixed and d only.
//
// Gather design (`consensus_mix_f32`):
// - grid (K, tiles of N); blockIdx.x is the peer, so the K blocks that work
//   on one tile of N run next to each other and find that tile's neighbor
//   rows in L2.
// - each block stages its peer's slot row (nbr_idx, nbr_w, beta) in shared
//   memory once and reduces sum(beta) there, in slot order.
// - each thread keeps float32 accumulators for both outputs and loops over
//   the D slots, reading the neighbor rows by index: the (K, D, N) gather the
//   TPU wrapper builds in HBM (ops.py:126) never exists.
// - float4 loads and stores when N is a multiple of 4 and the buffers are
//   16-byte aligned (the port pads each parameter row to a multiple of 4),
//   scalar otherwise; the tail is masked by the loop bound.
// - outputs go to buffers other than x: other blocks still read x[k] as a
//   neighbor.
// Padding slots carry the peer's own index with weight 0 and add exactly
// +-0.0 to both sums.
//
// Bound on an H100: at the iid_k100 shape (K = 100, D = 99, N = 199,212) one
// call must read 80 MB and write 160 MB (72 us at 3.35 TB/s) but does
// 4 D + 3 = 399 float32 operations per output element, 7.9 GFLOP (119 us at
// 67 TFLOP/s): it is bound by float32 FMA throughput.  The gather design
// re-reads every neighbor row once per peer that needs it (K * D row reads
// per call, served from L2 at best) and shares no loaded value between the
// peers that need it; the tile design reads each row once and does the
// (2K x K) @ (K x N) product from shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {
constexpr int kTileMaxPeers = 128;
}  // namespace

#include "tile_mix.cuh"

namespace {

// T is float (scalar path) or float4 (vector path); n_vec counts T elements
// per row, and rows are n_vec T elements apart.
template <typename T>
__global__ void __launch_bounds__(kThreads)
consensus_mix_kernel(const float* __restrict__ x, int64_t n_vec,
                     const float* __restrict__ self_w, const int32_t* __restrict__ nbr_idx,
                     const float* __restrict__ nbr_w, const float* __restrict__ beta,
                     int d_slots, float local_steps, float* __restrict__ mixed,
                     float* __restrict__ d_out) {
  extern __shared__ float smem[];  // [D] nbr_w | [D] beta | [D] nbr_idx
  float* s_w = smem;
  float* s_b = smem + d_slots;
  int32_t* s_idx = reinterpret_cast<int32_t*>(smem + 2 * d_slots);
  __shared__ int s_has_nbrs;

  const int k = blockIdx.x;
  const int64_t slot_row = static_cast<int64_t>(k) * d_slots;
  for (int s = threadIdx.x; s < d_slots; s += blockDim.x) {
    s_w[s] = nbr_w[slot_row + s];
    s_b[s] = beta[slot_row + s];
    s_idx[s] = nbr_idx[slot_row + s];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float sum = 0.0f;
    for (int s = 0; s < d_slots; ++s) sum += s_b[s];
    s_has_nbrs = sum > 0.0f;
  }
  __syncthreads();
  const bool has_nbrs = s_has_nbrs != 0;
  const float sw = self_w[k];

  const T* xv = reinterpret_cast<const T*>(x);
  T* mv = reinterpret_cast<T*>(mixed);
  T* dv = reinterpret_cast<T*>(d_out);
  const int64_t own = static_cast<int64_t>(k) * n_vec;
  const int64_t stride = static_cast<int64_t>(gridDim.y) * blockDim.x;
  for (int64_t e = static_cast<int64_t>(blockIdx.y) * blockDim.x + threadIdx.x; e < n_vec;
       e += stride) {
    const T self = xv[own + e];
    T acc_mix = vscale(sw, self);
    T acc_beta;
    vzero(acc_beta);
#pragma unroll 4
    for (int s = 0; s < d_slots; ++s) {
      const T v = xv[static_cast<int64_t>(s_idx[s]) * n_vec + e];
      acc_mix = vfma(s_w[s], v, acc_mix);
      acc_beta = vfma(s_b[s], v, acc_beta);
    }
    mv[own + e] = acc_mix;
    dv[own + e] = vbias(acc_beta, self, local_steps, has_nbrs);
  }
}

}  // namespace

// x, mixed, d_out: (num_peers, n) row-major float32 on the device; self_w
// (num_peers,); nbr_idx, nbr_w, beta (num_peers, d_slots).  Every nbr_idx
// entry must lie in [0, num_peers) and d_slots * 12 bytes must fit the
// default 48 KB of shared memory; the Python wrapper checks both.  Launches on
// `stream` and returns the launch's cudaError_t (0 on success).
extern "C" int consensus_mix_f32(const float* x, int64_t num_peers, int64_t n,
                                 const float* self_w, const int32_t* nbr_idx,
                                 const float* nbr_w, const float* beta, int64_t d_slots,
                                 float local_steps, float* mixed, float* d_out,
                                 void* stream) {
  if (num_peers <= 0 || n <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(d_slots) * 3 * sizeof(float);
  const bool vec4 = n % 4 == 0 && aligned16(x) && aligned16(mixed) && aligned16(d_out);
  const int64_t n_vec = vec4 ? n / 4 : n;
  int64_t tiles = (n_vec + kThreads - 1) / kThreads;
  if (tiles > kMaxGridY) tiles = kMaxGridY;
  const dim3 grid(static_cast<unsigned>(num_peers), static_cast<unsigned>(tiles));
  if (vec4) {
    consensus_mix_kernel<float4><<<grid, kThreads, smem, s>>>(
        x, n_vec, self_w, nbr_idx, nbr_w, beta, static_cast<int>(d_slots), local_steps, mixed,
        d_out);
  } else {
    consensus_mix_kernel<float><<<grid, kThreads, smem, s>>>(
        x, n_vec, self_w, nbr_idx, nbr_w, beta, static_cast<int>(d_slots), local_steps, mixed,
        d_out);
  }
  return static_cast<int>(cudaGetLastError());
}

// The column-tile design's entry point: the arguments and their contract are
// consensus_mix_f32's, for num_peers <= kTileMaxPeers (else
// cudaErrorInvalidValue).  Launches a persistent grid on `stream` and
// returns a cudaError_t (0 on success).
extern "C" int consensus_mix_tile_f32(const float* x, int64_t num_peers, int64_t n,
                                      const float* self_w, const int32_t* nbr_idx,
                                      const float* nbr_w, const float* beta, int64_t d_slots,
                                      float local_steps, float* mixed, float* d_out,
                                      void* stream) {
  if (num_peers <= 0 || n <= 0) return static_cast<int>(cudaSuccess);
  if (num_peers > kTileMaxPeers || d_slots < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int k = static_cast<int>(num_peers), ds = static_cast<int>(d_slots);
  const LeafStarts leaves = {};  // no payload: one leaf, unused
  const size_t smem = tile_smem_bytes(k, false);
  const bool vec4 = n % 4 == 0 && aligned16(x) && aligned16(mixed) && aligned16(d_out);
  const cudaError_t err =
      vec4 ? launch_tile<true, true>(false, smem, s, x, x, nullptr, nullptr, leaves, 1, n, k,
                                     self_w, nbr_idx, nbr_w, beta, ds, local_steps, mixed,
                                     d_out, nullptr)
           : launch_tile<false, true>(false, smem, s, x, x, nullptr, nullptr, leaves, 1, n, k,
                                      self_w, nbr_idx, nbr_w, beta, ds, local_steps, mixed,
                                      d_out, nullptr);
  return static_cast<int>(err);
}
