// Segment-sum gossip mix + affinity bias for all K peers of a stacked
// parameter buffer, over one round of a stacked sparse schedule, on Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/consensus_mix/segment.py
// (`segment_mix_2d`, body `_segment_kernel`), reached there through
// `segment_mix_stacked` and `segment_mix_schedule`.  For every peer k of the
// row-major (K, N) float32 buffer x, with the D padded neighbor slots of
// round r = round_idx % R of the stacked (R, K, D) operands:
//
//   mixed[k] = self_w[r, k] * x[k] + sum_s nbr_w[r, k, s] * x[nbr_idx[r, k, s]]
//   d[k]     = (sum_s beta[r, k, s] * x[nbr_idx[r, k, s]] - x[k]) / T,
//              and d[k] = 0 when sum_s beta[r, k, s] == 0 (isolated peer)
//
// Design (simple first; what it shares with consensus_mix.cu is in
// vec_ops.cuh):
// - the round is chosen by offsetting the operand pointers on the host: no
//   round's operands are sliced or copied.
// - grid (K, tiles of N); blockIdx.x is the peer, so the K blocks that work
//   on one tile of N run next to each other and find that tile's neighbor
//   rows in L2.  Every row and byte offset is int64: at K = 4096 and
//   N = 199,212 one buffer holds 8.2e8 floats.  gridDim.y is capped at
//   65,535 and the blocks stride over the remaining tiles.
// - any degree bound D: the slot rows (nbr_idx, nbr_w, beta) are staged in
//   shared memory in chunks of kChunk slots (12 KB); when D <= kChunk one
//   staging serves every tile, otherwise each tile restages chunk by chunk.
//   The isolated-peer guard reduces the raw beta row across the block.
// - each thread keeps float32 accumulators for both outputs, starts the mix
//   from self_w * x and adds the slots in slot order, as the Pallas grid's
//   innermost slot axis does; the (K, D, N) gather never exists.
// - float4 loads and stores when N is a multiple of 4 and the buffers are
//   16-byte aligned (the port pads each parameter row to a multiple of 4),
//   scalar otherwise; the tail is masked.
// - outputs go to buffers other than x: other blocks still read x[k] as a
//   neighbor.
// Padding slots carry the peer's own index with weight 0 and add exactly
// +-0.0 to both sums.
//
// Mass mode (push-sum, `segment_mix_push_sum_f32`; the template switch
// kMass): the round's weights are column-stochastic push weights and every
// peer carries a scalar mass y, (K,) and the same for every round.  The
// sender's mass scales each slot's weight where the slot is staged, the
// self term uses y_k, and
//
//   y'[k]    = self_w[r, k] y[k] + sum_s nbr_w[r, k, s] y[nbr_idx[r, k, s]]
//   mixed[k] = (self_w[r, k] y[k] x[k] + sum_s nbr_w[r, k, s] y[j] x[j]) / y'[k]
//   d[k]     = as in gossip (raw x, beta not scaled)
//
// y' is reduced across the block from the raw slot row, as the guard is, so
// any degree bound works; the division is a multiply by 1 / y' (see
// consensus_mix.cu); the blocks of the first tile column write y' to
// new_mass.
//
// Bound on an H100 SXM: at the large-K shape (K = 4096 on a ring, D = 2,
// N = 199,212) one call must read x once (3.26 GB) and write mixed and d
// (6.53 GB): 9.8 GB, 2.9 ms at 3.35 TB/s, against 9.0 GFLOP (0.13 ms at
// 67 TFLOP/s): it is bound by bytes, and the L2 reuse of neighboring peers'
// rows is what keeps its traffic near that (the slots alone would read
// (D + 1) K N floats, 9.8 GB of reads).  At K = 100 on the complete graph
// (D = 99) it is bound by float32 FMA throughput, like consensus_mix.

#include <cuda_runtime.h>
#include <stdint.h>

#include "vec_ops.cuh"

namespace {

constexpr int kChunk = 1024;  // slots staged at a time: 3 x 4 KB of shared memory

// kMass: each slot's weight scaled by its sender's mass.
template <bool kMass>
__device__ __forceinline__ void stage_slots(const int32_t* __restrict__ nbr_idx,
                                            const float* __restrict__ nbr_w,
                                            const float* __restrict__ beta,
                                            const float* __restrict__ mass, int64_t first,
                                            int count, int32_t* s_idx, float* s_w,
                                            float* s_b) {
  for (int s = threadIdx.x; s < count; s += kThreads) {
    const int32_t j = nbr_idx[first + s];
    s_idx[s] = j;
    s_w[s] = kMass ? nbr_w[first + s] * mass[j] : nbr_w[first + s];
    s_b[s] = beta[first + s];
  }
}

// T is float (scalar path) or float4 (vector path); n_vec counts T elements
// per row, and rows are n_vec T elements apart.  The operand pointers point
// at the round's (K,) and (K, D) slices; mass and new_mass are (K,), used in
// the mass mode only.
template <typename T, bool kMass>
__global__ void __launch_bounds__(kThreads)
segment_mix_kernel(const float* __restrict__ x, int64_t n_vec,
                   const float* __restrict__ self_w, const int32_t* __restrict__ nbr_idx,
                   const float* __restrict__ nbr_w, const float* __restrict__ beta,
                   int d_slots, float local_steps, const float* __restrict__ mass,
                   float* __restrict__ mixed, float* __restrict__ d_out,
                   float* __restrict__ new_mass) {
  __shared__ int32_t s_idx[kChunk];
  __shared__ float s_w[kChunk];
  __shared__ float s_b[kChunk];
  __shared__ float s_part[kThreads / 32];
  __shared__ float s_ypart[kThreads / 32];  // kMass: partial sums of y'

  const int k = blockIdx.x;
  const int64_t slot_row = static_cast<int64_t>(k) * d_slots;

  // the guard reads the raw beta row: strided partial sums, then the warps
  // (and y' in the mass mode, from the raw weights and masses)
  float part = 0.0f, ypart = 0.0f;
  for (int s = threadIdx.x; s < d_slots; s += kThreads) {
    part += beta[slot_row + s];
    if (kMass) ypart += __fmul_rn(nbr_w[slot_row + s], mass[nbr_idx[slot_row + s]]);
  }
  for (int off = 16; off > 0; off >>= 1) {
    part += __shfl_down_sync(0xffffffffu, part, off);
    if (kMass) ypart += __shfl_down_sync(0xffffffffu, ypart, off);
  }
  if ((threadIdx.x & 31) == 0) {
    s_part[threadIdx.x >> 5] = part;
    if (kMass) s_ypart[threadIdx.x >> 5] = ypart;
  }
  const bool one_chunk = d_slots <= kChunk;
  if (one_chunk)
    stage_slots<kMass>(nbr_idx, nbr_w, beta, mass, slot_row, d_slots, s_idx, s_w, s_b);
  __syncthreads();
  float beta_sum = 0.0f;
  for (int w = 0; w < kThreads / 32; ++w) beta_sum += s_part[w];
  const bool has_nbrs = beta_sum > 0.0f;
  const float sw = kMass ? self_w[k] * mass[k] : self_w[k];
  float inv_y = 1.0f;
  if (kMass) {
    float y_new = sw;
    for (int w = 0; w < kThreads / 32; ++w) y_new += s_ypart[w];
    if (blockIdx.y == 0 && threadIdx.x == 0) new_mass[k] = y_new;
    inv_y = 1.0f / y_new;
  }

  const T* xv = reinterpret_cast<const T*>(x);
  T* mv = reinterpret_cast<T*>(mixed);
  T* dv = reinterpret_cast<T*>(d_out);
  const int64_t own = static_cast<int64_t>(k) * n_vec;
  // the loop bound is the same for every thread of the block, so the
  // barriers of the chunked staging below are reached by all of them
  for (int64_t tile = blockIdx.y; tile * kThreads < n_vec; tile += gridDim.y) {
    const int64_t e = tile * kThreads + threadIdx.x;
    const bool live = e < n_vec;
    T self;
    vzero(self);
    if (live) self = xv[own + e];
    T acc_mix = vscale(sw, self);
    T acc_beta;
    vzero(acc_beta);
    for (int c0 = 0; c0 < d_slots; c0 += kChunk) {
      const int cn = min(kChunk, d_slots - c0);
      if (!one_chunk) {
        __syncthreads();  // every thread is done with the previous chunk
        stage_slots<kMass>(nbr_idx, nbr_w, beta, mass, slot_row + c0, cn, s_idx, s_w, s_b);
        __syncthreads();
      }
      if (live) {
#pragma unroll 4
        for (int s = 0; s < cn; ++s) {
          const T v = xv[static_cast<int64_t>(s_idx[s]) * n_vec + e];
          acc_mix = vfma(s_w[s], v, acc_mix);
          acc_beta = vfma(s_b[s], v, acc_beta);
        }
      }
    }
    if (live) {
      mv[own + e] = kMass ? vscale(inv_y, acc_mix) : acc_mix;
      dv[own + e] = vbias(acc_beta, self, local_steps, has_nbrs);
    }
  }
}

template <bool kMass>
int launch_segment(const float* x, int64_t num_peers, int64_t n, const float* self_w,
                   const int32_t* nbr_idx, const float* nbr_w, const float* beta,
                   int64_t rounds, int64_t round_idx, int64_t d_slots, float local_steps,
                   const float* mass, float* mixed, float* d_out, float* new_mass,
                   void* stream) {
  if (num_peers <= 0 || n <= 0) return static_cast<int>(cudaSuccess);
  if (rounds <= 0 || d_slots <= 0 || d_slots > INT32_MAX || num_peers > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t r = (round_idx % rounds + rounds) % rounds;
  const int64_t peer_off = r * num_peers;
  const int64_t slot_off = peer_off * d_slots;
  const bool vec4 = n % 4 == 0 && aligned16(x) && aligned16(mixed) && aligned16(d_out);
  const int64_t n_vec = vec4 ? n / 4 : n;
  int64_t tiles = (n_vec + kThreads - 1) / kThreads;
  if (kMass) tiles = mass_mode_tiles(tiles, d_slots);
  if (tiles > kMaxGridY) tiles = kMaxGridY;
  const dim3 grid(static_cast<unsigned>(num_peers), static_cast<unsigned>(tiles));
  if (vec4) {
    segment_mix_kernel<float4, kMass><<<grid, kThreads, 0, s>>>(
        x, n_vec, self_w + peer_off, nbr_idx + slot_off, nbr_w + slot_off, beta + slot_off,
        static_cast<int>(d_slots), local_steps, mass, mixed, d_out, new_mass);
  } else {
    segment_mix_kernel<float, kMass><<<grid, kThreads, 0, s>>>(
        x, n_vec, self_w + peer_off, nbr_idx + slot_off, nbr_w + slot_off, beta + slot_off,
        static_cast<int>(d_slots), local_steps, mass, mixed, d_out, new_mass);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, mixed, d_out: (num_peers, n) row-major float32 on the device; self_w
// (rounds, num_peers); nbr_idx, nbr_w, beta (rounds, num_peers, d_slots).
// Mixes with round round_idx % rounds.  Every nbr_idx entry must lie in
// [0, num_peers); the Python wrapper's schedule checked that once.  Launches
// on `stream` and returns the launch's cudaError_t (0 on success).
extern "C" int segment_mix_f32(const float* x, int64_t num_peers, int64_t n,
                               const float* self_w, const int32_t* nbr_idx,
                               const float* nbr_w, const float* beta, int64_t rounds,
                               int64_t round_idx, int64_t d_slots, float local_steps,
                               float* mixed, float* d_out, void* stream) {
  return launch_segment<false>(x, num_peers, n, self_w, nbr_idx, nbr_w, beta, rounds,
                               round_idx, d_slots, local_steps, nullptr, mixed, d_out, nullptr,
                               stream);
}

// The mass mode (push-sum): segment_mix_f32's arguments and contract, with
// mass (num_peers,) float32 on the device, every entry positive, and
// new_mass (num_peers,), a buffer other than mass, which receives y'.
extern "C" int segment_mix_push_sum_f32(const float* x, int64_t num_peers, int64_t n,
                                        const float* self_w, const int32_t* nbr_idx,
                                        const float* nbr_w, const float* beta, int64_t rounds,
                                        int64_t round_idx, int64_t d_slots, float local_steps,
                                        const float* mass, float* mixed, float* d_out,
                                        float* new_mass, void* stream) {
  return launch_segment<true>(x, num_peers, n, self_w, nbr_idx, nbr_w, beta, rounds,
                              round_idx, d_slots, local_steps, mass, mixed, d_out, new_mass,
                              stream);
}
