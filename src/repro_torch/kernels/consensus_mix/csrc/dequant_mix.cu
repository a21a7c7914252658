// Fused int8 dequantize + gossip mix + affinity bias for all K peers of a
// stacked parameter buffer, on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/consensus_mix/dequant.py
// (`dequant_mix_2d`, body `_kernel`), the fused form of the compressed-gossip
// consensus step (`p2p._consensus_phase_compressed`).  Every peer carries a
// public estimate est of every peer's parameters; this step's payload of
// sender j is an int8 row q[j] with one float32 scale per leaf of the
// parameter row.  For every peer k and column n of leaf l(n), with D padded
// neighbor slots j = nbr_idx[k, s]:
//
//   v_j      = est[j, n] + scale[j, l(n)] * q[j, n]      (advanced estimate)
//   mixed[k] = self_w[k] * x[k, n] + sum_s nbr_w[k, s] * v_j
//   d[k]     = (sum_s beta[k, s] * v_j - v_k) / T,  0 if sum_s beta[k, s] == 0
//   est'[k]  = v_k                                         (written once)
//
// The self term of the mix stays on the true parameters x; the affinity d
// runs on estimate differences, as the runtime computes it from the advanced
// own estimate.  With no payload (q == nullptr: top-k, whose estimate was
// advanced by a scatter beforehand) v_j = est[j, n] and est' is not written.
//
// Two designs; the Python wrapper picks one by the number of peers K alone
// (`dequant.takes_tile_path`): the column-tile design for K <= kTileMaxPeers
// (128: both main paths, K = 8 and K = 100), the gather design above it.
//
// Column-tile design (`dequant_mix_tile_f32`; the code and its note are in
// tile_mix.cuh, shared with consensus_mix.cu): TN = 80 at K = 100,
// one block of 512 threads an SM; 256 at K = 8, several small blocks.  Every
// sender's est and q of a tile is read once and dequantized once: each thread
// advances the elements it staged, in place (v = fmaf(scale, q, est), one
// rounding), and writes them to est'.  mixed_k takes x_k from device memory
// (x is not est here), loaded before the sums.
//
// Gather design (`dequant_mix_f32`, K > kTileMaxPeers, in the shape of
// consensus_mix.cu):
// - grid (K, tiles of N); blockIdx.x is the peer, so the K blocks of one
//   N-tile run together and find that tile's neighbor rows in L2.
// - each block stages its peer's slot row (nbr_idx, nbr_w, beta), the
//   senders' scales of every leaf (leaf-major, L * D floats) and its own L
//   scales in shared memory, and reduces the RAW sum(beta) there for the
//   no-neighbor guard (a scale-folded beta would read 0 for a zero scale).
// - the leaf of a column comes from a scan of the L leaf starts (L = 6 for
//   the 2NN), once per element, outside the slot loop.  Columns past the last
//   leaf (the row's zero padding) take the last leaf's scale; q is 0 there.
// - the advanced estimates are formed in registers and never stored for
//   neighbors: only this peer's own est' is written, to a buffer other than
//   est, since other blocks still read est[k] as a neighbor.
// - float4 loads and stores (one 32-bit char4 of q per float4) when N and
//   every leaf start are multiples of 4 and the buffers are aligned (16 bytes
//   for float32, 4 for int8: a q row of 199,212 bytes is 4-byte aligned
//   only); scalar otherwise.
// - the advance is one fmaf (one rounding); the plain version multiplies and
//   then adds (two roundings), which the card check's tolerance covers.
// Padding slots carry the peer's own index with weight 0 and add exactly
// +-0.0 to both sums.
//
// Mass mode (compressed push-sum, `dequant_mix_push_sum_f32` and
// `dequant_mix_push_sum_tile_f32`; the template switch kMass, in both
// designs): the weights are the column-stochastic push weights A, every peer
// carries an uncompressed scalar mass y, and
//
//   y'[k]    = self_w[k] y[k] + sum_s nbr_w[k, s] y[j]
//   mixed[k] = (self_w[k] y[k] x[k] + sum_s nbr_w[k, s] y[j] v_j) / y'[k]
//   d[k], est'[k] as above (advanced estimates, beta not scaled by mass)
//
// the self term on the true parameters, the off-diagonal terms on the
// advanced estimates: the reference's PushSumProtocol.mix_compressed.  Each
// weight is scaled by its sender's mass where it is staged (gather) or
// scattered (tile); the gather design sums y' in slot order and multiplies
// by 1 / y' at the store, the tile design sums it one warp a row and folds
// 1 / y' into the row's weights (see consensus_mix.cu); y' is written once
// to new_mass.
//
// bf16 storage mode (`dequant_mix_bf16`, `dequant_mix_tile_bf16` and their
// push-sum forms; the storage type TS of both designs): x, est, est', mixed
// and d are bf16 in device memory, as a bf16 model's parameters and their
// public estimates are; q stays int8, the scales, the weights and the mass
// float32.  The advance rounds where the reference's compressed path rounds
// (compression/compressors.py ef_compress_leaf, QInt8.decompress): the
// payload's value scale * q is formed in float32 and rounded to bf16, and the
// new estimate est + D is rounded to bf16, v = bf16(est + bf16(scale * q))
// (tile_mix.cuh's vadvance); v is widened to float32 for the sums, which stay
// float32, and mixed and d are rounded to bf16 as they are stored.  The
// vector path reads 4 bf16 (8 bytes) where the float32 one reads a float4.
//
// Bound on an H100 SXM: at iid_k100 with qint8 (K = 100, D = 99,
// N = 199,212) one call must read x, est (79.7 MB each) and q (19.9 MB) and
// write mixed, d and est' (239 MB): 418 MB, 0.125 ms at 3.35 TB/s; its least
// arithmetic, 4 D + 5 operations per element, is 8.0 GFLOP, 0.119 ms at
// 67 TFLOP/s.  It is balanced, barely bound by bytes.  The gather design
// re-reads every neighbor row and payload once per peer that needs it (9.86
// GB through L2 at K = 100) and dequantizes it again each time; the
// column-tile design reads each once and does the 2 x 2K x K x N = 8.0
// GFLOP of dense multiply-adds from shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
constexpr int kTileMaxPeers = 128;
}  // namespace

#include "tile_mix.cuh"

namespace {

__device__ __forceinline__ float load_q(const int8_t* q, int64_t i) {
  return static_cast<float>(q[i]);
}
__device__ __forceinline__ float4 load_q(const char4* q, int64_t i) {
  const char4 c = q[i];
  return make_float4(static_cast<float>(c.x), static_cast<float>(c.y),
                     static_cast<float>(c.z), static_cast<float>(c.w));
}

// T is float (scalar path, Q = int8_t) or float4 (vector path, Q = char4);
// n_vec counts T elements per row.  kHasQ is false for the no-payload call;
// kMass is the push-sum mode (mass and new_mass used); TS the storage type
// of x, est, est', mixed and d (float, or __nv_bfloat16).
template <typename T, typename Q, bool kHasQ, bool kMass, typename TS = float>
__global__ void __launch_bounds__(kThreads)
dequant_mix_kernel(const TS* __restrict__ x, const TS* __restrict__ est,
                   const int8_t* __restrict__ q, const float* __restrict__ scale,
                   LeafStarts leaves, int num_leaves, int64_t n_vec,
                   const float* __restrict__ self_w, const int32_t* __restrict__ nbr_idx,
                   const float* __restrict__ nbr_w, const float* __restrict__ beta,
                   int d_slots, float local_steps, const float* __restrict__ mass,
                   TS* __restrict__ mixed, TS* __restrict__ d_out,
                   TS* __restrict__ est_out, float* __restrict__ new_mass) {
  // [D] nbr_w | [D] beta | [D] nbr_idx | [L * D] sender scales | [L] own scales
  extern __shared__ float smem[];
  float* s_w = smem;
  float* s_b = smem + d_slots;
  int32_t* s_idx = reinterpret_cast<int32_t*>(smem + 2 * d_slots);
  float* s_sc = smem + 3 * d_slots;
  float* s_own = s_sc + num_leaves * d_slots;
  __shared__ int64_t s_start[kMaxLeaves];
  __shared__ int s_has_nbrs;
  __shared__ float s_mass[2];  // kMass: self_w[k] y[k] and 1 / y'[k]

  const int k = blockIdx.x;
  const int64_t slot_row = static_cast<int64_t>(k) * d_slots;
  for (int s = threadIdx.x; s < d_slots; s += blockDim.x) {
    if (kMass) {
      const int32_t j = nbr_idx[slot_row + s];
      s_w[s] = nbr_w[slot_row + s] * mass[j];
      s_b[s] = beta[slot_row + s];
      s_idx[s] = j;
    } else {
      s_w[s] = nbr_w[slot_row + s];
      s_b[s] = beta[slot_row + s];
      s_idx[s] = nbr_idx[slot_row + s];
    }
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int l = 0; l < kMaxLeaves; ++l) {
      if (l < num_leaves) s_start[l] = leaves.start[l];
    }
  }
  __syncthreads();
  if (kHasQ) {
    for (int i = threadIdx.x; i < num_leaves * d_slots; i += blockDim.x) {
      const int l = i / d_slots, s = i - l * d_slots;
      s_sc[i] = scale[static_cast<int64_t>(s_idx[s]) * num_leaves + l];
    }
    for (int l = threadIdx.x; l < num_leaves; l += blockDim.x) {
      s_own[l] = scale[static_cast<int64_t>(k) * num_leaves + l];
    }
  }
  if (threadIdx.x == 0) {
    float sum = 0.0f;
    for (int s = 0; s < d_slots; ++s) sum += s_b[s];
    s_has_nbrs = sum > 0.0f;
    if (kMass) {  // y' in slot order, from the scaled slot weights
      const float sw_y = self_w[k] * mass[k];
      float y = sw_y;
      for (int s = 0; s < d_slots; ++s) y += s_w[s];
      s_mass[0] = sw_y;
      s_mass[1] = 1.0f / y;
      if (blockIdx.y == 0) new_mass[k] = y;
    }
  }
  __syncthreads();
  const bool has_nbrs = s_has_nbrs != 0;
  const float sw = kMass ? s_mass[0] : self_w[k];
  const float inv_y = kMass ? s_mass[1] : 1.0f;
  constexpr int kWidth = sizeof(T) / sizeof(float);

  const Q* qv = reinterpret_cast<const Q*>(q);
  const int64_t own = static_cast<int64_t>(k) * n_vec;
  const int64_t stride = static_cast<int64_t>(gridDim.y) * blockDim.x;
  for (int64_t e = static_cast<int64_t>(blockIdx.y) * blockDim.x + threadIdx.x; e < n_vec;
       e += stride) {
    T self_est = vload<T>(est, own + e);
    const float* sc = s_sc;
    if (kHasQ) {
      const int64_t col = e * kWidth;
      int l = 0;
      while (l + 1 < num_leaves && col >= s_start[l + 1]) ++l;
      sc = s_sc + l * d_slots;
      self_est = vadvance<TS>(s_own[l], load_q(qv, own + e), self_est);
      vstore(est_out, own + e, self_est);
    }
    T acc_mix = vscale(sw, vload<T>(x, own + e));
    T acc_beta;
    vzero(acc_beta);
#pragma unroll 4
    for (int s = 0; s < d_slots; ++s) {
      const int64_t nbr = static_cast<int64_t>(s_idx[s]) * n_vec + e;
      T v = vload<T>(est, nbr);
      if (kHasQ) v = vadvance<TS>(sc[s], load_q(qv, nbr), v);
      acc_mix = vfma(s_w[s], v, acc_mix);
      acc_beta = vfma(s_b[s], v, acc_beta);
    }
    vstore(mixed, own + e, kMass ? vscale(inv_y, acc_mix) : acc_mix);
    vstore(d_out, own + e, vbias(acc_beta, self_est, local_steps, has_nbrs));
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename T, typename Q, bool kMass, typename TS>
void launch(bool has_q, dim3 grid, size_t smem, cudaStream_t s, const TS* x,
            const TS* est, const int8_t* q, const float* scale, const LeafStarts& leaves,
            int num_leaves, int64_t n_vec, const float* self_w, const int32_t* nbr_idx,
            const float* nbr_w, const float* beta, int d_slots, float local_steps,
            const float* mass, TS* mixed, TS* d_out, TS* est_out, float* new_mass) {
  if (has_q) {
    dequant_mix_kernel<T, Q, true, kMass, TS><<<grid, kThreads, smem, s>>>(
        x, est, q, scale, leaves, num_leaves, n_vec, self_w, nbr_idx, nbr_w, beta, d_slots,
        local_steps, mass, mixed, d_out, est_out, new_mass);
  } else {
    dequant_mix_kernel<T, Q, false, kMass, TS><<<grid, kThreads, smem, s>>>(
        x, est, q, scale, leaves, num_leaves, n_vec, self_w, nbr_idx, nbr_w, beta, d_slots,
        local_steps, mass, mixed, d_out, est_out, new_mass);
  }
}

// The checks both entry points make: 0 or the cudaError_t to return.
int check_args(const int8_t* q, const float* scale, const int64_t* leaf_start,
               int64_t num_leaves, int64_t n, int vec4, const void* x, const void* est,
               const void* mixed, const void* d_out, const void* est_out,
               LeafStarts& leaves) {
  const bool has_q = q != nullptr;
  if (num_leaves < 1 || num_leaves > kMaxLeaves ||
      (has_q && (scale == nullptr || est_out == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int64_t l = 0; l < num_leaves; ++l) {
    leaves.start[l] = leaf_start[l];
    if (vec4 && leaf_start[l] % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  }
  if (vec4 && !(n % 4 == 0 && aligned(x, 16) && aligned(est, 16) && aligned(mixed, 16) &&
                aligned(d_out, 16) && (!has_q || (aligned(q, 4) && aligned(est_out, 16)))))
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

template <bool kMass, typename TS = float>
int launch_gather(const TS* x, const TS* est, const int8_t* q, const float* scale,
                  const int64_t* leaf_start, int64_t num_leaves, int64_t num_peers, int64_t n,
                  const float* self_w, const int32_t* nbr_idx, const float* nbr_w,
                  const float* beta, int64_t d_slots, float local_steps, int vec4,
                  const float* mass, TS* mixed, TS* d_out, TS* est_out,
                  float* new_mass, void* stream) {
  if (num_peers <= 0 || n <= 0) return static_cast<int>(cudaSuccess);
  const bool has_q = q != nullptr;
  LeafStarts leaves = {};
  if (const int err = check_args(q, scale, leaf_start, num_leaves, n, vec4, x, est, mixed,
                                 d_out, est_out, leaves))
    return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nl = static_cast<int>(num_leaves);
  const int ds = static_cast<int>(d_slots);
  const size_t smem =
      (static_cast<size_t>(d_slots) * (3 + (has_q ? num_leaves : 0)) + (has_q ? num_leaves : 0)) *
      sizeof(float);
  const int64_t n_vec = vec4 ? n / 4 : n;
  int64_t tiles = (n_vec + kThreads - 1) / kThreads;
  if (kMass) tiles = mass_mode_tiles(tiles, d_slots);
  if (tiles > kMaxGridY) tiles = kMaxGridY;
  const dim3 grid(static_cast<unsigned>(num_peers), static_cast<unsigned>(tiles));
  if (vec4) {
    launch<float4, char4, kMass, TS>(has_q, grid, smem, s, x, est, q, scale, leaves, nl, n_vec,
                                 self_w, nbr_idx, nbr_w, beta, ds, local_steps, mass, mixed,
                                 d_out, est_out, new_mass);
  } else {
    launch<float, int8_t, kMass, TS>(has_q, grid, smem, s, x, est, q, scale, leaves, nl, n_vec,
                                 self_w, nbr_idx, nbr_w, beta, ds, local_steps, mass, mixed,
                                 d_out, est_out, new_mass);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kMass, typename TS = float>
int launch_column_tile(const TS* x, const TS* est, const int8_t* q, const float* scale,
                       const int64_t* leaf_start, int64_t num_leaves, int64_t num_peers,
                       int64_t n, const float* self_w, const int32_t* nbr_idx,
                       const float* nbr_w, const float* beta, int64_t d_slots,
                       float local_steps, int vec4, const float* mass, TS* mixed,
                       TS* d_out, TS* est_out, float* new_mass, void* stream) {
  if (num_peers <= 0 || n <= 0) return static_cast<int>(cudaSuccess);
  const bool has_q = q != nullptr;
  if (num_peers > kTileMaxPeers || d_slots < 1) return static_cast<int>(cudaErrorInvalidValue);
  LeafStarts leaves = {};
  if (const int err = check_args(q, scale, leaf_start, num_leaves, n, vec4, x, est, mixed,
                                 d_out, est_out, leaves))
    return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nl = static_cast<int>(num_leaves), k = static_cast<int>(num_peers);
  const int ds = static_cast<int>(d_slots);
  const size_t smem = tile_smem_bytes(k, has_q, kMass);
  const cudaError_t err =
      vec4 ? launch_tile<true, false, kMass, false, TS>(
                 has_q, smem, s, x, est, q, scale, leaves, nl, n, k, self_w, nbr_idx, nbr_w,
                 beta, ds, local_steps, mass, mixed, d_out, est_out, new_mass)
           : launch_tile<false, false, kMass, false, TS>(
                 has_q, smem, s, x, est, q, scale, leaves, nl, n, k, self_w, nbr_idx, nbr_w,
                 beta, ds, local_steps, mass, mixed, d_out, est_out, new_mass);
  return static_cast<int>(err);
}

}  // namespace

// x, est, mixed, d_out, est_out: (num_peers, n) row-major float32 on the
// device; q: (num_peers, n) int8 and scale: (num_peers, num_leaves) float32,
// or both null for a call with no payload (est_out is then unused).
// leaf_start: HOST array of the num_leaves first columns of the leaves
// (leaf_start[0] == 0, increasing, below n).  self_w (num_peers,); nbr_idx,
// nbr_w, beta (num_peers, d_slots).  vec4 != 0 asks for the float4 path,
// which needs n and every leaf start to be multiples of 4 and the buffers
// aligned.  Every nbr_idx entry must lie in [0, num_peers) and the staged
// slot row must fit the default 48 KB of shared memory; the Python wrapper
// checks both.  Launches on `stream` and returns a cudaError_t (0 on
// success; cudaErrorInvalidValue for arguments it refuses).
extern "C" int dequant_mix_f32(const float* x, const float* est, const int8_t* q,
                               const float* scale, const int64_t* leaf_start,
                               int64_t num_leaves, int64_t num_peers, int64_t n,
                               const float* self_w, const int32_t* nbr_idx, const float* nbr_w,
                               const float* beta, int64_t d_slots, float local_steps, int vec4,
                               float* mixed, float* d_out, float* est_out, void* stream) {
  return launch_gather<false>(x, est, q, scale, leaf_start, num_leaves, num_peers, n, self_w,
                              nbr_idx, nbr_w, beta, d_slots, local_steps, vec4, nullptr, mixed,
                              d_out, est_out, nullptr, stream);
}

// The column-tile design's entry point: the arguments and their contract are
// dequant_mix_f32's, for num_peers <= kTileMaxPeers (else
// cudaErrorInvalidValue).  Launches a persistent grid on `stream` and
// returns a cudaError_t (0 on success).
extern "C" int dequant_mix_tile_f32(const float* x, const float* est, const int8_t* q,
                                    const float* scale, const int64_t* leaf_start,
                                    int64_t num_leaves, int64_t num_peers, int64_t n,
                                    const float* self_w, const int32_t* nbr_idx,
                                    const float* nbr_w, const float* beta, int64_t d_slots,
                                    float local_steps, int vec4, float* mixed, float* d_out,
                                    float* est_out, void* stream) {
  return launch_column_tile<false>(x, est, q, scale, leaf_start, num_leaves, num_peers, n,
                                   self_w, nbr_idx, nbr_w, beta, d_slots, local_steps, vec4,
                                   nullptr, mixed, d_out, est_out, nullptr, stream);
}

// The mass mode (compressed push-sum) of the two designs: the arguments and
// contracts of dequant_mix_f32 and dequant_mix_tile_f32, with mass
// (num_peers,) float32 on the device, every entry positive, and new_mass
// (num_peers,), a buffer other than mass, which receives y'.
extern "C" int dequant_mix_push_sum_f32(const float* x, const float* est, const int8_t* q,
                                        const float* scale, const int64_t* leaf_start,
                                        int64_t num_leaves, int64_t num_peers, int64_t n,
                                        const float* self_w, const int32_t* nbr_idx,
                                        const float* nbr_w, const float* beta, int64_t d_slots,
                                        float local_steps, int vec4, const float* mass,
                                        float* mixed, float* d_out, float* est_out,
                                        float* new_mass, void* stream) {
  return launch_gather<true>(x, est, q, scale, leaf_start, num_leaves, num_peers, n, self_w,
                             nbr_idx, nbr_w, beta, d_slots, local_steps, vec4, mass, mixed,
                             d_out, est_out, new_mass, stream);
}

extern "C" int dequant_mix_push_sum_tile_f32(const float* x, const float* est, const int8_t* q,
                                             const float* scale, const int64_t* leaf_start,
                                             int64_t num_leaves, int64_t num_peers, int64_t n,
                                             const float* self_w, const int32_t* nbr_idx,
                                             const float* nbr_w, const float* beta,
                                             int64_t d_slots, float local_steps, int vec4,
                                             const float* mass, float* mixed, float* d_out,
                                             float* est_out, float* new_mass, void* stream) {
  return launch_column_tile<true>(x, est, q, scale, leaf_start, num_leaves, num_peers, n,
                                  self_w, nbr_idx, nbr_w, beta, d_slots, local_steps, vec4, mass,
                                  mixed, d_out, est_out, new_mass, stream);
}

// The bf16 storage mode of the four entry points above: their arguments and
// contracts, with x, est, mixed, d_out and est_out (num_peers, n) row-major
// bf16; q int8, scale, the weights, mass and new_mass as they were.
extern "C" int dequant_mix_bf16(const __nv_bfloat16* x, const __nv_bfloat16* est,
                                const int8_t* q, const float* scale, const int64_t* leaf_start,
                                int64_t num_leaves, int64_t num_peers, int64_t n,
                                const float* self_w, const int32_t* nbr_idx, const float* nbr_w,
                                const float* beta, int64_t d_slots, float local_steps, int vec4,
                                __nv_bfloat16* mixed, __nv_bfloat16* d_out,
                                __nv_bfloat16* est_out, void* stream) {
  return launch_gather<false>(x, est, q, scale, leaf_start, num_leaves, num_peers, n, self_w,
                              nbr_idx, nbr_w, beta, d_slots, local_steps, vec4, nullptr, mixed,
                              d_out, est_out, nullptr, stream);
}

extern "C" int dequant_mix_tile_bf16(const __nv_bfloat16* x, const __nv_bfloat16* est,
                                     const int8_t* q, const float* scale,
                                     const int64_t* leaf_start, int64_t num_leaves,
                                     int64_t num_peers, int64_t n, const float* self_w,
                                     const int32_t* nbr_idx, const float* nbr_w,
                                     const float* beta, int64_t d_slots, float local_steps,
                                     int vec4, __nv_bfloat16* mixed, __nv_bfloat16* d_out,
                                     __nv_bfloat16* est_out, void* stream) {
  return launch_column_tile<false>(x, est, q, scale, leaf_start, num_leaves, num_peers, n,
                                   self_w, nbr_idx, nbr_w, beta, d_slots, local_steps, vec4,
                                   nullptr, mixed, d_out, est_out, nullptr, stream);
}

extern "C" int dequant_mix_push_sum_bf16(const __nv_bfloat16* x, const __nv_bfloat16* est,
                                         const int8_t* q, const float* scale,
                                         const int64_t* leaf_start, int64_t num_leaves,
                                         int64_t num_peers, int64_t n, const float* self_w,
                                         const int32_t* nbr_idx, const float* nbr_w,
                                         const float* beta, int64_t d_slots, float local_steps,
                                         int vec4, const float* mass, __nv_bfloat16* mixed,
                                         __nv_bfloat16* d_out, __nv_bfloat16* est_out,
                                         float* new_mass, void* stream) {
  return launch_gather<true>(x, est, q, scale, leaf_start, num_leaves, num_peers, n, self_w,
                             nbr_idx, nbr_w, beta, d_slots, local_steps, vec4, mass, mixed,
                             d_out, est_out, new_mass, stream);
}

extern "C" int dequant_mix_push_sum_tile_bf16(const __nv_bfloat16* x, const __nv_bfloat16* est,
                                              const int8_t* q, const float* scale,
                                              const int64_t* leaf_start, int64_t num_leaves,
                                              int64_t num_peers, int64_t n, const float* self_w,
                                              const int32_t* nbr_idx, const float* nbr_w,
                                              const float* beta, int64_t d_slots,
                                              float local_steps, int vec4, const float* mass,
                                              __nv_bfloat16* mixed, __nv_bfloat16* d_out,
                                              __nv_bfloat16* est_out, float* new_mass,
                                              void* stream) {
  return launch_column_tile<true>(x, est, q, scale, leaf_start, num_leaves, num_peers, n,
                                  self_w, nbr_idx, nbr_w, beta, d_slots, local_steps, vec4, mass,
                                  mixed, d_out, est_out, new_mass, stream);
}

// Columns of one tile of the column-tile design at num_peers peers.
extern "C" int64_t dequant_mix_tile_columns(int64_t num_peers) {
  return tile_shape(static_cast<int>(num_peers)).tn;
}
