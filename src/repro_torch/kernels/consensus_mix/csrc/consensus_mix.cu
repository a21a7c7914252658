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
// Mass mode (push-sum, `consensus_mix_push_sum_f32` and
// `consensus_mix_push_sum_tile_f32`; the template switch kMass): the weights
// are the column-stochastic push weights A and every peer carries a scalar
// mass y.  Each weight is scaled by its sender's mass where the kernel
// already reads it (the gather design when it stages its slot row, the tile
// design when it scatters its [W_off; Beta] table and loads self_w), and
//
//   y'[k]    = self_w[k] y[k] + sum_s nbr_w[k, s] y[nbr_idx[k, s]]
//   mixed[k] = (self_w[k] y[k] x[k] + sum_s nbr_w[k, s] y[j] x[j]) / y'[k]
//   d[k]     = as in gossip: raw x, beta not scaled by mass
//
// Every block computes the y' of its rows from the same slots and takes the
// correctly rounded 1 / y': the gather design multiplies by it at the
// store, the tile design folds it into the row's weights as it builds its
// table, so its loop and stores are gossip's (an IEEE divide per element
// cost the FMA-bound tile 7% on an H100, and pushed dequant_mix's tile into
// register spills).  The result is within a few ulp of A (y x) / y'.  y' is
// written once to new_mass (by the blocks of the first column tile).  The mass is read from device memory: nothing is appended
// to x and nothing goes back to the host.  The gossip instantiations
// (kMass false) are the code they were.
//
// Snapshot mode (bounded-staleness consensus, `consensus_mix_snapshot_f32`,
// `consensus_mix_snapshot_tile_f32` and their push-sum forms; the template
// switch kSnap, in either weight mode): every neighbor term reads the
// sender's last published snapshot P (a second (K, N) buffer), while the
// self term and d's own term read the live x, with weights the caller has
// already age-decayed:
//
//   mixed[k] = self_w[k] * x[k] + sum_s nbr_w[k, s] * P[nbr_idx[k, s]]
//   d[k]     = (sum_s beta[k, s] * P[nbr_idx[k, s]] - x[k]) / T
//
// (in the mass mode the weights are scaled by the senders' masses and the
// mix divided by y'_k, as above).  The gather design changes only its
// neighbor load, from x to P; the column tile stages P's tiles in place of
// x's, reads the self term from device memory (as dequant_mix does) and
// loads x_k for the d rows too.  Every other instantiation is the code it
// was: kSnap is a template switch, and the gather kernel's one new argument
// comes last.
//
// bf16 storage mode (`consensus_mix_bf16` and `consensus_mix_tile_bf16`, and
// the mass and snapshot modes' `*_bf16` entry points): x, P, mixed and d are
// bf16 in device memory, as
// a bfloat16 model's parameters are (the reference mixes bf16 leaves in
// float32 and casts back, core/consensus.py, as its Pallas kernel does).
// Each x value is widened to float32 as it is read, every sum is float32 as
// in the float32 mode, and mixed and d are rounded to bf16 as they are
// stored; the weights, the guard and T stay float32.  The gather design
// reads 8 bf16 (16 bytes) a thread where N is a multiple of 8 and the
// buffers are 16-byte aligned (the port pads a bf16 row to a multiple of 8),
// one element otherwise; the column tile widens each tile as it stages it
// (tile_mix.cuh, TS = __nv_bfloat16).  The mass mode (kMass) and the
// snapshot mode (kSnap) take the same switches in bf16 storage as in float32:
// the mass, y', the weights and 1 / y' stay float32, and the gather design's
// bf16 kernel scales its staged weights and multiplies by 1 / y' at the
// store as the float32 one does.  The dense-operand mode is the sparse one on
// the candidate slots, so it takes bf16 too.  Bound: the same work on half
// the bytes.
//
// Row range (every entry point's `row0`, `rows`): the launch computes the
// mix and d rows of peers row0 .. row0 + rows - 1 only, into (rows, n)
// outputs (and y' into (rows,) new_mass), reading x (and P) of all K peers:
// a process that holds one peer's row and its in-neighbors' rows in a (K,
// n) buffer computes its own row, not all K.  Each row's arithmetic is the
// full launch's (the gather design's block is the same block; the column
// tile's table column and sender order are the same), so the rows equal the
// full launch's bit for bit.  row0 = 0, rows = num_peers is the full launch.
//
// Bound on an H100: at the iid_k100 shape (K = 100, D = 99, N = 199,212) one
// call must read 80 MB and write 160 MB (72 us at 3.35 TB/s) but does
// 4 D + 3 = 399 float32 operations per output element, 7.9 GFLOP (119 us at
// 67 TFLOP/s): it is bound by float32 FMA throughput.  The gather design
// re-reads every neighbor row once per peer that needs it (K * D row reads
// per call, served from L2 at best) and shares no loaded value between the
// peers that need it; the tile design reads each row once and does the
// (2K x K) @ (K x N) product from shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
constexpr int kTileMaxPeers = 128;
}  // namespace

#include "tile_mix.cuh"

namespace {

// T is float (scalar path) or float4 (vector path); n_vec counts T elements
// per row, and rows are n_vec T elements apart.  kMass: push-sum (mass,
// new_mass used), else gossip (both unused).  kSnap: the neighbor rows are
// read from pub (the published snapshots), else from x (pub unused).
template <typename T, bool kMass, bool kSnap = false>
__global__ void __launch_bounds__(kThreads)
consensus_mix_kernel(const float* __restrict__ x, int64_t n_vec,
                     const float* __restrict__ self_w, const int32_t* __restrict__ nbr_idx,
                     const float* __restrict__ nbr_w, const float* __restrict__ beta,
                     int d_slots, float local_steps, const float* __restrict__ mass,
                     float* __restrict__ mixed, float* __restrict__ d_out,
                     float* __restrict__ new_mass, const float* __restrict__ pub,
                     int64_t row0) {
  extern __shared__ float smem[];  // [D] nbr_w (x sender mass) | [D] beta | [D] nbr_idx
  float* s_w = smem;
  float* s_b = smem + d_slots;
  int32_t* s_idx = reinterpret_cast<int32_t*>(smem + 2 * d_slots);
  __shared__ int s_has_nbrs;
  __shared__ float s_mass[2];  // kMass: self_w[k] y[k] and 1 / y'[k]

  // block x computes peer row0 + x into output row x
  const int k = static_cast<int>(row0) + blockIdx.x;
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
  __syncthreads();
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
      if (blockIdx.y == 0) new_mass[blockIdx.x] = y;
    }
  }
  __syncthreads();
  const bool has_nbrs = s_has_nbrs != 0;
  const float sw = kMass ? s_mass[0] : self_w[k];
  const float inv_y = kMass ? s_mass[1] : 1.0f;

  const T* xv = reinterpret_cast<const T*>(x);
  const T* nv = reinterpret_cast<const T*>(kSnap ? pub : x);  // the neighbor rows
  T* mv = reinterpret_cast<T*>(mixed);
  T* dv = reinterpret_cast<T*>(d_out);
  const int64_t own = static_cast<int64_t>(k) * n_vec;
  const int64_t out = static_cast<int64_t>(blockIdx.x) * n_vec;
  const int64_t stride = static_cast<int64_t>(gridDim.y) * blockDim.x;
  for (int64_t e = static_cast<int64_t>(blockIdx.y) * blockDim.x + threadIdx.x; e < n_vec;
       e += stride) {
    const T self = xv[own + e];
    T acc_mix = vscale(sw, self);
    T acc_beta;
    vzero(acc_beta);
#pragma unroll 4
    for (int s = 0; s < d_slots; ++s) {
      const T v = nv[static_cast<int64_t>(s_idx[s]) * n_vec + e];
      acc_mix = vfma(s_w[s], v, acc_mix);
      acc_beta = vfma(s_b[s], v, acc_beta);
    }
    mv[out + e] = kMass ? vscale(inv_y, acc_mix) : acc_mix;
    dv[out + e] = vbias(acc_beta, self, local_steps, has_nbrs);
  }
}

// pub: the published snapshots (kSnap), else nullptr.
template <bool kMass, bool kSnap = false>
int launch_gather(const float* x, int64_t num_peers, int64_t n, int64_t row0, int64_t rows,
                  const float* self_w, const int32_t* nbr_idx, const float* nbr_w,
                  const float* beta, int64_t d_slots, float local_steps, const float* mass,
                  float* mixed, float* d_out, float* new_mass, void* stream,
                  const float* pub = nullptr) {
  if (num_peers <= 0 || n <= 0 || rows <= 0) return static_cast<int>(cudaSuccess);
  if (row0 < 0 || row0 + rows > num_peers) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(d_slots) * 3 * sizeof(float);
  const bool vec4 = n % 4 == 0 && aligned16(x) && aligned16(mixed) && aligned16(d_out) &&
                    (!kSnap || aligned16(pub));
  const int64_t n_vec = vec4 ? n / 4 : n;
  int64_t tiles = (n_vec + kThreads - 1) / kThreads;
  if (kMass) tiles = mass_mode_tiles(tiles, d_slots);
  if (tiles > kMaxGridY) tiles = kMaxGridY;
  const dim3 grid(static_cast<unsigned>(rows), static_cast<unsigned>(tiles));
  if (vec4) {
    consensus_mix_kernel<float4, kMass, kSnap><<<grid, kThreads, smem, s>>>(
        x, n_vec, self_w, nbr_idx, nbr_w, beta, static_cast<int>(d_slots), local_steps, mass,
        mixed, d_out, new_mass, pub, row0);
  } else {
    consensus_mix_kernel<float, kMass, kSnap><<<grid, kThreads, smem, s>>>(
        x, n_vec, self_w, nbr_idx, nbr_w, beta, static_cast<int>(d_slots), local_steps, mass,
        mixed, d_out, new_mass, pub, row0);
  }
  return static_cast<int>(cudaGetLastError());
}

// V bf16 values from p, widened to float32: 16 bytes at once where V is 8.
template <int V>
__device__ __forceinline__ void load_bf16(const __nv_bfloat16* __restrict__ p, float (&out)[V]) {
  if constexpr (V == 8) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) out[i] = __bfloat162float(p[i]);
  }
}

// V float32 values rounded to bf16 into p: 16 bytes at once where V is 8.
template <int V>
__device__ __forceinline__ void store_bf16(__nv_bfloat16* __restrict__ p, const float (&v)[V]) {
  if constexpr (V == 8) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 b = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&b);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = __float2bfloat16_rn(v[i]);
  }
}

// The gather design's bf16 storage mode: V elements a thread (8 on the
// vector path, 1 on the scalar path), float32 sums, bf16 stores.  kMass and
// kSnap as in consensus_mix_kernel (the published rows P bf16 too).
template <int V, bool kMass = false, bool kSnap = false>
__global__ void __launch_bounds__(kThreads)
consensus_mix_bf16_kernel(const __nv_bfloat16* __restrict__ x, int64_t n,
                          const float* __restrict__ self_w, const int32_t* __restrict__ nbr_idx,
                          const float* __restrict__ nbr_w, const float* __restrict__ beta,
                          int d_slots, float local_steps, __nv_bfloat16* __restrict__ mixed,
                          __nv_bfloat16* __restrict__ d_out, const float* __restrict__ mass,
                          float* __restrict__ new_mass, const __nv_bfloat16* __restrict__ pub,
                          int64_t row0) {
  extern __shared__ float smem[];  // [D] nbr_w (x sender mass) | [D] beta | [D] nbr_idx
  float* s_w = smem;
  float* s_b = smem + d_slots;
  int32_t* s_idx = reinterpret_cast<int32_t*>(smem + 2 * d_slots);
  __shared__ int s_has_nbrs;
  __shared__ float s_mass[2];  // kMass: self_w[k] y[k] and 1 / y'[k]

  // block x computes peer row0 + x into output row x
  const int k = static_cast<int>(row0) + blockIdx.x;
  const int64_t slot_row = static_cast<int64_t>(k) * d_slots;
  for (int s = threadIdx.x; s < d_slots; s += blockDim.x) {
    const int32_t j = nbr_idx[slot_row + s];
    s_w[s] = kMass ? nbr_w[slot_row + s] * mass[j] : nbr_w[slot_row + s];
    s_b[s] = beta[slot_row + s];
    s_idx[s] = j;
  }
  __syncthreads();
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
      if (blockIdx.y == 0) new_mass[blockIdx.x] = y;
    }
  }
  __syncthreads();
  const bool has_nbrs = s_has_nbrs != 0;
  const float sw = kMass ? s_mass[0] : self_w[k];
  const __nv_bfloat16* src = kSnap ? pub : x;  // the neighbor rows

  const int64_t n_vec = n / V;
  const int64_t own = static_cast<int64_t>(k) * n;
  const int64_t out = static_cast<int64_t>(blockIdx.x) * n;
  const int64_t stride = static_cast<int64_t>(gridDim.y) * blockDim.x;
  for (int64_t e = static_cast<int64_t>(blockIdx.y) * blockDim.x + threadIdx.x; e < n_vec;
       e += stride) {
    float self[V], acc_mix[V], acc_beta[V];
    load_bf16<V>(x + own + e * V, self);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      acc_mix[i] = sw * self[i];
      acc_beta[i] = 0.0f;
    }
#pragma unroll 4
    for (int s = 0; s < d_slots; ++s) {
      float v[V];
      load_bf16<V>(src + static_cast<int64_t>(s_idx[s]) * n + e * V, v);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        acc_mix[i] = fmaf(s_w[s], v[i], acc_mix[i]);
        acc_beta[i] = fmaf(s_b[s], v[i], acc_beta[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < V; ++i) {
      if (kMass) acc_mix[i] *= s_mass[1];
      acc_beta[i] = vbias(acc_beta[i], self[i], local_steps, has_nbrs);
    }
    store_bf16<V>(mixed + out + e * V, acc_mix);
    store_bf16<V>(d_out + out + e * V, acc_beta);
  }
}

template <bool kMass = false, bool kSnap = false>
int launch_gather_bf16(const __nv_bfloat16* x, int64_t num_peers, int64_t n, int64_t row0,
                       int64_t rows, const float* self_w, const int32_t* nbr_idx,
                       const float* nbr_w, const float* beta, int64_t d_slots,
                       float local_steps, __nv_bfloat16* mixed, __nv_bfloat16* d_out,
                       void* stream, const float* mass = nullptr, float* new_mass = nullptr,
                       const __nv_bfloat16* pub = nullptr) {
  if (num_peers <= 0 || n <= 0 || rows <= 0) return static_cast<int>(cudaSuccess);
  if (row0 < 0 || row0 + rows > num_peers) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(d_slots) * 3 * sizeof(float);
  const bool vec8 = n % 8 == 0 && aligned16(x) && aligned16(mixed) && aligned16(d_out) &&
                    (!kSnap || aligned16(pub));
  const int64_t n_vec = vec8 ? n / 8 : n;
  int64_t tiles = (n_vec + kThreads - 1) / kThreads;
  if (kMass) tiles = mass_mode_tiles(tiles, d_slots);
  if (tiles > kMaxGridY) tiles = kMaxGridY;
  const dim3 grid(static_cast<unsigned>(rows), static_cast<unsigned>(tiles));
  if (vec8) {
    consensus_mix_bf16_kernel<8, kMass, kSnap><<<grid, kThreads, smem, s>>>(
        x, n, self_w, nbr_idx, nbr_w, beta, static_cast<int>(d_slots), local_steps, mixed, d_out,
        mass, new_mass, pub, row0);
  } else {
    consensus_mix_bf16_kernel<1, kMass, kSnap><<<grid, kThreads, smem, s>>>(
        x, n, self_w, nbr_idx, nbr_w, beta, static_cast<int>(d_slots), local_steps, mixed, d_out,
        mass, new_mass, pub, row0);
  }
  return static_cast<int>(cudaGetLastError());
}

// The column tile's bf16 storage mode: the tile widens x (kSnap: P) as it
// stages it; the vector path needs rows of a multiple of 8 elements.
template <bool kMass = false, bool kSnap = false>
int launch_column_tile_bf16(const __nv_bfloat16* x, int64_t num_peers, int64_t n, int64_t row0,
                            int64_t rows, const float* self_w, const int32_t* nbr_idx,
                            const float* nbr_w, const float* beta, int64_t d_slots,
                            float local_steps, __nv_bfloat16* mixed, __nv_bfloat16* d_out,
                            void* stream, const float* mass = nullptr, float* new_mass = nullptr,
                            const __nv_bfloat16* pub = nullptr) {
  if (num_peers <= 0 || n <= 0 || rows <= 0) return static_cast<int>(cudaSuccess);
  if (num_peers > kTileMaxPeers || d_slots < 1 || row0 < 0 || row0 + rows > num_peers)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int k = static_cast<int>(num_peers), ds = static_cast<int>(d_slots);
  const int r0 = static_cast<int>(row0), nr = static_cast<int>(rows);
  const LeafStarts leaves = {};
  const size_t smem = tile_smem_bytes(k, false, kMass, nr);
  const __nv_bfloat16* staged = kSnap ? pub : x;
  const bool vec = n % 8 == 0 && aligned16(x) && aligned16(mixed) && aligned16(d_out) &&
                   aligned16(staged);
  const cudaError_t err =
      vec ? launch_tile<true, !kSnap, kMass, kSnap, __nv_bfloat16>(
                false, smem, s, x, staged, nullptr, nullptr, leaves, 1, n, k, self_w, nbr_idx,
                nbr_w, beta, ds, local_steps, mass, mixed, d_out, nullptr, new_mass, r0, nr)
          : launch_tile<false, !kSnap, kMass, kSnap, __nv_bfloat16>(
                false, smem, s, x, staged, nullptr, nullptr, leaves, 1, n, k, self_w, nbr_idx,
                nbr_w, beta, ds, local_steps, mass, mixed, d_out, nullptr, new_mass, r0, nr);
  return static_cast<int>(err);
}

// kSnap: the tile stages pub (the published snapshots) in place of x and
// reads the self term, and d's own term, from x in device memory.
template <bool kMass, bool kSnap = false>
int launch_column_tile(const float* x, int64_t num_peers, int64_t n, int64_t row0, int64_t rows,
                       const float* self_w, const int32_t* nbr_idx, const float* nbr_w,
                       const float* beta, int64_t d_slots, float local_steps, const float* mass,
                       float* mixed, float* d_out, float* new_mass, void* stream,
                       const float* pub = nullptr) {
  if (num_peers <= 0 || n <= 0 || rows <= 0) return static_cast<int>(cudaSuccess);
  if (num_peers > kTileMaxPeers || d_slots < 1 || row0 < 0 || row0 + rows > num_peers)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int k = static_cast<int>(num_peers), ds = static_cast<int>(d_slots);
  const int r0 = static_cast<int>(row0), nr = static_cast<int>(rows);
  const LeafStarts leaves = {};  // no payload: one leaf, unused
  const size_t smem = tile_smem_bytes(k, false, kMass, nr);
  const float* staged = kSnap ? pub : x;
  const bool vec4 = n % 4 == 0 && aligned16(x) && aligned16(mixed) && aligned16(d_out) &&
                    aligned16(staged);
  const cudaError_t err =
      vec4 ? launch_tile<true, !kSnap, kMass, kSnap>(false, smem, s, x, staged, nullptr,
                                                      nullptr, leaves, 1, n, k, self_w, nbr_idx,
                                                      nbr_w, beta, ds, local_steps, mass, mixed,
                                                      d_out, nullptr, new_mass, r0, nr)
           : launch_tile<false, !kSnap, kMass, kSnap>(false, smem, s, x, staged, nullptr,
                                                       nullptr, leaves, 1, n, k, self_w,
                                                       nbr_idx, nbr_w, beta, ds, local_steps,
                                                       mass, mixed, d_out, nullptr, new_mass, r0,
                                                       nr);
  return static_cast<int>(err);
}

}  // namespace

// x: (num_peers, n) row-major float32 on the device; self_w (num_peers,);
// nbr_idx, nbr_w, beta (num_peers, d_slots); mixed, d_out: (rows, n), the
// rows of peers row0 .. row0 + rows - 1 (0 <= row0, row0 + rows <=
// num_peers, else cudaErrorInvalidValue; rows = num_peers from row0 = 0 is
// the full launch; a mass mode's new_mass is (rows,) the same way).  Every nbr_idx
// entry must lie in [0, num_peers) and d_slots * 12 bytes must fit the
// default 48 KB of shared memory; the Python wrapper checks both.  Launches on
// `stream` and returns the launch's cudaError_t (0 on success).
extern "C" int consensus_mix_f32(const float* x, int64_t num_peers, int64_t n,
                                 int64_t row0, int64_t rows,
                                 const float* self_w, const int32_t* nbr_idx,
                                 const float* nbr_w, const float* beta, int64_t d_slots,
                                 float local_steps, float* mixed, float* d_out,
                                 void* stream) {
  return launch_gather<false>(x, num_peers, n, row0, rows, self_w, nbr_idx, nbr_w, beta, d_slots,
                              local_steps, nullptr, mixed, d_out, nullptr, stream);
}

// The column-tile design's entry point: the arguments and their contract are
// consensus_mix_f32's, for num_peers <= kTileMaxPeers (else
// cudaErrorInvalidValue).  Launches a persistent grid on `stream` and
// returns a cudaError_t (0 on success).
extern "C" int consensus_mix_tile_f32(const float* x, int64_t num_peers, int64_t n,
                                      int64_t row0, int64_t rows,
                                      const float* self_w, const int32_t* nbr_idx,
                                      const float* nbr_w, const float* beta, int64_t d_slots,
                                      float local_steps, float* mixed, float* d_out,
                                      void* stream) {
  return launch_column_tile<false>(x, num_peers, n, row0, rows,
                                   self_w, nbr_idx, nbr_w, beta, d_slots,
                                   local_steps, nullptr, mixed, d_out, nullptr, stream);
}

// The mass mode (push-sum) of the two designs: consensus_mix_f32's and
// consensus_mix_tile_f32's arguments and contracts, with mass (num_peers,)
// float32 on the device, every entry positive, and new_mass (num_peers,),
// a buffer other than mass, which receives y'.  x holds the de-biased
// parameters and mixed receives them de-biased again.
extern "C" int consensus_mix_push_sum_f32(const float* x, int64_t num_peers, int64_t n,
                                          int64_t row0, int64_t rows,
                                          const float* self_w, const int32_t* nbr_idx,
                                          const float* nbr_w, const float* beta,
                                          int64_t d_slots, float local_steps, const float* mass,
                                          float* mixed, float* d_out, float* new_mass,
                                          void* stream) {
  return launch_gather<true>(x, num_peers, n, row0, rows, self_w, nbr_idx, nbr_w, beta, d_slots,
                             local_steps, mass, mixed, d_out, new_mass, stream);
}

extern "C" int consensus_mix_push_sum_tile_f32(const float* x, int64_t num_peers, int64_t n,
                                               int64_t row0, int64_t rows,
                                               const float* self_w, const int32_t* nbr_idx,
                                               const float* nbr_w, const float* beta,
                                               int64_t d_slots, float local_steps,
                                               const float* mass, float* mixed, float* d_out,
                                               float* new_mass, void* stream) {
  return launch_column_tile<true>(x, num_peers, n, row0, rows,
                                  self_w, nbr_idx, nbr_w, beta, d_slots,
                                  local_steps, mass, mixed, d_out, new_mass, stream);
}

// The snapshot mode (bounded-staleness consensus) of the four entry points
// above: their arguments and contracts, with published (num_peers, n)
// row-major float32 on the device, the senders' last published snapshots,
// which every neighbor term reads; x, the live parameters, gives the self
// term and d's own term.  The weights are the round's age-decayed ones.
extern "C" int consensus_mix_snapshot_f32(const float* x, const float* published,
                                          int64_t num_peers, int64_t n,
                                          int64_t row0, int64_t rows, const float* self_w,
                                          const int32_t* nbr_idx, const float* nbr_w,
                                          const float* beta, int64_t d_slots,
                                          float local_steps, float* mixed, float* d_out,
                                          void* stream) {
  return launch_gather<false, true>(x, num_peers, n, row0, rows,
                                    self_w, nbr_idx, nbr_w, beta, d_slots,
                                    local_steps, nullptr, mixed, d_out, nullptr, stream,
                                    published);
}

extern "C" int consensus_mix_snapshot_tile_f32(const float* x, const float* published,
                                               int64_t num_peers, int64_t n,
                                               int64_t row0, int64_t rows,
                                               const float* self_w, const int32_t* nbr_idx,
                                               const float* nbr_w, const float* beta,
                                               int64_t d_slots, float local_steps,
                                               float* mixed, float* d_out, void* stream) {
  return launch_column_tile<false, true>(x, num_peers, n, row0, rows, self_w, nbr_idx, nbr_w, beta,
                                         d_slots, local_steps, nullptr, mixed, d_out, nullptr,
                                         stream, published);
}

extern "C" int consensus_mix_push_sum_snapshot_f32(const float* x, const float* published,
                                                   int64_t num_peers, int64_t n,
                                                   int64_t row0, int64_t rows,
                                                   const float* self_w, const int32_t* nbr_idx,
                                                   const float* nbr_w, const float* beta,
                                                   int64_t d_slots, float local_steps,
                                                   const float* mass, float* mixed,
                                                   float* d_out, float* new_mass, void* stream) {
  return launch_gather<true, true>(x, num_peers, n, row0, rows,
                                   self_w, nbr_idx, nbr_w, beta, d_slots,
                                   local_steps, mass, mixed, d_out, new_mass, stream, published);
}

extern "C" int consensus_mix_push_sum_snapshot_tile_f32(
    const float* x, const float* published, int64_t num_peers, int64_t n,
    int64_t row0, int64_t rows, const float* self_w,
    const int32_t* nbr_idx, const float* nbr_w, const float* beta, int64_t d_slots,
    float local_steps, const float* mass, float* mixed, float* d_out, float* new_mass,
    void* stream) {
  return launch_column_tile<true, true>(x, num_peers, n, row0, rows,
                                        self_w, nbr_idx, nbr_w, beta, d_slots,
                                        local_steps, mass, mixed, d_out, new_mass, stream,
                                        published);
}

// The bf16 storage mode (gossip) of the two designs: consensus_mix_f32's and
// consensus_mix_tile_f32's arguments and contracts, with x, mixed and d_out
// (num_peers, n) row-major bf16; the weights stay float32.
extern "C" int consensus_mix_bf16(const __nv_bfloat16* x, int64_t num_peers, int64_t n,
                                  int64_t row0, int64_t rows,
                                  const float* self_w, const int32_t* nbr_idx,
                                  const float* nbr_w, const float* beta, int64_t d_slots,
                                  float local_steps, __nv_bfloat16* mixed,
                                  __nv_bfloat16* d_out, void* stream) {
  return launch_gather_bf16(x, num_peers, n, row0, rows, self_w, nbr_idx, nbr_w, beta, d_slots,
                            local_steps, mixed, d_out, stream);
}

extern "C" int consensus_mix_tile_bf16(const __nv_bfloat16* x, int64_t num_peers, int64_t n,
                                       int64_t row0, int64_t rows,
                                       const float* self_w, const int32_t* nbr_idx,
                                       const float* nbr_w, const float* beta, int64_t d_slots,
                                       float local_steps, __nv_bfloat16* mixed,
                                       __nv_bfloat16* d_out, void* stream) {
  return launch_column_tile_bf16(x, num_peers, n, row0, rows, self_w, nbr_idx, nbr_w, beta, d_slots,
                                 local_steps, mixed, d_out, stream);
}


// The bf16 storage mode of the mass and snapshot modes: the arguments and
// contracts of the float32 entry points of the same names, with x,
// published, mixed and d_out (num_peers, n) row-major bf16; the weights, the
// mass and new_mass stay float32.
extern "C" int consensus_mix_push_sum_bf16(const __nv_bfloat16* x, int64_t num_peers,
                                           int64_t n,
                                           int64_t row0, int64_t rows, const float* self_w,
                                           const int32_t* nbr_idx, const float* nbr_w,
                                           const float* beta, int64_t d_slots,
                                           float local_steps, const float* mass,
                                           __nv_bfloat16* mixed, __nv_bfloat16* d_out,
                                           float* new_mass, void* stream) {
  return launch_gather_bf16<true>(x, num_peers, n, row0, rows,
                                  self_w, nbr_idx, nbr_w, beta, d_slots,
                                  local_steps, mixed, d_out, stream, mass, new_mass);
}

extern "C" int consensus_mix_push_sum_tile_bf16(const __nv_bfloat16* x, int64_t num_peers,
                                                int64_t n,
                                                int64_t row0, int64_t rows, const float* self_w,
                                                const int32_t* nbr_idx, const float* nbr_w,
                                                const float* beta, int64_t d_slots,
                                                float local_steps, const float* mass,
                                                __nv_bfloat16* mixed, __nv_bfloat16* d_out,
                                                float* new_mass, void* stream) {
  return launch_column_tile_bf16<true>(x, num_peers, n, row0, rows,
                                       self_w, nbr_idx, nbr_w, beta, d_slots,
                                       local_steps, mixed, d_out, stream, mass, new_mass);
}

extern "C" int consensus_mix_snapshot_bf16(const __nv_bfloat16* x,
                                           const __nv_bfloat16* published, int64_t num_peers,
                                           int64_t n,
                                           int64_t row0, int64_t rows, const float* self_w,
                                           const int32_t* nbr_idx, const float* nbr_w,
                                           const float* beta, int64_t d_slots,
                                           float local_steps, __nv_bfloat16* mixed,
                                           __nv_bfloat16* d_out, void* stream) {
  return launch_gather_bf16<false, true>(x, num_peers, n, row0, rows,
                                         self_w, nbr_idx, nbr_w, beta, d_slots,
                                         local_steps, mixed, d_out, stream, nullptr, nullptr,
                                         published);
}

extern "C" int consensus_mix_snapshot_tile_bf16(const __nv_bfloat16* x,
                                                const __nv_bfloat16* published,
                                                int64_t num_peers, int64_t n,
                                                int64_t row0, int64_t rows,
                                                const float* self_w, const int32_t* nbr_idx,
                                                const float* nbr_w, const float* beta,
                                                int64_t d_slots, float local_steps,
                                                __nv_bfloat16* mixed, __nv_bfloat16* d_out,
                                                void* stream) {
  return launch_column_tile_bf16<false, true>(x, num_peers, n, row0, rows,
                                              self_w, nbr_idx, nbr_w, beta,
                                              d_slots, local_steps, mixed, d_out, stream,
                                              nullptr, nullptr, published);
}

extern "C" int consensus_mix_push_sum_snapshot_bf16(
    const __nv_bfloat16* x, const __nv_bfloat16* published, int64_t num_peers, int64_t n,
    int64_t row0, int64_t rows,
    const float* self_w, const int32_t* nbr_idx, const float* nbr_w, const float* beta,
    int64_t d_slots, float local_steps, const float* mass, __nv_bfloat16* mixed,
    __nv_bfloat16* d_out, float* new_mass, void* stream) {
  return launch_gather_bf16<true, true>(x, num_peers, n, row0, rows,
                                        self_w, nbr_idx, nbr_w, beta, d_slots,
                                        local_steps, mixed, d_out, stream, mass, new_mass,
                                        published);
}

extern "C" int consensus_mix_push_sum_snapshot_tile_bf16(
    const __nv_bfloat16* x, const __nv_bfloat16* published, int64_t num_peers, int64_t n,
    int64_t row0, int64_t rows,
    const float* self_w, const int32_t* nbr_idx, const float* nbr_w, const float* beta,
    int64_t d_slots, float local_steps, const float* mass, __nv_bfloat16* mixed,
    __nv_bfloat16* d_out, float* new_mass, void* stream) {
  return launch_column_tile_bf16<true, true>(x, num_peers, n, row0, rows,
                                             self_w, nbr_idx, nbr_w, beta,
                                             d_slots, local_steps, mixed, d_out, stream, mass,
                                             new_mass, published);
}

// Present from the row range on: the entry points above take (row0, rows)
// after n (tools/kernel_ab.py reads it to call libraries of either form).
extern "C" int consensus_mix_row_range_abi() { return 1; }
