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
// The round is chosen by offsetting the operand pointers on the host: no
// round's operands are sliced or copied.  Outputs go to buffers other than
// x: other blocks still read x[k] as a neighbor.  Padding slots carry the
// peer's own index with weight 0 and add exactly +-0.0 to both sums.  Every
// row and byte offset is int64: at K = 4096 and N = 199,212 one buffer holds
// 8.2e8 floats.
//
// Two routes, chosen here by (K, D) alone (`route`; the Python wrapper's
// `segment.kernel_route` is the same rule):
//
// - the column tile (route 1) for kTileMinPeers <= K <= kTileMaxPeers and
//   K / kTileMinDensity <= D <= kTileMaxSlots: the code of tile_mix.cuh,
//   shared with consensus_mix.cu and dequant_mix.cu, on the round's operand
//   pointers.  A persistent grid reads each sender's column tile from device
//   memory once, scatters the D slots into a dense [W_off; Beta]^T table in
//   shared memory (a padding slot, also past K, adds +0.0 there), keeps the
//   raw beta sums for the guard and in the mass mode reduces y' from the raw
//   slots.  The old one-block-a-peer design re-read each sender's tile from
//   L1/L2 once per receiver (99 times at K = 100, 7.9 GB of cache reads a
//   call); the tile is bound by the float32 FMAs of the dense product, as
//   consensus_mix's is.  It sums over senders in index order, the gather in
//   slot order, so the two differ in the last bits.  The edges are measured
//   (PERF.md section 6, the segment_mix edge table: both routes' times at
//   each of chip_smoke.py's SEGMENT_EDGE_SHAPES, from copies of this tree with
//   kTileMinPeers and kTileMinDensity edited so that each case takes the
//   other route): on complete graphs the gather wins at K = 8 and 12 and
//   the tile from K = 16, as consensus_mix's rule has it; the dense product costs K^2 N however sparse the rows, the
//   gather (D + 1) K N, so sparse rows keep the gather (a ring of 64 runs
//   it in about half the tile's time), and the rule puts the crossing at
//   D = K / 3, between the Erdos-Renyi shapes on either side.
//   kTileMaxSlots bounds the table scatter's K x D (an int) and its cost
//   per block.
// - the persistent gather (route 0) everywhere else: K > 128 (the large-K
//   runtime, e.g. K = 4096 on a ring), K below the edge, sparse rows, any
//   degree bound D.  As many blocks as fit on the SMs walk items.  A block's
//   threads form groups of `lanes` threads, as many as a row's width needs
//   (kThreads at the 2NN's row, 64 at N = 256, so narrow rows still fill the
//   block); an item is a run of consecutive peers, up to kRunPeers a group,
//   over a span of `lanes` elements (4 KB of a row on the vector path at
//   kThreads).  The item's slot rows are staged in shared memory, and the
//   beta-sum guard and y' reduced by one warp a peer, once per item rather
//   than once per 4 KB as in the old (K, tiles) grid of one-shot blocks,
//   whose two dependent round trips to device memory came before each
//   block's first load of x: runs of one peer are 8-20% slower at the
//   K = 4096 ring (the same A/B).  Each thread starts the mix from self_w * x_k and
//   adds the slots in slot order, the old design's arithmetic, so its
//   outputs are the old ones bit for bit; the slot loop is unrolled by two.
//   Items go run-fastest, so the blocks in flight cover neighboring peers at
//   the same columns and a ring's shared rows come from L1 and L2 (staging
//   the union of a run's sender rows in shared memory was not built); the
//   outputs are stored with the evict-first hint (st.global.cs).  Past
//   kChunk / groups slots a peer, a group walks one peer at a time and its
//   slots are staged in chunks (complete_k2048: D = 2,047).
// Both routes take float4 loads and stores when N is a multiple of 4 and x,
// mixed and d are 16-byte aligned (the port pads each parameter row to a
// multiple of 4), scalar ones otherwise; columns past N are neither read nor
// written.  Neither allocates or synchronizes, so both are captured into the
// scan driver's CUDA graph of the round (repro_torch/capture.py).
//
// Mass mode (push-sum, `segment_mix_push_sum_f32`; the template switch
// kMass): the round's weights are column-stochastic push weights and every
// peer carries a scalar mass y, (K,) and the same for every round:
//
//   y'[k]    = self_w[r, k] y[k] + sum_s nbr_w[r, k, s] y[nbr_idx[r, k, s]]
//   mixed[k] = (self_w[r, k] y[k] x[k] + sum_s nbr_w[r, k, s] y[j] x[j]) / y'[k]
//   d[k]     = as in gossip (raw x, beta not scaled)
//
// y' is reduced from the raw slot row, as the guard is, so any degree bound
// works; the division is a multiply by the correctly rounded 1 / y' (see
// consensus_mix.cu).  y' is written to new_mass once a peer: by the tile's
// block 0, by the gather's item of the peer's run at span 0.
//
// Slot form (`segment_mix_slots_f32` and `segment_mix_slots_push_sum_f32`,
// the hierarchical runtime's "segment" mix in a process that holds a block
// of p peers; the template switch kSlots): the process has its (p, N) block
// and its peers' (p, D, N) neighbor rows gathered around the ring of
// processes, not the (K, N) buffer, so slot s of peer k is read from row
// k x D + s of the slot buffer rather than from row nbr_idx[k, s] of x, and
// in the mass mode the sender's mass from a (p, D) table gathered the same
// way.  The operands are the block's (p,) and (p, D) rows of one round.  It
// takes the gather route (the column tile reads senders' columns of x) with
// that route's arithmetic, so its rows equal the one-process call's gather
// rows bit for bit.  float32 only.  It must read (D + 1) p N floats and
// write 2 p N: at K = 4096 on a ring over 8 processes (p = 512, D = 2) one
// call moves 2.04 GB, 0.61 ms at 3.35 TB/s.
//
// bf16 storage mode (`segment_mix_bf16` and `segment_mix_push_sum_bf16`, on
// both routes; the storage type TS): x, mixed and d are bf16 in device
// memory, each value widened to float32 as it is read, every sum float32,
// mixed and d rounded to bf16 as they are stored; the weights, the mass and
// y' stay float32.  The column tile is tile_mix.cuh's bf16 tile (its vector
// path at rows of a multiple of 8 elements), the gather reads 4 bf16 (8
// bytes) where the float32 one reads a float4 and stores them with the same
// evict-first hint.
//
// Bound on an H100 SXM: at the large-K shape (K = 4096 on a ring, D = 2,
// N = 199,212) one call must read x once (3.26 GB) and write mixed and d
// (6.53 GB): 9.8 GB, 2.9 ms at 3.35 TB/s, against 9.0 GFLOP (0.13 ms at
// 67 TFLOP/s): it is bound by bytes (the slots alone would read
// (D + 1) K N floats, 9.8 GB of reads, without the L2's reuse).  At K = 100
// on the complete graph (D = 99) it is bound by float32 FMA throughput:
// 7.9 GFLOP, 0.119 ms, against 0.072 ms of bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
constexpr int kTileMaxPeers = 128;
}  // namespace

#include "tile_mix.cuh"

namespace {

constexpr int kTileMinPeers = 16;
constexpr int kTileMinDensity = 3;  // the tile from D >= K / 3 slots
constexpr int kTileMaxSlots = 4096;
constexpr int kRouteGather = 0, kRouteTile = 1;
constexpr int kRunPeers = 8;  // most consecutive peers a group walks in one item
constexpr int kChunk = 1024;  // slots staged at a time: 3 x 4 KB of shared memory
constexpr int kWarps = kThreads / 32;
constexpr int kItemPeers = kRunPeers * kWarps;  // most peers an item: groups x run

int route(int64_t num_peers, int64_t d_slots) {
  return num_peers >= kTileMinPeers && num_peers <= kTileMaxPeers &&
                 kTileMinDensity * d_slots >= num_peers && d_slots <= kTileMaxSlots
             ? kRouteTile
             : kRouteGather;
}

// Slot `from` of the round's slot table to slot `to` of the staged rows;
// kMass: its weight scaled by its sender's mass.  The staged index is the
// row the slot reads: the sender's row of x, or (kSlots) the slot's own row
// `from` of the gathered slot buffer, whose sender masses are slot_mass.
template <bool kMass, bool kSlots>
__device__ __forceinline__ void stage_slot(const int32_t* __restrict__ nbr_idx,
                                           const float* __restrict__ nbr_w,
                                           const float* __restrict__ beta,
                                           const float* __restrict__ mass,
                                           const float* __restrict__ slot_mass, int64_t from,
                                           int to, int32_t* s_idx, float* s_w, float* s_b) {
  const int32_t j = kSlots ? static_cast<int32_t>(from) : nbr_idx[from];
  s_idx[to] = j;
  s_w[to] = kMass ? nbr_w[from] * (kSlots ? slot_mass[from] : mass[j]) : nbr_w[from];
  s_b[to] = beta[from];
}

// Element i of a row seen as T (float or float4) of the storage type TS,
// through the read-only cache, as float32; and the evict-first store back.
template <typename T, typename TS>
__device__ __forceinline__ T load_nc(const TS* __restrict__ p, int64_t i) {
  if constexpr (std::is_same<TS, float>::value) {
    return __ldg(reinterpret_cast<const T*>(p) + i);
  } else if constexpr (std::is_same<T, float>::value) {
    return __bfloat162float(p[i]);
  } else {
    return bf16x4_to_float4(__ldg(reinterpret_cast<const uint2*>(p) + i));
  }
}
template <typename T, typename TS>
__device__ __forceinline__ void store_cs(TS* __restrict__ p, int64_t i, T v) {
  if constexpr (std::is_same<TS, float>::value) {
    __stcs(reinterpret_cast<T*>(p) + i, v);
  } else if constexpr (std::is_same<T, float>::value) {
    p[i] = __float2bfloat16_rn(v);
  } else {
    __stcs(reinterpret_cast<uint2*>(p) + i, float4_to_bf16x4(v));
  }
}

// Adds `count` staged slots to the accumulators of element e, in slot
// order; unrolled by two, so two slots' 16-byte loads are in flight.
template <typename T, typename TS>
__device__ __forceinline__ void add_slots(const TS* __restrict__ x, int64_t n_vec, int64_t e,
                                          const int32_t* s_idx, const float* s_w,
                                          const float* s_b, int count, T& acc_mix, T& acc_beta) {
#pragma unroll 2
  for (int s = 0; s < count; ++s) {
    const T v = load_nc<T>(x, static_cast<int64_t>(s_idx[s]) * n_vec + e);
    acc_mix = vfma(s_w[s], v, acc_mix);
    acc_beta = vfma(s_b[s], v, acc_beta);
  }
}

// T is float (scalar path) or float4 (vector path); n_vec counts T elements
// per row, and rows are n_vec T elements apart.  The slots read the rows of
// `rows`: x itself, or (kSlots, the slot form) a (K, D, N) buffer whose row
// k x D + s is peer k's slot s, with slot_mass (K, D) the senders' masses.  The operand pointers point
// at the round's (K,) and (K, D) slices; mass and new_mass are (K,), used in
// the mass mode only.  The block's threads form kThreads / lanes groups of
// `lanes` threads.  Item i covers groups x run consecutive peers from
// (i % n_runs) x groups x run over the span i / n_runs of `lanes` T
// elements; group g walks the run of peers g x run, ..., g x run + run - 1 of
// the item in turn.  chunk >= d_slots: every slot row of the item is staged
// at its start; else each group's peer is staged chunk slots at a time.
template <typename T, bool kMass, typename TS = float, bool kSlots = false>
__global__ void __launch_bounds__(kThreads)
segment_gather_kernel(const TS* __restrict__ x, const TS* __restrict__ rows,
                      const float* __restrict__ slot_mass, int64_t n_vec, int k_peers,
                      const float* __restrict__ self_w, const int32_t* __restrict__ nbr_idx,
                      const float* __restrict__ nbr_w, const float* __restrict__ beta,
                      int d_slots, float local_steps, const float* __restrict__ mass,
                      TS* __restrict__ mixed, TS* __restrict__ d_out,
                      float* __restrict__ new_mass, int lanes, int run, int chunk,
                      int64_t n_runs, int64_t n_items) {
  __shared__ int32_t s_idx[kChunk];
  __shared__ float s_w[kChunk];
  __shared__ float s_b[kChunk];
  __shared__ float s_sw[kItemPeers];     // self_w (x own mass in the mass mode)
  __shared__ float s_inv_y[kItemPeers];  // kMass: 1 / y'
  __shared__ int s_has[kItemPeers];      // the raw beta row sums to more than 0

  const int groups = kThreads / lanes, g = threadIdx.x / lanes, t = threadIdx.x % lanes;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool staged_once = chunk >= d_slots;
  // the loop bounds are the same for every thread of the block, so every
  // barrier below is reached by all of them
  for (int64_t item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int64_t span = item / n_runs;
    const int64_t k0 = (item - span * n_runs) * groups * run;
    const int np = k_peers - k0 < groups * run ? static_cast<int>(k_peers - k0) : groups * run;
    __syncthreads();  // every thread is done with the previous item's rows
    if (staged_once) {
      for (int s = threadIdx.x; s < np * d_slots; s += kThreads)
        stage_slot<kMass, kSlots>(nbr_idx, nbr_w, beta, mass, slot_mass, k0 * d_slots + s, s,
                                  s_idx, s_w, s_b);
    }
    for (int p = warp; p < np; p += kWarps) {  // the guard and y' from the raw slot row
      const int64_t k = k0 + p, row = k * d_slots;
      float sum = 0.0f, ysum = 0.0f;
      for (int s = lane; s < d_slots; s += 32) {
        sum += beta[row + s];
        if (kMass)
          ysum += __fmul_rn(nbr_w[row + s], kSlots ? slot_mass[row + s] : mass[nbr_idx[row + s]]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
        if (kMass) ysum += __shfl_xor_sync(0xffffffffu, ysum, off);
      }
      if (lane == 0) {
        s_has[p] = sum > 0.0f;
        const float sw = kMass ? self_w[k] * mass[k] : self_w[k];
        s_sw[p] = sw;
        if (kMass) {
          const float y = sw + ysum;
          s_inv_y[p] = 1.0f / y;
          if (span == 0) new_mass[k] = y;  // one writer a peer
        }
      }
    }
    __syncthreads();
    const int64_t e = span * lanes + t;
    for (int i = 0; i < run; ++i) {
      const int p = g * run + i;
      const bool live = p < np && e < n_vec;
      const int64_t own = (k0 + p) * n_vec;
      T self, acc_mix, acc_beta;
      vzero(self);
      vzero(acc_beta);
      if (live) self = load_nc<T>(x, own + e);
      acc_mix = vscale(live ? s_sw[p] : 0.0f, self);
      if (staged_once) {
        if (live) {
          const int at = p * d_slots;
          add_slots<T>(rows, n_vec, e, s_idx + at, s_w + at, s_b + at, d_slots, acc_mix,
                       acc_beta);
        }
      } else {
        for (int c0 = 0; c0 < d_slots; c0 += chunk) {
          const int cn = min(chunk, d_slots - c0);
          __syncthreads();  // every thread is done with the previous chunk
          for (int q = threadIdx.x; q < groups * cn; q += kThreads) {
            const int gg = q / cn, s = q - gg * cn, pp = gg * run + i;
            if (pp < np)
              stage_slot<kMass, kSlots>(nbr_idx, nbr_w, beta, mass, slot_mass,
                                        (k0 + pp) * d_slots + c0 + s, gg * chunk + s, s_idx,
                                        s_w, s_b);
          }
          __syncthreads();
          if (live)
            add_slots<T>(rows, n_vec, e, s_idx + g * chunk, s_w + g * chunk, s_b + g * chunk,
                         cn, acc_mix, acc_beta);
        }
      }
      if (!live) continue;
      const bool has = s_has[p] != 0;
      store_cs(mixed, own + e, kMass ? vscale(s_inv_y[p], acc_mix) : acc_mix);
      store_cs(d_out, own + e, vbias(acc_beta, self, local_steps, has));
    }
  }
}

// The persistent grid: as many blocks as fit on the SMs (asked once per
// device and instantiation, as launch_tile does), at most one an item.  A
// group is as many threads as a row's n_vec needs, a power of two from 32
// to kThreads.  A run is as many peers a group as kChunk staged
// slots hold, at most kRunPeers, halved while that leaves fewer than two
// items a block; past kChunk / groups slots a peer, its slots are staged
// in chunks of that many, one peer a group.
template <typename T, bool kMass, typename TS, bool kSlots = false>
cudaError_t launch_gather(cudaStream_t s, const TS* x, int64_t num_peers, int64_t n_vec,
                          const float* self_w, const int32_t* nbr_idx, const float* nbr_w,
                          const float* beta, int64_t d_slots, float local_steps,
                          const float* mass, TS* mixed, TS* d_out, float* new_mass,
                          const TS* slots = nullptr, const float* slot_mass = nullptr) {
  auto kernel = segment_gather_kernel<T, kMass, TS, kSlots>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  static int sms[kMaxDevices] = {}, fit[kMaxDevices] = {};
  if (fit[dev] == 0) {
    if ((err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev)) !=
        cudaSuccess)
      return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit[dev], kernel, kThreads, 0)) !=
        cudaSuccess)
      return err;
    if (fit[dev] < 1) return cudaErrorInvalidConfiguration;
  }
  const int64_t blocks = static_cast<int64_t>(sms[dev]) * fit[dev];
  int lanes = 32;
  while (lanes < kThreads && lanes < n_vec) lanes *= 2;
  const int64_t groups = kThreads / lanes;
  const int64_t n_spans = (n_vec + lanes - 1) / lanes;
  const bool staged_once = groups * d_slots <= kChunk;
  int64_t run = staged_once ? kChunk / (groups * d_slots) : 1;
  if (run > kRunPeers) run = kRunPeers;
  auto runs = [&](int64_t r) { return (num_peers + groups * r - 1) / (groups * r); };
  while (run > 1 && runs(run) * n_spans < 2 * blocks) run = (run + 1) / 2;
  const int64_t n_runs = runs(run), n_items = n_runs * n_spans;
  const int chunk = staged_once ? static_cast<int>(d_slots) : static_cast<int>(kChunk / groups);
  const int grid = static_cast<int>(blocks < n_items ? blocks : n_items);
  kernel<<<grid, kThreads, 0, s>>>(x, kSlots ? slots : x, slot_mass, n_vec,
                                   static_cast<int>(num_peers), self_w, nbr_idx,
                                   nbr_w, beta, static_cast<int>(d_slots), local_steps, mass,
                                   mixed, d_out, new_mass, lanes, static_cast<int>(run), chunk,
                                   n_runs, n_items);
  return cudaGetLastError();
}

template <bool kMass, typename TS = float>
int launch_segment(const TS* x, int64_t num_peers, int64_t n,
                   const float* self_w, const int32_t* nbr_idx, const float* nbr_w,
                   const float* beta, int64_t rounds, int64_t round_idx, int64_t d_slots,
                   float local_steps, const float* mass, TS* mixed, TS* d_out,
                   float* new_mass, void* stream) {
  if (num_peers <= 0 || n <= 0) return static_cast<int>(cudaSuccess);
  if (rounds <= 0 || d_slots <= 0 || d_slots > INT32_MAX || num_peers > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t r = (round_idx % rounds + rounds) % rounds;
  const int64_t peer_off = r * num_peers;
  const int64_t slot_off = peer_off * d_slots;
  self_w += peer_off;
  nbr_idx += slot_off;
  nbr_w += slot_off;
  beta += slot_off;
  const bool vec4 = n % 4 == 0 && aligned16(x) && aligned16(mixed) && aligned16(d_out);
  // the bf16 tile's vector path wants rows of a multiple of 8 (as consensus_mix's)
  const bool tile_vec = vec4 && (std::is_same<TS, float>::value || n % 8 == 0);
  cudaError_t err;
  if (route(num_peers, d_slots) == kRouteTile) {
    const int k = static_cast<int>(num_peers), ds = static_cast<int>(d_slots);
    const LeafStarts leaves = {};  // no payload: one leaf, unused
    const size_t smem = tile_smem_bytes(k, false, kMass);
    // x is the staged tile (kSelfStaged): the self term is read from it
    err = tile_vec ? launch_tile<true, true, kMass, false, TS>(
                         false, smem, s, x, x, nullptr, nullptr, leaves, 1, n, k, self_w,
                         nbr_idx, nbr_w, beta, ds, local_steps, mass, mixed, d_out, nullptr,
                         new_mass)
                   : launch_tile<false, true, kMass, false, TS>(
                         false, smem, s, x, x, nullptr, nullptr, leaves, 1, n, k, self_w,
                         nbr_idx, nbr_w, beta, ds, local_steps, mass, mixed, d_out, nullptr,
                         new_mass);
  } else {
    err = vec4 ? launch_gather<float4, kMass, TS>(s, x, num_peers, n / 4, self_w, nbr_idx,
                                                  nbr_w, beta, d_slots, local_steps, mass, mixed,
                                                  d_out, new_mass)
               : launch_gather<float, kMass, TS>(s, x, num_peers, n, self_w, nbr_idx, nbr_w,
                                                 beta, d_slots, local_steps, mass, mixed, d_out,
                                                 new_mass);
  }
  return static_cast<int>(err);
}

// The slot form: the gather route on a (K, D, N) slot buffer (see
// segment_mix_slots_f32).  The column tile reads each sender's column of x,
// which a process holding only its own block and its gathered slots does
// not have, so the slot form takes the gather route at every shape.
template <bool kMass>
int launch_slots(const float* x, const float* slots, int64_t num_peers, int64_t n,
                 const float* self_w, const float* nbr_w, const float* beta, int64_t d_slots,
                 float local_steps, const float* mass, const float* slot_mass, float* mixed,
                 float* d_out, float* new_mass, void* stream) {
  if (num_peers <= 0 || n <= 0) return static_cast<int>(cudaSuccess);
  // the staged index of a slot is its row of the slot buffer, an int32
  if (d_slots <= 0 || num_peers > INT32_MAX / d_slots) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec4 = n % 4 == 0 && aligned16(x) && aligned16(slots) && aligned16(mixed) &&
                    aligned16(d_out);
  const cudaError_t err =
      vec4 ? launch_gather<float4, kMass, float, true>(s, x, num_peers, n / 4, self_w, nullptr,
                                                       nbr_w, beta, d_slots, local_steps, mass,
                                                       mixed, d_out, new_mass, slots, slot_mass)
           : launch_gather<float, kMass, float, true>(s, x, num_peers, n, self_w, nullptr, nbr_w,
                                                      beta, d_slots, local_steps, mass, mixed,
                                                      d_out, new_mass, slots, slot_mass);
  return static_cast<int>(err);
}

}  // namespace

// The route a call of num_peers peers and d_slots slots takes: 1 the column
// tile, 0 the persistent gather.
extern "C" int64_t segment_mix_route(int64_t num_peers, int64_t d_slots) {
  return route(num_peers, d_slots);
}

// x, mixed, d_out: (num_peers, n) row-major float32 on the device; self_w
// (rounds, num_peers); nbr_idx, nbr_w, beta (rounds, num_peers, d_slots).
// Mixes with round round_idx % rounds, on the route segment_mix_route
// gives.  Every nbr_idx entry must lie in [0, num_peers); the Python
// wrapper's schedule checked that once.  Launches on `stream` and returns
// the launch's cudaError_t (0 on success).
extern "C" int segment_mix_f32(const float* x, int64_t num_peers, int64_t n,
                               const float* self_w, const int32_t* nbr_idx,
                               const float* nbr_w, const float* beta, int64_t rounds,
                               int64_t round_idx, int64_t d_slots, float local_steps,
                               float* mixed, float* d_out, void* stream) {
  return launch_segment<false>(x, num_peers, n, self_w, nbr_idx, nbr_w, beta, rounds, round_idx,
                               d_slots, local_steps, nullptr, mixed, d_out, nullptr, stream);
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
  return launch_segment<true>(x, num_peers, n, self_w, nbr_idx, nbr_w, beta, rounds, round_idx,
                              d_slots, local_steps, mass, mixed, d_out, new_mass, stream);
}

// The bf16 storage mode of the two entry points above: their arguments and
// contracts, with x, mixed and d_out (num_peers, n) row-major bf16; the
// weights, mass and new_mass stay float32.
extern "C" int segment_mix_bf16(const __nv_bfloat16* x, int64_t num_peers, int64_t n,
                                const float* self_w, const int32_t* nbr_idx,
                                const float* nbr_w, const float* beta, int64_t rounds,
                                int64_t round_idx, int64_t d_slots, float local_steps,
                                __nv_bfloat16* mixed, __nv_bfloat16* d_out, void* stream) {
  return launch_segment<false>(x, num_peers, n, self_w, nbr_idx, nbr_w, beta, rounds, round_idx,
                               d_slots, local_steps, nullptr, mixed, d_out, nullptr, stream);
}

extern "C" int segment_mix_push_sum_bf16(const __nv_bfloat16* x, int64_t num_peers, int64_t n,
                                         const float* self_w, const int32_t* nbr_idx,
                                         const float* nbr_w, const float* beta, int64_t rounds,
                                         int64_t round_idx, int64_t d_slots, float local_steps,
                                         const float* mass, __nv_bfloat16* mixed,
                                         __nv_bfloat16* d_out, float* new_mass, void* stream) {
  return launch_segment<true>(x, num_peers, n, self_w, nbr_idx, nbr_w, beta, rounds, round_idx,
                              d_slots, local_steps, mass, mixed, d_out, new_mass, stream);
}

// The slot form (a process of the hierarchical runtime, holding a block of
// num_peers peers): x (num_peers, n) is the block, slots (num_peers, d_slots,
// n) row-major its peers' gathered neighbor rows, slot s of peer k at row
// k x d_slots + s; self_w (num_peers,), nbr_w and beta (num_peers, d_slots)
// the block's rows of one round's operands, all float32 on the device.
// mixed[k] = self_w[k] x[k] + sum_s nbr_w[k, s] slots[k, s] and d as in
// segment_mix_f32, summed as its gather route sums them (the self term,
// then the slots in slot order), so a row equals that route's row bit for
// bit when its slots hold the rows nbr_idx names.  Launches on `stream`
// and returns the launch's cudaError_t (0 on success).
extern "C" int segment_mix_slots_f32(const float* x, const float* slots, int64_t num_peers,
                                     int64_t n, const float* self_w, const float* nbr_w,
                                     const float* beta, int64_t d_slots, float local_steps,
                                     float* mixed, float* d_out, void* stream) {
  return launch_slots<false>(x, slots, num_peers, n, self_w, nbr_w, beta, d_slots, local_steps,
                             nullptr, nullptr, mixed, d_out, nullptr, stream);
}

// The slot form's mass mode: mass (num_peers,) the block's masses,
// slot_mass (num_peers, d_slots) each slot's sender mass, new_mass
// (num_peers,) receives y'.
extern "C" int segment_mix_slots_push_sum_f32(const float* x, const float* slots,
                                              int64_t num_peers, int64_t n, const float* self_w,
                                              const float* nbr_w, const float* beta,
                                              int64_t d_slots, float local_steps,
                                              const float* mass, const float* slot_mass,
                                              float* mixed, float* d_out, float* new_mass,
                                              void* stream) {
  return launch_slots<true>(x, slots, num_peers, n, self_w, nbr_w, beta, d_slots, local_steps,
                            mass, slot_mass, mixed, d_out, new_mass, stream);
}
