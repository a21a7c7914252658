// The column-tile design of the dense consensus kernels on Hopper (sm_90a),
// shared by consensus_mix.cu and dequant_mix.cu: both compute, for every
// peer k of a (K, N) float32 buffer and the dense (2K x K) operator
// [W_off; Beta] that the padded slot table (nbr_idx, nbr_w, beta) stands for,
//
//   mixed[k] = self_w[k] * x[k] + sum_j W_off[k, j] v_j
//   d[k]     = (sum_j Beta[k, j] v_j - v_k) / T,  0 if the raw beta row sums to 0
//
// with v = est (advanced in place by an int8 payload where there is one:
// v_j = est[j] + scale[j, leaf] * q[j], written once to est').  Four template
// switches choose what a caller needs: kHasQ (a payload to dequantize, est'
// written), kSelfStaged (x is est, so the self term is read from the
// staged tile and not from device memory a second time: consensus_mix),
// kMass (push-sum: each row's y'_k = self_w[k] y_k + sum_s nbr_w[k, s] y_j
// reduced by one warp from the slots first, then every W weight, self_w
// included, scaled by its sender's mass y_j and by its row's 1 / y'_k as
// the table is scattered and self_w loaded, so the mix rows come out
// de-biased with the tile loop and its stores those of gossip; y' written
// to new_mass by block 0.  The Beta rows stay unscaled) and kSnap (the
// snapshot mode of consensus_mix: est is the published snapshot buffer P,
// and d's own term is the live x_k, not v_k, so the threads of the d rows
// load x as those of the mix rows do:
// d[k] = (sum_j Beta[k, j] P_j - x_k) / T).  A fifth, the storage type TS
// (float, or __nv_bfloat16 for the bf16 storage modes of all three kernels),
// names the type of x, est, est', mixed and d in device memory: a bf16 tile
// is widened to float32 as it is staged (plain loads, 8 bytes a 4-column
// chunk on the vector path; q still by cp.async), every sum is float32, and
// mixed and d are rounded to bf16 as they are stored.  A bf16 estimate is
// advanced where the reference rounds it (compression/compressors.py: the
// payload's value D = q * scale formed in float32 and cast to bf16, then
// est + D in bf16): v = bf16(est + bf16(scale * q)), two roundings, where
// the float32 form is one fmaf.
//
// - a block owns a tile of TN columns of ALL K peers; a persistent grid of
//   as many blocks as fit on the SMs walks the tiles.  Every sender's tile is
//   read from device memory once.
// - each block first scatters the slot table into a dense (K x 2K)
//   [W_off; Beta]^T table in shared memory (padding slots carry the row's
//   own index with weight 0 and add +0.0), keeps self_w, and reduces the RAW
//   beta row sums for the no-neighbor guard.
// - a row range (row0, rows): the block computes the mix and d rows of
//   peers row0 .. row0 + rows - 1 only, into (rows, N) outputs, from the
//   tiles of ALL K senders (a process that holds one peer's row computes
//   that row alone).  Each row's arithmetic is the full launch's: the same
//   table column, summed over the senders j = 0 .. K-1 in the same order,
//   so a row range gives the full launch's rows bit for bit.  The tile
//   keeps the full launch's width TN (its stages of K senders fit shared
//   memory) and holds 2 rows rounded up to 8 output rows.
// - two stages of tiles in shared memory, filled by cp.async (16 bytes of
//   est, 4 of q a copy) on the vector path while the previous tile is
//   computed; the scalar path (N or a leaf start not a multiple of 4, or a
//   buffer off alignment) stages with plain loads.
// - the 2K output rows of a tile come from shared memory with register
//   tiling: a thread holds 8 rows x 4 columns, so each step over a sender j
//   reads two float4s of the table and one of v for 32 FMAs.  float32 on the
//   float32 pipes, no TF32.  Columns past N are neither read (zero-filled)
//   nor written.
//
// The including source defines kTileMaxPeers, the most peers whose table
// fits shared memory, before it includes this header.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "vec_ops.cuh"

namespace {

constexpr int kMaxLeaves = 64;

struct LeafStarts {
  int64_t start[kMaxLeaves];  // first column of each leaf; start[0] == 0
};

constexpr int kMaxDevices = 64;
constexpr int kTileThreads = 512;  // most threads a block
constexpr int kTileRows = 8;       // output rows a thread holds
constexpr int kTileCols = 4;       // output columns a thread holds: one float4
constexpr int kTileMaxGroups = 64;  // most column groups a tile: 256 columns

// The tile's shape for K peers: RP = 2K output rows rounded up to 8, RG row
// groups of 8, CG column groups of 4 (each thread one row group and one
// column group), TN = 4 CG columns a tile, and the block's threads, RG x CG
// rounded up to a warp.  Few peers give narrow tiles and small blocks, so
// there are tiles for every SM and several blocks on each (K = 8: TN = 256,
// 128 threads); K = 100: TN = 80, 512 threads; K = 128: TN = 64.  A row
// range of `rows` peers (rows < K) keeps CG and TN of all K and takes RP =
// 2 rows rounded up to 8: fewer threads a block, the same stages.
struct TileShape {
  int rp, rg, cg, tn, threads, block;
};

__host__ __device__ __forceinline__ TileShape tile_shape(int k, int rows = -1) {
  TileShape t;
  const int rg_all = (2 * k + kTileRows - 1) / kTileRows;
  t.rp = (2 * (rows < 0 ? k : rows) + kTileRows - 1) / kTileRows * kTileRows;
  t.rg = t.rp / kTileRows;
  t.cg = min(kTileThreads / rg_all, kTileMaxGroups);
  t.tn = kTileCols * t.cg;
  t.threads = t.rg * t.cg;
  t.block = (t.threads + 31) / 32 * 32;
  return t;
}

// 16 (est) or 4 (q) bytes from global to shared memory without passing
// through registers; `valid` false writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(addr), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four bf16 values (8 bytes) as a float4, and back, rounding to nearest.
__device__ __forceinline__ float4 bf16x4_to_float4(uint2 raw) {
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ uint2 float4_to_bf16x4(float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  return make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                    *reinterpret_cast<const uint32_t*>(&hi));
}
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename TS>
__device__ __forceinline__ TS from_float(float v) {
  if constexpr (std::is_same<TS, float>::value) {
    return v;
  } else {
    return __float2bfloat16_rn(v);
  }
}

// Element i of a row seen as T (float: one element, float4: four) of the
// storage type TS, as float32, and back: a float4 of bf16 is 8 bytes.  The
// gather designs' loads and stores in either storage type; for TS = float
// they are the plain loads and stores of T.
template <typename T, typename TS>
__device__ __forceinline__ T vload(const TS* __restrict__ p, int64_t i) {
  if constexpr (std::is_same<TS, float>::value) {
    return reinterpret_cast<const T*>(p)[i];
  } else if constexpr (std::is_same<T, float>::value) {
    return __bfloat162float(p[i]);
  } else {
    return bf16x4_to_float4(reinterpret_cast<const uint2*>(p)[i]);
  }
}
template <typename T, typename TS>
__device__ __forceinline__ void vstore(TS* __restrict__ p, int64_t i, T v) {
  if constexpr (std::is_same<TS, float>::value) {
    reinterpret_cast<T*>(p)[i] = v;
  } else if constexpr (std::is_same<T, float>::value) {
    p[i] = __float2bfloat16_rn(v);
  } else {
    reinterpret_cast<uint2*>(p)[i] = float4_to_bf16x4(v);
  }
}

// The advance of an estimate by its payload, v = est + scale * q: one fmaf
// in float32 storage; in bf16 storage the reference's two roundings,
// bf16(est + bf16(scale * q)).
__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
template <typename TS>
__device__ __forceinline__ float vadvance(float scale, float q, float est) {
  if constexpr (std::is_same<TS, float>::value) {
    return fmaf(scale, q, est);
  } else {
    return bf16_round(__fadd_rn(est, bf16_round(__fmul_rn(scale, q))));
  }
}
template <typename TS>
__device__ __forceinline__ float4 vadvance(float scale, float4 q, float4 est) {
  return make_float4(vadvance<TS>(scale, q.x, est.x), vadvance<TS>(scale, q.y, est.y),
                     vadvance<TS>(scale, q.z, est.z), vadvance<TS>(scale, q.w, est.w));
}

__device__ __forceinline__ int leaf_of(int64_t col, const int64_t* starts, int num_leaves) {
  int l = 0;
  while (l + 1 < num_leaves && col >= starts[l + 1]) ++l;
  return l;
}

// Stage the (est, q) tile starting at column col0 into sv ([K][TN] float32)
// and sq ([K][TN] int8): thread tid takes the 4-column chunks tid, tid +
// blockDim, ...; columns past n are zero.  kVec: cp.async (asynchronous);
// else plain loads (synchronous).  A bf16 est is widened with plain loads
// (8 bytes a chunk where kVec), synchronously; its q as a float32 est's.
template <bool kVec, bool kHasQ, typename TS = float>
__device__ __forceinline__ void stage_tile(float* sv, int8_t* sq, const TS* __restrict__ est,
                                           const int8_t* __restrict__ q, int64_t col0, int64_t n,
                                           int k_peers, int tn) {
  const int c4 = tn / 4;
  for (int e = threadIdx.x; e < k_peers * c4; e += blockDim.x) {
    const int j = e / c4, c = e - j * c4;
    const int64_t col = col0 + 4 * c;
    const int64_t src = static_cast<int64_t>(j) * n + col;
    float* dv = sv + j * tn + 4 * c;
    int8_t* dq = sq + j * tn + 4 * c;
    if constexpr (!std::is_same<TS, float>::value) {
      if (kVec) {
        const bool ok = col < n;
        *reinterpret_cast<float4*>(dv) =
            ok ? bf16x4_to_float4(__ldg(reinterpret_cast<const uint2*>(est + src)))
               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (kHasQ) cp_async4(dq, ok ? q + src : q, ok);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool ok = col + i < n;
          dv[i] = ok ? to_float(est[src + i]) : 0.0f;
          if (kHasQ) dq[i] = ok ? q[src + i] : static_cast<int8_t>(0);
        }
      }
    } else if (kVec) {
      const bool ok = col < n;
      cp_async16(dv, ok ? est + src : est, ok);
      if (kHasQ) cp_async4(dq, ok ? q + src : q, ok);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool ok = col + i < n;
        dv[i] = ok ? est[src + i] : 0.0f;
        if (kHasQ) dq[i] = ok ? q[src + i] : static_cast<int8_t>(0);
      }
    }
  }
}

// Four consecutive columns of `row` from `col`, as float32: whole on the
// vector path (n is a multiple of 4 there; of 8 for bf16), guarded per
// column on the scalar path.
template <bool kVec, typename TS = float>
__device__ __forceinline__ float4 load4(const TS* __restrict__ p, int64_t row, int64_t col,
                                        int64_t n) {
  if constexpr (!std::is_same<TS, float>::value) {
    if (kVec)
      return col < n ? bf16x4_to_float4(__ldg(reinterpret_cast<const uint2*>(p + row * n + col)))
                     : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = col + i < n ? to_float(p[row * n + col + i]) : 0.0f;
    return make_float4(v[0], v[1], v[2], v[3]);
  } else {
    if (kVec) {
      return col < n ? __ldg(reinterpret_cast<const float4*>(p + row * n + col))
                     : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = col + i < n ? __ldg(p + row * n + col + i) : 0.0f;
    return make_float4(v[0], v[1], v[2], v[3]);
  }
}

template <bool kVec, typename TS = float>
__device__ __forceinline__ void store4(TS* __restrict__ p, int64_t row, int64_t col, int64_t n,
                                       float4 v) {
  if (kVec) {
    if (col < n) {
      if constexpr (std::is_same<TS, float>::value) {
        *reinterpret_cast<float4*>(p + row * n + col) = v;
      } else {
        *reinterpret_cast<uint2*>(p + row * n + col) = float4_to_bf16x4(v);
      }
    }
    return;
  }
  const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (col + i < n) p[row * n + col + i] = from_float<TS>(vv[i]);
}

// Advance the chunks this thread staged, in place (``vadvance``: v =
// fmaf(scale, q, est), one rounding, in float32 storage), and write them to
// est'.  The chunk assignment is stage_tile's, so each thread reads only its
// own copies, visible to it after its cp.async wait.
template <bool kVec, typename TS = float>
__device__ __forceinline__ void advance_tile(float* sv, const int8_t* sq,
                                             const float* __restrict__ scale,
                                             const int64_t* starts, int num_leaves,
                                             TS* __restrict__ est_out, int64_t col0,
                                             int64_t n, int k_peers, int tn) {
  const int c4 = tn / 4;
  for (int e = threadIdx.x; e < k_peers * c4; e += blockDim.x) {
    const int j = e / c4, c = e - j * c4;
    const int64_t col = col0 + 4 * c;
    float4 v = *reinterpret_cast<float4*>(sv + j * tn + 4 * c);
    const char4 qq = *reinterpret_cast<const char4*>(sq + j * tn + 4 * c);
    const float* sc = scale + static_cast<int64_t>(j) * num_leaves;
    float s0, s1, s2, s3;
    if (kVec) {  // every leaf start is a multiple of 4: one leaf a chunk
      s0 = s1 = s2 = s3 = __ldg(sc + leaf_of(col, starts, num_leaves));
    } else {
      s0 = __ldg(sc + leaf_of(col, starts, num_leaves));
      s1 = __ldg(sc + leaf_of(col + 1, starts, num_leaves));
      s2 = __ldg(sc + leaf_of(col + 2, starts, num_leaves));
      s3 = __ldg(sc + leaf_of(col + 3, starts, num_leaves));
    }
    v.x = vadvance<TS>(s0, static_cast<float>(qq.x), v.x);
    v.y = vadvance<TS>(s1, static_cast<float>(qq.y), v.y);
    v.z = vadvance<TS>(s2, static_cast<float>(qq.z), v.z);
    v.w = vadvance<TS>(s3, static_cast<float>(qq.w), v.w);
    *reinterpret_cast<float4*>(sv + j * tn + 4 * c) = v;
    store4<kVec, TS>(est_out, j, col, n, v);
  }
}

// Dynamic shared memory: [K][RP] table | K4 self_w | K4 has-neighbor flags |
// K4 1 / y' (mass mode only) | 2 stages of [K][TN] float32 est (advanced in
// place) | 2 of [K][TN] int8 q.  `rows`: a row range's count (-1: all K).
size_t tile_smem_bytes(int k, bool has_q, bool mass, int rows = -1) {
  const TileShape t = tile_shape(k, rows);
  const size_t k4 = static_cast<size_t>((k + 3) & ~3);
  const size_t tile = static_cast<size_t>(k) * t.tn;
  return sizeof(float) * (static_cast<size_t>(k) * t.rp + (mass ? 3 : 2) * k4 + 2 * tile) +
         (has_q ? 2 * tile : 0);
}

// One warp a row of the slot table, for the rows row0 .. row0 + rows - 1
// (each kept at its index in the range): the raw beta row sum (the
// no-neighbor guard) and self_w; in the mass mode also y'_k = self_w[k] y_k
// + sum_s nbr_w[k, s] y_j, kept as 1 / y'_k, self_w[k] y_k / y'_k in place
// of self_w, and y' written to new_mass (one entry a row of the range) by
// block 0.
template <bool kMass>
__device__ __forceinline__ void reduce_slot_rows(int row0, int rows, int d_slots,
                                                 const float* __restrict__ self_w,
                                                 const int32_t* __restrict__ nbr_idx,
                                                 const float* __restrict__ nbr_w,
                                                 const float* __restrict__ beta,
                                                 const float* __restrict__ mass, float* s_sw,
                                                 int* s_has, float* s_inv_y,
                                                 float* __restrict__ new_mass) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < rows; r += blockDim.x / 32) {
    const int k = row0 + r;
    float sum = 0.0f, ysum = 0.0f;
    for (int s = lane; s < d_slots; s += 32) {
      const int64_t e = static_cast<int64_t>(k) * d_slots + s;
      sum += beta[e];
      if (kMass) ysum += __fmul_rn(nbr_w[e], mass[nbr_idx[e]]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (kMass) ysum += __shfl_xor_sync(0xffffffffu, ysum, off);
    }
    if (lane == 0) {
      s_has[r] = sum > 0.0f;
      if (kMass) {
        const float sw_y = self_w[k] * mass[k], y = sw_y + ysum;
        const float inv_y = 1.0f / y;
        s_inv_y[r] = inv_y;
        s_sw[r] = sw_y * inv_y;
        if (blockIdx.x == 0) new_mass[r] = y;
      } else {
        s_sw[r] = self_w[k];
      }
    }
  }
}

template <bool kVec, bool kHasQ, bool kSelfStaged, bool kMass, bool kSnap = false,
          typename TS = float>
__global__ void __launch_bounds__(kTileThreads, 1)
mix_tile_kernel(const TS* __restrict__ x, const TS* __restrict__ est,
                        const int8_t* __restrict__ q, const float* __restrict__ scale,
                        LeafStarts leaves, int num_leaves, int64_t n, int k_peers,
                        const float* __restrict__ self_w, const int32_t* __restrict__ nbr_idx,
                        const float* __restrict__ nbr_w, const float* __restrict__ beta,
                        int d_slots, float local_steps, const float* __restrict__ mass,
                        TS* __restrict__ mixed, TS* __restrict__ d_out,
                        TS* __restrict__ est_out, float* __restrict__ new_mass, int row0,
                        int rows) {
  // rows of the range: mix row r (< rows) is peer row0 + r, d row r (rows <=
  // r < 2 rows) peer row0 + r - rows; mixed, d_out and new_mass hold the
  // range's rows only, est_out (a payload's advance: the full range) all K
  const TileShape ts = tile_shape(k_peers, rows);
  const int rp = ts.rp, tn = ts.tn;
  const int k4 = (k_peers + 3) & ~3;
  extern __shared__ __align__(16) float smem[];
  float* table = smem;                 // table[j * rp + r] = [W_off; Beta][r, j]
  float* s_sw = table + k_peers * rp;  // self_w (x own mass in the mass mode)
  int* s_has = reinterpret_cast<int*>(s_sw + k4);
  float* s_inv_y = s_sw + 2 * k4;      // 1 / y' (mass mode)
  float* stage_v = s_sw + (kMass ? 3 : 2) * k4;  // 2 x [K][TN]
  int8_t* stage_q = reinterpret_cast<int8_t*>(stage_v + 2 * k_peers * tn);  // 2 x [K][TN]
  const int tile_elems = k_peers * tn;
  __shared__ int64_t s_start[kMaxLeaves];

  const int64_t n_tiles = (n + tn - 1) / tn;
  for (int i = threadIdx.x; i < k_peers * rp; i += blockDim.x) table[i] = 0.0f;
  const int64_t slot0 = static_cast<int64_t>(row0) * d_slots;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int l = 0; l < kMaxLeaves; ++l) {
      if (l < num_leaves) s_start[l] = leaves.start[l];
    }
  }
  __syncthreads();
  if (kMass) {  // the rows' 1 / y' first: the scatter scales by it
    reduce_slot_rows<true>(row0, rows, d_slots, self_w, nbr_idx, nbr_w, beta, mass, s_sw,
                           s_has, s_inv_y, new_mass);
    __syncthreads();
  }
  // scatter the slot table: a row's slots name distinct senders but for its
  // padding slots (its own index, weight 0), so each entry receives at most
  // one real weight onto +0.0, whatever the order of the atomics
  for (int e = threadIdx.x; e < rows * d_slots; e += blockDim.x) {
    const int r = e / d_slots;
    const int64_t g = slot0 + e;
    const int j = nbr_idx[g];
    atomicAdd(table + j * rp + r, kMass ? nbr_w[g] * mass[j] * s_inv_y[r] : nbr_w[g]);
    atomicAdd(table + j * rp + rows + r, beta[g]);
  }
  if (!kMass)
    reduce_slot_rows<false>(row0, rows, d_slots, self_w, nbr_idx, nbr_w, beta, mass, s_sw,
                            s_has, s_inv_y, new_mass);
  __syncthreads();

  const int tid = threadIdx.x;
  const bool computes = tid < ts.threads;
  const int rg = tid / ts.cg, cgi = tid - rg * ts.cg;
  const int r0 = rg * kTileRows;
  const int ca = 4 * cgi;  // this thread's column group
  int64_t tile = blockIdx.x;
  stage_tile<kVec, kHasQ, TS>(stage_v, stage_q, est, q, tile * tn, n, k_peers, tn);
  cp_async_commit();
  for (int it = 0; tile < n_tiles; ++it, tile += gridDim.x) {
    const int64_t col0 = tile * tn;
    float* sv = stage_v + (it & 1) * tile_elems;
    const int8_t* sq = stage_q + (it & 1) * tile_elems;
    const int64_t next = tile + gridDim.x;
    if (next < n_tiles)  // the next tile's copies run while this one is computed
      stage_tile<kVec, kHasQ, TS>(stage_v + ((it + 1) & 1) * tile_elems,
                              stage_q + ((it + 1) & 1) * tile_elems, est, q, next * tn, n,
                              k_peers, tn);
    cp_async_commit();
    cp_async_wait<1>();  // this tile's copies (all but the newest group) have landed
    if (kHasQ)
      advance_tile<kVec, TS>(sv, sq, scale, s_start, num_leaves, est_out, col0, n, k_peers, tn);
    __syncthreads();
    if (computes) {
      // x of this thread's mix rows (kSnap: and of its d rows' peers), loads
      // in flight during the sums (with kSelfStaged the staged tile is x and
      // holds them already)
      float xs[kTileRows][kTileCols];
#pragma unroll
      for (int i = 0; i < kTileRows; ++i) {
        const int r = r0 + i;
        const bool live = kSnap ? r < 2 * rows : !kSelfStaged && r < rows;
        const float4 xa = live ? load4<kVec, TS>(x, row0 + (r >= rows ? r - rows : r),
                                             col0 + ca, n)
                               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        xs[i][0] = xa.x, xs[i][1] = xa.y, xs[i][2] = xa.z, xs[i][3] = xa.w;
      }
      float acc[kTileRows][kTileCols];
#pragma unroll
      for (int i = 0; i < kTileRows; ++i)
#pragma unroll
        for (int c = 0; c < kTileCols; ++c) acc[i][c] = 0.0f;
#pragma unroll 4
      for (int j = 0; j < k_peers; ++j) {
        const float4 a0 = *reinterpret_cast<const float4*>(table + j * rp + r0);
        const float4 a1 = *reinterpret_cast<const float4*>(table + j * rp + r0 + 4);
        const float4 v0 = *reinterpret_cast<const float4*>(sv + j * tn + ca);
        const float a[kTileRows] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float v[kTileCols] = {v0.x, v0.y, v0.z, v0.w};
#pragma unroll
        for (int i = 0; i < kTileRows; ++i)
#pragma unroll
          for (int c = 0; c < kTileCols; ++c) acc[i][c] = fmaf(a[i], v[c], acc[i][c]);
      }
#pragma unroll
      for (int i = 0; i < kTileRows; ++i) {
        const int r = r0 + i;
        if (r < rows) {
          const float sw = s_sw[r];
          if (kSelfStaged) {
            const float4 xa = *reinterpret_cast<const float4*>(sv + (row0 + r) * tn + ca);
            xs[i][0] = xa.x, xs[i][1] = xa.y, xs[i][2] = xa.z, xs[i][3] = xa.w;
          }
#pragma unroll
          for (int c = 0; c < kTileCols; ++c) acc[i][c] = fmaf(sw, xs[i][c], acc[i][c]);
          store4<kVec, TS>(mixed, r, col0 + ca, n,
                       make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
        } else if (r < 2 * rows) {
          const int k = r - rows;
          const bool has = s_has[k] != 0;
          const float4 va = kSnap ? make_float4(xs[i][0], xs[i][1], xs[i][2], xs[i][3])
                                  : *reinterpret_cast<const float4*>(sv + (row0 + k) * tn + ca);
          const float4 sa = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
          store4<kVec, TS>(d_out, k, col0 + ca, n, vbias(sa, va, local_steps, has));
        }
      }
    }
    __syncthreads();  // every thread is done with this stage before it is refilled
  }
  cp_async_wait<0>();
}

template <bool kVec, bool kSelfStaged, bool kMass, bool kSnap = false, typename TS = float>
cudaError_t launch_tile(bool has_q, size_t smem, cudaStream_t s, const TS* x,
                        const TS* est, const int8_t* q, const float* scale,
                        const LeafStarts& leaves, int num_leaves, int64_t n, int k_peers,
                        const float* self_w, const int32_t* nbr_idx, const float* nbr_w,
                        const float* beta, int d_slots, float local_steps, const float* mass,
                        TS* mixed, TS* d_out,
                        typename std::remove_const<TS>::type* est_out,  // not deduced: may be null
                        float* new_mass, int row0 = 0, int rows = -1) {
  // rows < 0: every peer (the full launch)
  if (rows < 0) rows = k_peers;
  void (*kernel)(const TS*, const TS*, const int8_t*, const float*, LeafStarts, int, int64_t,
                 int, const float*, const int32_t*, const float*, const float*, int, float,
                 const float*, TS*, TS*, TS*, float*, int, int) =
      has_q ? mix_tile_kernel<kVec, true, kSelfStaged, kMass, kSnap, TS>
            : mix_tile_kernel<kVec, false, kSelfStaged, kMass, kSnap, TS>;
  const TileShape ts = tile_shape(k_peers, rows);
  const int64_t n_tiles = (n + ts.tn - 1) / ts.tn;
  // the persistent grid: as many blocks as fit on the SMs, at most one a
  // tile.  The shared-memory limit, the SM count and the occupancy are set
  // and asked once per device, kernel and K: a launch at K = 8 is shorter
  // than those calls.
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  static int sms[kMaxDevices] = {}, smem_set[kMaxDevices][2] = {};
  static int per_sm[kMaxDevices][2][2][kTileMaxPeers + 1] = {};
  int& limit = smem_set[dev][has_q];
  if (static_cast<int>(smem) > limit) {
    if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    static_cast<int>(smem))) != cudaSuccess)
      return err;
    limit = static_cast<int>(smem);
  }
  // a row range's block is smaller: its occupancy is asked on every launch
  int range_fit = 0;
  int& fit = rows == k_peers ? per_sm[dev][kVec][has_q][k_peers] : range_fit;
  if (fit == 0) {
    if ((err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev)) !=
        cudaSuccess)
      return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, kernel, ts.block,
                                                             smem)) != cudaSuccess)
      return err;
    if (fit < 1) return cudaErrorInvalidConfiguration;
  }
  const int64_t blocks = static_cast<int64_t>(sms[dev]) * fit;
  const int grid = static_cast<int>(blocks < n_tiles ? blocks : n_tiles);
  kernel<<<grid, ts.block, smem, s>>>(x, est, q, scale, leaves, num_leaves, n, k_peers, self_w,
                                      nbr_idx, nbr_w, beta, d_slots, local_steps, mass, mixed,
                                      d_out, est_out, new_mass, row0, rows);
  return cudaGetLastError();
}

}  // namespace
