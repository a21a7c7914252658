// Device helpers shared by the consensus kernels (consensus_mix.cu,
// dequant_mix.cu, segment_mix.cu): the same arithmetic on one float (the
// scalar path) or on a float4 of four neighboring columns (the vector path).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxGridY = 65535;
// The mass mode (push-sum) of a gather design: its prologue (the sender-mass
// scaling, y' and 1 / y') is longer than gossip's, so where a peer's slot
// row is short (D <= 4: a ring, a matching) a block walks 4 column tiles and
// pays it once for them; with long rows the work a tile outweighs it and
// fewer blocks cost more than they save (tools/kernel_ab.py on an H100:
// K = 4096, D = 1 5.36 -> 4.49 ms, K = 100, D = 99 0.589 -> 0.667 ms).
inline int64_t mass_mode_tiles(int64_t tiles, int64_t d_slots) {
  return d_slots <= 4 ? (tiles + 3) / 4 : tiles;
}

__device__ __forceinline__ float vscale(float a, float v) { return a * v; }
__device__ __forceinline__ float4 vscale(float a, float4 v) {
  return make_float4(a * v.x, a * v.y, a * v.z, a * v.w);
}

__device__ __forceinline__ float vfma(float a, float v, float acc) { return fmaf(a, v, acc); }
__device__ __forceinline__ float4 vfma(float a, float4 v, float4 acc) {
  return make_float4(fmaf(a, v.x, acc.x), fmaf(a, v.y, acc.y), fmaf(a, v.z, acc.z),
                     fmaf(a, v.w, acc.w));
}

__device__ __forceinline__ void vzero(float& v) { v = 0.0f; }
__device__ __forceinline__ void vzero(float4& v) { v = make_float4(0.0f, 0.0f, 0.0f, 0.0f); }

// The affinity bias of one element: (sum - own) / T, or 0 for a peer whose
// beta row sums to 0 (an isolated peer keeps d = 0).
__device__ __forceinline__ float vbias(float sum, float own, float t, bool has) {
  return has ? (sum - own) / t : 0.0f;
}
__device__ __forceinline__ float4 vbias(float4 sum, float4 own, float t, bool has) {
  return make_float4(vbias(sum.x, own.x, t, has), vbias(sum.y, own.y, t, has),
                     vbias(sum.z, own.z, t, has), vbias(sum.w, own.w, t, has));
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace
