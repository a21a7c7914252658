// The tiles of the chunked backward kernels (ssd_bwd.cu, and wkv6_bwd.cu
// beside the rwkv6 sources): TF32 fragments of float32 values split in two
// (tf32_mma.cuh), products over groups of tiles, operands staged into shared
// memory in layouts free of bank conflicts for every fragment shape, and the
// quad sums and paired stores of an accumulator's rows.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

// A fragment as TF32 parts (tf32_mma.cuh's parts), the low part of a split
// value left unrounded: the tensor cores read the 19 high bits of a .tf32
// operand, so they truncate lo themselves (at most 2^-21 |v| lost, where
// rounding loses 2^-22), two integer operations a value fewer.
template <bool kSplit, int R>
__device__ __forceinline__ Parts<R> split(const float (&v)[R]) {
  Parts<R> f;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if constexpr (kSplit) {
      f.hi[i] = tf32_rna(v[i]);
      f.lo[i] = __float_as_uint(v[i] - __uint_as_float(f.hi[i]));
    } else {
      f.hi[i] = __float_as_uint(v[i]);
      f.lo[i] = 0u;
    }
  }
  return f;
}

// d[i] += a b[i] over a group of NB tiles sharing the A fragment, pass by
// pass across the group (the passes of tf32_mma.cuh's mma_parts, small terms
// first), so that the passes on one accumulator are NB instructions apart
template <bool kSA, bool kSB, int NB>
__device__ __forceinline__ void mma_group(float (*d)[4], const Parts<4>& a,
                                          const Parts<2> (&b)[NB]) {
  if constexpr (kSA) {
#pragma unroll
    for (int i = 0; i < NB; ++i) mma_tf32(d[i], a.lo, b[i].hi);
  }
  if constexpr (kSB) {
#pragma unroll
    for (int i = 0; i < NB; ++i) mma_tf32(d[i], a.hi, b[i].lo);
  }
#pragma unroll
  for (int i = 0; i < NB; ++i) mma_tf32(d[i], a.hi, b[i].hi);
}

// A staged (R x W) operand of type T in shared memory.  bf16: rows of W
// elements, the 16-byte chunks of row r XOR-swizzled by r / (8 / (W / 8)) (as
// ssd.cu's Tile).  float32 with W >= 32: rows of W floats, the 8-float groups
// of row r XOR-swizzled by f(r) = (r & 3) ^ ((r >> 2) & 1), distinct over
// any four consecutive rows and over rows 2q (and 2q + 1) for q = 0 .. 3, so
// both fragment shapes below fall in 32 different banks; narrower float32
// rows padded by 4.
//
// Fragment loads, for lane (g = lane / 4, q = lane % 4), with the k order
// permuted so that k = q reads element 2 q and k = q + 4 element 2 q + 1 of
// the eight (the same permutation on both operands of a product):
//   rows_a(r0, k0): a = M[r0+g][k0+2q], M[r0+g+8][k0+2q], M[r0+g][k0+2q+1],
//                       M[r0+g+8][k0+2q+1]  (A of a product along the rows)
//   rows_b(r0, k0): b = M[r0+g][k0+2q], M[r0+g][k0+2q+1]  (one 8-column tile)
//   cols_a(k0, c0): a = M[k0+2q][c0+g], M[k0+2q][c0+g+8], M[k0+2q+1][c0+g],
//                       M[k0+2q+1][c0+g+8]  (A of a product down the columns)
//   cols_b(k0, c0): b = M[k0+2q][c0+g], M[k0+2q+1][c0+g]; NM column tiles
//                   c0 + 8 m (at most 4)
template <typename T, int R, int W>
struct Op {
  using Type = T;
  static constexpr bool kBf16 = sizeof(T) == 2;
  static constexpr bool kSwz = !kBf16 && W >= 32;
  static constexpr int kStride = kBf16 || kSwz ? W : W + 4;
  static constexpr int kBytes = R * kStride * static_cast<int>(sizeof(T));
  static_assert(!kBf16 || (W >= 16 && W <= 64), "bf16 rows of 2 to 8 chunks");
  static_assert(kBytes % 16 == 0, "16-byte sections");
  const T* p;

  static __device__ __forceinline__ int off(int r, int c) {
    if constexpr (kBf16) {
      constexpr int kChunks = W / 8, kGroup = 8 / kChunks;
      return r * W + ((((c >> 3) ^ (r / kGroup)) & (kChunks - 1)) << 3) + (c & 7);
    } else if constexpr (kSwz) {
      return r * W + (c ^ (((r & 3) ^ ((r >> 2) & 1)) << 3));
    } else {
      return r * kStride + c;
    }
  }

  __device__ __forceinline__ float at(int r, int c) const {
    if constexpr (kBf16) {
      return __bfloat162float(p[off(r, c)]);
    } else {
      return p[off(r, c)];
    }
  }

  // elements (r, c) and (r, c + 1), c even
  __device__ __forceinline__ float2 at2(int r, int c) const {
    if constexpr (kBf16) {
      return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p + off(r, c)));
    } else {
      return *reinterpret_cast<const float2*>(p + off(r, c));
    }
  }

  __device__ __forceinline__ void rows_a(float (&a)[4], int r0, int k0) const {
    const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
    if constexpr (kBf16) {
      uint32_t r[2];
      ldsm<2, false>(r, p + off(r0 + (lane & 15), k0));
      a[0] = bf_lo(r[0]);
      a[2] = bf_hi(r[0]);
      a[1] = bf_lo(r[1]);
      a[3] = bf_hi(r[1]);
    } else {
      const float2 u = *reinterpret_cast<const float2*>(p + off(r0 + g, k0 + 2 * q));
      const float2 v = *reinterpret_cast<const float2*>(p + off(r0 + g + 8, k0 + 2 * q));
      a[0] = u.x;
      a[1] = v.x;
      a[2] = u.y;
      a[3] = v.y;
    }
  }

  __device__ __forceinline__ void rows_b(float (&b)[2], int r0, int k0) const {
    const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
    if constexpr (kBf16) {
      uint32_t r[1];
      ldsm<1, false>(r, p + off(r0 + (lane & 7), k0));
      b[0] = bf_lo(r[0]);
      b[1] = bf_hi(r[0]);
    } else {
      const float2 u = *reinterpret_cast<const float2*>(p + off(r0 + g, k0 + 2 * q));
      b[0] = u.x;
      b[1] = u.y;
    }
  }

  __device__ __forceinline__ void cols_a(float (&a)[4], int k0, int c0) const {
    const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
    if constexpr (kBf16) {
      uint32_t r[2];
      ldsm<2, true>(r, p + off(k0 + (lane & 7), c0 + 8 * ((lane >> 3) & 1)));
      a[0] = bf_lo(r[0]);
      a[2] = bf_hi(r[0]);
      a[1] = bf_lo(r[1]);
      a[3] = bf_hi(r[1]);
    } else {
      a[0] = p[off(k0 + 2 * q, c0 + g)];
      a[1] = p[off(k0 + 2 * q, c0 + g + 8)];
      a[2] = p[off(k0 + 2 * q + 1, c0 + g)];
      a[3] = p[off(k0 + 2 * q + 1, c0 + g + 8)];
    }
  }

  template <int NM>
  __device__ __forceinline__ void cols_b(float (&b)[NM][2], int k0, int c0) const {
    static_assert(NM >= 1 && NM <= 4 && NM != 3, "1, 2 or 4 column tiles");
    const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
    if constexpr (kBf16) {
      uint32_t r[NM];
      ldsm<NM, true>(r, p + off(k0 + (lane & 7), c0 + 8 * ((lane >> 3) % NM)));
#pragma unroll
      for (int m = 0; m < NM; ++m) {
        b[m][0] = bf_lo(r[m]);
        b[m][1] = bf_hi(r[m]);
      }
    } else {
#pragma unroll
      for (int m = 0; m < NM; ++m) {
        b[m][0] = p[off(k0 + 2 * q, c0 + 8 * m + g)];
        b[m][1] = p[off(k0 + 2 * q + 1, c0 + 8 * m + g)];
      }
    }
  }
};

// Start the copies of R rows of `cols` elements of type T into an operand's
// layout, row r from src + r * st, rows from `valid` on zero-filled.
template <typename O>
__device__ __forceinline__ void stage(unsigned char* dst, const typename O::Type* src, int64_t st,
                                      int rows, int cols, int valid) {
  using T = typename O::Type;
  constexpr int kE = 16 / static_cast<int>(sizeof(T));  // elements a copy
  T* d = reinterpret_cast<T*>(dst);
  const int per = cols / kE;
  for (int e = threadIdx.x; e < rows * per; e += blockDim.x) {
    const int r = e / per, i = (e - r * per) * kE;
    const bool ok = r < valid;
    cp_async16(d + O::off(r, i), ok ? src + r * st + i : src, ok);
  }
}

// the sum of a quad's four lanes (the lanes of one accumulator row), fixed order
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <typename T>
__device__ __forceinline__ void store2(T* p, float v0, float v1) {
  if constexpr (sizeof(T) == 2) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
  }
}

}  // namespace
