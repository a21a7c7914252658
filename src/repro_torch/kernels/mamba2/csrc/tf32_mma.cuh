// The tensor-core primitives of the SSD kernels (ssd.cu, ssd_bwd.cu): TF32
// mma.sync with float32 operands split into two TF32 parts, ldmatrix of bf16
// tiles widened exactly to float32, and cp.async copies into shared memory.
//
// A float32 operand v is split into hi = rna(v) and lo = rna(v - hi) and a
// product summed as lo * hi + hi * lo + hi * hi (the low * low term dropped:
// "3xTF32", CUTLASS's OpMultiplyAddFastF32 scheme).  bf16 values are exact in
// TF32 and are not split.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// v rounded to TF32, to nearest with ties away from zero (what
// cvt.rna.tf32.f32 gives for finite v, which sm_90 emulates in four
// instructions with an infinity check): the 13 low bits of the significand
// rounded into the rest of the sign-magnitude word, then cleared
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// d += a (16 x 8, row) * b (8 x 8, col), TF32 operands, float32 accumulator
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// An operand fragment as TF32 parts: hi alone when the values are exact in
// TF32 (kSplit false: widened bf16), else hi = rna(v) and lo = rna(v - hi).
template <int R>
struct Parts {
  uint32_t hi[R], lo[R];
};

template <bool kSplit, int R>
__device__ __forceinline__ Parts<R> parts(const float (&v)[R]) {
  Parts<R> f;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if constexpr (kSplit) {
      f.hi[i] = tf32_rna(v[i]);
      f.lo[i] = tf32_rna(v[i] - __uint_as_float(f.hi[i]));
    } else {
      f.hi[i] = __float_as_uint(v[i]);
      f.lo[i] = 0u;
    }
  }
  return f;
}

// d += a b in TF32 passes, the small terms first: kSA / kSB say whether a / b
// carry a low part (3 passes when both do, 2 when one does, 1 when neither)
template <bool kSA, bool kSB>
__device__ __forceinline__ void mma_parts(float (&d)[4], const Parts<4>& a, const Parts<2>& b) {
  if constexpr (kSA) mma_tf32(d, a.lo, b.hi);
  if constexpr (kSB) mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

// NM 8 x 8 b16 matrices from shared memory; lane L gives the address of row
// L % 8 of matrix (L / 8) % NM.  kTrans: each matrix transposed.
template <int NM, bool kTrans>
__device__ __forceinline__ void ldsm(uint32_t (&r)[NM], const void* ptr) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
  if constexpr (NM == 1 && kTrans) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x1.trans.shared.b16 {%0}, [%1];\n"
                 : "=r"(r[0]) : "r"(addr));
  } else if constexpr (NM == 1) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x1.shared.b16 {%0}, [%1];\n"
                 : "=r"(r[0]) : "r"(addr));
  } else if constexpr (NM == 2 && kTrans) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1]) : "r"(addr));
  } else if constexpr (NM == 2) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1]) : "r"(addr));
  } else if constexpr (kTrans) {
    static_assert(NM == 4, "ldmatrix takes 1, 2 or 4 matrices");
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
  } else {
    static_assert(NM == 4, "ldmatrix takes 1, 2 or 4 matrices");
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
  }
}

// the two bf16 of a register widened to float32 (exact in TF32)
__device__ __forceinline__ float bf_lo(uint32_t r) { return __uint_as_float(r << 16); }
__device__ __forceinline__ float bf_hi(uint32_t r) { return __uint_as_float(r & 0xffff0000u); }

// 16 (or 4) bytes from global to shared memory without passing through
// registers; `valid` false writes zeros and reads nothing.
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
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// wait until at most `kPending` committed groups are still in flight
template <int kPending>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(v));
  return r;
}
constexpr float kLog2e = 1.4426950408889634f;

}  // namespace
