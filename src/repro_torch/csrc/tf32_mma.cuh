// Float32 products on Hopper's TF32 tensor cores (sm_90a), shared by the
// float32 attention body (attention_tf32.cuh) and the SSD scan's tensor-core
// body (ssd_mma.cuh): the 3xTF32 split and the m16n8k8 mma.sync (16-byte
// cp.async copies into shared memory come from hopper.cuh).
//
// 3xTF32.  A float32 x is split in registers as hi = tf32(x) (round to
// nearest) and lo = x - hi (exact; the tensor core reads its top 19 bits),
// and a.b is formed as a_lo.b_hi + a_hi.b_lo + a_hi.b_hi into one float32
// accumulator, the small terms first; the dropped lo.lo term is ~2^-22
// relative.  An operand that is exact in TF32 (a bfloat16 value) has lo = 0,
// and the terms with its lo are left out.
//
// Fragments of mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, lane =
// 4g + t: A (16 x 8) a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4);
// B (8 x 8) b0 (k t, n g), b1 (k t+4, n g); C (16 x 8) c0 (g, 2t), c1 (g,
// 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace tf32 {

using hopper::cp_async16;
using hopper::cp_async4;
using hopper::cp_async_commit;
using hopper::cp_async_wait_all;
using hopper::smem_u32;

// x = hi + lo.  hi is x rounded to TF32 (10 mantissa bits), to nearest with
// ties away from zero, as cvt.rna.tf32.f32 rounds, in two integer
// instructions (cvt.rna is emulated on sm_90a, with checks for infinities
// and NaN the finite operands here do not need).  lo = x - hi is exact; the
// tensor core reads its top 19 bits (the low 13 mantissa bits are ignored,
// a truncation of lo, 2^-21 of x at most).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c += a.b on one m16n8k8 tile.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace tf32
