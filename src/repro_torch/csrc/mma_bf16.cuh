// Shared by flash_attention.cu and flash_attention_bwd.cu: the bfloat16
// tensor-core tile operations of the attention kernels (ldmatrix loads from
// shared memory and mma.sync.m16n8k16 with float32 accumulation).
//
// Fragment layout of m16n8k16 (g = lane / 4, t4 = lane % 4): the
// accumulator c[0..1] holds row g, columns 2 t4 and 2 t4 + 1, c[2..3] row
// g + 8; A's a[0] row g, k 2 t4..+1, a[1] row g + 8, a[2] and a[3] the
// same rows at k + 8; B's b0 k 2 t4..+1 at column g, b1 the same at k + 8.
// An accumulator tile pair (columns 16 j .. 16 j + 15) therefore packs into
// the A fragment of the next product without a trip through shared memory.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "attn_split.cuh"

namespace {

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
// c += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ldmatrix lane offsets into a shared tile of row stride rs (in bf16):
//   a_off: the A fragment of a 16x16 slice of a row-major [M][K] tile;
//   b_off: two B fragments (16 k x 2 x 8 n) of a tile stored [N][K] (the
//          rows are the output columns: K of Q K^T), non-transposed;
//   t_off: the same of a tile stored [K][N] (V of P V), with .trans.
__device__ __forceinline__ int a_off(int lane, int rs) {
  return (lane % 16) * rs + (lane / 16) * 8;
}
__device__ __forceinline__ int b_off(int lane, int rs) {
  return (8 * (lane / 16) + lane % 8) * rs + 8 * ((lane / 8) % 2);
}
__device__ __forceinline__ int t_off(int lane, int rs) {
  return (8 * ((lane / 8) % 2) + lane % 8) * rs + 8 * (lane / 16);
}

}  // namespace
