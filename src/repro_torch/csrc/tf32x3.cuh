// 3xTF32 tensor-core products for Hopper (sm_90a), shared by the SSD scan
// (ssd_scan.cu) and its gradient (ssd_scan_bwd.cu).
//
// mma.sync.m16n8k8 takes TF32 operands (10 mantissa bits) and accumulates
// in float32. A float32 product is taken as three of them: each operand v
// is split as it is loaded into hi = v cut to TF32 and lo = v - hi, and
// a * b is lo*hi' + hi*lo' + hi*hi', about 2^-20 relative, where one TF32
// product (2^-11) misses the 1e-4 the SSD kernels are held to
// (tests/test_torch_ssm.py and tests/test_torch_scan_bwd.py emulate both).
//
// Fragment layout of m16n8k8 .tf32 (g = lane / 4, tg = lane % 4): A's
// a[0] is (row g, column tg), a[1] (g + 8, tg), a[2] (g, tg + 4), a[3]
// (g + 8, tg + 4); B's b[0] is (k tg, column g), b[1] (k tg + 4, g); the
// accumulator's c[0..1] row g, columns 2 tg and 2 tg + 1, c[2..3] row
// g + 8. Row-major operands are loaded by ldmatrix (rows on 16 bytes; a
// row stride of 4 (mod 32) floats hits 32 banks), operands stored the
// other way round by scalar loads (a row stride of 8 (mod 32) floats hits
// 32 banks).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 3xTF32 operands: v = hi + lo, both rounded to TF32
struct A4 {
  uint32_t hi[4], lo[4];
};
struct B2 {
  uint32_t hi[2], lo[2];
};

// v = hi + lo: hi is v cut to TF32 (10 mantissa bits), lo = v - hi is
// exact and passed whole; the tensor cores read a TF32 operand's top 19
// bits, which cuts lo to 10 bits too, an error under 2^-20 of v. Two
// operations: cvt.rna.tf32.f32 runs at a quarter of their rate and
// rounding by integer operations takes three more a value, and the
// splits, not the products, bound the issue rate.
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(v) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A 16 x 8 product tile in 3xTF32: the hi*hi' products and the two cross
// terms are summed apart (two dependency chains, not one of three)
struct Acc {
  float big[4], small[4];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 4; ++i) big[i] = small[i] = 0.f;
  }
  __device__ __forceinline__ float operator[](int i) const {
    return big[i] + small[i];
  }
};

// d += a * b in 3xTF32
__device__ __forceinline__ void mma3(Acc& d, const A4& a, const B2& b) {
  mma(d.small, a.lo, b.hi);
  mma(d.small, a.hi, b.lo);
  mma(d.big, a.hi, b.hi);
}

// ldmatrix moves 8 x 8 tiles of 16-bit halves; a pair of halves is one
// float, so one of its tiles is 8 rows of 4 floats and a lane gets the
// float (lane / 4, lane % 4) of it, as mma.sync's TF32 fragments want.
// Lane l gives the address of row l % 8 of tile l / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const float* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const float* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(row)));
}

// The A fragment (16 x 8) at rows r0.., columns k0.. of a row-major tile
// (rows on 16 bytes)
__device__ __forceinline__ void load_a(A4& f, const float* base, int ld,
                                       int r0, int k0, int lane) {
  const int m = lane >> 3;
  uint32_t v[4];
  ldsm_x4(v, base + (r0 + 8 * (m & 1) + (lane & 7)) * ld + k0 + 4 * (m >> 1));
#pragma unroll
  for (int i = 0; i < 4; ++i) split(__uint_as_float(v[i]), f.hi[i], f.lo[i]);
}

// The B fragment (8 x 8: k0.. by n0..) of a matrix stored n-major,
// base[n][k] (rows on 16 bytes)
__device__ __forceinline__ void load_b_nk(B2& f, const float* base, int ld,
                                          int n0, int k0, int lane) {
  uint32_t v[2];
  ldsm_x2(v, base + (n0 + (lane & 7)) * ld + k0 + 4 * ((lane >> 3) & 1));
  split(__uint_as_float(v[0]), f.hi[0], f.lo[0]);
  split(__uint_as_float(v[1]), f.hi[1], f.lo[1]);
}

// The B fragment of a matrix stored k-major, base[k][n]
__device__ __forceinline__ void load_b_kn(B2& f, const float* base, int ld,
                                          int n0, int k0, int lane) {
  const float* p = base + (k0 + (lane & 3)) * ld + n0 + (lane >> 2);
  split(p[0], f.hi[0], f.lo[0]);
  split(p[4 * ld], f.hi[1], f.lo[1]);
}

}  // namespace
