// Shared by flash_attention.cu and decode_attention.cu (each includes it
// once, into its own translation unit): the query head -> stored KV head
// map, 16-byte cp.async copies, and the split-KV combine kernel.
//
// Split-KV ("flash-decoding"): when one block per output row would leave
// the card's 132 SMs idle, the kernels cut a row's visible keys into
// n_split chunks. Chunk c writes its row's output normalised over its own
// keys, o_c (float32, [n_split, R, D]), and the log-sum-exp of its scores
// in base 2, lse_c ([n_split, R]); a chunk that sees no key writes lse_c =
// -inf and leaves o_c unwritten. The combine kernel then gives
//
//     out = sum_c 2^(lse_c - M) o_c / sum_c 2^(lse_c - M),  M = max_c lse_c
//
// and 0 for a row whose every chunk is empty (no visible key). The plain
// PyTorch version of the same rule is kernels/attn_split.py::merge_partials.
// With lse_out it also writes the row's merged log-sum-exp, (M + log2 den)
// lse_scale, -inf for an empty row, at [B, H, T] (row r = (b T + t) H + h
// of the partials): in base e (lse_scale = ln 2) for the prefill forward's
// backward, in base 2 (lse_scale = 1, T = 1: row r at r) for the decode
// kernel's partial mode, whose output is a rank's partial in its turn.
//
// The same combine merges the ranks' partials of a sequence-sharded decode
// (attn_merge.cu): there the chunks are the ranks, each partial normalised
// over the rank's slots.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

// Stored KV head read by query head h: kv_map[h] clamped to [0, Hk) (the
// JAX model's jnp.minimum(q_to_kv, n_store - 1)), or h without a map.
__device__ __forceinline__ int kv_head(const int* kv_map, int h, int Hk) {
  return kv_map ? min(max(__ldg(kv_map + h), 0), Hk - 1) : h;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; zero-filled when !valid (then
// src is not read, but must still be a mapped address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(p);
  q[0] = __floats2bfloat162_rn(x.x, x.y);
  q[1] = __floats2bfloat162_rn(x.z, x.w);
}

constexpr int kCombineThreads = 128;

// One thread per (row, 4 columns): a single pass over the chunks, the
// running max rescaling the sums as it rises (online, as the kernels'
// softmax), with every load unconditional so that the unrolled loop keeps
// 8 chunks' loads in flight; an empty chunk's o_c is loaded and ignored.
template <typename Elem>
__global__ void __launch_bounds__(kCombineThreads)
combine_kernel(const float* __restrict__ opart, const float* __restrict__ lse,
               Elem* __restrict__ out, int n_split, long long R, int D,
               float* __restrict__ lse_out, int T, int H, float lse_scale) {
  const int nq = D / 4;
  const long long i = blockIdx.x * static_cast<long long>(kCombineThreads) +
                      threadIdx.x;
  if (i >= R * nq) return;
  const long long r = i / nq;
  const int c4 = static_cast<int>(i % nq);
  float m = -INFINITY, den = 0.f;
  float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
  for (int c = 0; c < n_split; ++c) {
    const float l = __ldg(lse + c * R + r);
    const float4 o =
        __ldg(reinterpret_cast<const float4*>(opart + (c * R + r) * D) + c4);
    if (l == -INFINITY) continue;             // empty chunk
    const float m_new = fmaxf(m, l);
    const float a = exp2f(m - m_new), w = exp2f(l - m_new);
    den = fmaf(den, a, w);
    num.x = fmaf(num.x, a, w * o.x);
    num.y = fmaf(num.y, a, w * o.y);
    num.z = fmaf(num.z, a, w * o.z);
    num.w = fmaf(num.w, a, w * o.w);
    m = m_new;
  }
  const float inv = den > 0.f ? 1.f / den : 0.f;
  if (lse_out != nullptr && c4 == 0) {
    const long long bt = r / H, b = bt / T;
    lse_out[(b * H + r % H) * T + bt % T] =
        den > 0.f ? (m + log2f(den)) * lse_scale : -INFINITY;
  }
  store4(out + r * D + 4 * c4,
         make_float4(num.x * inv, num.y * inv, num.z * inv, num.w * inv));
}

template <typename Elem>
cudaError_t launch_combine(const float* opart, const float* lse, void* out,
                           int n_split, long long R, int D,
                           cudaStream_t stream, float* lse_out = nullptr,
                           int T = 1, int H = 1,
                           float lse_scale = 0.6931471805599453f) {
  const long long blocks = (R * (D / 4) + kCombineThreads - 1) /
                           kCombineThreads;
  combine_kernel<Elem><<<static_cast<unsigned>(blocks), kCombineThreads, 0,
                         stream>>>(opart, lse, static_cast<Elem*>(out),
                                   n_split, R, D, lse_out, T, H,
                                   lse_scale);
  return cudaGetLastError();
}

}  // namespace
