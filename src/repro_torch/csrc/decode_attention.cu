// Decode attention for Hopper (sm_90a): one new query token per sequence
// against a padded KV cache, keys masked to kpos < lengths[b], online
// softmax in float32. One block per (sequence, head).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py::decode_attention
// (Pallas, body `_kernel`). Same function: q [B,H,D], k/v [B,S,H,D],
// lengths [B] int32; a sequence of length 0 gives 0; output in the input type.
//
// Bound on the H100: each key is read once and used for 4*D flops, about one
// flop per byte in bf16, so the kernel is bound by device-memory bytes
// (2 * sum(lengths) * H * D * sizeof(elem)). This first design reads only
// the keys below each sequence's length (nothing past it, no padding of D),
// lets one thread score one key and lets the threads of the block own the
// head dim for the P.V update (D / 128 output elements each at D = 256). With B = 8 sequences it fills 8 * H blocks,
// short of the 132 SMs at small H: splitting the KV axis over blocks
// (flash-decoding) is the work of the kernel's redesign.
//
// Plain C interface (bound from Python with ctypes). The caller allocates the
// output [B,H,D] contiguous; inputs may be strided except along D.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;  // keys scored per step
constexpr int kWarps = kThreads / 32;
constexpr float kNegBig = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

struct Strides {  // element strides of the batch, sequence and head axes
  long long b, s, h;
};

// Reduce over the block; every thread gets the same value.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float x, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, off);
    x = kMax ? fmaxf(x, y) : x + y;
  }
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = x;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r = kMax ? fmaxf(r, red[w]) : r + red[w];
  __syncthreads();  // red is reused by the next reduction
  return r;
}

template <typename Elem, int D>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const Elem* __restrict__ q, const Elem* __restrict__ k,
              const Elem* __restrict__ v, const int* __restrict__ lengths,
              Elem* __restrict__ o, int S, int H, long long q_sb,
              long long q_sh, Strides ks, Strides vs, float scale) {
  __shared__ float q_s[D];
  __shared__ float p_s[kThreads];
  __shared__ float red[kWarps];

  const int tid = threadIdx.x;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int len = min(max(lengths[b], 0), S);
  const Elem* kb = k + b * ks.b + h * ks.h;
  const Elem* vb = v + b * vs.b + h * vs.h;

  for (int d = tid; d < D; d += kThreads)
    q_s[d] = to_f32(q[b * q_sb + h * q_sh + d]) * scale;
  __syncthreads();

  // thread tid owns output elements d = tid + r * kThreads, d < D
  constexpr int kOwn = (D + kThreads - 1) / kThreads;
  float m = kNegBig, l = 0.f;  // identical in every thread
  float acc[kOwn];
#pragma unroll
  for (int r = 0; r < kOwn; ++r) acc[r] = 0.f;
  for (int c = 0; c < len; c += kThreads) {
    const int j = c + tid;
    float sc = -INFINITY;      // keys at or past the length: probability 0
    if (j < len) {
      const Elem* kr = kb + j * ks.s;
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) dot = fmaf(q_s[d], to_f32(kr[d]), dot);
      sc = dot;
    }
    const float m_new = fmaxf(m, block_reduce<true>(sc, red));
    const float p = expf(sc - m_new);
    const float sum = block_reduce<false>(p, red);
    const float alpha = expf(m - m_new);
    l = alpha * l + sum;
    m = m_new;
    p_s[tid] = p;
    __syncthreads();
    const int n = min(kThreads, len - c);
#pragma unroll
    for (int r = 0; r < kOwn; ++r) {
      const int d = tid + r * kThreads;
      if (d < D) {
        float x = acc[r] * alpha;
        for (int jj = 0; jj < n; ++jj)
          x = fmaf(p_s[jj], to_f32(vb[(c + jj) * vs.s + d]), x);
        acc[r] = x;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < kOwn; ++r) {
    const int d = tid + r * kThreads;
    if (d < D) {
      const long long off = (static_cast<long long>(b) * H + h) * D + d;
      store(o + off, acc[r] / fmaxf(l, 1e-30f));
    }
  }
}

template <typename Elem, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lengths, void* o, int B, int S, int H,
                   long long q_sb, long long q_sh, Strides ks, Strides vs,
                   float scale, cudaStream_t stream) {
  decode_kernel<Elem, D><<<B * H, kThreads, 0, stream>>>(
      static_cast<const Elem*>(q), static_cast<const Elem*>(k),
      static_cast<const Elem*>(v), lengths, static_cast<Elem*>(o), S, H, q_sb,
      q_sh, ks, vs, scale);
  return cudaGetLastError();
}

template <typename Elem>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       const int* lengths, void* o, int B, int S, int H,
                       long long q_sb, long long q_sh, Strides ks, Strides vs,
                       float scale, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<Elem, 32>(q, k, v, lengths, o, B, S, H, q_sb, q_sh, ks, vs, scale, stream);
    case 64: return launch<Elem, 64>(q, k, v, lengths, o, B, S, H, q_sb, q_sh, ks, vs, scale, stream);
    case 96: return launch<Elem, 96>(q, k, v, lengths, o, B, S, H, q_sb, q_sh, ks, vs, scale, stream);
    case 128: return launch<Elem, 128>(q, k, v, lengths, o, B, S, H, q_sb, q_sh, ks, vs, scale, stream);
    case 256: return launch<Elem, 256>(q, k, v, lengths, o, B, S, H, q_sb, q_sh, ks, vs, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; lengths is a
// device array of B int32. Returns the cudaError_t of the launch.
extern "C" int decode_attention_fwd(
    const void* q, const void* k, const void* v, const void* lengths, void* o,
    int dtype, int B, int S, int H, int D, long long q_sb, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, float scale, void* stream) {
  const Strides ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh};
  const int* len = static_cast<const int*>(lengths);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(D, q, k, v, len, o, B, S, H, q_sb, q_sh, ks, vs,
                             scale, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, len, o, B, S, H, q_sb, q_sh,
                                     ks, vs, scale, st);
  return cudaErrorInvalidValue;
}
