// Prefill attention forward for Hopper (sm_90a): one block per
// (batch*head, query tile), online softmax over KV tiles staged in shared
// memory, float32 accumulation.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::flash_attention
// (Pallas, body `_kernel`). Same function: q [B,T,H,D], k/v [B,S,H,D] with
// heads already mapped to the query heads, query row i at position
// i + q_offset, optional causal mask and sliding window (qpos - kpos <
// window), keys >= S and fully masked rows give 0, output in the input type.
//
// Bound on the H100: at the serving shapes (T = S = 512, D = 64) the work is
// ~4*T*S*D/2 flops per head against ~4*T*D*2 bytes, i.e. far above the
// card's ~295 flop/byte ridge, so the bound is arithmetic. This first design
// is the simple one: it runs the two products on the CUDA cores in float32
// (not the tensor cores), reads K/V once per query tile from device memory
// into shared memory, and skips every KV tile wholly above the diagonal or
// outside the window. wgmma/TMA tiles are the work of a later redesign.
//
// Plain C interface (bound from Python with ctypes). The caller allocates the
// output [B,T,H,D] contiguous; inputs may be strided except along D.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kWarps = kThreads / 32;
constexpr float kNegBig = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

struct Strides {  // element strides of the batch, sequence and head axes
  long long b, t, h;
};

template <int D>
constexpr int smem_floats() {
  return kBlockQ * D              // q tile, pre-scaled
         + kBlockK * (D + 1)      // k tile, padded row: no bank conflicts
         + kBlockK * D            // v tile
         + kBlockQ * (kBlockK + 1)  // scores, then probabilities
         + 3 * kBlockQ;           // running max, running sum, rescale
}

template <typename Elem, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const Elem* __restrict__ q, const Elem* __restrict__ k,
                 const Elem* __restrict__ v, Elem* __restrict__ o,
                 int T, int S, int H, Strides qs, Strides ks, Strides vs,
                 int causal, int window, int q_offset, float scale) {
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + kBlockQ * D;
  float* v_s = k_s + kBlockK * (D + 1);
  float* p_s = v_s + kBlockK * D;
  float* m_s = p_s + kBlockQ * (kBlockK + 1);
  float* l_s = m_s + kBlockQ;
  float* a_s = l_s + kBlockQ;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int q0 = blockIdx.y * kBlockQ;
  const Elem* qb = q + b * qs.b + h * qs.h;
  const Elem* kb = k + b * ks.b + h * ks.h;
  const Elem* vb = v + b * vs.b + h * vs.h;

  constexpr int kAcc = kBlockQ * D / kThreads;  // output elements per thread
  float acc[kAcc];
#pragma unroll
  for (int r = 0; r < kAcc; ++r) acc[r] = 0.f;

  for (int idx = tid; idx < kBlockQ * D; idx += kThreads) {
    const int i = idx / D, d = idx % D;
    const int t = q0 + i;
    q_s[idx] = t < T ? to_f32(qb[t * qs.t + d]) * scale : 0.f;
  }
  for (int i = tid; i < kBlockQ; i += kThreads) {
    m_s[i] = kNegBig;
    l_s[i] = 0.f;
  }

  // KV range any row of this tile can see: tiles wholly above the diagonal
  // or wholly outside the window are skipped.
  const int q_last = min(q0 + kBlockQ, T) - 1 + q_offset;
  const int kv_end = causal ? min(S, q_last + 1) : S;
  int kv_begin = window > 0 ? max(0, q0 + q_offset - window + 1) : 0;
  kv_begin = (kv_begin / kBlockK) * kBlockK;
  __syncthreads();

  for (int k0 = kv_begin; k0 < kv_end; k0 += kBlockK) {
    for (int idx = tid; idx < kBlockK * D; idx += kThreads) {
      const int j = idx / D, d = idx % D;
      const int s = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (s < S) {
        kx = to_f32(kb[s * ks.t + d]);
        vx = to_f32(vb[s * vs.t + d]);
      }
      k_s[j * (D + 1) + d] = kx;
      v_s[j * D + d] = vx;
    }
    __syncthreads();

    // scores; a masked key gets -inf, so its probability is exactly 0
    for (int idx = tid; idx < kBlockQ * kBlockK; idx += kThreads) {
      const int i = idx / kBlockK, j = idx % kBlockK;
      const int qpos = q0 + i + q_offset, kpos = k0 + j;
      bool ok = kpos < S && q0 + i < T;
      if (causal) ok = ok && qpos >= kpos;
      if (window > 0) ok = ok && qpos - kpos < window;
      float sc = -INFINITY;
      if (ok) {
        const float* qr = q_s + i * D;
        const float* kr = k_s + j * (D + 1);
        float dot = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
        sc = dot;
      }
      p_s[i * (kBlockK + 1) + j] = sc;
    }
    __syncthreads();

    // online softmax: one warp per row, two keys per lane
    for (int i = warp; i < kBlockQ; i += kWarps) {
      float* row = p_s + i * (kBlockK + 1);
      const float s0 = row[lane], s1 = row[lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[i];
      const float m_new = fmaxf(m_prev, mx);  // finite: m_prev >= -1e30
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      row[lane] = p0;
      row[lane + 32] = p1;
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[i] = alpha;
        l_s[i] = alpha * l_s[i] + sum;
        m_s[i] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V
#pragma unroll
    for (int r = 0; r < kAcc; ++r) {
      const int idx = tid + r * kThreads;
      const int i = idx / D, d = idx % D;
      const float* prow = p_s + i * (kBlockK + 1);
      float x = acc[r] * a_s[i];
#pragma unroll 8
      for (int j = 0; j < kBlockK; ++j) x = fmaf(prow[j], v_s[j * D + d], x);
      acc[r] = x;
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < kAcc; ++r) {
    const int idx = tid + r * kThreads;
    const int i = idx / D, d = idx % D;
    const int t = q0 + i;
    if (t < T) {
      const long long off = ((static_cast<long long>(b) * T + t) * H + h) * D + d;
      store(o + off, acc[r] / fmaxf(l_s[i], 1e-30f));
    }
  }
}

template <typename Elem, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int T, int S, int H, Strides qs, Strides ks,
                   Strides vs, int causal, int window, int q_offset,
                   float scale, cudaStream_t stream) {
  const int smem = smem_floats<D>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<Elem, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (T + kBlockQ - 1) / kBlockQ);
  flash_fwd_kernel<Elem, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const Elem*>(q), static_cast<const Elem*>(k),
      static_cast<const Elem*>(v), static_cast<Elem*>(o), T, S, H, qs, ks, vs,
      causal, window, q_offset, scale);
  return cudaGetLastError();
}

template <typename Elem>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       void* o, int B, int T, int S, int H, Strides qs,
                       Strides ks, Strides vs, int causal, int window,
                       int q_offset, float scale, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<Elem, 32>(q, k, v, o, B, T, S, H, qs, ks, vs, causal, window, q_offset, scale, stream);
    case 64: return launch<Elem, 64>(q, k, v, o, B, T, S, H, qs, ks, vs, causal, window, q_offset, scale, stream);
    case 96: return launch<Elem, 96>(q, k, v, o, B, T, S, H, qs, ks, vs, causal, window, q_offset, scale, stream);
    case 128: return launch<Elem, 128>(q, k, v, o, B, T, S, H, qs, ks, vs, causal, window, q_offset, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int T, int S, int H, int D, long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_st, long long k_sh, long long v_sb,
    long long v_st, long long v_sh, int causal, int window, int q_offset,
    float scale, void* stream) {
  const Strides qs{q_sb, q_st, q_sh}, ks{k_sb, k_st, k_sh}, vs{v_sb, v_st, v_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(D, q, k, v, o, B, T, S, H, qs, ks, vs, causal,
                             window, q_offset, scale, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, o, B, T, S, H, qs, ks, vs,
                                     causal, window, q_offset, scale, st);
  return cudaErrorInvalidValue;
}
