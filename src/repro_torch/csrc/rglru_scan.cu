// RG-LRU linear recurrence for Hopper (sm_90a): h_t = a_t * h_{t-1} + x_t
// over [B, T, W] in float32, carried from an optional initial state.
//
// Replaces the TPU kernel src/repro/kernels/rglru.py::rglru_scan (Pallas,
// body `_kernel`). Same function: a/x [B,T,W] float32, init_state [B,W] or
// none (zeros); returns h [B,T,W] and the final state [B,W], both float32.
// Any W and any T >= 0 (T = 0 gives the initial state back).
//
// Bound on the H100: one multiply-add per element read, so the bytes bound
// it: 4 * (3*B*T*W + 2*B*W) (a and x read once, h written once, the state in
// and out). The TPU kernel solves each time chunk with a log-depth
// associative scan across its 128-lane vectors; here one thread owns one
// (b, w) channel of one time chunk and steps through it with the state in a
// register, so a warp reads 32 neighbouring channels of one step
// (coalesced) and the dependent chain is one FMA a step; each thread keeps
// the next kUnroll steps of a and x in flight in registers while it runs
// the current ones. One thread a channel over all of T would leave too few
// loads in flight at B = 1 (4096 threads, ~0.5 MB, where 3.35 TB/s needs
// several MB), so a long T is cut into chunks of `chunk` steps, in two
// passes:
//   1. chunk_summary_kernel: for every chunk but the last, the product of
//      its a and its end state from a zero start;
//   2. rglru_scan_kernel: each chunk folds the summaries of the chunks
//      before it into its carry (h_end = prod * h_start + end), then
//      rescans its own steps from that carry, writing h; the last chunk
//      writes the final state.
// a and x are read twice, the summaries (B*(nc-1)*W*8 bytes) stay in L2. A
// T of one chunk (decode, short suffixes) takes pass 2 alone.
//
// Plain C interface (bound from Python with ctypes). The caller allocates h
// [B,T,W], the final state [B,W] and, for more than one chunk, the
// summaries [2, B, nc-1, W], all contiguous; a and x may be strided except
// along W, the initial state is contiguous.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;
constexpr int kUnroll = 16;  // steps of a and x loaded ahead

struct Steps {
  float a[kUnroll], x[kUnroll];
};

// Steps [t0, t0 + kUnroll) of one channel; from t1 on, a = 1 and x = 0 keep
// the state exactly (fmaf(1, s, 0) == s) and nothing is stored.
__device__ __forceinline__ void load_steps(Steps& s,
                                           const float* __restrict__ ab,
                                           const float* __restrict__ xb,
                                           long long a_st, long long x_st,
                                           int t0, int t1) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int t = t0 + u;
    s.a[u] = t < t1 ? __ldg(ab + t * a_st) : 1.f;
    s.x[u] = t < t1 ? __ldg(xb + t * x_st) : 0.f;
  }
}

// Runs steps [t0, t1) of one channel from `state`; with `hb` set, writes
// h_t at hb[t * W]; with `prod` set, multiplies the a's into it.
__device__ __forceinline__ float run_steps(const float* __restrict__ ab,
                                           const float* __restrict__ xb,
                                           float* __restrict__ hb,
                                           long long a_st, long long x_st,
                                           int W, int t0, int t1, float state,
                                           float* prod) {
  Steps cur, nxt;
  load_steps(cur, ab, xb, a_st, x_st, t0, t1);
  for (int g = t0; g < t1; g += kUnroll) {
    load_steps(nxt, ab, xb, a_st, x_st, g + kUnroll, t1);  // in flight below
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      state = fmaf(cur.a[u], state, cur.x[u]);
      if (prod != nullptr) *prod *= cur.a[u];
      if (hb != nullptr && g + u < t1)
        hb[static_cast<long long>(g + u) * W] = state;
    }
    cur = nxt;
  }
  return state;
}

struct Args {
  const float* a;
  const float* x;
  long long a_sb, a_st, x_sb, x_st;
  int T, W, chunk, nc;
};

__global__ void __launch_bounds__(kThreads)
chunk_summary_kernel(Args p, float* __restrict__ prod,
                     float* __restrict__ end) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  const int c = blockIdx.y, b = blockIdx.z;
  if (w >= p.W) return;
  const int t0 = c * p.chunk;
  float pr = 1.f;
  const float e = run_steps(p.a + b * p.a_sb + w, p.x + b * p.x_sb + w,
                            nullptr, p.a_st, p.x_st, p.W, t0, t0 + p.chunk,
                            0.f, &pr);
  const long long off = (static_cast<long long>(b) * (p.nc - 1) + c) * p.W + w;
  prod[off] = pr;
  end[off] = e;
}

__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(Args p, const float* __restrict__ s0,
                  const float* __restrict__ prod,
                  const float* __restrict__ end, float* __restrict__ h,
                  float* __restrict__ sf) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  const int c = blockIdx.y, b = blockIdx.z;
  if (w >= p.W) return;
  float state = s0 != nullptr ? s0[static_cast<long long>(b) * p.W + w] : 0.f;
  const long long sum0 = static_cast<long long>(b) * (p.nc - 1) * p.W + w;
#pragma unroll 8
  for (int k = 0; k < c; ++k)  // the carry into chunk c
    state = fmaf(prod[sum0 + k * p.W], state, end[sum0 + k * p.W]);
  const int t0 = c * p.chunk, t1 = min(t0 + p.chunk, p.T);
  state = run_steps(p.a + b * p.a_sb + w, p.x + b * p.x_sb + w,
                    h + static_cast<long long>(b) * p.T * p.W + w, p.a_st,
                    p.x_st, p.W, t0, t1, state, nullptr);
  if (c == p.nc - 1) sf[static_cast<long long>(b) * p.W + w] = state;
}

}  // namespace

// s0 may be null (zero initial state); `summaries` holds 2*B*(nc-1)*W
// floats, nc = max(1, ceil(T / chunk)), and may be null when nc == 1.
// Strides are in elements. Returns the cudaError_t of the launches (0 on
// success).
extern "C" int rglru_scan_fwd(const void* a, const void* x, const void* s0,
                              void* h, void* sf, void* summaries, int B,
                              int T, int W, int chunk, long long a_sb,
                              long long a_st, long long x_sb, long long x_st,
                              void* stream) {
  const int nc = T > chunk ? (T + chunk - 1) / chunk : 1;
  const Args p{static_cast<const float*>(a), static_cast<const float*>(x),
               a_sb, a_st, x_sb, x_st, T, W, chunk, nc};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int wb = (W + kThreads - 1) / kThreads;
  float* prod = static_cast<float*>(summaries);
  float* end = nullptr;
  if (prod != nullptr) end = prod + static_cast<long long>(B) * (nc - 1) * W;
  if (nc > 1) {
    if (prod == nullptr) return cudaErrorInvalidValue;
    chunk_summary_kernel<<<dim3(wb, nc - 1, B), kThreads, 0, st>>>(p, prod,
                                                                   end);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  rglru_scan_kernel<<<dim3(wb, nc, B), kThreads, 0, st>>>(
      p, static_cast<const float*>(s0), prod, end, static_cast<float*>(h),
      static_cast<float*>(sf));
  return cudaGetLastError();
}
