// The gradient of the RG-LRU recurrence h_t = a_t * h_{t-1} + x_t for Hopper
// (sm_90a), float32, over [B, T, W]:
//     g_{T-1} = dh_{T-1} + dhf,   g_t = dh_t + a_{t+1} g_{t+1}
//     dx_t = g_t,   da_t = g_t h_{t-1}  (h_{-1} = the initial state or 0),
//     d init_state = a_0 g_0
// given a, the forward's h, its initial state, dh (the gradient of h) and
// dhf (the final state's; null for zeros).
//
// Replaces what the JAX package gets from autodiff of its oracle
// (src/repro/kernels/ref.py `rglru_ref`, which src/repro/kernels/ops.py
// runs off the TPU): the TPU kernel src/repro/kernels/rglru.py::rglru_scan
// has no backward of its own.
//
// Bound on the H100: one multiply-add and one multiply per element, so the
// bytes bound it: 4 * (5*B*T*W + 2*B*W) (a, h and dh read once, dx and da
// written once, dhf in and d init_state out). The design is the forward's
// (csrc/rglru_scan.cu) run backwards in time: a block of kThreads threads
// owns kThreads neighbouring channels of one time chunk of kChunk steps,
// one channel a thread, and every (channel block, chunk) runs at once in
// one pass:
//   1. a block takes its (chunk, sequence, channel block) from an atomic
//      ticket, the last chunk first, so the chunks after its own in time
//      started before it and are resident or done: waiting on them cannot
//      deadlock;
//   2. it copies its chunk of a, dh and h (shifted one step back) into
//      shared memory by cp.async, all in flight at once (h read inside the
//      rerun of step 4 would wait on one load a step: the stores of dx and
//      da between keep the compiler from hoisting it), and runs the chunk
//      backwards from a zero carry: c_out = prod(a) c_in +
//      end, c_in the adjoint flowing in from the next step (a_{t+1}
//      g_{t+1}; dhf for the last chunk) and c_out the one it hands to the
//      step before (a_{t0} g_{t0});
//   3. it publishes that aggregate with a flag, then one warp waits for
//      the aggregates of every later chunk, and each thread folds them
//      into its c_in in one fixed order, from dhf at the last chunk down:
//      c = prod c + end. That is the sequential chain's own arithmetic, so
//      every block gets the same bits whatever the timing (the forward's
//      shortcut to the nearest published inclusive value would not: where
//      it stops changes the rounding);
//   4. it reruns the chunk from its c_in, writing dx and da (h_{t-1} of
//      the chunk's first step is the previous chunk's last row or the
//      initial state); the first chunk writes d init_state.
// The fold reads j aggregates in the j-th block done, ~nc^2 / 2 a channel
// in all: at recurrentgemma-9b's T = 2112 (33 chunks) 528 from L2, well
// under the bytes of a, h, dh, dx and da. Every value is computed by one
// thread in a fixed order: no float atomics, and two calls give the same
// bits. The flags are cleared by one cudaMemsetAsync on the call's stream
// before every launch (CUDA-graph replays included); a T of one chunk runs
// with no ticket, flag or memset.
//
// Plain C interface (bound from Python with ctypes). The caller allocates
// dx and da [B,T,W] contiguous, d init_state [B,W] (or null) and, for more
// than one chunk, the carries [2, B, nc-1, W] float32 and the flags
// [1 + B*nwb*nc] int32 (nwb = ceil(W / kThreads)); a, h and dh may be
// strided except along W; the initial state and dhf are contiguous.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;  // channels a block
constexpr int kChunk = 64;    // time steps a block

enum : int { kAggregate = 1 };  // a flag: 0 (cleared) until then

struct Args {
  const float* a;
  const float* h;
  const float* dh;
  const float* s0;   // the forward's initial state (null: zeros)
  const float* dsf;  // the final state's adjoint (null: zeros)
  float* dx;
  float* da;
  float* ds0;        // d init_state (null: not wanted)
  float* carries;    // [2][B][nc-1][W]: prod a, end from zero
  int* flags;        // [0]: the ticket; then [B][nwb][nc], by order done
  long long a_sb, a_st, h_sb, h_st, g_sb, g_st;
  int B, T, W, nc, nwb;
  int v16;  // rows of a, dh and h start on 16 bytes and W % 4 == 0
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ int load_flag(const int* f) {
  return *reinterpret_cast<const volatile int*>(f);
}

// Makes this block's writes to `carries` visible device-wide, then raises
// the flag (one thread).
__device__ __forceinline__ void publish(int* flag, int v) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *reinterpret_cast<volatile int*>(flag) = v;
}

// One warp waits until the blocks done before j (flags 0..j-1) have all
// published their aggregates, 32 flags at a time.
__device__ __forceinline__ void wait_for(const int* flag, int j, int lane) {
  for (int base = 0; base < j; base += 32) {
    const int k = base + lane;
    if (k < j)
      while (load_flag(flag + k) != kAggregate) {
      }
    __syncwarp();
  }
  __threadfence();
}

// Shared memory of a block: a, dh and h_{t-1} of the chunk's steps
struct Smem {
  float a[kChunk][kThreads], g[kChunk][kThreads], h[kChunk][kThreads];
};

__global__ void __launch_bounds__(kThreads) rglru_scan_bwd_kernel(Args p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  __shared__ int s_ticket;
  const int tid = threadIdx.x;
  int j = 0, b, wb;  // j: the order in which chunks are done, last first
  if (p.nc > 1) {
    if (tid == 0) s_ticket = atomicAdd(p.flags, 1);
    __syncthreads();
    const int per = p.B * p.nwb;
    j = s_ticket / per;
    b = (s_ticket % per) / p.nwb;
    wb = s_ticket % p.nwb;
  } else {
    b = blockIdx.x / p.nwb;
    wb = blockIdx.x % p.nwb;
  }
  const int c = p.nc - 1 - j;
  const int w = wb * kThreads + tid;
  const bool ok = w < p.W;
  const int t0 = c * kChunk, n = max(0, min(kChunk, p.T - t0));

  // every step of the chunk in flight at once; h row u of the chunk is
  // h_{t0+u-1} (row 0, the step before the chunk, is set below)
  if (p.v16) {  // a copy moves 4 channels of one step
    const int w0 = wb * kThreads;
    const float* ab = p.a + b * p.a_sb + w0 + t0 * p.a_st;
    const float* gb = p.dh + b * p.g_sb + w0 + t0 * p.g_st;
    const float* hb = p.h + b * p.h_sb + w0 + (t0 - 1) * p.h_st;
#pragma unroll 4
    for (int e = tid; e < n * (kThreads / 4); e += kThreads) {
      const int u = e / (kThreads / 4), q = 4 * (e % (kThreads / 4));
      if (w0 + q < p.W) {
        cp_async16(&sm.a[u][q], ab + u * p.a_st + q);
        cp_async16(&sm.g[u][q], gb + u * p.g_st + q);
        if (u > 0) cp_async16(&sm.h[u][q], hb + u * p.h_st + q);
      }
    }
    asm volatile("cp.async.wait_all;\n" ::);
    __syncthreads();
  } else if (ok) {  // a thread reads back only its own copies
    const float* ab = p.a + b * p.a_sb + w + t0 * p.a_st;
    const float* gb = p.dh + b * p.g_sb + w + t0 * p.g_st;
    const float* hb = p.h + b * p.h_sb + w + (t0 - 1) * p.h_st;
#pragma unroll 8
    for (int u = 0; u < n; ++u) {
      cp_async4(&sm.a[u][tid], ab + u * p.a_st);
      cp_async4(&sm.g[u][tid], gb + u * p.g_st);
      if (u > 0) cp_async4(&sm.h[u][tid], hb + u * p.h_st);
    }
    asm volatile("cp.async.wait_all;\n" ::);
  }
  if (ok && n > 0)  // h_{t0-1}: only this thread reads it
    sm.h[0][tid] = t0 > 0 ? p.h[b * p.h_sb + (t0 - 1) * p.h_st + w]
        : (p.s0 != nullptr ? p.s0[static_cast<long long>(b) * p.W + w] : 0.f);

  float carry = 0.f;  // c_in, folded from dhf at the last chunk down
  if (p.dsf != nullptr && ok)
    carry = p.dsf[static_cast<long long>(b) * p.W + w];
  const bool last = j == p.nc - 1;
  const long long plane = static_cast<long long>(p.B) * (p.nc - 1) * p.W;
  const long long col = static_cast<long long>(b) * (p.nc - 1) * p.W + w;
  int* flag = p.flags + 1 + (static_cast<long long>(b) * p.nwb + wb) * p.nc;
  if (!last) {  // the blocks done later fold this chunk's aggregate
    float prod = 1.f, end = 0.f;
    if (ok) {
#pragma unroll 8
      for (int u = n - 1; u >= 0; --u) {
        end = sm.a[u][tid] * (sm.g[u][tid] + end);
        prod *= sm.a[u][tid];
      }
      p.carries[col + j * p.W] = prod;
      p.carries[plane + col + j * p.W] = end;
    }
    publish(flag + j, kAggregate);
  }
  if (j > 0) {
    if (tid < 32) wait_for(flag, j, tid);
    __syncthreads();
    if (ok) {
#pragma unroll 8
      for (int k = 0; k < j; ++k) {  // the loads of 8 chunks at once
        const long long at = col + static_cast<long long>(k) * p.W;
        carry = fmaf(__ldcg(p.carries + at), carry,
                     __ldcg(p.carries + plane + at));
      }
    }
  }

  if (ok) {
    float s = carry;
    const long long row = static_cast<long long>(b) * p.T + t0;
#pragma unroll 8
    for (int u = n - 1; u >= 0; --u) {
      const float g = sm.g[u][tid] + s;
      p.dx[(row + u) * p.W + w] = g;
      p.da[(row + u) * p.W + w] = g * sm.h[u][tid];
      s = sm.a[u][tid] * g;
    }
    if (last && p.ds0 != nullptr)
      p.ds0[static_cast<long long>(b) * p.W + w] = s;
  }
}

}  // namespace

// s0, dsf and ds0 may be null. nc = max(1, ceil(T / chunk)); for nc > 1,
// `carries` holds at least 2*B*(nc-1)*W floats and `flags` n_flags = 1 + B*nwb*nc
// ints, cleared here; both may be null when nc == 1. `chunk` and `threads`
// are the wrapper's plan and must equal this file's. Strides are in
// elements (a, h, dh: batch, time); `v16` says that every row of a, dh and
// h starts on 16 bytes and W % 4 == 0. Returns the cudaError_t of the memset
// or the launch (0 on success).
extern "C" int rglru_scan_bwd(const void* a, const void* h, const void* dh,
                              const void* s0, const void* dsf, void* dx,
                              void* da, void* ds0, void* carries, void* flags,
                              int B, int T, int W, int chunk, int threads,
                              int n_flags, long long a_sb, long long a_st,
                              long long h_sb, long long h_st, long long g_sb,
                              long long g_st, int v16, void* stream) {
  if (chunk != kChunk || threads != kThreads) return cudaErrorInvalidValue;
  const int nc = T > kChunk ? (T + kChunk - 1) / kChunk : 1;
  const int nwb = (W + kThreads - 1) / kThreads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nc > 1) {
    if (carries == nullptr || flags == nullptr || n_flags != 1 + B * nwb * nc)
      return cudaErrorInvalidValue;
    const cudaError_t err = cudaMemsetAsync(flags, 0, sizeof(int) * n_flags, st);
    if (err != cudaSuccess) return err;
  }
  const Args p{static_cast<const float*>(a), static_cast<const float*>(h),
               static_cast<const float*>(dh), static_cast<const float*>(s0),
               static_cast<const float*>(dsf), static_cast<float*>(dx),
               static_cast<float*>(da), static_cast<float*>(ds0),
               static_cast<float*>(carries), static_cast<int*>(flags), a_sb,
               a_st, h_sb, h_st, g_sb, g_st, B, T, W, nc, nwb, v16};
  const cudaError_t err = cudaFuncSetAttribute(
      rglru_scan_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      sizeof(Smem));
  if (err != cudaSuccess) return err;
  rglru_scan_bwd_kernel<<<nc * B * nwb, kThreads, sizeof(Smem), st>>>(p);
  return cudaGetLastError();
}
