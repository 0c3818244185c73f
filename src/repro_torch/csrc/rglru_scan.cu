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
// associative scan across its 128-lane vectors and carries the state from
// chunk to chunk in order. Here a block of kThreads threads owns kThreads
// neighbouring channels of one time chunk of kChunk steps, one channel a
// thread (a warp reads 32 neighbouring channels of one step: coalesced),
// and every (channel block, chunk) runs at once, in one pass that reads a
// and x once (decoupled look-back, as in a single-pass prefix scan):
//   1. each block takes its (chunk, sequence, channel block) from an atomic
//      ticket, chunk-major, so a block's predecessor in time started
//      before it and is resident or done: waiting on it cannot deadlock
//      (numbering by blockIdx could leave a waiter resident and its
//      predecessor unscheduled);
//   2. it copies its chunk of a and x into shared memory by cp.async, 16
//      bytes (4 channels) a copy where the rows allow, all in flight at
//      once (loops over the steps, not unrolled into registers, keep the
//      code small for short T), and scans them from zero: (prod a, end
//      state);
//   3. it publishes that aggregate with a flag, then one warp looks back
//      over the flags of 32 predecessors at once for the nearest published
//      inclusive end with only aggregates between; those compose into its
//      carry; chunk 0's inclusive end is the initial state run through it;
//   4. it publishes its own inclusive end, rescans its chunk from shared
//      memory from the true carry writing h, and the last chunk writes the
//      final state.
// The flags live in a buffer the wrapper allocates and this file clears
// with one cudaMemsetAsync on the call's stream before every launch, so
// a call replayed from a CUDA graph starts from clear flags too (an epoch
// passed as an argument would be frozen in the graph). A T of one chunk
// (decode, short suffixes) runs the same kernel with no ticket, flag or
// memset.
//
// Plain C interface (bound from Python with ctypes). The caller allocates h
// [B,T,W] and the final state [B,W] contiguous and, for more than one
// chunk, the carries [3, B, nc-1, W] float32 and the flags [1 + B*nwb*nc]
// int32 (nwb = ceil(W / kThreads)); a and x may be strided except along W,
// the initial state is contiguous.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;  // channels a block
constexpr int kChunk = 64;    // time steps a block

enum : int { kEmpty = 0, kAggregate = 1, kInclusive = 2 };

struct Args {
  const float* a;
  const float* x;
  const float* s0;
  float* h;
  float* sf;
  float* carries;  // [3][B][nc-1][W]: prod a, end from zero, inclusive end
  int* flags;      // [0]: the ticket; then [B][nwb][nc]
  long long a_sb, a_st, x_sb, x_st;
  int B, T, W, nc, nwb;
  int v16;  // rows of a and x start on 16 bytes and W % 4 == 0
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

// The nearest chunk before c whose inclusive end is published, once every
// chunk between has published its aggregate. One warp reads the flags of
// 32 predecessors at once, nearest in lane 0, and spins until that holds;
// a window of aggregates only moves 32 chunks further back.
__device__ __forceinline__ int look_back(const int* flag, int c, int lane) {
  for (int base = c - 1;;) {
    const int k = base - lane;
    const int f = k >= 0 ? load_flag(flag + k) : kAggregate;
    const unsigned incl = __ballot_sync(0xffffffffu, f == kInclusive);
    const unsigned empty = __ballot_sync(0xffffffffu, f == kEmpty);
    if (incl != 0) {
      const int li = __ffs(incl) - 1;            // the nearest inclusive end
      if ((empty & ((1u << li) - 1u)) == 0) {
        __threadfence();
        return base - li;
      }
    } else if (empty == 0) {
      base -= 32;
    }
  }
}

__global__ void __launch_bounds__(kThreads) rglru_scan_kernel(Args p) {
  __shared__ float sa[kChunk][kThreads], sx[kChunk][kThreads];
  __shared__ int s_ticket, s_stop;
  const int tid = threadIdx.x;
  int c = 0, b, wb;
  if (p.nc > 1) {
    if (tid == 0) s_ticket = atomicAdd(p.flags, 1);
    __syncthreads();
    const int per = p.B * p.nwb;
    c = s_ticket / per;
    b = (s_ticket % per) / p.nwb;
    wb = s_ticket % p.nwb;
  } else {
    b = blockIdx.x / p.nwb;
    wb = blockIdx.x % p.nwb;
  }
  const int w = wb * kThreads + tid;
  const bool ok = w < p.W;
  const int t0 = c * kChunk, n = min(kChunk, p.T - t0);

  // every step of the chunk in flight at once
  if (p.v16) {  // a copy moves 4 channels of one step
    const int w0 = wb * kThreads;
    const float* ab = p.a + b * p.a_sb + w0 + t0 * p.a_st;
    const float* xb = p.x + b * p.x_sb + w0 + t0 * p.x_st;
#pragma unroll 4
    for (int e = tid; e < n * (kThreads / 4); e += kThreads) {
      const int u = e / (kThreads / 4), q = 4 * (e % (kThreads / 4));
      if (w0 + q < p.W) {
        cp_async16(&sa[u][q], ab + u * p.a_st + q);
        cp_async16(&sx[u][q], xb + u * p.x_st + q);
      }
    }
    asm volatile("cp.async.wait_all;\n" ::);
    __syncthreads();
  } else if (ok) {  // a thread reads back only its own copies
    const float* ab = p.a + b * p.a_sb + w + t0 * p.a_st;
    const float* xb = p.x + b * p.x_sb + w + t0 * p.x_st;
#pragma unroll 8
    for (int u = 0; u < n; ++u) {
      cp_async4(&sa[u][tid], ab + u * p.a_st);
      cp_async4(&sx[u][tid], xb + u * p.x_st);
    }
    asm volatile("cp.async.wait_all;\n" ::);
  }

  float carry = 0.f;
  if (c == 0 && p.s0 != nullptr && ok)
    carry = p.s0[static_cast<long long>(b) * p.W + w];
  const bool last = c == p.nc - 1;
  const long long plane = static_cast<long long>(p.B) * (p.nc - 1) * p.W;
  const long long col = static_cast<long long>(b) * (p.nc - 1) * p.W + w;
  int* flag = p.flags + 1 + (static_cast<long long>(b) * p.nwb + wb) * p.nc;
  float prod = 1.f, end = 0.f;
  if (!last && ok) {  // a successor reads this chunk's carries
#pragma unroll 8
    for (int u = 0; u < n; ++u) {
      end = fmaf(sa[u][tid], end, sx[u][tid]);
      prod *= sa[u][tid];
    }
  }
  if (c > 0) {
    if (!last) {
      if (ok) {
        p.carries[col + c * p.W] = prod;
        p.carries[plane + col + c * p.W] = end;
      }
      publish(flag + c, kAggregate);
    }
    if (tid < 32) {
      const int stop = look_back(flag, c, tid);
      if (tid == 0) s_stop = stop;
    }
    __syncthreads();
    const int stop = s_stop;
    if (ok) {  // carry = (a's of chunks stop+1..c-1) applied to stop's end
      float pa = 1.f, ea = 0.f;
#pragma unroll 8
      for (int k = c - 1; k > stop; --k) {  // the loads of 8 steps at once
        const long long at = col + static_cast<long long>(k) * p.W;
        ea = fmaf(pa, __ldcg(p.carries + plane + at), ea);
        pa *= __ldcg(p.carries + at);
      }
      carry = fmaf(pa, __ldcg(p.carries + 2 * plane + col +
                              static_cast<long long>(stop) * p.W), ea);
    }
  }
  if (!last) {
    if (ok) p.carries[2 * plane + col + c * p.W] = fmaf(prod, carry, end);
    publish(flag + c, kInclusive);
  }

  if (ok) {
    float s = carry;
    float* hb = p.h + (static_cast<long long>(b) * p.T + t0) * p.W + w;
#pragma unroll 8
    for (int u = 0; u < n; ++u) {
      s = fmaf(sa[u][tid], s, sx[u][tid]);
      hb[static_cast<long long>(u) * p.W] = s;
    }
    if (last) p.sf[static_cast<long long>(b) * p.W + w] = s;
  }
}

}  // namespace

// s0 may be null (zero initial state). nc = max(1, ceil(T / chunk)); for
// nc > 1, `carries` holds 3*B*(nc-1)*W floats and `flags` n_flags =
// 1 + B*nwb*nc ints, cleared here; both may be null when nc == 1. `chunk`
// and `threads` are the wrapper's plan and must equal this file's. Strides
// are in elements; `v16` says that every row of a and x starts on 16 bytes
// and W % 4 == 0 (16-byte copies). Returns the cudaError_t of the memset or the launch (0
// on success).
extern "C" int rglru_scan_fwd(const void* a, const void* x, const void* s0,
                              void* h, void* sf, void* carries, void* flags,
                              int B, int T, int W, int chunk, int threads,
                              int n_flags, long long a_sb, long long a_st,
                              long long x_sb, long long x_st, int v16,
                              void* stream) {
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
  const Args p{static_cast<const float*>(a), static_cast<const float*>(x),
               static_cast<const float*>(s0), static_cast<float*>(h),
               static_cast<float*>(sf), static_cast<float*>(carries),
               static_cast<int*>(flags), a_sb, a_st, x_sb, x_st, B, T, W, nc,
               nwb, v16};
  rglru_scan_kernel<<<nc * B * nwb, kThreads, 0, st>>>(p);
  return cudaGetLastError();
}
