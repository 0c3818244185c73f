// Mamba2 SSD (state-space duality) scan for Hopper (sm_90a), float32.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py::ssd_chunked
// (Pallas, body `_kernel`). Same function:
//     s_t = exp(dt_t * A_h) * s_{t-1} + dt_t * x_t B_t^T     (s: [hd, N])
//     y_t = C_t s_t                                            (D * x_t is
// added by the wrapper, outside the kernel, as in the TPU kernel)
// x [Bz,T,H,hd], B/C [Bz,T,N], dt [Bz,T,H], A [H], init_state [Bz,H,hd,N]
// (or null for zeros); outputs y [Bz,T,H,hd] and the final state
// [Bz,H,hd,N], both float32. Any T works, including T=1 (decode) and a
// ragged T: the time loop simply stops at T, which is what the TPU
// kernel's dt=0 padding amounts to.
//
// Design. The TPU kernel recasts the recurrence per chunk of Q steps as
// matrix products for the MXU (C B^T, the masked decay matrix L, C s^T,
// x^T B), about 1.7x the flops of the recurrence at Q=64. On the H100 in
// float32 those products would run on the CUDA cores (TF32 tensor cores
// keep ~3 decimal digits, short of the 1e-4 the kernel is held to), so this
// kernel runs the recurrence itself, 4*hd*N flops per step, with the state
// in registers:
//   * one block of 128 threads per (sequence, head, tile of kRows state
//     rows): kOwners threads per row d, each owning N/kOwners columns
//     interleaved by float4 (n = 4*kOwners*j + 4*q + i), so that the
//     shared-memory reads of B_t and C_t are conflict-free broadcasts;
//     16-row tiles give 256 blocks at the prefill shape, two per SM;
//   * time is walked in chunks of kChunk steps, double-buffered in shared
//     memory: while the block runs the steps of one chunk, cp.async copies
//     of the next chunk's B, C, x and dt are in flight (copied between
//     barriers instead, one load at a time per thread, their ~0.3 us
//     latency set the whole time); exp(dt*A) is taken once per step and
//     chunk, and the chunk's y tile is written back coalesced;
//   * a step has no cross-thread dependency: each owner keeps its partial
//     readout of y_t[d] in shared memory (four independent FMA chains), and
//     the kOwners partials are summed when the chunk's y tile is written.
// Bound on the H100: at the prefill shape (Bz=1, T=256, H=64, hd=64,
// N=128) the 0.54 GFLOP of the recurrence take 8 us at the 67 TFLOP/s of
// float32, more than its 10.8 MB of bytes; a decode step (T=1, Bz=8) reads
// and writes 16.8 MB of state each way and is bound by bytes (10 us). The
// time loop is sequential inside a block, and every block stages the same
// B and C from L2 (the redundancy a block over several heads would cut).
//
// Plain C interface (bound from Python with ctypes). The caller allocates y
// and the final state contiguous; x, B, C and dt may be strided except
// along their last axis (x, B, C); B and C rows and init_state are 16-byte
// aligned (the wrapper copies what is not).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 16;              // time steps staged per pass

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_prev() {  // all but the newest group
  asm volatile("cp.async.wait_group 1;\n" ::);
}

struct Strides {  // element strides; t = time, h = head
  long long xb, xt, xh, bb, bt, cb, ct, db, dt, dh;
};

template <int N>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ Bm,
                const float* __restrict__ Cm, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ s0,
                float* __restrict__ y, float* __restrict__ sf, int T, int H,
                int hd, Strides st) {
  static_assert(N % 16 == 0, "N must be a multiple of 16");
  constexpr int kOwners = N >= 32 ? 8 : 4;       // threads per state row
  constexpr int kRows = kThreads / kOwners;      // state rows per block
  constexpr int kStride = 4 * kOwners;           // columns between groups
  constexpr int kJ = N / kStride;                // float4 groups per thread
  __shared__ __align__(16) float b_s[2][kChunk][N];
  __shared__ __align__(16) float c_s[2][kChunk][N];
  __shared__ float x_s[2][kChunk][kRows];
  __shared__ float dt_s[2][kChunk];
  __shared__ float yp_s[kChunk][kRows][kOwners];  // partial readouts
  __shared__ float decay_s[kChunk];

  const int tid = threadIdx.x;
  const int r = tid / kOwners, q = tid % kOwners;
  const int tiles = (hd + kRows - 1) / kRows;
  const int tile = blockIdx.x % tiles;
  const int h = (blockIdx.x / tiles) % H;
  const int b = blockIdx.x / (tiles * H);
  const int d0 = tile * kRows;
  const int d = d0 + r;
  const bool row_ok = d < hd;
  const float a = A[h];
  const long long srow = ((static_cast<long long>(b) * H + h) * hd + d) * N;

  float s[4 * kJ];
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (s0 != nullptr && row_ok)
      v = *reinterpret_cast<const float4*>(s0 + srow + kStride * j + 4 * q);
    s[4 * j] = v.x; s[4 * j + 1] = v.y; s[4 * j + 2] = v.z; s[4 * j + 3] = v.w;
  }

  const float* xb = x + b * st.xb + h * st.xh;
  const float* bb = Bm + b * st.bb;
  const float* cb = Cm + b * st.cb;
  const float* db = dt + b * st.db + h * st.dh;
  // copies of the chunk at t0 into buffer buf (rows past T are not read)
  auto fetch = [&](int t0, int buf) {
    const int nt = min(kChunk, T - t0);
    for (int e = tid; e < nt * (N / 4); e += kThreads) {
      const int t = e / (N / 4), n = 4 * (e % (N / 4));
      cp_async16(&b_s[buf][t][n], bb + (t0 + t) * st.bt + n);
      cp_async16(&c_s[buf][t][n], cb + (t0 + t) * st.ct + n);
    }
    for (int e = tid; e < nt * kRows; e += kThreads) {
      const int t = e / kRows, dd = d0 + e % kRows;
      if (dd < hd)
        cp_async4(&x_s[buf][t][e % kRows], xb + (t0 + t) * st.xt + dd);
      else
        x_s[buf][t][e % kRows] = 0.f;
    }
    if (tid < nt) cp_async4(&dt_s[buf][tid], db + (t0 + tid) * st.dt);
  };

  fetch(0, 0);
  cp_async_commit();
  for (int t0 = 0, buf = 0; t0 < T; t0 += kChunk, buf ^= 1) {
    const int nt = min(kChunk, T - t0);
    // the other buffer's steps ended at the last barrier of the previous
    // pass: refill it with the next chunk while this one runs
    if (t0 + kChunk < T) fetch(t0 + kChunk, buf ^ 1);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();                             // this chunk has landed
    if (tid < nt) decay_s[tid] = expf(dt_s[buf][tid] * a);
    __syncthreads();

    for (int t = 0; t < nt; ++t) {
      const float decay = decay_s[t];
      const float xw = dt_s[buf][t] * x_s[buf][t][r];
      float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f, acc3 = 0.f;
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const int n = kStride * j + 4 * q;
        const float4 bv = *reinterpret_cast<const float4*>(&b_s[buf][t][n]);
        const float4 cv = *reinterpret_cast<const float4*>(&c_s[buf][t][n]);
        s[4 * j] = fmaf(s[4 * j], decay, xw * bv.x);
        s[4 * j + 1] = fmaf(s[4 * j + 1], decay, xw * bv.y);
        s[4 * j + 2] = fmaf(s[4 * j + 2], decay, xw * bv.z);
        s[4 * j + 3] = fmaf(s[4 * j + 3], decay, xw * bv.w);
        acc0 = fmaf(cv.x, s[4 * j], acc0);
        acc1 = fmaf(cv.y, s[4 * j + 1], acc1);
        acc2 = fmaf(cv.z, s[4 * j + 2], acc2);
        acc3 = fmaf(cv.w, s[4 * j + 3], acc3);
      }
      yp_s[t][r][q] = (acc0 + acc1) + (acc2 + acc3);
    }
    // partials complete; this chunk's buffer is free again (the next pass's
    // first barrier orders these reads of yp_s before its steps)
    __syncthreads();

    for (int e = tid; e < nt * kRows; e += kThreads) {
      const int t = e / kRows, rr = e % kRows;
      if (d0 + rr < hd) {
        float v = 0.f;
#pragma unroll
        for (int o = 0; o < kOwners; ++o) v += yp_s[t][rr][o];
        y[((static_cast<long long>(b) * T + t0 + t) * H + h) * hd + d0 + rr] =
            v;
      }
    }
  }

  if (row_ok) {
#pragma unroll
    for (int j = 0; j < kJ; ++j)
      *reinterpret_cast<float4*>(sf + srow + kStride * j + 4 * q) =
          make_float4(s[4 * j], s[4 * j + 1], s[4 * j + 2], s[4 * j + 3]);
  }
}

template <int N>
cudaError_t launch(const float* x, const float* Bm, const float* Cm,
                   const float* dt, const float* A, const float* s0, float* y,
                   float* sf, int Bz, int T, int H, int hd, Strides st,
                   cudaStream_t stream) {
  constexpr int kRows = kThreads / (N >= 32 ? 8 : 4);
  const int tiles = (hd + kRows - 1) / kRows;
  ssd_scan_kernel<N><<<Bz * H * tiles, kThreads, 0, stream>>>(
      x, Bm, Cm, dt, A, s0, y, sf, T, H, hd, st);
  return cudaGetLastError();
}

}  // namespace

// All tensors float32. Strides are in elements; s0 may be null (zero
// initial state). Returns the cudaError_t of the launch.
extern "C" int ssd_scan_fwd(
    const void* x, const void* Bm, const void* Cm, const void* dt,
    const void* A, const void* s0, void* y, void* sf, int Bz, int T, int H,
    int hd, int N, long long x_sb, long long x_st, long long x_sh,
    long long b_sb, long long b_st, long long c_sb, long long c_st,
    long long dt_sb, long long dt_st, long long dt_sh, void* stream) {
  const Strides st{x_sb, x_st, x_sh, b_sb, b_st, c_sb, c_st, dt_sb, dt_st,
                   dt_sh};
  const float* xf = static_cast<const float*>(x);
  const float* bf = static_cast<const float*>(Bm);
  const float* cf = static_cast<const float*>(Cm);
  const float* df = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(A);
  const float* s0f = static_cast<const float*>(s0);
  float* yf = static_cast<float*>(y);
  float* sff = static_cast<float*>(sf);
  cudaStream_t str = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 16: return launch<16>(xf, bf, cf, df, af, s0f, yf, sff, Bz, T, H, hd, st, str);
    case 32: return launch<32>(xf, bf, cf, df, af, s0f, yf, sff, Bz, T, H, hd, st, str);
    case 64: return launch<64>(xf, bf, cf, df, af, s0f, yf, sff, Bz, T, H, hd, st, str);
    case 128: return launch<128>(xf, bf, cf, df, af, s0f, yf, sff, Bz, T, H, hd, st, str);
    default: return cudaErrorInvalidValue;
  }
}
