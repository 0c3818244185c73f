// Mamba2 SSD (state-space duality) scan for Hopper (sm_90a), float32.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py::ssd_chunked
// (Pallas, body `_kernel`). Same function:
//     s_t = exp(dt_t * A_h) * s_{t-1} + dt_t * x_t B_t^T     (s: [hd, N])
//     y_t = C_t s_t + D_h * x_t
// x [Bz,T,H,hd], B/C [Bz,T,N], dt [Bz,T,H], A/D [H], init_state [Bz,H,hd,N]
// (or null for zeros); outputs y [Bz,T,H,hd] and the final state
// [Bz,H,hd,N], both float32. The final state may be written over the
// initial state (decode updates its cache in place): each block reads its
// own state rows before it writes them, and no other block touches them.
//
// Two kernels; the wrapper picks one by T alone (`ssd_plan` in
// kernels/ssd_scan.py):
//
// * gram_kernel + dual_kernel, the chunked dual form on tensor cores
//   (prefill). As the TPU kernel does, time is cut into chunks of kQ = 64
//   steps and each chunk is four matrix products, with cs the in-chunk
//   cumsum of dt*A:
//       G = C B^T                          [Q, Q], the same for every head
//       y = exp(cs) (C s^T) + (G o L) x + D x,  L[t,u] = exp(cs_t-cs_u) dt_u
//       s = exp(cs_Q) s + (x o w)^T B,     w_u = exp(cs_Q - cs_u) dt_u
//   gram_kernel makes G for every chunk once (made in each of dual_kernel's
//   blocks it was over half their tensor work); dual_kernel is launched as
//   its programmatic dependent, so its blocks stage their first chunk while
//   G is made and wait for it only where they copy G. dual_kernel runs one
//   block per (sequence, head, tile of kRows = 32 state rows), which walks
//   its chunks in order with the [32, N] state carried in registers (and in
//   shared memory, where the next chunk's C s^T reads it): 128 blocks at
//   mamba2-1.3b's prefill shape, one an SM (204 KB of shared memory at
//   N = 128). A block is 16 product warps and 4 staging warps. The staging
//   warps copy the next chunk's B, C, G, x and dt by cp.async into a
//   two-stage ring and make cs and w while the product warps run this
//   chunk: every block stages the same B and C from L2, and copied by the
//   product warps between their products those copies stalled them for a
//   quarter of each chunk (one staging warp cannot keep enough copies in
//   flight; 4 do). The products run on mma.sync.m16n8k8 TF32 tensor cores
//   in 3xTF32: each float32 operand v is split as it is loaded into hi = v
//   cut to TF32 and lo = v - hi, and a product is lo*hi' + hi*lo' + hi*hi'
//   with float32 accumulation (the cross terms and hi*hi' in separate
//   accumulators, two dependency chains), about 2^-20 relative per
//   product, where one TF32 product (2^-11) misses the 1e-4 the kernel is
//   held to (tests/test_torch_ssm.py emulates both). Row-major operands
//   are loaded by ldmatrix. The decay L, the exponentials and the cumsum
//   stay float32 on the CUDA cores; G o L is made in place, causal tiles
//   only. Serial chain at T = 256: 4 chunks, not 256 steps. Ragged T: rows
//   past T are staged as zeros with dt = 0, which keeps the state (decay
//   exp(0) = 1, weight 0), the TPU kernel's padding, and a short last chunk
//   skips the row tiles wholly past T.
//   Bound at the prefill shape (Bz=1, T=256, H=64, hd=64, N=128): the
//   products (G once per sequence and chunk, causal halves) are 0.61 GFLOP,
//   1.82 GFLOP of tensor work in 3xTF32, 3.7 us at 495 TFLOP/s; the bytes
//   (10.8 MB) take 3.2 us. mma.sync does not reach that peak (wgmma does).
//
// * rec_kernel, the recurrence itself (decode T = 1, suffixes of up to 32
//   steps, where it is faster on the card: a chunk of a few steps has
//   little product to speed up). 4*hd*N flops a
//   step with the state in registers: one block of 128 threads per
//   (sequence, head, tile of kRows state rows), kOwners threads per row,
//   each owning N/kOwners columns interleaved by float4 so that the
//   shared-memory reads of B_t and C_t are conflict-free broadcasts; time
//   in chunks of 16 steps double-buffered by cp.async; each owner keeps
//   its partial readout of y_t[d] in shared memory and the partials are
//   summed when the chunk's y tile is written. A decode step (Bz=8) reads
//   and writes 16.8 MB of state and is bound by those bytes.
//
// Plain C interface (bound from Python with ctypes). The caller allocates y
// and the final state contiguous; x, B, C and dt may be strided except
// along their last axis (x, B, C); B and C rows and the states are 16-byte
// aligned (the wrapper copies what is not).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

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

struct Args {
  const float* x;
  const float* B;
  const float* C;
  const float* dt;
  const float* A;
  const float* D;
  const float* s0;  // may alias sf
  float* y;
  float* sf;
  float* gram;      // dual form: G = C B^T of every chunk, [Bz, nc, 64, 64]
  int x16;          // rows of x start on 16 bytes (the dual form copies 4
                    // head dims at once)
  int T, H, hd;
  Strides st;
};

// ------------------------------------------------------------ recurrence
namespace rec {

constexpr int kThreads = 128;
constexpr int kChunk = 16;              // time steps staged per pass

template <int N>
struct Shape {
  static constexpr int kOwners = N >= 32 ? 8 : 4;   // threads per state row
  static constexpr int kRows = kThreads / kOwners;  // state rows per block
  static constexpr int kStride = 4 * kOwners;       // columns between groups
  static constexpr int kJ = N / kStride;            // float4 groups a thread
};

template <int N>
struct Smem {
  static constexpr int kRows = Shape<N>::kRows;
  float b[2][kChunk][N];
  float c[2][kChunk][N];
  float x[2][kChunk][kRows];
  float dt[2][kChunk];
  float yp[kChunk][kRows][Shape<N>::kOwners];  // partial readouts
  float decay[kChunk];
};

template <int N>
__global__ void __launch_bounds__(kThreads) rec_kernel(Args p) {
  static_assert(N % 16 == 0, "N must be a multiple of 16");
  constexpr int kOwners = Shape<N>::kOwners, kRows = Shape<N>::kRows;
  constexpr int kStride = Shape<N>::kStride, kJ = Shape<N>::kJ;
  __shared__ __align__(16) Smem<N> sm;

  const int tid = threadIdx.x;
  const int r = tid / kOwners, q = tid % kOwners;
  const int T = p.T, H = p.H, hd = p.hd;
  const Strides& st = p.st;
  const int tiles = (hd + kRows - 1) / kRows;
  const int tile = blockIdx.x % tiles;
  const int h = (blockIdx.x / tiles) % H;
  const int b = blockIdx.x / (tiles * H);
  const int d0 = tile * kRows;
  const int d = d0 + r;
  const bool row_ok = d < hd;
  const float a = p.A[h], dh = p.D[h];
  const long long srow = ((static_cast<long long>(b) * H + h) * hd + d) * N;

  float s[4 * kJ];
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (p.s0 != nullptr && row_ok)
      v = *reinterpret_cast<const float4*>(p.s0 + srow + kStride * j + 4 * q);
    s[4 * j] = v.x; s[4 * j + 1] = v.y; s[4 * j + 2] = v.z; s[4 * j + 3] = v.w;
  }

  const float* xb = p.x + b * st.xb + h * st.xh;
  const float* bb = p.B + b * st.bb;
  const float* cb = p.C + b * st.cb;
  const float* db = p.dt + b * st.db + h * st.dh;
  // copies of the chunk at t0 into buffer buf (rows past T are not read)
  auto fetch = [&](int t0, int buf) {
    const int nt = min(kChunk, T - t0);
    for (int e = tid; e < nt * (N / 4); e += kThreads) {
      const int t = e / (N / 4), n = 4 * (e % (N / 4));
      cp_async16(&sm.b[buf][t][n], bb + (t0 + t) * st.bt + n);
      cp_async16(&sm.c[buf][t][n], cb + (t0 + t) * st.ct + n);
    }
    for (int e = tid; e < nt * kRows; e += kThreads) {
      const int t = e / kRows, dd = d0 + e % kRows;
      if (dd < hd)
        cp_async4(&sm.x[buf][t][e % kRows], xb + (t0 + t) * st.xt + dd);
      else
        sm.x[buf][t][e % kRows] = 0.f;
    }
    if (tid < nt) cp_async4(&sm.dt[buf][tid], db + (t0 + tid) * st.dt);
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
    if (tid < nt) sm.decay[tid] = expf(sm.dt[buf][tid] * a);
    __syncthreads();

    for (int t = 0; t < nt; ++t) {
      const float decay = sm.decay[t];
      const float xv = sm.x[buf][t][r];
      const float xw = sm.dt[buf][t] * xv;
      float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f, acc3 = 0.f;
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const int n = kStride * j + 4 * q;
        const float4 bv = *reinterpret_cast<const float4*>(&sm.b[buf][t][n]);
        const float4 cv = *reinterpret_cast<const float4*>(&sm.c[buf][t][n]);
        s[4 * j] = fmaf(s[4 * j], decay, xw * bv.x);
        s[4 * j + 1] = fmaf(s[4 * j + 1], decay, xw * bv.y);
        s[4 * j + 2] = fmaf(s[4 * j + 2], decay, xw * bv.z);
        s[4 * j + 3] = fmaf(s[4 * j + 3], decay, xw * bv.w);
        acc0 = fmaf(cv.x, s[4 * j], acc0);
        acc1 = fmaf(cv.y, s[4 * j + 1], acc1);
        acc2 = fmaf(cv.z, s[4 * j + 2], acc2);
        acc3 = fmaf(cv.w, s[4 * j + 3], acc3);
      }
      // the first owner of the row adds D * x_t[d]
      sm.yp[t][r][q] = (acc0 + acc1) + (acc2 + acc3) + (q == 0 ? dh * xv : 0.f);
    }
    // partials complete; this chunk's buffer is free again (the next pass's
    // first barrier orders these reads of yp before its steps)
    __syncthreads();

    for (int e = tid; e < nt * kRows; e += kThreads) {
      const int t = e / kRows, rr = e % kRows;
      if (d0 + rr < hd) {
        float v = 0.f;
#pragma unroll
        for (int o = 0; o < kOwners; ++o) v += sm.yp[t][rr][o];
        p.y[((static_cast<long long>(b) * T + t0 + t) * H + h) * hd + d0 + rr] =
            v;
      }
    }
  }

  if (row_ok) {
#pragma unroll
    for (int j = 0; j < kJ; ++j)
      *reinterpret_cast<float4*>(p.sf + srow + kStride * j + 4 * q) =
          make_float4(s[4 * j], s[4 * j + 1], s[4 * j + 2], s[4 * j + 3]);
  }
}

template <int N>
cudaError_t launch(const Args& p, int Bz, int smem, cudaStream_t stream) {
  if (smem != static_cast<int>(sizeof(Smem<N>))) return cudaErrorInvalidValue;
  const int tiles = (p.hd + Shape<N>::kRows - 1) / Shape<N>::kRows;
  rec_kernel<N><<<Bz * p.H * tiles, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace rec

// ------------------------------------------------------------- dual form
namespace dual {

constexpr int kQ = 64;          // chunk length
constexpr int kRows = 32;       // state rows (of hd) a block
constexpr int kWarps = 16;      // the warps that run the products
constexpr int kConsumers = 32 * kWarps;
constexpr int kStagers = 4;     // and the warps that stage the chunks
constexpr int kThreads = kConsumers + 32 * kStagers;
// named barriers (0 is __syncthreads): a chunk has landed; a chunk's
// buffers are free; the product warps among themselves
constexpr int kFull = 1, kEmpty = 2, kProducts = 3;
constexpr int kXs = kRows + 8;  // x row stride: 40 = 8 (mod 32 banks)
constexpr int kGs = kQ + 4;     // G row stride: 68 = 4 (mod 32 banks)

// Row strides of B, C and the state are N + 4 floats: a fragment load
// whose 8 rows are indexed by the lane's group (lane / 4) and whose
// columns by its index in the group (lane % 4) hits 32 banks. The state
// update reads B the other way round (2-way conflicts).
template <int N>
struct Smem {
  static constexpr int kBs = N + 4;
  float b[2][kQ][kBs];
  float c[2][kQ][kBs];
  float x[2][kQ][kXs];
  float dt[2][kQ];
  float cs[2][kQ];       // in-chunk cumsum of dt * A
  float w[2][kQ];        // exp(cs_Q - cs_u) dt_u
  float g[2][kQ][kGs];   // G from gram_kernel, made G o L in place
  float s[kRows][kBs];   // the state entering the chunk
};

// G = C B^T of every chunk, [Bz, nc, kQ, kQ]: the heads share B and C, so
// G is made once here and not in each of the H * hd / kRows blocks of
// dual_kernel (where it took over half the tensor work). A block of 4
// warps per (sequence, chunk, 16 rows of G); a warp takes the column
// tiles w and w + 4 of these rows, computes those at or left of the
// diagonal in 3xTF32 and writes the others as zeros. Rows and columns past
// T come out zero (their B and C are staged as zeros).
constexpr int kGramWarps = 4;

template <int N>
__global__ void __launch_bounds__(32 * kGramWarps) gram_kernel(Args p) {
  constexpr int kBs = N + 4;
  __shared__ __align__(16) float crow[16][kBs];
  __shared__ __align__(16) float brow[kQ][kBs];
  // dual_kernel may start now: it waits for this grid before it reads G
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nc = (p.T + kQ - 1) / kQ;
  const int mi = blockIdx.x % (kQ / 16);
  const int c = (blockIdx.x / (kQ / 16)) % nc;
  const int b = blockIdx.x / ((kQ / 16) * nc);
  const int t0 = c * kQ, nt = min(kQ, p.T - t0);
  const int rows = 16 * (mi + 1);        // B rows up to the diagonal
  const float* bb = p.B + b * p.st.bb + t0 * p.st.bt;
  const float* cb = p.C + b * p.st.cb + t0 * p.st.ct;
  for (int e = tid; e < (16 + rows) * (N / 4); e += 32 * kGramWarps) {
    const int r = e / (N / 4), n = 4 * (e % (N / 4));
    const bool is_c = r < 16;
    const int t = is_c ? 16 * mi + r : r - 16;
    float* dst = is_c ? &crow[r][n] : &brow[t][n];
    if (t < nt)
      cp_async16(dst, (is_c ? cb + t * p.st.ct : bb + t * p.st.bt) + n);
    else
      *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
  const int diag = 2 * mi + 1;
  Acc acc[2];
  acc[0].zero();
  acc[1].zero();
#pragma unroll
  for (int k0 = 0; k0 < N; k0 += 8) {
    A4 af;
    load_a(af, &crow[0][0], kBs, 0, k0, lane);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (warp + 4 * j <= diag) {
        B2 bf;
        load_b_nk(bf, &brow[0][0], kBs, 8 * (warp + 4 * j), k0, lane);
        mma3(acc[j], af, bf);
      }
    }
  }
  float* out = p.gram + (static_cast<long long>(b) * nc + c) * kQ * kQ;
  const int ta = 16 * mi + (lane >> 2);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int u = 8 * (warp + 4 * j) + 2 * (lane & 3);
    *reinterpret_cast<float2*>(out + ta * kQ + u) =
        make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(out + (ta + 8) * kQ + u) =
        make_float2(acc[j][2], acc[j][3]);
  }
}

// The staging warps (thread `pt` of them): copies of chunk c into buffer
// buf (rows past T are zeros with dt = 0), the initial state with chunk 0;
// dt goes by the first staging warp, which makes the cumsum.
template <int N>
__device__ __forceinline__ void stage(const Args& p, Smem<N>& sm, int c,
                                      int buf, int pt, int b, int h,
                                      int d0) {
  constexpr int kStep = 32 * kStagers;
  const Strides& st = p.st;
  const int t0 = c * kQ, nt = min(kQ, p.T - t0);
  const float* bb = p.B + b * st.bb + t0 * st.bt;
  const float* cb = p.C + b * st.cb + t0 * st.ct;
  const float* xb = p.x + b * st.xb + h * st.xh + t0 * st.xt + d0;
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int e = pt; e < kQ * (N / 4); e += kStep) {
    const int t = e / (N / 4), n = 4 * (e % (N / 4));
    if (t < nt) {
      cp_async16(&sm.b[buf][t][n], bb + t * st.bt + n);
      cp_async16(&sm.c[buf][t][n], cb + t * st.ct + n);
    } else {
      *reinterpret_cast<float4*>(&sm.b[buf][t][n]) = z;
      *reinterpret_cast<float4*>(&sm.c[buf][t][n]) = z;
    }
  }
  if (p.x16) {  // rows of x on 16 bytes: a copy moves 4 head dims
    for (int e = pt; e < kQ * (kRows / 4); e += kStep) {
      const int t = e / (kRows / 4), r = 4 * (e % (kRows / 4));
      if (t < nt && d0 + r < p.hd)
        cp_async16(&sm.x[buf][t][r], xb + t * st.xt + r);
      else
        *reinterpret_cast<float4*>(&sm.x[buf][t][r]) = z;
    }
  } else {
    for (int e = pt; e < kQ * kRows; e += kStep) {
      const int t = e / kRows, r = e % kRows;
      if (t < nt && d0 + r < p.hd)
        cp_async4(&sm.x[buf][t][r], xb + t * st.xt + r);
      else
        sm.x[buf][t][r] = 0.f;
    }
  }
  // G comes from gram_kernel, which may still run (dual_kernel is its
  // programmatic dependent): chunk 0's other copies go first
  if (c == 0) asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const float* gb = p.gram + (static_cast<long long>(b) * ((p.T + kQ - 1) / kQ)
                              + c) * kQ * kQ;
  for (int e = pt; e < kQ * (kQ / 4); e += kStep) {
    const int t = e / (kQ / 4), u = 4 * (e % (kQ / 4));
    cp_async16(&sm.g[buf][t][u], gb + t * kQ + u);
  }
  const float* db = p.dt + b * st.db + h * st.dh + t0 * st.dt;
  for (int t = pt; pt < 32 && t < kQ; t += 32) {
    if (t < nt)
      cp_async4(&sm.dt[buf][t], db + t * st.dt);
    else
      sm.dt[buf][t] = 0.f;
  }
  if (c == 0) {  // the initial state (rows past hd stay zero)
    const long long sbase = (static_cast<long long>(b) * p.H + h) * p.hd * N;
    for (int e = pt; e < kRows * (N / 4); e += kStep) {
      const int r = e / (N / 4), n = 4 * (e % (N / 4));
      if (p.s0 != nullptr && d0 + r < p.hd)
        cp_async16(&sm.s[r][n], p.s0 + sbase + (d0 + r) * N + n);
      else
        *reinterpret_cast<float4*>(&sm.s[r][n]) = z;
    }
  }
  cp_async_commit();
}

// The first staging warp: the cumsum cs of dt * A over the chunk in
// buffer buf and the state update's weights w
template <int N>
__device__ __forceinline__ void decays(Smem<N>& sm, int buf, int lane,
                                       float a) {
  __syncwarp();  // dt of the chunk, copied by this warp's lanes
  const float u0 = sm.dt[buf][lane], u1 = sm.dt[buf][lane + 32];
  float v0 = u0 * a, v1 = u1 * a;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float w0 = __shfl_up_sync(0xffffffffu, v0, o);
    const float w1 = __shfl_up_sync(0xffffffffu, v1, o);
    if (lane >= o) { v0 += w0; v1 += w1; }
  }
  v1 += __shfl_sync(0xffffffffu, v0, 31);
  const float cq = __shfl_sync(0xffffffffu, v1, 31);
  sm.cs[buf][lane] = v0;
  sm.cs[buf][lane + 32] = v1;
  sm.w[buf][lane] = expf(cq - v0) * u0;
  sm.w[buf][lane + 32] = expf(cq - v1) * u1;
}

template <int N>
__global__ void __launch_bounds__(kThreads, 1) dual_kernel(Args p) {
  static_assert(N % 16 == 0, "N must be a multiple of 16");
  constexpr int kBs = N + 4;
  constexpr int kStateTiles = (kRows / 16) * (N / 8);  // 16 x 8 output tiles
  constexpr int kTilesPerWarp = kStateTiles >= kWarps ? kStateTiles / kWarps : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<N>& sm = *reinterpret_cast<Smem<N>*>(smem_raw);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int T = p.T, H = p.H, hd = p.hd;
  const int tiles = (hd + kRows - 1) / kRows;
  const int tile = blockIdx.x % tiles;
  const int h = (blockIdx.x / tiles) % H;
  const int b = blockIdx.x / (tiles * H);
  const int d0 = tile * kRows;
  const int nc = (T + kQ - 1) / kQ;

  if (warp >= kWarps) {
    // The staging warps keep the next chunk's copies in flight while the
    // product warps run this one (one warp alone cannot keep enough
    // copies in flight), and take the cumsum off their path: chunk c
    // lands and its cs and w are made; once the product warps are done
    // with c - 1 (kEmpty), kFull lets them into c and c + 1 goes into the
    // buffer c - 1 used.
    const int pt = tid - kConsumers;
    const float a = p.A[h];
    stage<N>(p, sm, 0, 0, pt, b, h, d0);
    for (int c = 0; c < nc; ++c) {
      const int buf = c & 1;
      asm volatile("cp.async.wait_all;\n" ::);  // chunk c, staged last
      if (warp == kWarps) decays<N>(sm, buf, lane, a);
      if (c > 0) bar_sync(kEmpty, kThreads);
      bar_arrive(kFull, kThreads);  // this thread's copies have landed
      if (c + 1 < nc) stage<N>(p, sm, c + 1, buf ^ 1, pt, b, h, d0);
    }
    return;
  }

  const float dh = p.D[h];
  // this warp's tiles of the state update: kTilesPerWarp n-tiles of one
  // 16-row m-tile (warps past kStateTiles have none)
  const int st0 = warp * kTilesPerWarp;
  const bool has_state = st0 < kStateTiles;
  const int mc = has_state ? st0 / (N / 8) : 0;
  Acc state[kTilesPerWarp];

  // this warp's rows of t (the 16 of m-tile mi) and y's columns 8*dj..;
  // the four warps a scheduler runs (w, w + 4, ...) take one m-tile each,
  // which evens the causal work out between schedulers
  const int mi = warp >> 2, dj = warp & 3;
  const int ta = 16 * mi + g, tb = ta + 8;

  for (int c = 0; c < nc; ++c) {
    const int buf = c & 1, t0 = c * kQ, nt = min(kQ, T - t0);
    bar_sync(kFull, kThreads);  // chunk c has landed, cs and w are made
    if (c == 0) {
#pragma unroll
      for (int j = 0; j < kTilesPerWarp; ++j) {
        const int nb = (st0 + j) % (N / 8);
        state[j].zero();
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (has_state)
            state[j].big[i] =
                sm.s[16 * mc + g + 8 * (i >> 1)][8 * nb + 2 * tg + (i & 1)];
      }
    }

    // --- C s^T; G o L in place over G's column tiles jt0 and jt0 + 4 of
    // these rows (zero past the diagonal), which evens the work with exp
    // out over the warps. A short last chunk skips the m-tiles past T.
    const bool rows = 16 * mi < nt;
    const int cols = min(2 * mi + 1, (nt - 1) >> 3);  // causal 8-col tiles
    const int jt0 = (dj + 4 - (mi == 0 ? 0 : 2)) & 3;
    Acc y;
    y.zero();
    if (rows) {
#pragma unroll
      for (int k0 = 0; k0 < N; k0 += 8) {
        A4 af;
        B2 bf;
        load_a(af, &sm.c[buf][0][0], kBs, 16 * mi, k0, lane);
        load_b_nk(bf, &sm.s[0][0], kBs, 8 * dj, k0, lane);
        mma3(y, af, bf);
      }
    }
    const float* cs = sm.cs[buf];
    const float csa = cs[ta], csb = cs[tb];
    float acc[4] = {y[0], y[1], y[2], y[3]};
    const float ea = expf(csa), eb = expf(csb);
    acc[0] *= ea; acc[1] *= ea; acc[2] *= eb; acc[3] *= eb;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const bool causal = jt0 + 4 * j <= cols;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = i < 2 ? ta : tb, u = 8 * (jt0 + 4 * j) + 2 * tg + (i & 1);
        float& gv = sm.g[buf][t][u];
        gv = causal && u <= t
            ? gv * expf((i < 2 ? csa : csb) - cs[u]) * sm.dt[buf][u] : 0.f;
      }
    }
    bar_sync(kProducts, kConsumers);  // G o L complete; sm.s is read

    // --- y += (G o L) x over the causal column tiles, and s = exp(cs_Q) s
    // + (x o w)^T B, their k-steps interleaved: two independent sets of
    // products in each warp hide each other's latency
    Acc yl;
    yl.zero();
    const float dq = expf(cs[kQ - 1]);
#pragma unroll
    for (int j = 0; j < kTilesPerWarp; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        state[j].big[i] = state[j][i] * dq;
        state[j].small[i] = 0.f;
      }
#pragma unroll
    for (int k0 = 0; k0 < kQ; k0 += 8) {
      if (rows && k0 <= 8 * cols) {
        A4 af;
        B2 bf;
        load_a(af, &sm.g[buf][0][0], kGs, 16 * mi, k0, lane);
        load_b_kn(bf, &sm.x[buf][0][0], kXs, 8 * dj, k0, lane);
        mma3(yl, af, bf);
      }
      if (has_state) {  // x o w is zero past T
        const int u0 = k0 + tg, u1 = u0 + 4;
        const float w0 = sm.w[buf][u0], w1 = sm.w[buf][u1];
        const int r0 = 16 * mc + g;
        A4 af;  // (x o w)^T: rows d, columns u
        split(sm.x[buf][u0][r0] * w0, af.hi[0], af.lo[0]);
        split(sm.x[buf][u0][r0 + 8] * w0, af.hi[1], af.lo[1]);
        split(sm.x[buf][u1][r0] * w1, af.hi[2], af.lo[2]);
        split(sm.x[buf][u1][r0 + 8] * w1, af.hi[3], af.lo[3]);
#pragma unroll
        for (int j = 0; j < kTilesPerWarp; ++j) {
          B2 bf;
          load_b_kn(bf, &sm.b[buf][0][0], kBs, 8 * ((st0 + j) % (N / 8)), k0,
                    lane);
          mma3(state[j], af, bf);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // y with D x
      const int t = i < 2 ? ta : tb;
      const int r = 8 * dj + 2 * tg + (i & 1);
      if (t < nt && d0 + r < hd)
        p.y[((static_cast<long long>(b) * T + t0 + t) * H + h) * hd + d0 + r] =
            acc[i] + yl[i] + dh * sm.x[buf][t][r];
    }
    if (has_state) {
#pragma unroll
      for (int j = 0; j < kTilesPerWarp; ++j) {
        const int nb = (st0 + j) % (N / 8);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          sm.s[16 * mc + g + 8 * (i >> 1)][8 * nb + 2 * tg + (i & 1)] =
              state[j][i];
      }
    }
    // chunk c's buffers are free (the next kFull orders these writes of
    // sm.s before the next chunk's reads)
    if (c + 1 < nc) bar_arrive(kEmpty, kThreads);
  }

  bar_sync(kProducts, kConsumers);  // the final state is in sm.s
  const long long sbase = (static_cast<long long>(b) * H + h) * hd * N;
  for (int e = tid; e < kRows * (N / 4); e += kConsumers) {
    const int r = e / (N / 4), n = 4 * (e % (N / 4));
    if (d0 + r < hd)
      *reinterpret_cast<float4*>(p.sf + sbase + (d0 + r) * N + n) =
          *reinterpret_cast<const float4*>(&sm.s[r][n]);
  }
}

template <int N>
cudaError_t launch(const Args& p, int Bz, int smem, cudaStream_t stream) {
  if (smem != static_cast<int>(sizeof(Smem<N>)) || p.gram == nullptr)
    return cudaErrorInvalidValue;
  const int nc = (p.T + kQ - 1) / kQ;
  gram_kernel<N><<<Bz * nc * (kQ / 16), 32 * kGramWarps, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      dual_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  // a programmatic dependent of gram_kernel: its blocks start while G is
  // made and stage chunk 0's B, C, x and state meanwhile
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(Bz * p.H * ((p.hd + kRows - 1) / kRows));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, dual_kernel<N>, p);
}

}  // namespace dual

template <int N>
cudaError_t launch(int path, const Args& p, int Bz, int smem,
                   cudaStream_t stream) {
  if (path == 1) return dual::launch<N>(p, Bz, smem, stream);
  if (path == 0) return rec::launch<N>(p, Bz, smem, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// All tensors float32. Strides are in elements; s0 may be null (zero
// initial state) and may equal sf. `path` is 0 for the recurrence, 1 for
// the dual form; `x16` says that x's rows (and head dims 4k..) start on
// 16 bytes; `smem` is the shared memory a block of that path uses,
// as the wrapper's launch plan counts it (a mismatch is refused). Returns
// the cudaError_t of the launch.
extern "C" int ssd_scan_fwd(
    const void* x, const void* Bm, const void* Cm, const void* dt,
    const void* A, const void* D, const void* s0, void* y, void* sf,
    void* gram, int x16, int Bz, int T, int H, int hd, int N, int path,
    int smem,
    long long x_sb,
    long long x_st, long long x_sh, long long b_sb, long long b_st,
    long long c_sb, long long c_st, long long dt_sb, long long dt_st,
    long long dt_sh, void* stream) {
  const Args p{static_cast<const float*>(x), static_cast<const float*>(Bm),
               static_cast<const float*>(Cm), static_cast<const float*>(dt),
               static_cast<const float*>(A), static_cast<const float*>(D),
               static_cast<const float*>(s0), static_cast<float*>(y),
               static_cast<float*>(sf), static_cast<float*>(gram), x16, T, H,
               hd,
               Strides{x_sb, x_st, x_sh, b_sb, b_st, c_sb, c_st, dt_sb, dt_st,
                       dt_sh}};
  cudaStream_t str = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 16: return launch<16>(path, p, Bz, smem, str);
    case 32: return launch<32>(path, p, Bz, smem, str);
    case 64: return launch<64>(path, p, Bz, smem, str);
    case 128: return launch<128>(path, p, Bz, smem, str);
    default: return cudaErrorInvalidValue;
  }
}
