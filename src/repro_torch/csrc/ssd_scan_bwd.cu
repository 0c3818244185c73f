// The gradient of the Mamba2 SSD scan (csrc/ssd_scan.cu) for Hopper
// (sm_90a), float32:
//     s_t = exp(dt_t * A_h) * s_{t-1} + dt_t * x_t B_t^T     (s: [hd, N])
//     y_t = C_t s_t + D_h * x_t
// Given the forward's inputs x [Bz,T,H,hd], B/C [Bz,T,N], dt [Bz,T,H], A/D
// [H], init_state [Bz,H,hd,N] (or null), dy [Bz,T,H,hd] and dsf [Bz,H,hd,N]
// (the final state's adjoint, or null for zeros), writes dx, dB, dC, ddt,
// dA, dD and d init_state (when asked), all float32.
//
// Replaces what the JAX package gets from autodiff of its oracle
// (src/repro/kernels/ref.py `ssd_dual`, which src/repro/kernels/ops.py runs
// off the TPU): the TPU kernel src/repro/kernels/ssd_scan.py::ssd_chunked
// has no backward of its own. The formulas are those of
// kernels/ref.py::ssd_chunked_bwd_plain, by chunks of kQ = 64 steps, with
// cs the in-chunk cumsum of dt*A, cq = cs[Q-1], G = C B^T, E[t,s] =
// exp(cs_t - cs_s) (s <= t), L = E dt_s, M = G o L, w_s = exp(cq - cs_s)
// dt_s, s_in the state entering a chunk and ds the adjoint of the state
// leaving it. Six kernels, in order on the call's stream:
//
//   ssd_bwd_gram_kernel    G of every chunk, [Bz, nc, Q, Q] (the heads
//                          share it);
//   ssd_bwd_states_kernel  one block per (sequence, head, 32 state rows,
//                          direction) walks its chunks with a [32, N] tile
//                          in registers: forwards it writes each chunk's
//                          s_in and updates s = exp(cq) s + (x o w)^T B;
//                          backwards it writes each chunk's ds and updates
//                          ds = exp(cq) ds + (dy o exp(cs))^T C, ending at
//                          d init_state (the chunk-entry states are
//                          recomputed, not saved by the forward: at
//                          mamba2-1.3b's B=8 x 1024 they would be 268 MB a
//                          layer);
//   ssd_bwd_chunk_kernel   one block per (sequence, chunk, head): dx = M^T
//                          dy + w o (B ds^T) + D dy, dM = dy x^T, the
//                          per-head dG = dM o L (written out), the row and
//                          column sums of dM o M and dM o G o E, dw,
//                          <dy, C s_in^T>, and from them dcs, its suffix
//                          sums, ddt and this chunk's parts of dA and dD;
//   ssd_bwd_bc_kernel      one block per (sequence, chunk, 64 state
//                          columns, group of 8 heads): the group's part of
//                          sum_h exp(cs) o (dy s_in) and sum_h (x o w) ds
//                          and of dG = sum_h dG_h, the heads in order;
//   ssd_bwd_bc_sum_kernel  one block per (sequence, chunk, 64 state
//                          columns): dC = dG B + the groups' parts, dB =
//                          dG^T C + theirs, the groups in order;
//   ssd_bwd_sum_kernel     dA and dD over sequences and chunks, in order.
//
// No float atomics anywhere: every value is summed by one thread in a
// fixed order (the sums over heads and over head dims included), so two
// calls give the same bits and a resumed run stays bitwise equal to the
// straight one. Rows past T are staged as zeros with dt = 0 (the forward's
// padding), which keeps the state and adds nothing.
//
// Bound on the H100: ~12 Bz*T*H*hd*N flops (the recurrence's backward with
// the states recomputed) and the bytes of x, dy, dx (3 of [Bz,T,H,hd]) and
// B, C, dB, dC, dt, ddt. All products here run in float32 on the CUDA
// cores (thread tiles of 4 x 4 and 4 x 2 out of shared memory), their
// operands staged by cp.async (16 bytes a copy where the rows allow), every
// copy of a stage in flight at once, the next stage's beside this one's
// products where shared memory allows (states, bc): staged by plain loads
// between the products, the load latency set the pace. This version is
// exact and plain, not fast; the forward's 3xTF32 tensor-core products are
// the way to speed it up.
//
// Plain C interface (bound from Python with ctypes). x, B, C and dt may be
// strided except along their last axis; dy, dsf, the initial state and
// every output are contiguous; the caller allocates the scratch.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kQ = 64;        // chunk length, as the forward's dual form
constexpr int kPad = kQ + 4;  // row stride of [.][kQ] tiles
constexpr int kRows = 32;     // state rows (of hd) a states block
constexpr int kPT = 32;       // head dims a pass of the chunk and bc blocks
constexpr int kPTs = kPT + 4; // row stride of [.][kPT] tiles
constexpr int kThreads = 256; // gram, chunk and bc kernels: 16 x 16 threads

struct Args {
  const float* x;
  const float* B;
  const float* C;
  const float* dt;
  const float* A;
  const float* D;
  const float* s0;   // may be null (zeros)
  const float* dy;   // [Bz,T,H,hd] contiguous
  const float* dsf;  // may be null (zeros)
  float* dx;         // [Bz,T,H,hd]
  float* dB;         // [Bz,T,N]
  float* dC;         // [Bz,T,N]
  float* ddt;        // [Bz,T,H]
  float* dA;         // [H]
  float* dD;         // [H]
  float* ds0;        // [Bz,H,hd,N], may be null (not wanted)
  float* gram;       // [Bz][nc][Q][Q]
  float* s_in;       // [Bz][nc][H][N][hd]: the state entering each chunk
  float* s_out;      // [Bz][nc][H][N][hd]: the adjoint of the state leaving it
  float* ecs;        // [Bz][nc*Q][H]: exp(cs)
  float* wv;         // [Bz][nc*Q][H]: w
  float* dgh;        // [Bz][nc][H][Q][Q]: dM o L of each head
  float* part;       // [2][Bz][nc][H]: each chunk's part of dA and dD
  float* bcp;        // [2][Bz][nc][G][Q][N]: each head group's part of dC, dB
  float* dgp;        // [Bz][nc][G][Q][Q]: each head group's part of dG
  int Bz, T, H, hd, nc;
  int v16;           // rows of x, dy, B and C on 16 bytes, hd % 4 == 0
  long long xb, xt, xh, bb, bt, cb, ct, db, dtt, dh;  // element strides
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_prev() {  // all but the newest
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ long long dy_at(const Args& p, int b, int t, int h) {
  return ((static_cast<long long>(b) * p.T + t) * p.H + h) * p.hd;
}

// Warp 0: cs = the cumsum of dt * a over the chunk's 64 steps (two a lane)
__device__ __forceinline__ void cumsum64(const float* dts, float* cs, float a,
                                         int lane) {
  float v0 = dts[lane] * a, v1 = dts[lane + 32] * a;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float w0 = __shfl_up_sync(0xffffffffu, v0, o);
    const float w1 = __shfl_up_sync(0xffffffffu, v1, o);
    if (lane >= o) { v0 += w0; v1 += w1; }
  }
  v1 += __shfl_sync(0xffffffffu, v0, 31);
  cs[lane] = v0;
  cs[lane + 32] = v1;
}

// ------------------------------------------------------------------- gram
// G[t][s] = sum_n C[t][n] B[s][n] for s <= t (0 above the diagonal); one
// block per (sequence, chunk), thread (ty, tx) owns rows 4ty.., columns
// 4tx.., n in slices of 32 staged transposed.
template <int N>
__global__ void __launch_bounds__(kThreads) ssd_bwd_gram_kernel(Args p) {
  __shared__ __align__(16) float ct[32][kPad], bt[32][kPad];
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int c = blockIdx.x % p.nc, b = blockIdx.x / p.nc;
  const int t0 = c * kQ, nt = min(kQ, p.T - t0);
  float acc[4][4] = {};
  for (int n0 = 0; n0 < N; n0 += 32) {
    for (int e = tid; e < kQ * 32; e += kThreads) {
      const int t = e >> 5, n = e & 31;
      const bool in = t < nt && n0 + n < N;
      ct[n][t] = in ? p.C[b * p.cb + (t0 + t) * p.ct + n0 + n] : 0.f;
      bt[n][t] = in ? p.B[b * p.bb + (t0 + t) * p.bt + n0 + n] : 0.f;
    }
    __syncthreads();
    if (tx <= ty) {
#pragma unroll 8
      for (int n = 0; n < 32; ++n) {
        const float4 cv = *reinterpret_cast<const float4*>(&ct[n][4 * ty]);
        const float4 bv = *reinterpret_cast<const float4*>(&bt[n][4 * tx]);
        const float cr[4] = {cv.x, cv.y, cv.z, cv.w};
        const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(cr[i], br[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
  float* g = p.gram + (static_cast<long long>(b) * p.nc + c) * kQ * kQ;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = 4 * ty + i;
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = 4 * tx + j <= t ? acc[i][j] : 0.f;
    *reinterpret_cast<float4*>(g + t * kQ + 4 * tx) =
        make_float4(v[0], v[1], v[2], v[3]);
  }
}

// ----------------------------------------------------------------- states
// One block per (direction, sequence, head, tile of kRows state rows): 2N
// threads, each a 4 x 4 tile (rows 4 pg.., columns 4 ng..) of the state
// (forwards) or of its adjoint (backwards), carried over the chunks. The
// next chunk's x (or dy), B (or C) and dt are copied by cp.async into the
// other stage of a two-stage ring while this chunk's product runs: staged
// between the products by plain loads, their latency set the pace (the
// product of a chunk is ~1k multiply-adds a thread). x o w (or dy o
// exp(cs)) is made in the product from the raw rows.
template <int N>
struct StatesSmem {
  float u[2][kQ][kRows + 4];  // x (forwards) or dy (backwards), raw
  float v[2][kQ][N + 4];      // B (forwards) or C (backwards)
  float dts[2][kQ];
  float cs[kQ], coef[kQ];     // w (forwards) or exp(cs) (backwards)
};

// The copies of chunk c into stage `buf` (rows past T and state rows past
// hd as zeros, dt = 0 past T). `v16`: rows on 16 bytes, copied 4 floats
// at a time.
template <int N>
__device__ __forceinline__ void stage_states(const Args& p, StatesSmem<N>& sm,
                                             int buf, int c, int b, int h,
                                             int d0, bool back, int tid) {
  constexpr int kT = 2 * N;
  const int t0 = c * kQ, nt = min(kQ, p.T - t0);
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int t = tid; t < kQ; t += kT) {
    if (t < nt)
      cp_async4(&sm.dts[buf][t], p.dt + b * p.db + (t0 + t) * p.dtt + h * p.dh);
    else
      sm.dts[buf][t] = 0.f;
  }
  const float* vm = back ? p.C : p.B;
  const long long vb = back ? p.cb : p.bb, vt = back ? p.ct : p.bt;
  if (p.v16) {
    for (int e = tid; e < kQ * (kRows / 4); e += kT) {
      const int t = e / (kRows / 4), r = 4 * (e % (kRows / 4)), d = d0 + r;
      if (t < nt && d < p.hd)
        cp_async16(&sm.u[buf][t][r],
                   back ? p.dy + dy_at(p, b, t0 + t, h) + d
                        : p.x + b * p.xb + (t0 + t) * p.xt + h * p.xh + d);
      else
        *reinterpret_cast<float4*>(&sm.u[buf][t][r]) = z;
    }
    for (int e = tid; e < kQ * (N / 4); e += kT) {
      const int t = e / (N / 4), n = 4 * (e % (N / 4));
      if (t < nt)
        cp_async16(&sm.v[buf][t][n], vm + b * vb + (t0 + t) * vt + n);
      else
        *reinterpret_cast<float4*>(&sm.v[buf][t][n]) = z;
    }
  } else {
    for (int e = tid; e < kQ * kRows; e += kT) {
      const int t = e / kRows, r = e % kRows, d = d0 + r;
      if (t < nt && d < p.hd)
        cp_async4(&sm.u[buf][t][r],
                  back ? p.dy + dy_at(p, b, t0 + t, h) + d
                       : p.x + b * p.xb + (t0 + t) * p.xt + h * p.xh + d);
      else
        sm.u[buf][t][r] = 0.f;
    }
    for (int e = tid; e < kQ * N; e += kT) {
      const int t = e / N, n = e % N;
      if (t < nt)
        cp_async4(&sm.v[buf][t][n], vm + b * vb + (t0 + t) * vt + n);
      else
        sm.v[buf][t][n] = 0.f;
    }
  }
  cp_async_commit();
}

template <int N>
__global__ void __launch_bounds__(2 * N) ssd_bwd_states_kernel(Args p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  StatesSmem<N>& sm = *reinterpret_cast<StatesSmem<N>*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int pg = tid & 7, ng = tid >> 3;
  const int tiles = (p.hd + kRows - 1) / kRows;
  int id = blockIdx.x;
  const int tile = id % tiles; id /= tiles;
  const int h = id % p.H; id /= p.H;
  const int b = id % p.Bz;
  const bool back = id >= p.Bz;
  const int d0 = tile * kRows;
  const float a = p.A[h];
  const long long srow = (static_cast<long long>(b) * p.H + h) * p.hd;

  float s[4][4];
  const float* init = back ? p.dsf : p.s0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int d = d0 + 4 * pg + i;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      s[i][j] = init != nullptr && d < p.hd
          ? init[(srow + d) * N + 4 * ng + j] : 0.f;
  }

  if (p.nc > 0)
    stage_states<N>(p, sm, 0, back ? p.nc - 1 : 0, b, h, d0, back, tid);
  for (int k = 0; k < p.nc; ++k) {
    const int c = back ? p.nc - 1 - k : k, buf = k & 1;
    if (k + 1 < p.nc)
      stage_states<N>(p, sm, buf ^ 1, back ? c - 1 : c + 1, b, h, d0, back,
                      tid);
    else
      cp_async_commit();  // an empty group keeps the count
    cp_async_wait_prev();
    __syncthreads();      // chunk c has landed
    if (warp == 0) {
      cumsum64(sm.dts[buf], sm.cs, a, lane);
      __syncwarp();
      const float cq = sm.cs[kQ - 1];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int t = lane + 32 * r;
        sm.coef[t] = back ? expf(sm.cs[t])
                          : expf(cq - sm.cs[t]) * sm.dts[buf][t];
      }
    }
    __syncthreads();

    // this chunk's s_in (forwards) or ds (backwards), [N][hd] per head: a
    // thread's 4 rows are 4 neighbouring floats of each of its 4 columns
    float* out = (back ? p.s_out : p.s_in) +
        ((static_cast<long long>(b) * p.nc + c) * p.H + h) * N * p.hd;
    const int d = d0 + 4 * pg;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float* o = out + (4 * ng + j) * p.hd + d;
      if (p.hd % 4 == 0) {
        if (d < p.hd)
          *reinterpret_cast<float4*>(o) =
              make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (d + i < p.hd) o[i] = s[i][j];
      }
    }

    float acc[4][4] = {};
#pragma unroll 4
    for (int t = 0; t < kQ; ++t) {
      const float4 uv = *reinterpret_cast<const float4*>(&sm.u[buf][t][4 * pg]);
      const float4 vv = *reinterpret_cast<const float4*>(&sm.v[buf][t][4 * ng]);
      const float f = sm.coef[t];
      const float ur[4] = {uv.x * f, uv.y * f, uv.z * f, uv.w * f};
      const float vr[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ur[i], vr[j], acc[i][j]);
    }
    const float dq = expf(sm.cs[kQ - 1]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(dq, s[i][j], acc[i][j]);
    __syncthreads();  // this stage is read: the next pass refills it
  }

  if (back && p.ds0 != nullptr) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int d = d0 + 4 * pg + i;
      if (d < p.hd)
        *reinterpret_cast<float4*>(p.ds0 + (srow + d) * N + 4 * ng) =
            make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
    }
  }
}

// ------------------------------------------------------------------ chunk
template <int N>
struct ChunkSmem {
  float b[kQ][N + 4], c[kQ][N + 4];      // B, C of the chunk, [t][n]
  float g[kQ][kPad], m[kQ][kPad];        // G and M = G o L, [t][s]
  float x[kQ][kPTs], dy[kQ][kPTs];       // a slice of head dims, [t][p]
  float st[N][kPTs], dst[N][kPTs];       // s_in, ds of the slice, [n][p]
  float dts[kQ], cs[kQ], w[kQ], ecs[kQ];
  float rw[kQ][17], re[kQ][17];          // dw, <dy, C s_in^T> by tx
  float rrow[kQ][17], rcl[kQ][17], rce[kQ][17];  // sums of dM o M, dM o G o E
  float blk[2][kThreads];                // x dy and <ds, s_in> by thread
  float dcs[kQ], ddt[kQ], suf[kQ];
};

template <int N>
__global__ void __launch_bounds__(kThreads, 1) ssd_bwd_chunk_kernel(Args p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ChunkSmem<N>& sm = *reinterpret_cast<ChunkSmem<N>*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ty = tid >> 4, tx = tid & 15;
  const int h = blockIdx.x % p.H;
  const int c = (blockIdx.x / p.H) % p.nc;
  const int b = blockIdx.x / (p.H * p.nc);
  const int t0 = c * kQ, nt = min(kQ, p.T - t0);
  const float a = p.A[h], dD = p.D[h];

  const long long head = (static_cast<long long>(b) * p.nc + c) * p.H + h;
  const float* s_in = p.s_in + head * N * p.hd;
  const float* s_out = p.s_out + head * N * p.hd;
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  // cp.async copies of a slice of head dims (rows past T and head dims
  // past hd as zeros): x, dy [t][p] and s_in, ds [n][p]
  auto stage_slice = [&](int p0) {
    if (p.v16) {
      for (int e = tid; e < kQ * (kPT / 4); e += kThreads) {
        const int t = e / (kPT / 4), r = 4 * (e % (kPT / 4)), d = p0 + r;
        if (t < nt && d < p.hd) {
          cp_async16(&sm.x[t][r],
                     p.x + b * p.xb + (t0 + t) * p.xt + h * p.xh + d);
          cp_async16(&sm.dy[t][r], p.dy + dy_at(p, b, t0 + t, h) + d);
        } else {
          *reinterpret_cast<float4*>(&sm.x[t][r]) = z;
          *reinterpret_cast<float4*>(&sm.dy[t][r]) = z;
        }
      }
      for (int e = tid; e < N * (kPT / 4); e += kThreads) {
        const int n = e / (kPT / 4), r = 4 * (e % (kPT / 4)), d = p0 + r;
        if (d < p.hd) {
          cp_async16(&sm.st[n][r], s_in + n * p.hd + d);
          cp_async16(&sm.dst[n][r], s_out + n * p.hd + d);
        } else {
          *reinterpret_cast<float4*>(&sm.st[n][r]) = z;
          *reinterpret_cast<float4*>(&sm.dst[n][r]) = z;
        }
      }
    } else {
      for (int e = tid; e < kQ * kPT; e += kThreads) {
        const int t = e / kPT, r = e % kPT, d = p0 + r;
        if (t < nt && d < p.hd) {
          cp_async4(&sm.x[t][r],
                    p.x + b * p.xb + (t0 + t) * p.xt + h * p.xh + d);
          cp_async4(&sm.dy[t][r], p.dy + dy_at(p, b, t0 + t, h) + d);
        } else {
          sm.x[t][r] = sm.dy[t][r] = 0.f;
        }
      }
      for (int e = tid; e < N * kPT; e += kThreads) {
        const int n = e / kPT, r = e % kPT, d = p0 + r;
        if (d < p.hd) {
          cp_async4(&sm.st[n][r], s_in + n * p.hd + d);
          cp_async4(&sm.dst[n][r], s_out + n * p.hd + d);
        } else {
          sm.st[n][r] = sm.dst[n][r] = 0.f;
        }
      }
    }
  };
  // the chunk's dt, B, C and G, and the first slice, all in flight at once
  stage_slice(0);
  for (int t = tid; t < kQ; t += kThreads) {
    if (t < nt)
      cp_async4(&sm.dts[t], p.dt + b * p.db + (t0 + t) * p.dtt + h * p.dh);
    else
      sm.dts[t] = 0.f;
  }
  if (p.v16) {
    for (int e = tid; e < kQ * (N / 4); e += kThreads) {
      const int t = e / (N / 4), n = 4 * (e % (N / 4));
      if (t < nt) {
        cp_async16(&sm.b[t][n], p.B + b * p.bb + (t0 + t) * p.bt + n);
        cp_async16(&sm.c[t][n], p.C + b * p.cb + (t0 + t) * p.ct + n);
      } else {
        *reinterpret_cast<float4*>(&sm.b[t][n]) = z;
        *reinterpret_cast<float4*>(&sm.c[t][n]) = z;
      }
    }
  } else {
    for (int e = tid; e < kQ * N; e += kThreads) {
      const int t = e / N, n = e % N;
      if (t < nt) {
        cp_async4(&sm.b[t][n], p.B + b * p.bb + (t0 + t) * p.bt + n);
        cp_async4(&sm.c[t][n], p.C + b * p.cb + (t0 + t) * p.ct + n);
      } else {
        sm.b[t][n] = sm.c[t][n] = 0.f;
      }
    }
  }
  const float* gb = p.gram + (static_cast<long long>(b) * p.nc + c) * kQ * kQ;
  for (int e = tid; e < kQ * kQ / 4; e += kThreads) {
    const int t = e / (kQ / 4), s = 4 * (e % (kQ / 4));
    cp_async16(&sm.g[t][s], gb + t * kQ + s);
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
  if (warp == 0) {
    cumsum64(sm.dts, sm.cs, a, lane);
    __syncwarp();
    const float cq = sm.cs[kQ - 1];
    float* ecs = p.ecs + (static_cast<long long>(b) * p.nc * kQ + t0) * p.H + h;
    float* wv = p.wv + (static_cast<long long>(b) * p.nc * kQ + t0) * p.H + h;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = lane + 32 * r;
      sm.ecs[t] = expf(sm.cs[t]);
      sm.w[t] = expf(cq - sm.cs[t]) * sm.dts[t];
      ecs[static_cast<long long>(t) * p.H] = sm.ecs[t];
      wv[static_cast<long long>(t) * p.H] = sm.w[t];
    }
  }
  __syncthreads();
  for (int e = tid; e < kQ * kQ; e += kThreads) {
    const int t = e / kQ, s = e % kQ;
    sm.m[t][s] = s <= t ? sm.g[t][s] * expf(sm.cs[t] - sm.cs[s]) * sm.dts[s]
                        : 0.f;
  }

  float dM[4][4] = {};
  float dwp[4] = {}, dep[4] = {}, xdy = 0.f, sds = 0.f;
  for (int p0 = 0; p0 < p.hd; p0 += kPT) {
    if (p0 > 0) {
      __syncthreads();  // the previous slice is read
      stage_slice(p0);
      asm volatile("cp.async.wait_all;\n" ::);
    }
    __syncthreads();  // the slice has landed (and M is made)
    for (int e = tid; e < N * kPT; e += kThreads)
      sds = fmaf(sm.st[e / kPT][e % kPT], sm.dst[e / kPT][e % kPT], sds);

    // dM[t][s] += sum_p dy[t][p] x[s][p], t = 4ty+i, s = 4tx+j (s <= t)
    if (tx <= ty) {
#pragma unroll 4
      for (int r = 0; r < kPT; ++r) {
        float dv[4], xv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dv[i] = sm.dy[4 * ty + i][r];
          xv[i] = sm.x[4 * tx + i][r];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) dM[i][j] = fmaf(dv[i], xv[j], dM[i][j]);
      }
    }
    // rows 4ty+i, head dims 2tx+jj of M^T dy, B ds^T and C s_in^T
    float mdy[4][2] = {}, bds[4][2] = {}, cst[4][2] = {};
#pragma unroll 4
    for (int t = 4 * ty; t < kQ; ++t) {
      const float4 mv = *reinterpret_cast<const float4*>(&sm.m[t][4 * ty]);
      const float2 yv = *reinterpret_cast<const float2*>(&sm.dy[t][2 * tx]);
      const float mr[4] = {mv.x, mv.y, mv.z, mv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        mdy[i][0] = fmaf(mr[i], yv.x, mdy[i][0]);
        mdy[i][1] = fmaf(mr[i], yv.y, mdy[i][1]);
      }
    }
    for (int n0 = 0; n0 < N; n0 += 4) {  // B, C rows 4 floats at a time
      float br[4][4], cr[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 bv =
            *reinterpret_cast<const float4*>(&sm.b[4 * ty + i][n0]);
        const float4 cv =
            *reinterpret_cast<const float4*>(&sm.c[4 * ty + i][n0]);
        br[i][0] = bv.x; br[i][1] = bv.y; br[i][2] = bv.z; br[i][3] = bv.w;
        cr[i][0] = cv.x; cr[i][1] = cv.y; cr[i][2] = cv.z; cr[i][3] = cv.w;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 dv =
            *reinterpret_cast<const float2*>(&sm.dst[n0 + q][2 * tx]);
        const float2 sv =
            *reinterpret_cast<const float2*>(&sm.st[n0 + q][2 * tx]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          bds[i][0] = fmaf(br[i][q], dv.x, bds[i][0]);
          bds[i][1] = fmaf(br[i][q], dv.y, bds[i][1]);
          cst[i][0] = fmaf(cr[i][q], sv.x, cst[i][0]);
          cst[i][1] = fmaf(cr[i][q], sv.y, cst[i][1]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = 4 * ty + i;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int r = 2 * tx + jj, d = p0 + r;
        const float xv = sm.x[t][r], yv = sm.dy[t][r];
        dwp[i] = fmaf(xv, bds[i][jj], dwp[i]);
        dep[i] = fmaf(yv, cst[i][jj], dep[i]);
        xdy = fmaf(xv, yv, xdy);
        if (t < nt && d < p.hd)
          p.dx[dy_at(p, b, t0 + t, h) + d] =
              fmaf(sm.w[t], bds[i][jj], mdy[i][jj]) + dD * yv;
      }
    }
  }

  // dG_h = dM o L out; the sums of dM o M (= dL o L) by rows and columns
  // and of dM o G o E (= dL o E) by columns, by thread
  float* dg = p.dgh + head * kQ * kQ;
  float rowp[4] = {}, cll[4] = {}, cle[4] = {};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = 4 * ty + i;
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int s = 4 * tx + j;
      v[j] = 0.f;
      if (s <= t) {
        const float e = expf(sm.cs[t] - sm.cs[s]);
        const float ll = dM[i][j] * sm.m[t][s];
        v[j] = dM[i][j] * e * sm.dts[s];
        rowp[i] += ll;
        cll[j] += ll;
        cle[j] = fmaf(dM[i][j] * sm.g[t][s], e, cle[j]);
      }
    }
    *reinterpret_cast<float4*>(dg + t * kQ + 4 * tx) =
        make_float4(v[0], v[1], v[2], v[3]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    sm.rw[4 * ty + i][tx] = dwp[i];
    sm.re[4 * ty + i][tx] = dep[i];
    sm.rrow[4 * ty + i][tx] = rowp[i];
    sm.rcl[4 * tx + i][ty] = cll[i];
    sm.rce[4 * tx + i][ty] = cle[i];
  }
  sm.blk[0][tid] = xdy;
  sm.blk[1][tid] = sds;
  __syncthreads();
  const float cq = sm.cs[kQ - 1];
  if (tid < kQ) {
    const int t = tid;
    float dw = 0.f, de = 0.f, row = 0.f, col = 0.f, ce = 0.f;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      dw += sm.rw[t][k];
      de += sm.re[t][k];
      row += sm.rrow[t][k];
      col += sm.rcl[t][k];
      ce += sm.rce[t][k];
    }
    const float dww = dw * sm.w[t];
    sm.dcs[t] = row - col + sm.ecs[t] * de - dww;
    sm.ddt[t] = fmaf(dw, expf(cq - sm.cs[t]), ce);
    sm.suf[t] = dww;
  }
  __syncthreads();
  if (tid == 0) {
    float dww = 0.f, xd = 0.f, sd = 0.f;
    for (int t = 0; t < kQ; ++t) dww += sm.suf[t];
    for (int k = 0; k < kThreads; ++k) {
      xd += sm.blk[0][k];
      sd += sm.blk[1][k];
    }
    sm.dcs[kQ - 1] += dww + expf(cq) * sd;
    float S = 0.f, da = 0.f;
    for (int t = kQ - 1; t >= 0; --t) {  // suffix sums: t' >= t
      S += sm.dcs[t];
      sm.suf[t] = S;
      da = fmaf(sm.dts[t], S, da);
    }
    p.part[head] = da;
    p.part[static_cast<long long>(p.Bz) * p.nc * p.H + head] = xd;
  }
  __syncthreads();
  if (tid < nt)
    p.ddt[(static_cast<long long>(b) * p.T + t0 + tid) * p.H + h] =
        fmaf(a, sm.suf[tid], sm.ddt[tid]);
}

// --------------------------------------------------------------------- bc
// dC = dG B + sum_h exp(cs) o (dy s_in) and dB = dG^T C + sum_h (x o w) ds
// in two passes, so that a few chunks still fill the card: bc_kernel, one
// block per (sequence, chunk, kNT state columns, group of kHG heads), sums
// its heads' terms (and, for the first column tile, their dG_h) into a
// partial of the group; bc_sum_kernel, one block per (sequence, chunk,
// column tile), adds the groups' partials in order and the dG products.
// Thread (ty, tx) owns rows 4ty.. and columns tx + 16 j (j < kNT / 16).
constexpr int kHG = 8;  // heads a bc_kernel block sums

template <int N>
struct BcSmem {
  static constexpr int kNT = N < 64 ? N : 64;
  float dy[2][kQ][kPTs], x[2][kQ][kPTs];      // a slice of head dims, [t][p]
  float sp[2][kNT][kPTs], dsp[2][kNT][kPTs];  // s_in, ds of it, [n][p]
  float ecs[2][kQ], w[2][kQ];                 // exp(cs) and w of the head
};

template <int N>
struct BcSumSmem {
  static constexpr int kNT = BcSmem<N>::kNT;
  float dg[kQ][kPad];                      // dG = sum_h dG_h, [t][s]
  float bn[kQ][kNT + 4], cn[kQ][kNT + 4];  // B, C columns of the tile
};

__device__ __forceinline__ int head_groups(const Args& p) {
  return (p.H + kHG - 1) / kHG;
}

template <int N>
__global__ void __launch_bounds__(kThreads) ssd_bwd_bc_kernel(Args p) {
  constexpr int kNT = BcSmem<N>::kNT, kJ = kNT / 16, kTiles = N / kNT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  BcSmem<N>& sm = *reinterpret_cast<BcSmem<N>*>(smem_raw);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int G = head_groups(p);
  int id = blockIdx.x;
  const int grp = id % G; id /= G;
  const int tile = id % kTiles; id /= kTiles;
  const int c = id % p.nc, b = id / p.nc;
  const int n0 = tile * kNT, t0 = c * kQ, nt = min(kQ, p.T - t0);
  const int h0 = grp * kHG, h1 = min(p.H, h0 + kHG);
  const int ns = (p.hd + kPT - 1) / kPT, steps = (h1 - h0) * ns;
  const long long head0 = (static_cast<long long>(b) * p.nc + c) * p.H;
  const long long step0 = (static_cast<long long>(b) * p.nc * kQ + t0) * p.H;
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);

  // cp.async copies of (head, slice) number k into stage buf: raw dy and x
  // rows, s_in and ds rows of the column tile, the head's exp(cs) and w
  auto stage = [&](int k, int buf) {
    const int h = h0 + k / ns, p0 = (k % ns) * kPT;
    const float* s_in = p.s_in + (head0 + h) * N * p.hd + n0 * p.hd;
    const float* s_out = p.s_out + (head0 + h) * N * p.hd + n0 * p.hd;
    if (p.v16) {
      for (int e = tid; e < kQ * (kPT / 4); e += kThreads) {
        const int t = e / (kPT / 4), r = 4 * (e % (kPT / 4)), d = p0 + r;
        if (t < nt && d < p.hd) {
          cp_async16(&sm.dy[buf][t][r], p.dy + dy_at(p, b, t0 + t, h) + d);
          cp_async16(&sm.x[buf][t][r],
                     p.x + b * p.xb + (t0 + t) * p.xt + h * p.xh + d);
        } else {
          *reinterpret_cast<float4*>(&sm.dy[buf][t][r]) = z;
          *reinterpret_cast<float4*>(&sm.x[buf][t][r]) = z;
        }
      }
      for (int e = tid; e < kNT * (kPT / 4); e += kThreads) {
        const int n = e / (kPT / 4), r = 4 * (e % (kPT / 4)), d = p0 + r;
        if (d < p.hd) {
          cp_async16(&sm.sp[buf][n][r], s_in + n * p.hd + d);
          cp_async16(&sm.dsp[buf][n][r], s_out + n * p.hd + d);
        } else {
          *reinterpret_cast<float4*>(&sm.sp[buf][n][r]) = z;
          *reinterpret_cast<float4*>(&sm.dsp[buf][n][r]) = z;
        }
      }
    } else {
      for (int e = tid; e < kQ * kPT; e += kThreads) {
        const int t = e / kPT, r = e % kPT, d = p0 + r;
        if (t < nt && d < p.hd) {
          cp_async4(&sm.dy[buf][t][r], p.dy + dy_at(p, b, t0 + t, h) + d);
          cp_async4(&sm.x[buf][t][r],
                    p.x + b * p.xb + (t0 + t) * p.xt + h * p.xh + d);
        } else {
          sm.dy[buf][t][r] = sm.x[buf][t][r] = 0.f;
        }
      }
      for (int e = tid; e < kNT * kPT; e += kThreads) {
        const int n = e / kPT, r = e % kPT, d = p0 + r;
        if (d < p.hd) {
          cp_async4(&sm.sp[buf][n][r], s_in + n * p.hd + d);
          cp_async4(&sm.dsp[buf][n][r], s_out + n * p.hd + d);
        } else {
          sm.sp[buf][n][r] = sm.dsp[buf][n][r] = 0.f;
        }
      }
    }
    for (int t = tid; t < kQ; t += kThreads) {  // every step of the chunk
      cp_async4(&sm.ecs[buf][t], p.ecs + step0 + t * p.H + h);
      cp_async4(&sm.w[buf][t], p.wv + step0 + t * p.H + h);
    }
    cp_async_commit();
  };

  float dgs[kQ * kQ / kThreads] = {};
  float acc_c[4][kJ] = {}, acc_b[4][kJ] = {};
  float hc[4][kJ] = {}, hb[4][kJ] = {};  // this head's sums over head dims
  if (steps > 0) stage(0, 0);
  for (int k = 0; k < steps; ++k) {
    const int buf = k & 1, h = h0 + k / ns;
    if (k + 1 < steps)
      stage(k + 1, buf ^ 1);
    else
      cp_async_commit();  // an empty group keeps the count
    if (tile == 0 && k % ns == 0) {  // the head's dG, from the chunk pass
      const float* dg = p.dgh + (head0 + h) * kQ * kQ;
#pragma unroll
      for (int q = 0; q < kQ * kQ / kThreads; ++q)
        dgs[q] += dg[tid + q * kThreads];
    }
    cp_async_wait_prev();
    __syncthreads();  // step k has landed
#pragma unroll 4
    for (int r = 0; r < kPT; ++r) {
      float yr[4], xr[4], sv[kJ], dv[kJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        yr[i] = sm.dy[buf][4 * ty + i][r];
        xr[i] = sm.x[buf][4 * ty + i][r];
      }
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        sv[j] = sm.sp[buf][tx + 16 * j][r];
        dv[j] = sm.dsp[buf][tx + 16 * j][r];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
          hc[i][j] = fmaf(yr[i], sv[j], hc[i][j]);
          hb[i][j] = fmaf(xr[i], dv[j], hb[i][j]);
        }
    }
    if (k % ns == ns - 1) {  // the head's last slice: scale by its rows
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float e = sm.ecs[buf][4 * ty + i], w = sm.w[buf][4 * ty + i];
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
          acc_c[i][j] = fmaf(e, hc[i][j], acc_c[i][j]);
          acc_b[i][j] = fmaf(w, hb[i][j], acc_b[i][j]);
          hc[i][j] = hb[i][j] = 0.f;
        }
      }
    }
    __syncthreads();  // this stage is read: step k + 2 refills it
  }
  const long long part = ((static_cast<long long>(b) * p.nc + c) * G + grp);
  if (tile == 0) {
    float* dg = p.dgp + part * kQ * kQ;
#pragma unroll
    for (int q = 0; q < kQ * kQ / kThreads; ++q)
      dg[tid + q * kThreads] = dgs[q];
  }
  const long long plane = static_cast<long long>(p.Bz) * p.nc * G * kQ * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long row = (part * kQ + 4 * ty + i) * N + n0;
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      p.bcp[row + tx + 16 * j] = acc_c[i][j];
      p.bcp[plane + row + tx + 16 * j] = acc_b[i][j];
    }
  }
}

template <int N>
__global__ void __launch_bounds__(kThreads, 1) ssd_bwd_bc_sum_kernel(Args p) {
  constexpr int kNT = BcSmem<N>::kNT, kJ = kNT / 16, kTiles = N / kNT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  BcSumSmem<N>& sm = *reinterpret_cast<BcSumSmem<N>*>(smem_raw);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int G = head_groups(p);
  const int tile = blockIdx.x % kTiles;
  const int c = (blockIdx.x / kTiles) % p.nc;
  const int b = blockIdx.x / (kTiles * p.nc);
  const int n0 = tile * kNT, t0 = c * kQ, nt = min(kQ, p.T - t0);
  const long long part0 = (static_cast<long long>(b) * p.nc + c) * G;

#pragma unroll
  for (int k = 0; k < kQ * kQ / kThreads; ++k) {
    const int e = tid + k * kThreads;
    float v = 0.f;
    for (int g = 0; g < G; ++g) v += p.dgp[(part0 + g) * kQ * kQ + e];
    sm.dg[e / kQ][e % kQ] = v;
  }
  for (int e = tid; e < kQ * kNT; e += kThreads) {
    const int t = e / kNT, n = e % kNT;
    const bool in = t < nt;
    sm.bn[t][n] = in ? p.B[b * p.bb + (t0 + t) * p.bt + n0 + n] : 0.f;
    sm.cn[t][n] = in ? p.C[b * p.cb + (t0 + t) * p.ct + n0 + n] : 0.f;
  }
  // the groups' partials, in order
  const long long plane = static_cast<long long>(p.Bz) * p.nc * G * kQ * N;
  float acc_c[4][kJ] = {}, acc_b[4][kJ] = {};
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long row = ((part0 + g) * kQ + 4 * ty + i) * N + n0;
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        acc_c[i][j] += p.bcp[row + tx + 16 * j];
        acc_b[i][j] += p.bcp[plane + row + tx + 16 * j];
      }
    }
  }
  __syncthreads();
  // dC[t] += sum_s dG[t][s] B[s]; dB[s] += sum_t dG[t][s] C[t]
#pragma unroll 4
  for (int k = 0; k < kQ; ++k) {
    float gr[4], gc[4], bv[kJ], cv[kJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      gr[i] = sm.dg[4 * ty + i][k];
      gc[i] = sm.dg[k][4 * ty + i];
    }
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      bv[j] = sm.bn[k][tx + 16 * j];
      cv[j] = sm.cn[k][tx + 16 * j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        acc_c[i][j] = fmaf(gr[i], bv[j], acc_c[i][j]);
        acc_b[i][j] = fmaf(gc[i], cv[j], acc_b[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = 4 * ty + i;
    if (t < nt) {
      const long long row = (static_cast<long long>(b) * p.T + t0 + t) * N + n0;
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        p.dC[row + tx + 16 * j] = acc_c[i][j];
        p.dB[row + tx + 16 * j] = acc_b[i][j];
      }
    }
  }
}

// dA and dD: each chunk's parts, summed over sequences and chunks in order
__global__ void ssd_bwd_sum_kernel(Args p) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= p.H) return;
  const long long plane = static_cast<long long>(p.Bz) * p.nc * p.H;
  float da = 0.f, dd = 0.f;
  for (long long k = 0; k < static_cast<long long>(p.Bz) * p.nc; ++k) {
    da += p.part[k * p.H + h];
    dd += p.part[plane + k * p.H + h];
  }
  p.dA[h] = da;
  p.dD[h] = dd;
}

// the dynamic shared memory one block may have on sm_90
constexpr size_t kMaxSmem = 227 * 1024;

template <int N>
cudaError_t launch(const Args& p, cudaStream_t stream) {
  static_assert(sizeof(StatesSmem<N>) <= kMaxSmem &&
                    sizeof(ChunkSmem<N>) <= kMaxSmem &&
                    sizeof(BcSmem<N>) <= kMaxSmem &&
                    sizeof(BcSumSmem<N>) <= kMaxSmem,
                "a kernel's shared memory exceeds a Hopper block's 227 KB");
  const int tiles = (p.hd + kRows - 1) / kRows;
  // backwards the state walk also gives d init_state: it runs at T = 0 too
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_states_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      sizeof(StatesSmem<N>));
  if (err != cudaSuccess) return err;
  ssd_bwd_states_kernel<N><<<2 * p.Bz * p.H * tiles, 2 * N,
                             sizeof(StatesSmem<N>), stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (p.nc > 0) {
    constexpr int kTiles = N / BcSmem<N>::kNT;
    const int G = (p.H + kHG - 1) / kHG;
    ssd_bwd_gram_kernel<N><<<p.Bz * p.nc, kThreads, 0, stream>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    err = cudaFuncSetAttribute(ssd_bwd_chunk_kernel<N>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               sizeof(ChunkSmem<N>));
    if (err != cudaSuccess) return err;
    ssd_bwd_chunk_kernel<N><<<p.Bz * p.nc * p.H, kThreads,
                              sizeof(ChunkSmem<N>), stream>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    err = cudaFuncSetAttribute(ssd_bwd_bc_kernel<N>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               sizeof(BcSmem<N>));
    if (err != cudaSuccess) return err;
    ssd_bwd_bc_kernel<N><<<p.Bz * p.nc * kTiles * G, kThreads,
                           sizeof(BcSmem<N>), stream>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    err = cudaFuncSetAttribute(ssd_bwd_bc_sum_kernel<N>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               sizeof(BcSumSmem<N>));
    if (err != cudaSuccess) return err;
    ssd_bwd_bc_sum_kernel<N><<<p.Bz * p.nc * kTiles, kThreads,
                               sizeof(BcSumSmem<N>), stream>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  ssd_bwd_sum_kernel<<<(p.H + 63) / 64, 64, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// All tensors float32. s0, dsf and ds0 may be null. x, B, C and dt strides
// are in elements (x: batch, time, head; B, C: batch, time; dt: batch,
// time, head), their last axis unit-stride; dy and every output are
// contiguous. The scratch (`gram` [Bz*nc*Q*Q], `s_in`/`s_out`
// [Bz*nc*H*N*hd], `ecs`/`wv` [Bz*nc*Q*H], `dgh` [Bz*nc*H*Q*Q], `part`
// [2*Bz*nc*H], `bcp` [2*Bz*nc*G*Q*N], `dgp` [Bz*nc*G*Q*Q], G = ceil(H / 8))
// is the caller's; nc = ceil(T / 64). Returns the cudaError_t of the first
// launch that fails (0 on success).
extern "C" int ssd_scan_bwd(
    const void* x, const void* Bm, const void* Cm, const void* dt,
    const void* A, const void* D, const void* s0, const void* dy,
    const void* dsf, void* dx, void* dB, void* dC, void* ddt, void* dA,
    void* dD, void* ds0, void* gram, void* s_in, void* s_out, void* ecs,
    void* wv, void* dgh, void* part, void* bcp, void* dgp, int Bz, int T,
    int H, int hd, int N, int v16, long long x_sb, long long x_st,
    long long x_sh, long long b_sb, long long b_st, long long c_sb,
    long long c_st, long long dt_sb, long long dt_st, long long dt_sh,
    void* stream) {
  const Args p{static_cast<const float*>(x), static_cast<const float*>(Bm),
               static_cast<const float*>(Cm), static_cast<const float*>(dt),
               static_cast<const float*>(A), static_cast<const float*>(D),
               static_cast<const float*>(s0), static_cast<const float*>(dy),
               static_cast<const float*>(dsf), static_cast<float*>(dx),
               static_cast<float*>(dB), static_cast<float*>(dC),
               static_cast<float*>(ddt), static_cast<float*>(dA),
               static_cast<float*>(dD), static_cast<float*>(ds0),
               static_cast<float*>(gram), static_cast<float*>(s_in),
               static_cast<float*>(s_out), static_cast<float*>(ecs),
               static_cast<float*>(wv), static_cast<float*>(dgh),
               static_cast<float*>(part), static_cast<float*>(bcp),
               static_cast<float*>(dgp), Bz, T, H, hd,
               (T + kQ - 1) / kQ, v16, x_sb, x_st, x_sh, b_sb, b_st, c_sb, c_st,
               dt_sb, dt_st, dt_sh};
  cudaStream_t str = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 16: return launch<16>(p, str);
    case 32: return launch<32>(p, str);
    case 64: return launch<64>(p, str);
    case 128: return launch<128>(p, str);
    default: return cudaErrorInvalidValue;
  }
}
