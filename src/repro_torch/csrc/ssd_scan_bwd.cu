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
// leaving it. Five kernels, in order on the call's stream:
//
//   ssd_bwd_states_kernel  one block per (direction, sequence, head, 64
//                          state rows) walks its chunks with the [64, N]
//                          tile in mma accumulators: forwards it writes
//                          each chunk's s_in and makes s = exp(cq) s +
//                          (x o w)^T B; backwards each chunk's ds and ds =
//                          exp(cq) ds + (dy o exp(cs))^T C, ending at d
//                          init_state (the chunk-entry states are
//                          recomputed, not saved by the forward: at
//                          mamba2-1.3b's B=8 x 1024 they would be 268 MB a
//                          layer); the next chunk is copied by cp.async
//                          while this one's product runs;
//   ssd_bwd_gram_kernel    G of every chunk, [Bz, nc, Q, Q] (the heads
//                          share it), as the forward's gram_kernel;
//   ssd_bwd_chunk_kernel   one block per (sequence, chunk, group of hg
//                          heads) walks its heads in order, each in slices
//                          of kPT head dims, and reads each s_in and ds
//                          element once: dx = M^T dy + w o (B ds^T) + D dy,
//                          dM = dy x^T, from them dcs, its suffix sums, ddt
//                          and the chunk's parts of dA and dD (as the plain
//                          version: the row and column sums of dM o M and
//                          dM o G o E, dw = rows of x o (B ds^T), <dy, C
//                          s_in^T> = rows of C o (dy s_in)); and, summed
//                          over the group's heads on chip, dG = sum_h dM o
//                          L, sum_h exp(cs) o (dy s_in) and sum_h (x o w)
//                          ds, written once a block (hg: ssd_bwd_plan);
//   ssd_bwd_bc_sum_kernel  one block per (sequence, chunk, 64 state
//                          columns): dC = dG B + the groups' parts, dB =
//                          dG^T C + theirs, the groups in order;
//   ssd_bwd_sum_kernel     dA and dD over sequences and chunks, in order.
//
// Every product runs on the tensor cores in 3xTF32 (tf32x3.cuh: one TF32
// product misses the 1e-4 the kernel is held to, the adjoint crossing 16
// chunks), mma.sync.m16n8k8 with float32 accumulation; the decays, the
// exponentials, the cumsum and the sums of the gradient's rows stay
// float32 on the CUDA cores. The chunk kernel's 16 warps copy the next
// (head, slice) step's x, dy, s_in and ds by cp.async into a two-stage
// ring while they run this one's products (B, C and G are copied once a
// block). No float atomics anywhere: every value is summed in a fixed
// order (butterflies within a warp, then one warp over the warps' parts;
// heads in order, groups in order), so two calls give the same bits and a
// resumed run stays bitwise equal to the straight one.
// Rows past T are staged as zeros with dt = 0 (the forward's padding),
// which keeps the state and adds nothing.
//
// Bound on the H100: the gradient's products in 3xTF32 at the TF32 rate
// (chip_smoke.py::ssd_bwd_kernel_work), and the bytes of x, dy, dx (3 of
// [Bz,T,H,hd]) and B, C, dB, dC, dt, ddt. The scratch this design moves
// besides: s_in and ds written once and read once (4 x Bz nc H hd N
// floats), the group partials of dB, dC and dG and G. At mamba2-1.3b's
// training layer (Bz=4, T=1024) the call is ~0.91 ms, 7.7x that bound:
// the chunk kernel ~0.60 (its products run at ~0.2 mma.sync a cycle an
// SM, latency-bound at 16 warps), the state walk ~0.25 (bound by its
// copies and stores: ~0.24 with its products left out), measured by
// tools/scan_probe.py --bwd and --bwd-ablate.
//
// Plain C interface (bound from Python with ctypes). x and dt may be
// strided except along their last axis; B and C rows start on 16 bytes
// (the wrapper copies what does not); dy, dsf, the initial state and every
// output are contiguous; the caller allocates the scratch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

constexpr int kQ = 64;        // chunk length, as the forward's dual form
constexpr int kRows = 64;     // state rows (of hd) a states block
constexpr int kMT = kRows / 16;  // their 16-row tiles
constexpr int kPT = 32;       // head dims a step of the chunk kernel

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
  float* s_in;       // [Bz][nc][H][hd][N]: the state entering each chunk
  float* s_out;      // [Bz][nc][H][hd][N]: the adjoint of the state leaving it
  float* part;       // [2][Bz][nc][H]: each chunk's part of dA and dD
  float* bcp;        // [2][Bz][nc][G][Q][N]: each head group's part of dC, dB
  float* dgp;        // [Bz][nc][G][Q][Q]: each head group's part of dG
  int Bz, T, H, hd, nc;
  int hg;            // heads a chunk block walks (a head group)
  int v16;           // rows of x and dy on 16 bytes, hd % 4 == 0
  long long xb, xt, xh, bb, bt, cb, ct, db, dtt, dh;  // element strides
};

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
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

__device__ __forceinline__ long long dy_at(const Args& p, int b, int t, int h) {
  return ((static_cast<long long>(b) * p.T + t) * p.H + h) * p.hd;
}

__host__ __device__ __forceinline__ int head_groups(const Args& p) {
  return (p.H + p.hg - 1) / p.hg;
}

// d += a * b in 3xTF32 into one accumulator (the tiles a warp holds at
// once are its independent chains)
__device__ __forceinline__ void mma3(float (&d)[4], const A4& a, const B2& b) {
  mma(d, a.lo, b.hi);
  mma(d, a.hi, b.lo);
  mma(d, a.hi, b.hi);
}

// The A fragment (16 x 8) at rows r0.., columns k0.. of a matrix stored
// transposed, base[k][r], column k scaled by ca (k0 + tg) and cb
// (k0 + tg + 4)
__device__ __forceinline__ void load_a_t(A4& f, const float* base, int ld,
                                         int r0, int k0, int lane,
                                         float ca = 1.f, float cb = 1.f) {
  const float* p = base + (k0 + (lane & 3)) * ld + r0 + (lane >> 2);
  split(p[0] * ca, f.hi[0], f.lo[0]);
  split(p[8] * ca, f.hi[1], f.lo[1]);
  split(p[4 * ld] * cb, f.hi[2], f.lo[2]);
  split(p[4 * ld + 8] * cb, f.hi[3], f.lo[3]);
}

// load_a of a row-major tile with row r0 + g scaled by ra, r0 + g + 8 by rb
__device__ __forceinline__ void load_a_rows(A4& f, const float* base, int ld,
                                            int r0, int k0, int lane,
                                            float ra, float rb) {
  const int m = lane >> 3;
  uint32_t v[4];
  ldsm_x4(v, base + (r0 + 8 * (m & 1) + (lane & 7)) * ld + k0 + 4 * (m >> 1));
  split(__uint_as_float(v[0]) * ra, f.hi[0], f.lo[0]);
  split(__uint_as_float(v[1]) * rb, f.hi[1], f.lo[1]);
  split(__uint_as_float(v[2]) * ra, f.hi[2], f.lo[2]);
  split(__uint_as_float(v[3]) * rb, f.hi[3], f.lo[3]);
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

// sums over the 4 lanes of a quad (the columns of a fragment row) and over
// its 8 quads (the rows of a fragment column), the same order every call
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
__device__ __forceinline__ float column_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}
__device__ __forceinline__ float warp_sum(float v) {
  return column_sum(quad_sum(v));
}

// ----------------------------------------------------------------- states
// One block per (direction, sequence, head, tile of kRows state rows): 2N
// threads, N / 16 warps; warp w holds the 16 x 8 tiles of every 16 rows
// and columns 16 w.. of the state (forwards) or its adjoint (backwards) as
// mma accumulators, carried over the chunks, two blocks an SM. The next
// chunk's x (or dy), B (or C) and dt are copied by cp.async into the other
// stage of a two-stage ring while this chunk's product runs. Each block
// copies its sequence's B (or C) from L2 for every chunk and writes its
// states out: at row 3bwd the walk takes 0.24 of its 0.26 ms with its
// products left out. Blocks of 32 rows (twice the B and C copies) took
// 0.32 ms (tools/scan_probe.py --bwd-ablate); an earlier build with blocks
// of 2 heads on a three-stage ring, one an SM (half the copies again),
// 0.38 (--bwd): the other block on the SM hides each block's barriers and
// cumsum. The product's A operand, (x o w)^T (or (dy o exp(cs))^T), is
// read transposed from the raw [t][row] stage and scaled as it is loaded.
template <int N>
struct StatesSmem {
  static constexpr int kUs = kRows + 8;  // 72 = 8 (mod 32)
  static constexpr int kVs = N + 8;      // = 8 (mod 32)
  float u[2][kQ][kUs];  // x (forwards) or dy (backwards), raw, [t][row]
  float v[2][kQ][kVs];  // B (forwards) or C (backwards), [t][n]
  float dts[2][kQ];
  float cs[kQ], coef[kQ];  // w (forwards) or exp(cs) (backwards)
};

// The copies of chunk c into stage `buf` (rows past T and state rows past
// hd as zeros, dt = 0 past T). `v16`: rows of x and dy on 16 bytes, copied
// 4 floats at a time (B and C rows always are).
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
  }
  for (int e = tid; e < kQ * (N / 4); e += kT) {
    const int t = e / (N / 4), n = 4 * (e % (N / 4));
    if (t < nt)
      cp_async16(&sm.v[buf][t][n], vm + b * vb + (t0 + t) * vt + n);
    else
      *reinterpret_cast<float4*>(&sm.v[buf][t][n]) = z;
  }
  cp_async_commit();
}

template <int N>
__global__ void __launch_bounds__(2 * N, 2) ssd_bwd_states_kernel(Args p) {
  constexpr int kUs = StatesSmem<N>::kUs, kVs = StatesSmem<N>::kVs;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  StatesSmem<N>& sm = *reinterpret_cast<StatesSmem<N>*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int tiles = (p.hd + kRows - 1) / kRows;
  int id = blockIdx.x;
  const int tile = id % tiles; id /= tiles;
  const int h = id % p.H; id /= p.H;
  const int b = id % p.Bz;
  const bool back = id >= p.Bz;
  const int d0 = tile * kRows;
  const float a = p.A[h];
  const long long srow = (static_cast<long long>(b) * p.H + h) * p.hd;

  // s[mt][j][i]: row d0 + 16 mt + g + 8 (i >> 1), column 16 warp + 8 j +
  // 2 tg + (i & 1)
  float s[kMT][2][4];
  const float* init = back ? p.dsf : p.s0;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int d = d0 + 16 * mt + g + 8 * (i >> 1);
        const int n = 16 * warp + 8 * j + 2 * tg + (i & 1);
        s[mt][j][i] = init != nullptr && d < p.hd ? init[(srow + d) * N + n]
                                                  : 0.f;
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

    // this chunk's s_in (forwards) or ds (backwards), [hd][N] per head
    float* out = (back ? p.s_out : p.s_in) +
        ((static_cast<long long>(b) * p.nc + c) * p.H + h) * p.hd * N;
    const float dq = expf(sm.cs[kQ - 1]);
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = 16 * warp + 8 * j + 2 * tg;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int d = d0 + 16 * mt + g + 8 * hh;
          if (d < p.hd)
            *reinterpret_cast<float2*>(out + d * N + n) =
                make_float2(s[mt][j][2 * hh], s[mt][j][2 * hh + 1]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) s[mt][j][i] *= dq;
      }

    // s += (u o coef)^T v: rows d, k = the chunk's steps
#pragma unroll
    for (int k0 = 0; k0 < kQ; k0 += 8) {
      const float ca = sm.coef[k0 + tg], cb = sm.coef[k0 + tg + 4];
      A4 af[kMT];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
        load_a_t(af[mt], &sm.u[buf][0][0], kUs, 16 * mt, k0, lane, ca, cb);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        B2 bf;
        load_b_kn(bf, &sm.v[buf][0][0], kVs, 16 * warp + 8 * j, k0, lane);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) mma3(s[mt][j], af[mt], bf);
      }
    }
    __syncthreads();  // this stage is read: the next pass refills it
  }

  if (back && p.ds0 != nullptr) {
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int d = d0 + 16 * mt + g + 8 * hh;
          const int n = 16 * warp + 8 * j + 2 * tg;
          if (d < p.hd)
            *reinterpret_cast<float2*>(p.ds0 + (srow + d) * N + n) =
                make_float2(s[mt][j][2 * hh], s[mt][j][2 * hh + 1]);
        }
  }
}

// ------------------------------------------------------------------- gram
// G[t][s] = sum_n C[t][n] B[s][n] for s <= t (0 above the diagonal), as the
// forward's gram_kernel: a block of 4 warps per (sequence, chunk, 16 rows
// of G); a warp takes the column tiles w and w + 4 of these rows, those at
// or left of the diagonal in 3xTF32, the others written as zeros.
constexpr int kGramWarps = 4;

template <int N>
__global__ void __launch_bounds__(32 * kGramWarps) ssd_bwd_gram_kernel(Args p) {
  constexpr int kBs = N + 4;
  __shared__ __align__(16) float crow[16][kBs];
  __shared__ __align__(16) float brow[kQ][kBs];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int mi = blockIdx.x % (kQ / 16);
  const int c = (blockIdx.x / (kQ / 16)) % p.nc;
  const int b = blockIdx.x / ((kQ / 16) * p.nc);
  const int t0 = c * kQ, nt = min(kQ, p.T - t0);
  const int rows = 16 * (mi + 1);        // B rows up to the diagonal
  const float* bb = p.B + b * p.bb + t0 * p.bt;
  const float* cb = p.C + b * p.cb + t0 * p.ct;
  for (int e = tid; e < (16 + rows) * (N / 4); e += 32 * kGramWarps) {
    const int r = e / (N / 4), n = 4 * (e % (N / 4));
    const bool is_c = r < 16;
    const int t = is_c ? 16 * mi + r : r - 16;
    float* dst = is_c ? &crow[r][n] : &brow[t][n];
    if (t < nt)
      cp_async16(dst, (is_c ? cb + t * p.ct : bb + t * p.bt) + n);
    else
      *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  cp_async_wait_all();
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
  float* out = p.gram + (static_cast<long long>(b) * p.nc + c) * kQ * kQ;
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

// ------------------------------------------------------------------ chunk
// One block per (sequence, chunk, group of hg heads). A step is one
// (head, slice of kPT head dims); per step the warps run
//   (a) dM += dy x^T           [Q x Q], the 20 causal 16 x 8 tiles, k = p
//   (b) M^T dy                 [Q x kPT], k = t >= s
//   (c) B ds^T                 [Q x kPT], k = n
//   (d) P += dy s_in           [Q x N], k = p (the head's, over its slices)
//   (e) dBg += (x o w) ds      [Q x N], k = p (the group's, over its heads)
// and write dx = (b) + w o (c) + D dy; after a head's last slice dM and P
// are read out: dGg += dM o L, dCg += exp(cs) o P, the row and column sums
// of the head's dcs (dw = rows of x o (c), <dy, C s_in^T> = rows of C o P,
// the sums of dM o M and dM o G o E), then its ddt and its parts of dA and
// dD. dCg and dBg stay in the warps' accumulators over the group, dGg in
// shared memory (each thread its own fragments); all three are written
// once. Warp w's tiles: (a) the causal tile w of 20, and w + 4 for w >= 12
// (whose (b) rows have the fewest steps t >= s); (b), (c) rows 16 (w /
// 4).., columns 8 (w % 4)..; (d), (e) rows 16 (w % 4).., kJ column tiles
// from 8 kJ (w / 4) (N = 16: warps 0-7).
//
// The 16 warps also stage: step k + 1's x, dy, s_in and ds are copied by
// cp.async into the other stage of a two-stage ring while step k's
// products run (B, C and G once a block, with step 0). Staging warps
// beside the product warps (1, 2 or 4 of them, as the forward's
// dual_kernel has) made no difference to the time and cut the product
// warps to 96 registers a thread (a block of 17 to 20 warps), with spills;
// 16 warps have 128.
constexpr int kWarps = 16;
constexpr int kChunkThreads = 32 * kWarps;
constexpr int kXs = kPT + 4;  // x, dy rows: 36 = 4 (mod 32), read by ldmatrix
constexpr int kGs = kQ + 4;   // G rows: 68 = 4 (mod 32)
constexpr int kMs = kQ + 8;   // M rows: 72 = 8 (mod 32), read transposed
constexpr int kCausal = 20;   // causal 16 x 8 tiles of a [Q x Q] matrix

template <int N>
struct ChunkSmem {
  static constexpr int kBs = N + 4;  // B, C, ds rows: = 4 (mod 32)
  static constexpr int kSs = N + 8;  // s_in rows: = 8 (mod 32), read k-major
  // a (head, slice) step, two stages
  float x[2][kQ][kXs], dy[2][kQ][kXs];      // [t][p]
  float st[2][kPT][kSs], dst[2][kPT][kBs];  // s_in, ds: [p][n]
  float dts[2][kQ];                         // dt (a head's first slice)
  // the chunk's
  float b[kQ][kBs], c[kQ][kBs];  // B, C: [t][n]
  float g[kQ][kGs];              // G: [t][s]
  // the head's
  float m[kQ][kMs];              // M = G o L
  float dt[kQ], cs[kQ], ecs[kQ], w[kQ];
  // the group's dG, by causal tile and fragment (lane l: 4 l..)
  float dgg[kCausal][128];
  // a head's partial sums, by contributor
  float rw[kQ][4];               // dw by (c)'s column tile
  float re[kQ][4];               // <dy, C s_in^T> by (d)'s column group
  float rrow[kQ][8];             // dM o M by rows, by column tile
  float rcl[kQ][4], rce[kQ][4];  // dM o M and dM o G o E by columns, by row tile
  float red[2][kWarps];          // x dy and <ds, s_in> by warp
};

// Causal 16 x 8 tile k (of 20) of a [Q x Q] matrix: m-tile mi has 2 mi + 2
__device__ __forceinline__ void causal_tile(int k, int& mi, int& nj) {
  mi = k < 2 ? 0 : k < 6 ? 1 : k < 12 ? 2 : 3;
  nj = k - mi * (mi + 1);
}

// Step k's copies into buffer buf (rows past T and head dims past hd as
// zeros, dt = 0 past T), the head's dt with its first slice, the chunk's
// B, C and G with step 0
template <int N>
__device__ __forceinline__ void stage_chunk(const Args& p, ChunkSmem<N>& sm,
                                            int k, int buf, int tid, int b,
                                            int c, int h0, int ns) {
  const int t0 = c * kQ, nt = min(kQ, p.T - t0);
  const int h = h0 + k / ns, p0 = (k % ns) * kPT;
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  const float* xb = p.x + b * p.xb + h * p.xh + t0 * p.xt;
  const float* yb = p.dy + dy_at(p, b, t0, h);
  const long long ystride = static_cast<long long>(p.H) * p.hd;
  if (p.v16) {
    for (int e = tid; e < kQ * (kPT / 4); e += kChunkThreads) {
      const int t = e / (kPT / 4), r = 4 * (e % (kPT / 4)), d = p0 + r;
      if (t < nt && d < p.hd) {
        cp_async16(&sm.x[buf][t][r], xb + t * p.xt + d);
        cp_async16(&sm.dy[buf][t][r], yb + t * ystride + d);
      } else {
        *reinterpret_cast<float4*>(&sm.x[buf][t][r]) = z;
        *reinterpret_cast<float4*>(&sm.dy[buf][t][r]) = z;
      }
    }
  } else {
    for (int e = tid; e < kQ * kPT; e += kChunkThreads) {
      const int t = e / kPT, r = e % kPT, d = p0 + r;
      if (t < nt && d < p.hd) {
        cp_async4(&sm.x[buf][t][r], xb + t * p.xt + d);
        cp_async4(&sm.dy[buf][t][r], yb + t * ystride + d);
      } else {
        sm.x[buf][t][r] = sm.dy[buf][t][r] = 0.f;
      }
    }
  }
  const long long head = (static_cast<long long>(b) * p.nc + c) * p.H + h;
  const float* si = p.s_in + head * p.hd * N;
  const float* so = p.s_out + head * p.hd * N;
  for (int e = tid; e < kPT * (N / 4); e += kChunkThreads) {
    const int r = e / (N / 4), n = 4 * (e % (N / 4)), d = p0 + r;
    if (d < p.hd) {
      cp_async16(&sm.st[buf][r][n], si + d * N + n);
      cp_async16(&sm.dst[buf][r][n], so + d * N + n);
    } else {
      *reinterpret_cast<float4*>(&sm.st[buf][r][n]) = z;
      *reinterpret_cast<float4*>(&sm.dst[buf][r][n]) = z;
    }
  }
  if (k % ns == 0 && tid < kQ) {
    if (tid < nt)
      cp_async4(&sm.dts[buf][tid],
                p.dt + b * p.db + (t0 + tid) * p.dtt + h * p.dh);
    else
      sm.dts[buf][tid] = 0.f;
  }
  if (k == 0) {
    for (int e = tid; e < kQ * (N / 4); e += kChunkThreads) {
      const int t = e / (N / 4), n = 4 * (e % (N / 4));
      if (t < nt) {
        cp_async16(&sm.b[t][n], p.B + b * p.bb + (t0 + t) * p.bt + n);
        cp_async16(&sm.c[t][n], p.C + b * p.cb + (t0 + t) * p.ct + n);
      } else {
        *reinterpret_cast<float4*>(&sm.b[t][n]) = z;
        *reinterpret_cast<float4*>(&sm.c[t][n]) = z;
      }
    }
    const float* gb = p.gram + (static_cast<long long>(b) * p.nc + c) * kQ * kQ;
    for (int e = tid; e < kQ * (kQ / 4); e += kChunkThreads) {
      const int t = e / (kQ / 4), s = 4 * (e % (kQ / 4));
      cp_async16(&sm.g[t][s], gb + t * kQ + s);
    }
  }
  cp_async_commit();
}

template <int N>
__global__ void __launch_bounds__(kChunkThreads, 1) ssd_bwd_chunk_kernel(Args p) {
  constexpr int kBs = ChunkSmem<N>::kBs, kSs = ChunkSmem<N>::kSs;
  constexpr int kJ = N >= 32 ? N / 32 : 1;  // (d), (e) column tiles a warp
  constexpr int kDG = N / 8 / kJ;           // warps over one row tile's columns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ChunkSmem<N>& sm = *reinterpret_cast<ChunkSmem<N>*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int G = head_groups(p);
  const int grp = blockIdx.x % G;
  const int c = (blockIdx.x / G) % p.nc;
  const int b = blockIdx.x / (G * p.nc);
  const int t0 = c * kQ, nt = min(kQ, p.T - t0);
  const int h0 = grp * p.hg, nh = min(p.H - h0, p.hg);
  const int ns = (p.hd + kPT - 1) / kPT, steps = nh * ns;

  int ak[2], am[2], an[2];  // (a)'s causal tiles: 16-19 to the warps of
  ak[0] = warp;             // (b)'s shortest rows (t >= s from 48)
  ak[1] = warp >= 12 ? warp + 4 : 0;
  const int na = warp >= 12 ? 2 : 1;
  causal_tile(ak[0], am[0], an[0]);
  causal_tile(ak[1], am[1], an[1]);
  const int xm = warp >> 2, xp = warp & 3;          // (b), (c)
  const int em = warp & 3, eg = warp >> 2;          // (d), (e)
  const bool has_e = eg < kDG;

  float dM[2][4] = {};
  float P[kJ][4] = {}, dCg[kJ][4] = {}, dBg[kJ][4] = {};
  float dwp[2] = {0.f, 0.f}, xdy = 0.f, sds = 0.f;
  float dD = 0.f;
#pragma unroll
  for (int q = 0; q < 2; ++q)
    if (q < na)
      *reinterpret_cast<float4*>(&sm.dgg[ak[q]][4 * lane]) =
          make_float4(0.f, 0.f, 0.f, 0.f);

  stage_chunk<N>(p, sm, 0, 0, tid, b, c, h0, ns);
  for (int k = 0; k < steps; ++k) {
    const int buf = k & 1, h = h0 + k / ns, sl = k % ns, p0 = sl * kPT;
    cp_async_wait_all();
    __syncthreads();  // step k has landed, and step k - 1 is done: its
                      // buffers take step k + 1 while k runs
    if (k + 1 < steps) stage_chunk<N>(p, sm, k + 1, buf ^ 1, tid, b, c, h0, ns);
    if (sl == 0) {    // the head's decays, then M = G o L
      if (warp == 0) {
        const float a = p.A[h];
        const float u0 = sm.dts[buf][lane], u1 = sm.dts[buf][lane + 32];
        cumsum64(sm.dts[buf], sm.cs, a, lane);
        __syncwarp();
        const float v0 = sm.cs[lane], v1 = sm.cs[lane + 32];
        const float cq = sm.cs[kQ - 1];
        sm.dt[lane] = u0;
        sm.dt[lane + 32] = u1;
        sm.ecs[lane] = expf(v0);
        sm.ecs[lane + 32] = expf(v1);
        sm.w[lane] = expf(cq - v0) * u0;
        sm.w[lane + 32] = expf(cq - v1) * u1;
      }
      dD = p.D[h];
      __syncthreads();
      for (int e = tid; e < kQ * kQ; e += kChunkThreads) {
        const int t = e / kQ, s = e % kQ;
        sm.m[t][s] = s <= t ? sm.g[t][s] * expf(sm.cs[t] - sm.cs[s]) * sm.dt[s]
                            : 0.f;
      }
      __syncthreads();
    }
    const float* cs = sm.cs;
    const float* dts = sm.dt;
    const float* ws = sm.w;
    const float* xs = &sm.x[buf][0][0];
    const float* ys = &sm.dy[buf][0][0];

    // (a) dM += dy x^T over this slice (tiles wholly past T are zero: a
    // short last chunk skips them, as every product below)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (q < na && 16 * am[q] < nt && 8 * an[q] < nt) {
#pragma unroll
        for (int k0 = 0; k0 < kPT; k0 += 8) {
          A4 af;
          B2 bf;
          load_a(af, ys, kXs, 16 * am[q], k0, lane);
          load_b_nk(bf, xs, kXs, 8 * an[q], k0, lane);
          mma3(dM[q], af, bf);
        }
      }
    }
    // (d) P += dy s_in, (e) dBg += (x o w) ds over this slice
    if (has_e && 16 * em < nt) {
      const float wa = ws[16 * em + g], wb = ws[16 * em + g + 8];
#pragma unroll
      for (int k0 = 0; k0 < kPT; k0 += 8) {
        A4 ay, ax;
        load_a(ay, ys, kXs, 16 * em, k0, lane);
        load_a_rows(ax, xs, kXs, 16 * em, k0, lane, wa, wb);
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
          const int n0 = 8 * (eg * kJ + j);
          B2 bs, bd;
          load_b_kn(bs, &sm.st[buf][0][0], kSs, n0, k0, lane);
          mma3(P[j], ay, bs);
          load_b_kn(bd, &sm.dst[buf][0][0], kBs, n0, k0, lane);
          mma3(dBg[j], ax, bd);
        }
      }
    }
    // (b) M^T dy (t >= s) and (c) B ds^T (one chain each: with two, 3%
    // slower for the registers)
    float mdy[4] = {}, bds[4] = {};
    const bool xlive = 16 * xm < nt;
#pragma unroll 2
    for (int k0 = 16 * xm; xlive && k0 < nt; k0 += 8) {
      A4 af;
      B2 bf;
      load_a_t(af, &sm.m[0][0], kMs, 16 * xm, k0, lane);
      load_b_kn(bf, ys, kXs, 8 * xp, k0, lane);
      mma3(mdy, af, bf);
    }
#pragma unroll 4
    for (int k0 = 0; xlive && k0 < N; k0 += 8) {
      A4 af;
      B2 bf;
      load_a(af, &sm.b[0][0], kBs, 16 * xm, k0, lane);
      load_b_nk(bf, &sm.dst[buf][0][0], kBs, 8 * xp, k0, lane);
      mma3(bds, af, bf);
    }
    // dx; dw and x dy by thread
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = 16 * xm + g + 8 * (i >> 1);
      const int r = 8 * xp + 2 * tg + (i & 1), d = p0 + r;
      const float xv = sm.x[buf][s][r], yv = sm.dy[buf][s][r], bv = bds[i];
      dwp[i >> 1] = fmaf(xv, bv, dwp[i >> 1]);
      xdy = fmaf(xv, yv, xdy);
      if (s < nt && d < p.hd)
        p.dx[dy_at(p, b, t0 + s, h) + d] = fmaf(ws[s], bv, mdy[i]) + dD * yv;
    }
    for (int e = tid; e < kPT * N; e += kChunkThreads)
      sds = fmaf(sm.st[buf][e / N][e % N], sm.dst[buf][e / N][e % N], sds);

    if (sl == ns - 1) {
      // the head is done: dM o L into dGg; the sums of dM o M by rows and
      // columns and of dM o G o E by columns, by tile
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (q < na) {
          const int mi = am[q], nj = an[q];
          float rp[2] = {0.f, 0.f}, cl[2] = {0.f, 0.f}, ce[2] = {0.f, 0.f};
          float4& dg = *reinterpret_cast<float4*>(&sm.dgg[ak[q]][4 * lane]);
          float dgv[4] = {dg.x, dg.y, dg.z, dg.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int t = 16 * mi + g + 8 * (i >> 1);
            const int s = 8 * nj + 2 * tg + (i & 1);
            if (s <= t) {
              const float v = dM[q][i], e = expf(cs[t] - cs[s]);
              const float ll = v * sm.m[t][s];
              dgv[i] += v * e * dts[s];
              rp[i >> 1] += ll;
              cl[i & 1] += ll;
              ce[i & 1] = fmaf(v * sm.g[t][s], e, ce[i & 1]);
            }
            dM[q][i] = 0.f;
          }
          dg = make_float4(dgv[0], dgv[1], dgv[2], dgv[3]);
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            rp[hh] = quad_sum(rp[hh]);
            cl[hh] = column_sum(cl[hh]);
            ce[hh] = column_sum(ce[hh]);
          }
          if (tg == 0) {
            sm.rrow[16 * mi + g][nj] = rp[0];
            sm.rrow[16 * mi + g + 8][nj] = rp[1];
          }
          if (g == 0) {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              sm.rcl[8 * nj + 2 * tg + j][mi] = cl[j];
              sm.rce[8 * nj + 2 * tg + j][mi] = ce[j];
            }
          }
        }
      }
      // exp(cs) o P into dCg; <dy, C s_in^T> = the rows of C o P
      if (has_e) {
        const float* ecs = sm.ecs;
        float de[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < kJ; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int t = 16 * em + g + 8 * (i >> 1);
            const int n = 8 * (eg * kJ + j) + 2 * tg + (i & 1);
            de[i >> 1] = fmaf(sm.c[t][n], P[j][i], de[i >> 1]);
            dCg[j][i] = fmaf(ecs[t], P[j][i], dCg[j][i]);
            P[j][i] = 0.f;
          }
        de[0] = quad_sum(de[0]);
        de[1] = quad_sum(de[1]);
        if (tg == 0) {
          sm.re[16 * em + g][eg] = de[0];
          sm.re[16 * em + g + 8][eg] = de[1];
        }
      }
      dwp[0] = quad_sum(dwp[0]);
      dwp[1] = quad_sum(dwp[1]);
      if (tg == 0) {
        sm.rw[16 * xm + g][xp] = dwp[0];
        sm.rw[16 * xm + g + 8][xp] = dwp[1];
      }
      xdy = warp_sum(xdy);
      sds = warp_sum(sds);
      if (lane == 0) {
        sm.red[0][warp] = xdy;
        sm.red[1][warp] = sds;
      }
      dwp[0] = dwp[1] = xdy = sds = 0.f;
      __syncthreads();

      // warp 0 closes the head, steps t = lane and lane + 32: dcs, its
      // suffix sums S, ddt = the row terms + A S, dA's part sum dt S
      if (warp == 0) {
        const float cq = cs[kQ - 1];
        float dcs[2], ddt[2], dww[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int t = lane + 32 * r;
          float dw = 0.f, de = 0.f, row = 0.f, col = 0.f, ce = 0.f;
#pragma unroll
          for (int q = 0; q < 4; ++q) dw += sm.rw[t][q];
#pragma unroll
          for (int q = 0; q < kDG; ++q) de += sm.re[t][q];
#pragma unroll
          for (int nj = 0; nj < 8; ++nj)  // the causal tiles of row t
            if (nj <= 2 * (t >> 4) + 1) row += sm.rrow[t][nj];
#pragma unroll
          for (int mi = 0; mi < 4; ++mi)  // and of column t
            if (mi >= (t >> 3) >> 1) {
              col += sm.rcl[t][mi];
              ce += sm.rce[t][mi];
            }
          dww[r] = dw * ws[t];
          dcs[r] = row - col + sm.ecs[t] * de - dww[r];
          ddt[r] = fmaf(dw, expf(cq - cs[t]), ce);
        }
        const float dwsum = warp_sum(dww[0] + dww[1]);
        const float xd = warp_sum(lane < kWarps ? sm.red[0][lane] : 0.f);
        const float sd = warp_sum(lane < kWarps ? sm.red[1][lane] : 0.f);
        if (lane == 31) dcs[1] += dwsum + expf(cq) * sd;
        // suffix sums (t' >= t) of each half, then the upper half's total
        // into the lower
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float u0 = __shfl_down_sync(0xffffffffu, dcs[0], o);
          const float u1 = __shfl_down_sync(0xffffffffu, dcs[1], o);
          if (lane + o < 32) {
            dcs[0] += u0;
            dcs[1] += u1;
          }
        }
        dcs[0] += __shfl_sync(0xffffffffu, dcs[1], 0);
        const float da = warp_sum(fmaf(dts[lane], dcs[0],
                                       dts[lane + 32] * dcs[1]));
        const long long head = (static_cast<long long>(b) * p.nc + c) * p.H + h;
        if (lane == 0) {
          p.part[head] = da;
          p.part[static_cast<long long>(p.Bz) * p.nc * p.H + head] = xd;
        }
        const float ah = p.A[h];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int t = lane + 32 * r;
          if (t < nt)
            p.ddt[(static_cast<long long>(b) * p.T + t0 + t) * p.H + h] =
                fmaf(ah, dcs[r], ddt[r]);
        }
      }
    }
  }

  // the group's parts of dC, dB and dG
  const long long part = (static_cast<long long>(b) * p.nc + c) * G + grp;
  const long long plane = static_cast<long long>(p.Bz) * p.nc * G * kQ * N;
  if (has_e) {
#pragma unroll
    for (int j = 0; j < kJ; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int t = 16 * em + g + 8 * hh;
        const long long row =
            (part * kQ + t) * N + 8 * (eg * kJ + j) + 2 * tg;
        *reinterpret_cast<float2*>(p.bcp + row) =
            make_float2(dCg[j][2 * hh], dCg[j][2 * hh + 1]);
        *reinterpret_cast<float2*>(p.bcp + plane + row) =
            make_float2(dBg[j][2 * hh], dBg[j][2 * hh + 1]);
      }
  }
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    if (q < na) {
      const float4 dg = *reinterpret_cast<const float4*>(&sm.dgg[ak[q]][4 * lane]);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int t = 16 * am[q] + g + 8 * hh, s = 8 * an[q] + 2 * tg;
        *reinterpret_cast<float2*>(p.dgp + (part * kQ + t) * kQ + s) =
            hh ? make_float2(dg.z, dg.w) : make_float2(dg.x, dg.y);
      }
    }
  }
}

// ----------------------------------------------------------------- bc_sum
// dC = dG B + sum_g dCg and dB = dG^T C + sum_g dBg: one block per
// (sequence, chunk, kNT state columns), dG = the groups' dGg summed in
// order (the chunk kernel writes the causal tiles only: zero above the
// diagonal here). Warps 0-3 make dC's rows 16 w.., warps 4-7 dB's, over
// every column of the tile, their accumulators started at the groups'
// parts (in order).
constexpr int kSumWarps = 8;

template <int N>
struct BcSumSmem {
  static constexpr int kNT = N < 64 ? N : 64;
  static constexpr int kNs = kNT + 8;   // B, C rows, read k-major
  float dg[kQ][kGs];                    // dG: [t][s]
  float bn[kQ][kNs], cn[kQ][kNs];       // B, C columns of the tile
};

template <int N>
__global__ void __launch_bounds__(32 * kSumWarps) ssd_bwd_bc_sum_kernel(Args p) {
  using S = BcSumSmem<N>;
  constexpr int kNT = S::kNT, kNs = S::kNs, kJ = kNT / 8, kTiles = N / kNT;
  constexpr int kThreads = 32 * kSumWarps;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S& sm = *reinterpret_cast<S*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int G = head_groups(p);
  const int tile = blockIdx.x % kTiles;
  const int c = (blockIdx.x / kTiles) % p.nc;
  const int b = blockIdx.x / (kTiles * p.nc);
  const int n0 = tile * kNT, t0 = c * kQ, nt = min(kQ, p.T - t0);
  const long long part0 = (static_cast<long long>(b) * p.nc + c) * G;

  for (int e = tid; e < kQ * (kNT / 4); e += kThreads) {
    const int t = e / (kNT / 4), n = 4 * (e % (kNT / 4));
    if (t < nt) {
      cp_async16(&sm.bn[t][n], p.B + b * p.bb + (t0 + t) * p.bt + n0 + n);
      cp_async16(&sm.cn[t][n], p.C + b * p.cb + (t0 + t) * p.ct + n0 + n);
    } else {
      *reinterpret_cast<float4*>(&sm.bn[t][n]) = make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(&sm.cn[t][n]) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  for (int e = tid; e < kQ * kQ; e += kThreads) {
    const int t = e / kQ, s = e % kQ;
    float v = 0.f;
    if (s <= t)
      for (int q = 0; q < G; ++q) v += p.dgp[(part0 + q) * kQ * kQ + e];
    sm.dg[t][s] = v;
  }
  const int which = warp >> 2, mi = warp & 3;  // 0: dC, 1: dB
  const float* src =
      p.bcp + (which ? static_cast<long long>(p.Bz) * p.nc * G * kQ * N : 0);
  float acc[kJ][4];
#pragma unroll
  for (int j = 0; j < kJ; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = 16 * mi + g + 8 * (i >> 1);
      const int n = n0 + 8 * j + 2 * tg + (i & 1);
      float v = 0.f;
      for (int q = 0; q < G; ++q) v += src[((part0 + q) * kQ + t) * N + n];
      acc[j][i] = v;
    }
  cp_async_wait_all();
  __syncthreads();
  if (16 * mi >= nt) {
    // rows wholly past T: nothing to write
  } else if (which == 0) {  // dC[t] += sum_{s <= t} dG[t][s] B[s]
    for (int k0 = 0; k0 < 16 * mi + 16; k0 += 8) {
      A4 af;
      load_a(af, &sm.dg[0][0], kGs, 16 * mi, k0, lane);
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        B2 bf;
        load_b_kn(bf, &sm.bn[0][0], kNs, 8 * j, k0, lane);
        mma3(acc[j], af, bf);
      }
    }
  } else {                  // dB[s] += sum_{t >= s} dG[t][s] C[t]
    for (int k0 = 16 * mi; k0 < nt; k0 += 8) {
      A4 af;
      load_a_t(af, &sm.dg[0][0], kGs, 16 * mi, k0, lane);
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        B2 bf;
        load_b_kn(bf, &sm.cn[0][0], kNs, 8 * j, k0, lane);
        mma3(acc[j], af, bf);
      }
    }
  }
  float* out = which ? p.dB : p.dC;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = 16 * mi + g + 8 * (i >> 1);
    if (t < nt) {
      const long long row = (static_cast<long long>(b) * p.T + t0 + t) * N + n0;
#pragma unroll
      for (int j = 0; j < kJ; ++j) out[row + 8 * j + 2 * tg + (i & 1)] = acc[j][i];
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
  static_assert(N % 16 == 0, "N must be a multiple of 16");
  static_assert(sizeof(StatesSmem<N>) <= kMaxSmem &&
                    sizeof(ChunkSmem<N>) <= kMaxSmem &&
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
    constexpr int kTiles = N / BcSumSmem<N>::kNT;
    const int G = head_groups(p);
    ssd_bwd_gram_kernel<N><<<p.Bz * p.nc * (kQ / 16), 32 * kGramWarps, 0,
                             stream>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    err = cudaFuncSetAttribute(ssd_bwd_chunk_kernel<N>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               sizeof(ChunkSmem<N>));
    if (err != cudaSuccess) return err;
    ssd_bwd_chunk_kernel<N><<<p.Bz * p.nc * G, kChunkThreads,
                              sizeof(ChunkSmem<N>), stream>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    err = cudaFuncSetAttribute(ssd_bwd_bc_sum_kernel<N>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               sizeof(BcSumSmem<N>));
    if (err != cudaSuccess) return err;
    ssd_bwd_bc_sum_kernel<N><<<p.Bz * p.nc * kTiles, 32 * kSumWarps,
                               sizeof(BcSumSmem<N>), stream>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  ssd_bwd_sum_kernel<<<(p.H + 63) / 64, 64, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// All tensors float32. s0, dsf and ds0 may be null. x, B, C and dt strides
// are in elements (x: batch, time, head; B, C: batch, time; dt: batch,
// time, head), their last axis unit-stride, B and C rows on 16 bytes; dy
// and every output are contiguous. The scratch (`gram` [Bz*nc*Q*Q],
// `s_in`/`s_out` [Bz*nc*H*hd*N], `part` [2*Bz*nc*H], `bcp`
// [2*Bz*nc*G*Q*N], `dgp` [Bz*nc*G*Q*Q], G = ceil(H / hg)) is the caller's;
// nc = ceil(T / 64); `hg` heads a chunk block walks. Returns the
// cudaError_t of the first launch that fails (0 on success).
extern "C" int ssd_scan_bwd(
    const void* x, const void* Bm, const void* Cm, const void* dt,
    const void* A, const void* D, const void* s0, const void* dy,
    const void* dsf, void* dx, void* dB, void* dC, void* ddt, void* dA,
    void* dD, void* ds0, void* gram, void* s_in, void* s_out, void* part,
    void* bcp, void* dgp, int Bz, int T, int H, int hd, int N, int hg,
    int v16,
    long long x_sb, long long x_st, long long x_sh, long long b_sb,
    long long b_st, long long c_sb, long long c_st, long long dt_sb,
    long long dt_st, long long dt_sh, void* stream) {
  const Args p{static_cast<const float*>(x), static_cast<const float*>(Bm),
               static_cast<const float*>(Cm), static_cast<const float*>(dt),
               static_cast<const float*>(A), static_cast<const float*>(D),
               static_cast<const float*>(s0), static_cast<const float*>(dy),
               static_cast<const float*>(dsf), static_cast<float*>(dx),
               static_cast<float*>(dB), static_cast<float*>(dC),
               static_cast<float*>(ddt), static_cast<float*>(dA),
               static_cast<float*>(dD), static_cast<float*>(ds0),
               static_cast<float*>(gram), static_cast<float*>(s_in),
               static_cast<float*>(s_out), static_cast<float*>(part),
               static_cast<float*>(bcp), static_cast<float*>(dgp), Bz, T, H,
               hd, (T + kQ - 1) / kQ, hg, v16, x_sb, x_st, x_sh, b_sb, b_st,
               c_sb, c_st, dt_sb, dt_st, dt_sh};
  cudaStream_t str = static_cast<cudaStream_t>(stream);
  if (hg < 1) return cudaErrorInvalidValue;
  switch (N) {
    case 16: return launch<16>(p, str);
    case 32: return launch<32>(p, str);
    case 64: return launch<64>(p, str);
    case 128: return launch<128>(p, str);
    default: return cudaErrorInvalidValue;
  }
}
