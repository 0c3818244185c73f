// Prefill attention backward for Hopper (sm_90a): FlashAttention-2's
// backward, recomputing the probabilities from the forward's row
// log-sum-exp.
//
// Replaces the attention backward of the JAX package's train path,
// src/repro/kernels/flash_xla.py::_bwd (the custom VJP of
// flash_attention_xla, which JAX differentiates instead of the Pallas
// forward off the TPU). Same function, for the forward of
// flash_attention.cu (q [B,T,H,D], k/v [B,S,Hk,D], query head h reads KV
// head kv_map[h], causal at q_offset, a window, or no mask):
//
//     delta = rowsum(dO * O)
//     p     = exp(scale q.k - lse)             (0 for a masked pair)
//     dV   += p^T dO,  dP = dO V^T,  ds = p (dP - delta)
//     dQ   += scale ds K,  dK += scale ds^T Q
//
// with dK/dV summed over the query heads that read each KV head. lse is the
// forward's lse_out, [B, H, T] float32 in base e (-inf for a row with no
// visible key); the bfloat16 kernels scale it by log2 e and recompute p in
// base 2 with scale log2 e folded into the scores, as the forward does. A
// row with no visible key, and a row past T, gets lse = +inf here, so its
// p, and with it every gradient it feeds, is exactly 0.
//
// Three kernels, no atomics: each output element is written by one block
// that sums its terms in a fixed order, so two calls give bitwise the same
// dQ, dK and dV.
//   (a) delta_kernel: delta [B, H, T] float32, one warp a row.
//   (b) dkdv: one block per (batch, KV head, 64-key tile). It walks the
//       query heads of its KV head (the inverse map, built on the host:
//       group_off [Hk+1] and group_heads [H]) and their visible query
//       tiles, recomputes S^T = K Q^T and dP^T = V dO^T for its keys, and
//       keeps dK and dV in registers. GQA/MQA need no expanded K/V and no
//       reduction across blocks.
//   (c) dq: one block per (batch, query head, 64-row tile), over the
//       visible KV tiles, dQ in registers.
// At head dim 256 the dK/dV and dQ accumulators of 16 rows x 256 columns
// would take 256 registers a thread; the grid's third axis then cuts the
// output columns into slices of 128, each block recomputing the scores for
// its slice.
//
// Bound on the H100: per visible (query, key) pair and head, 2.5x the
// forward's 4 D flops (S, dP, dV, dQ, dK: five products of 2 D), at the
// training shapes (T = S = 1024, D = 64) far above the ridge: the bound is
// the tensor cores' arithmetic. This first kernel is FlashAttention-2's
// structure on mma.sync, as the forward; a wgmma/TMA pipeline is later work.
//
// bfloat16: mma.sync.m16n8k16 bf16 -> f32, with p and ds rounded to bf16 in
// registers as the A operands of the next products (as the forward's P);
// Q/dO (dkdv) and K/V (dq) tiles stream through a 2-stage cp.async ring.
// float32: CUDA-core kernels with the scores in shared memory (the tensor
// cores take float32 only as TF32), held to 2e-5 like the float32 forward.
//
// Plain C interface (bound from Python with ctypes). Every tensor is
// contiguous: q, o, dout, dq [B,T,H,D]; k, v, dk, dv [B,S,Hk,D]; lse and
// the delta scratch [B,H,T] float32.

#include "attn_split.cuh"
#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;         // [B, H, T], base e
  float* delta;             // [B, H, T]
  void* dq;
  void* dk;
  void* dv;
  const int* kv_map;        // [H] or null
  const int* group_off;     // [Hk + 1]: query heads of KV head j are
  const int* group_heads;   //   group_heads[group_off[j] .. group_off[j+1])
  int B, T, S, H, Hk;
  int causal, window, q_offset;
  float scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ bool visible(const Params& p, int qpos, int kpos) {
  bool ok = kpos < p.S;
  if (p.causal) ok = ok && qpos >= kpos;
  if (p.window > 0) ok = ok && qpos - kpos < p.window;
  return ok;
}

// Query rows [i_begin, i_end) that any key of [k0, k0 + rows) sees.
__device__ __forceinline__ void visible_rows(const Params& p, int k0, int rows,
                                             int* i_begin, int* i_end) {
  const int k_last = min(k0 + rows, p.S) - 1;
  *i_begin = p.causal ? max(0, k0 - p.q_offset) : 0;
  *i_end = p.window > 0 ? min(p.T, k_last + p.window - p.q_offset) : p.T;
  if (k_last < k0) *i_end = *i_begin;
}

// Keys [j_begin, j_end) that any query row of [q0, q0 + rows) sees.
__device__ __forceinline__ void visible_keys(const Params& p, int q0, int rows,
                                             int* j_begin, int* j_end) {
  const int q_last = min(q0 + rows, p.T) - 1 + p.q_offset;
  *j_end = p.causal ? min(p.S, q_last + 1) : p.S;
  *j_begin = p.window > 0 ? max(0, q0 + p.q_offset - p.window + 1) : 0;
}

// The row's lse as the kernels read it: +inf for a row past T or with no
// visible key (so that every p of the row is 0), times `mul` otherwise.
__device__ __forceinline__ float row_lse(const Params& p, int b, int h, int i,
                                         float mul) {
  if (i >= p.T) return INFINITY;
  const float l = __ldg(p.lse + (static_cast<long long>(b) * p.H + h) * p.T + i);
  return l == -INFINITY ? INFINITY : l * mul;
}
__device__ __forceinline__ float row_delta(const Params& p, int b, int h,
                                           int i) {
  if (i >= p.T) return 0.f;
  return p.delta[(static_cast<long long>(b) * p.H + h) * p.T + i];
}

// ------------------------------------------------------- (a) delta
template <typename E>
__global__ void __launch_bounds__(kThreads)
delta_kernel(const Params p, int D) {
  const long long r = blockIdx.x * static_cast<long long>(kThreads / 32) +
                      threadIdx.x / 32;          // row (b T + t) H + h
  const int lane = threadIdx.x % 32;
  if (r >= static_cast<long long>(p.B) * p.T * p.H) return;
  const E* o = static_cast<const E*>(p.o) + r * D;
  const E* d = static_cast<const E*>(p.dout) + r * D;
  float s = 0.f;
  for (int c = lane; c < D; c += 32) s = fmaf(to_f(o[c]), to_f(d[c]), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) {
    const long long bt = r / p.H, b = bt / p.T;
    p.delta[(b * p.H + r % p.H) * p.T + bt % p.T] = s;
  }
}

// ------------------------------------------------- bfloat16: tensor cores
constexpr int kKeys = 64;     // keys a dkdv block, 16 a warp
constexpr int kRows = 64;     // query rows a dq block, 16 a warp

template <int D>
struct Bwd {
  static constexpr int kRS = D + 8;             // shared row stride: +16 B
  static constexpr int kDO = D < 128 ? D : 128; // output columns a block
  // dkdv: query rows a step (S^T and dP^T are 16 x kBM a warp)
  static constexpr int kBM = D <= 64 ? 64 : 32;
  static constexpr int kQ = kBM * kRS;
  static constexpr int kKV = kKeys * kRS;
  // K, V, 2 x (Q, dO), 2 x (lse, delta)
  static constexpr int kSmemKV = (2 * kKV + 4 * kQ) * 2 + 4 * kBM * 4;
  // dq: keys a K/V tile
  static constexpr int kBN = D <= 64 ? 64 : 32;
  static constexpr int kQr = kRows * kRS;
  static constexpr int kKt = kBN * kRS;
  static constexpr int kSmemQ = (2 * kQr + 4 * kKt) * 2;   // Q, dO, 2 x (K, V)
};

// rows x D bf16 from global (row r at base + r * stride) into shared
// (row stride D + 8); rows at or past n_valid are zero-filled.
template <int D, int kR>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* base,
                                          long long stride, int n_valid) {
  constexpr int kChunks = D / 8;
  for (int c = threadIdx.x; c < kR * kChunks; c += kThreads) {
    const int r = c / kChunks, col = (c % kChunks) * 8;
    const bool ok = r < n_valid;
    cp_async16(dst + r * Bwd<D>::kRS + col, base + (ok ? r * stride : 0) + col,
               ok);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
dkdv_mma_kernel(const Params p) {
  using L = Bwd<D>;
  constexpr int kRS = L::kRS, kBM = L::kBM, kDO = L::kDO;
  constexpr int kNT = kBM / 8;    // 8-query column tiles of S^T
  constexpr int kOT = kDO / 8;    // 8-wide column tiles of dK, dV
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* v_s = k_s + L::kKV;
  bf16* qo_s = v_s + L::kKV;      // stage s: Q at 2s, dO at 2s + 1
  float* st_s = reinterpret_cast<float*>(qo_s + 4 * L::kQ);  // lse2, delta

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int b = blockIdx.x / p.Hk, kvh = blockIdx.x % p.Hk;
  const int k0 = blockIdx.y * kKeys, d0 = blockIdx.z * kDO;
  const long long kv_rs = static_cast<long long>(p.Hk) * D;
  const long long q_rs = static_cast<long long>(p.H) * D;
  const long long kv_at = (static_cast<long long>(b) * p.S + k0) * kv_rs +
                          static_cast<long long>(kvh) * D;
  load_rows<D, kKeys>(k_s, static_cast<const bf16*>(p.k) + kv_at, kv_rs,
                      p.S - k0);
  load_rows<D, kKeys>(v_s, static_cast<const bf16*>(p.v) + kv_at, kv_rs,
                      p.S - k0);
  cp_async_commit();

  int i_begin, i_end;
  visible_rows(p, k0, kKeys, &i_begin, &i_end);
  const int tb = i_begin / kBM;
  const int n_tiles = i_end > i_begin ? (i_end + kBM - 1) / kBM - tb : 0;
  const int h_begin = __ldg(p.group_off + kvh);
  const int steps = (__ldg(p.group_off + kvh + 1) - h_begin) * n_tiles;

  // step -> (query head, query tile)
  auto load_q = [&](int stage, int step) {
    const int h = __ldg(p.group_heads + h_begin + step / n_tiles);
    const int i0 = (tb + step % n_tiles) * kBM;
    const long long at = (static_cast<long long>(b) * p.T + i0) * q_rs +
                         static_cast<long long>(h) * D;
    bf16* q_s = qo_s + 2 * stage * L::kQ;
    load_rows<D, kBM>(q_s, static_cast<const bf16*>(p.q) + at, q_rs,
                      p.T - i0);
    load_rows<D, kBM>(q_s + L::kQ, static_cast<const bf16*>(p.dout) + at,
                      q_rs, p.T - i0);
    float* st = st_s + 2 * stage * kBM;
    for (int r = threadIdx.x; r < kBM; r += kThreads) {
      st[r] = row_lse(p, b, h, i0 + r, kLog2e);
      st[kBM + r] = row_delta(p, b, h, i0 + r);
    }
  };
  if (steps > 0) load_q(0, 0);
  cp_async_commit();

  float dk[kOT][4], dv[kOT][4];
#pragma unroll
  for (int i = 0; i < kOT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;
  const float scale2 = p.scale * kLog2e;
  const int key0 = k0 + warp * 16 + g;          // keys key0 and key0 + 8
  const int a_at = warp * 16 * kRS + a_off(lane, kRS);
  const int b_at = b_off(lane, kRS), t_at = t_off(lane, kRS);

  for (int step = 0; step < steps; ++step) {
    const int stage = step & 1;
    if (step + 1 < steps) load_q(stage ^ 1, step + 1);
    cp_async_commit();
    cp_async_wait<1>();           // K, V and this step's Q, dO have landed
    __syncthreads();
    const bf16* q_s = qo_s + 2 * stage * L::kQ;
    const bf16* do_s = q_s + L::kQ;
    const float* lse_s = st_s + 2 * stage * kBM;
    const float* dl_s = lse_s + kBM;
    const int i0 = (tb + step % n_tiles) * kBM;

    // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x kBM queries
    float s[kNT][4], dp[kNT][4];
#pragma unroll
    for (int i = 0; i < kNT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ak[4], av[4];
      ldsm_x4(ak, k_s + a_at + kk * 16);
      ldsm_x4(av, v_s + a_at + kk * 16);
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        uint32_t bq[4], bd[4];
        ldsm_x4(bq, q_s + np * 16 * kRS + kk * 16 + b_at);
        mma_bf16(s[2 * np], ak, bq[0], bq[1]);
        mma_bf16(s[2 * np + 1], ak, bq[2], bq[3]);
        ldsm_x4(bd, do_s + np * 16 * kRS + kk * 16 + b_at);
        mma_bf16(dp[2 * np], av, bd[0], bd[1]);
        mma_bf16(dp[2 * np + 1], av, bd[2], bd[3]);
      }
    }

    // p^T and ds^T; the mask only where the tile crosses S, the diagonal
    // or the window's edge (rows past T have lse = +inf: p = 0)
    const int qp0 = i0 + p.q_offset;
    const bool need_mask = k0 + kKeys > p.S ||
                           (p.causal && k0 + kKeys - 1 > qp0) ||
                           (p.window > 0 && qp0 + kBM - 1 - k0 >= p.window);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * t4 + (e & 1);
        float pr = exp2f(s[nt][e] * scale2 - lse_s[col]);
        if (need_mask && !visible(p, qp0 + col, key0 + 8 * (e / 2))) pr = 0.f;
        s[nt][e] = pr;
        dp[nt][e] = pr * (dp[nt][e] - dl_s[col]);
      }
    }

    // dV += p^T dO, dK += ds^T Q over this step's queries, columns d0..
#pragma unroll
    for (int j = 0; j < kBM / 16; ++j) {
      const uint32_t pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                              pack_bf16(s[2 * j][2], s[2 * j][3]),
                              pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                              pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
      const uint32_t da[4] = {pack_bf16(dp[2 * j][0], dp[2 * j][1]),
                              pack_bf16(dp[2 * j][2], dp[2 * j][3]),
                              pack_bf16(dp[2 * j + 1][0], dp[2 * j + 1][1]),
                              pack_bf16(dp[2 * j + 1][2], dp[2 * j + 1][3])};
#pragma unroll
      for (int np = 0; np < kOT / 2; ++np) {
        uint32_t bd[4], bq[4];
        ldsm_x4_t(bd, do_s + j * 16 * kRS + d0 + np * 16 + t_at);
        mma_bf16(dv[2 * np], pa, bd[0], bd[1]);
        mma_bf16(dv[2 * np + 1], pa, bd[2], bd[3]);
        ldsm_x4_t(bq, q_s + j * 16 * kRS + d0 + np * 16 + t_at);
        mma_bf16(dk[2 * np], da, bq[0], bq[1]);
        mma_bf16(dk[2 * np + 1], da, bq[2], bq[3]);
      }
    }
    __syncthreads();              // the stage is free for the next load
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key0 + 8 * i;
    if (key >= p.S) continue;
    const long long at = (static_cast<long long>(b) * p.S + key) * kv_rs +
                         static_cast<long long>(kvh) * D + d0 + 2 * t4;
    bf16* dkr = static_cast<bf16*>(p.dk) + at;
    bf16* dvr = static_cast<bf16*>(p.dv) + at;
#pragma unroll
    for (int dt = 0; dt < kOT; ++dt) {
      *reinterpret_cast<__nv_bfloat162*>(dkr + dt * 8) = __floats2bfloat162_rn(
          dk[dt][2 * i] * p.scale, dk[dt][2 * i + 1] * p.scale);
      *reinterpret_cast<__nv_bfloat162*>(dvr + dt * 8) =
          __floats2bfloat162_rn(dv[dt][2 * i], dv[dt][2 * i + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
dq_mma_kernel(const Params p) {
  using L = Bwd<D>;
  constexpr int kRS = L::kRS, kBN = L::kBN, kDO = L::kDO;
  constexpr int kNT = kBN / 8;    // 8-key column tiles of S
  constexpr int kOT = kDO / 8;    // 8-wide column tiles of dQ
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* do_s = q_s + L::kQr;
  bf16* kv_s = do_s + L::kQr;     // stage s: K at 2s, V at 2s + 1

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;   // long rows first
  const int d0 = blockIdx.z * kDO;
  const int kvh = kv_head(p.kv_map, h, p.Hk);
  const long long kv_rs = static_cast<long long>(p.Hk) * D;
  const long long q_rs = static_cast<long long>(p.H) * D;
  const long long q_at = (static_cast<long long>(b) * p.T + q0) * q_rs +
                         static_cast<long long>(h) * D;
  const long long kv_at = static_cast<long long>(b) * p.S * kv_rs +
                          static_cast<long long>(kvh) * D;
  const bf16* kb = static_cast<const bf16*>(p.k) + kv_at;
  const bf16* vb = static_cast<const bf16*>(p.v) + kv_at;

  int j_begin, j_end;
  visible_keys(p, q0, kRows, &j_begin, &j_end);
  const int t0 = j_begin / kBN;
  const int t1 = j_end > j_begin ? (j_end + kBN - 1) / kBN : t0;
  auto load_kv = [&](int stage, int tile) {
    const int k0 = tile * kBN;
    load_rows<D, kBN>(kv_s + 2 * stage * L::kKt, kb + k0 * kv_rs, kv_rs,
                      p.S - k0);
    load_rows<D, kBN>(kv_s + (2 * stage + 1) * L::kKt, vb + k0 * kv_rs, kv_rs,
                      p.S - k0);
  };
  load_rows<D, kRows>(q_s, static_cast<const bf16*>(p.q) + q_at, q_rs,
                      p.T - q0);
  load_rows<D, kRows>(do_s, static_cast<const bf16*>(p.dout) + q_at, q_rs,
                      p.T - q0);
  cp_async_commit();
  if (t0 < t1) load_kv(0, t0);
  cp_async_commit();

  const int row0 = q0 + warp * 16 + g;   // rows row0 and row0 + 8
  const float lse2[2] = {row_lse(p, b, h, row0, kLog2e),
                         row_lse(p, b, h, row0 + 8, kLog2e)};
  const float dl[2] = {row_delta(p, b, h, row0), row_delta(p, b, h, row0 + 8)};
  float dq[kOT][4];
#pragma unroll
  for (int i = 0; i < kOT; ++i)
    dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.f;
  const float scale2 = p.scale * kLog2e;
  const int a_at = warp * 16 * kRS + a_off(lane, kRS);
  const int b_at = b_off(lane, kRS), t_at = t_off(lane, kRS);

  for (int tile = t0; tile < t1; ++tile) {
    const int stage = (tile - t0) & 1;
    if (tile + 1 < t1) load_kv(stage ^ 1, tile + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* k_s = kv_s + 2 * stage * L::kKt;
    const bf16* v_s = k_s + L::kKt;
    const int k0 = tile * kBN;

    // S = Q K^T and dP = dO V^T: this warp's 16 rows x kBN keys
    float s[kNT][4], dp[kNT][4];
#pragma unroll
    for (int i = 0; i < kNT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t aq[4], ad[4];
      ldsm_x4(aq, q_s + a_at + kk * 16);
      ldsm_x4(ad, do_s + a_at + kk * 16);
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        uint32_t bk[4], bv[4];
        ldsm_x4(bk, k_s + np * 16 * kRS + kk * 16 + b_at);
        mma_bf16(s[2 * np], aq, bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], aq, bk[2], bk[3]);
        ldsm_x4(bv, v_s + np * 16 * kRS + kk * 16 + b_at);
        mma_bf16(dp[2 * np], ad, bv[0], bv[1]);
        mma_bf16(dp[2 * np + 1], ad, bv[2], bv[3]);
      }
    }

    const int qp0 = q0 + p.q_offset;
    const bool need_mask = k0 + kBN > p.S ||
                           (p.causal && k0 + kBN - 1 > qp0) ||
                           (p.window > 0 && qp0 + kRows - 1 - k0 >= p.window);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e / 2;
        float pr = exp2f(s[nt][e] * scale2 - lse2[i]);
        if (need_mask &&
            !visible(p, row0 + 8 * i + p.q_offset, k0 + nt * 8 + 2 * t4 + (e & 1)))
          pr = 0.f;
        dp[nt][e] = pr * (dp[nt][e] - dl[i]);
      }
    }

    // dQ += ds K, columns d0..
#pragma unroll
    for (int j = 0; j < kBN / 16; ++j) {
      const uint32_t da[4] = {pack_bf16(dp[2 * j][0], dp[2 * j][1]),
                              pack_bf16(dp[2 * j][2], dp[2 * j][3]),
                              pack_bf16(dp[2 * j + 1][0], dp[2 * j + 1][1]),
                              pack_bf16(dp[2 * j + 1][2], dp[2 * j + 1][3])};
#pragma unroll
      for (int np = 0; np < kOT / 2; ++np) {
        uint32_t bk[4];
        ldsm_x4_t(bk, k_s + j * 16 * kRS + d0 + np * 16 + t_at);
        mma_bf16(dq[2 * np], da, bk[0], bk[1]);
        mma_bf16(dq[2 * np + 1], da, bk[2], bk[3]);
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= p.T) continue;
    bf16* out = static_cast<bf16*>(p.dq) +
                (static_cast<long long>(b) * p.T + row) * q_rs +
                static_cast<long long>(h) * D + d0 + 2 * t4;
#pragma unroll
    for (int dt = 0; dt < kOT; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(out + dt * 8) = __floats2bfloat162_rn(
          dq[dt][2 * i] * p.scale, dq[dt][2 * i + 1] * p.scale);
  }
}

template <int D>
cudaError_t launch_bf16(const Params& p, cudaStream_t stream) {
  using L = Bwd<D>;
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::kSmemKV);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dq_mma_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             L::kSmemQ);
  if (err != cudaSuccess) return err;
  const dim3 grid_kv(p.B * p.Hk, (p.S + kKeys - 1) / kKeys, D / L::kDO);
  dkdv_mma_kernel<D><<<grid_kv, kThreads, L::kSmemKV, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_q(p.B * p.H, (p.T + kRows - 1) / kRows, D / L::kDO);
  dq_mma_kernel<D><<<grid_q, kThreads, L::kSmemQ, stream>>>(p);
  return cudaGetLastError();
}

// ------------------------------------------------ float32: CUDA cores
constexpr int kF32Rows = 32;   // query rows a step (dkdv) or a block (dq)

// keys a dkdv block or a dq step: 32, or 16 at head dim 256 (the dK and dV
// accumulators are keys x D / 128 floats a thread each)
template <int D>
__host__ __device__ constexpr int f32_keys() { return D > 128 ? 16 : 32; }

// p or ds of one tile pair, laid [keys][rows + 1] (dkdv) or [rows][keys + 1]
// (dq)
template <int D>
__host__ __device__ constexpr int f32_pairs() {
  return (f32_keys<D>() + 1) * (kF32Rows + 1);
}

template <int D>
__host__ __device__ constexpr int f32_smem_floats() {
  constexpr int kK = f32_keys<D>();
  return 2 * kK * (D + 1)            // K, V (padded rows)
         + 2 * kF32Rows * (D + 1)    // Q (pre-scaled), dO
         + 2 * f32_pairs<D>()        // p, ds
         + 2 * kF32Rows;             // lse, delta
}

// p and ds of the (key j, query i) pairs of one tile pair, into
// p_s[j * ld_j + i * ld_i] and ds_s[...]: scores of the pre-scaled Q in base
// e, as the float32 forward computes them.
template <int D>
__device__ __forceinline__ void f32_scores(
    const Params& p, const float* q_s, const float* do_s, const float* k_s,
    const float* v_s, const float* lse_s, const float* dl_s, float* p_s,
    float* ds_s, int ld_j, int ld_i, int n_keys, int k0, int i0, bool keys_fast) {
  for (int idx = threadIdx.x; idx < n_keys * kF32Rows; idx += kThreads) {
    const int j = keys_fast ? idx % n_keys : idx / kF32Rows;
    const int i = keys_fast ? idx / n_keys : idx % kF32Rows;
    const float* qr = q_s + i * (D + 1);
    const float* dr = do_s + i * (D + 1);
    const float* kr = k_s + j * (D + 1);
    const float* vr = v_s + j * (D + 1);
    float s = 0.f, dp = 0.f;
#pragma unroll 16
    for (int d = 0; d < D; ++d) {
      s = fmaf(qr[d], kr[d], s);
      dp = fmaf(dr[d], vr[d], dp);
    }
    const bool ok = visible(p, i0 + i + p.q_offset, k0 + j);
    const float pr = ok ? expf(s - lse_s[i]) : 0.f;
    p_s[j * ld_j + i * ld_i] = pr;
    ds_s[j * ld_j + i * ld_i] = pr * (dp - dl_s[i]);
  }
}

template <int D>
__device__ __forceinline__ void f32_load(float* dst, const float* base,
                                         long long stride, int rows,
                                         int n_valid, float mul) {
  for (int idx = threadIdx.x; idx < rows * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    dst[r * (D + 1) + d] = r < n_valid ? base[r * stride + d] * mul : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
dkdv_f32_kernel(const Params p) {
  constexpr int kK = f32_keys<D>(), kR = kF32Rows;
  constexpr int kAcc = kK * D / kThreads;
  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = k_s + kK * (D + 1);
  float* q_s = v_s + kK * (D + 1);
  float* do_s = q_s + kR * (D + 1);
  float* p_s = do_s + kR * (D + 1);
  float* ds_s = p_s + f32_pairs<D>();
  float* lse_s = ds_s + f32_pairs<D>();
  float* dl_s = lse_s + kR;

  const int b = blockIdx.x / p.Hk, kvh = blockIdx.x % p.Hk;
  const int k0 = blockIdx.y * kK;
  const long long kv_rs = static_cast<long long>(p.Hk) * D;
  const long long q_rs = static_cast<long long>(p.H) * D;
  const long long kv_at = (static_cast<long long>(b) * p.S + k0) * kv_rs +
                          static_cast<long long>(kvh) * D;
  f32_load<D>(k_s, static_cast<const float*>(p.k) + kv_at, kv_rs, kK,
              p.S - k0, 1.f);
  f32_load<D>(v_s, static_cast<const float*>(p.v) + kv_at, kv_rs, kK,
              p.S - k0, 1.f);

  int i_begin, i_end;
  visible_rows(p, k0, kK, &i_begin, &i_end);
  const int tb = i_begin / kR;
  const int n_tiles = i_end > i_begin ? (i_end + kR - 1) / kR - tb : 0;
  const int h_begin = __ldg(p.group_off + kvh);
  const int steps = (__ldg(p.group_off + kvh + 1) - h_begin) * n_tiles;

  float dk[kAcc], dv[kAcc];
#pragma unroll
  for (int r = 0; r < kAcc; ++r) dk[r] = dv[r] = 0.f;

  for (int step = 0; step < steps; ++step) {
    const int h = __ldg(p.group_heads + h_begin + step / n_tiles);
    const int i0 = (tb + step % n_tiles) * kR;
    const long long at = (static_cast<long long>(b) * p.T + i0) * q_rs +
                         static_cast<long long>(h) * D;
    // Q pre-scaled: the scores as the forward's, and dK = ds^T (scale Q)
    f32_load<D>(q_s, static_cast<const float*>(p.q) + at, q_rs, kR,
                p.T - i0, p.scale);
    f32_load<D>(do_s, static_cast<const float*>(p.dout) + at, q_rs, kR,
                p.T - i0, 1.f);
    for (int r = threadIdx.x; r < kR; r += kThreads) {
      lse_s[r] = row_lse(p, b, h, i0 + r, 1.f);
      dl_s[r] = row_delta(p, b, h, i0 + r);
    }
    __syncthreads();
    f32_scores<D>(p, q_s, do_s, k_s, v_s, lse_s, dl_s, p_s, ds_s, kR + 1, 1,
                  kK, k0, i0, false);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kAcc; ++r) {
      const int idx = threadIdx.x + r * kThreads;
      const int j = idx / D, d = idx % D;
      const float* pr = p_s + j * (kR + 1);
      const float* dr = ds_s + j * (kR + 1);
      float a = dv[r], c = dk[r];
#pragma unroll 8
      for (int i = 0; i < kR; ++i) {
        a = fmaf(pr[i], do_s[i * (D + 1) + d], a);
        c = fmaf(dr[i], q_s[i * (D + 1) + d], c);
      }
      dv[r] = a;
      dk[r] = c;
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < kAcc; ++r) {
    const int idx = threadIdx.x + r * kThreads;
    const int j = idx / D, d = idx % D;
    if (k0 + j >= p.S) continue;
    const long long at = (static_cast<long long>(b) * p.S + k0 + j) * kv_rs +
                         static_cast<long long>(kvh) * D + d;
    static_cast<float*>(p.dk)[at] = dk[r];
    static_cast<float*>(p.dv)[at] = dv[r];
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
dq_f32_kernel(const Params p) {
  constexpr int kK = f32_keys<D>(), kR = kF32Rows;
  constexpr int kAcc = kR * D / kThreads;
  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = k_s + kK * (D + 1);
  float* q_s = v_s + kK * (D + 1);
  float* do_s = q_s + kR * (D + 1);
  float* ds_s = do_s + kR * (D + 1);   // [kR][kK + 1]
  float* p_s = ds_s + f32_pairs<D>();  // p, unused after ds
  float* lse_s = p_s + f32_pairs<D>();
  float* dl_s = lse_s + kR;

  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int q0 = blockIdx.y * kR;
  const int kvh = kv_head(p.kv_map, h, p.Hk);
  const long long kv_rs = static_cast<long long>(p.Hk) * D;
  const long long q_rs = static_cast<long long>(p.H) * D;
  const long long q_at = (static_cast<long long>(b) * p.T + q0) * q_rs +
                         static_cast<long long>(h) * D;
  f32_load<D>(q_s, static_cast<const float*>(p.q) + q_at, q_rs, kR, p.T - q0,
              p.scale);
  f32_load<D>(do_s, static_cast<const float*>(p.dout) + q_at, q_rs, kR,
              p.T - q0, 1.f);
  for (int r = threadIdx.x; r < kR; r += kThreads) {
    lse_s[r] = row_lse(p, b, h, q0 + r, 1.f);
    dl_s[r] = row_delta(p, b, h, q0 + r);
  }
  int j_begin, j_end;
  visible_keys(p, q0, kR, &j_begin, &j_end);
  j_begin = (j_begin / kK) * kK;

  float dq[kAcc];
#pragma unroll
  for (int r = 0; r < kAcc; ++r) dq[r] = 0.f;
  for (int k0 = j_begin; k0 < j_end; k0 += kK) {
    const long long kv_at = (static_cast<long long>(b) * p.S + k0) * kv_rs +
                            static_cast<long long>(kvh) * D;
    f32_load<D>(k_s, static_cast<const float*>(p.k) + kv_at, kv_rs, kK,
                p.S - k0, 1.f);
    f32_load<D>(v_s, static_cast<const float*>(p.v) + kv_at, kv_rs, kK,
                p.S - k0, 1.f);
    __syncthreads();
    f32_scores<D>(p, q_s, do_s, k_s, v_s, lse_s, dl_s, p_s, ds_s, 1, kK + 1,
                  kK, k0, q0, true);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kAcc; ++r) {
      const int idx = threadIdx.x + r * kThreads;
      const int i = idx / D, d = idx % D;
      const float* dr = ds_s + i * (kK + 1);
      float a = dq[r];
#pragma unroll 8
      for (int j = 0; j < kK; ++j) a = fmaf(dr[j], k_s[j * (D + 1) + d], a);
      dq[r] = a;
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < kAcc; ++r) {
    const int idx = threadIdx.x + r * kThreads;
    const int i = idx / D, d = idx % D;
    if (q0 + i >= p.T) continue;
    static_cast<float*>(p.dq)[(static_cast<long long>(b) * p.T + q0 + i) *
                                  q_rs + static_cast<long long>(h) * D + d] =
        dq[r] * p.scale;
  }
}

template <int D>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  const int smem = f32_smem_floats<D>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      dq_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid_kv(p.B * p.Hk, (p.S + f32_keys<D>() - 1) / f32_keys<D>());
  dkdv_f32_kernel<D><<<grid_kv, kThreads, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_q(p.B * p.H, (p.T + kF32Rows - 1) / kF32Rows);
  dq_f32_kernel<D><<<grid_q, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(int dtype, const Params& p, cudaStream_t stream) {
  if (dtype == 0) return launch_f32<D>(p, stream);
  if (dtype == 1) return launch_bf16<D>(p, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. kv_map is a device array of H int32 or
// null (then Hk == H); group_off [Hk + 1] and group_heads [H] are the
// inverse map on the device. delta is [B, H, T] float32 scratch. Launches
// the three kernels on `stream`; returns the cudaError_t of the launches
// (0 on success).
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, const void* kv_map, const void* group_off,
    const void* group_heads, int dtype, int B, int T, int S, int H, int Hk,
    int D, int causal, int window, int q_offset, float scale, void* stream) {
  const Params p{q, k, v, o, dout, static_cast<const float*>(lse),
                 static_cast<float*>(delta), dq, dk, dv,
                 static_cast<const int*>(kv_map),
                 static_cast<const int*>(group_off),
                 static_cast<const int*>(group_heads), B, T, S, H, Hk,
                 causal, window, q_offset, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long rows = static_cast<long long>(B) * T * H;
  const unsigned blocks =
      static_cast<unsigned>((rows + kThreads / 32 - 1) / (kThreads / 32));
  if (dtype == 0)
    delta_kernel<float><<<blocks, kThreads, 0, st>>>(p, D);
  else if (dtype == 1)
    delta_kernel<bf16><<<blocks, kThreads, 0, st>>>(p, D);
  else
    return cudaErrorInvalidValue;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  switch (D) {
    case 32: return launch<32>(dtype, p, st);
    case 64: return launch<64>(dtype, p, st);
    case 96: return launch<96>(dtype, p, st);
    case 128: return launch<128>(dtype, p, st);
    case 256: return launch<256>(dtype, p, st);
    default: return cudaErrorInvalidValue;
  }
}
