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
// visible key).
//
// What bounds it: operations. Per visible (query, key) pair and head it
// does 2.5x the forward's 4 D flops (S, dP, dV, dK, dQ: five products of
// 2 D), far above the H100's ridge at the training shapes (T = S = 1024,
// D = 64-256: some 2 D x 64 flops a byte of the Q, dO, K, V tiles read).
// The bound is the bf16 tensor cores' rate, which only wgmma reaches.
//
// Kernels, no float atomics (each output element is summed in a fixed
// order, so two calls give bitwise the same dQ, dK and dV):
//   (a) delta_kernel: delta = rowsum(dO * O) and lse2 = lse log2 e (+inf
//       for a row with no visible key, and for the rows past T up to Tp, a
//       multiple of 64), [B, H, Tp] float32 each.
//   (b) dkdv_wgmma_kernel: one block per (64-key tile, batch, KV head,
//       split). Its keys' K and V stay in shared memory; it walks its
//       split's query heads and their visible 64-row query tiles, and for
//       each recomputes S^T = K Q^T and dP^T = V dO^T, then dV += p^T dO
//       and dK += ds^T Q.
//   (c) sum_splits_kernel (only when split): the float32 partials of the
//       splits summed in split order into bf16 dK and dV.
//   (d) dq_wgmma_kernel: one block per (batch, query head, 64-row tile),
//       Q and dO resident, over the visible 64-key K/V tiles: S, dP again,
//       then dQ += ds K.
//
// What the design does about what held the first kernel back:
//   - Too few blocks at big groups (starcoder2's 32 query heads over 2 KV
//     heads, MQA): the query heads of a KV head are split over n_split
//     blocks (kernels/flash_attention.py::bwd_split_plan, from Python ints:
//     at least 2 blocks an SM where the groups allow, 1 where the grid
//     already fills the card). Split s takes heads [s per, (s + 1) per) of
//     the group, per = ceil(group / n_split), and writes float32 partial
//     dK/dV to a scratch [2, n_split, B, S, Hk, D] that (c) sums in order.
//   - mma.sync: every product is a wgmma of a consumer warpgroup, 64 rows
//     (keys in (b), query rows in (d)) by the other tile's 64. One
//     producer warp keeps the next Q, dO, lse2 and delta tiles (b), or K
//     and V tiles (d), in flight by TMA into a 2-3 stage ring guarded by
//     mbarriers; the consumers read lse2 and delta from shared memory,
//     never from global memory inside the loop. p^T and ds^T (ds) go to
//     the next products as register A fragments. The producer is one warp,
//     not a warpgroup, so that a block's registers go to its consumers
//     (ptxas caps every thread of a kernel at 65536 / (threads x blocks an
//     SM), setmaxnreg or not): (b) at D = 64 takes 2 blocks an SM, (d) 3
//     at D = 64 and 2 at 128.
//   - S and dP computed twice: kept. (d) recomputes them (7 products where
//     the bound counts 5); fusing dQ into (b) needs its partial sums over
//     key tiles in a fixed order (a scratch per key tile, or blocks waiting
//     on each other), which is left for later.
//   - D = 256: no column slices and no recomputed scores. Two consumer
//     warpgroups each compute the scores of half the query rows (b) or keys
//     (d), write p^T and ds^T (ds) in bf16 to shared memory, and each then
//     accumulates half the output columns over all of them.
//   - Causal balance: under a causal mask key tile 0 is the longest (every
//     query row sees it), and the key tile is the grid's slowest axis, so
//     the longest blocks start first (the first kernel's order did too).
//     (d) runs its query tiles in reverse, the last (longest) first.
//
// bfloat16: wgmma m64nNk16 bf16 -> f32, p and ds rounded to bf16 as the A
// operands of the next products (as the forward's P); D = 64, 128 or 256
// (the wrapper pads 32 and 96). float32: CUDA-core kernels with the scores
// in shared memory (the tensor cores take float32 only as TF32), held to
// 2e-5 like the float32 forward.
//
// Plain C interface (bound from Python with ctypes). Every tensor is
// contiguous: q, o, dout, dq [B,T,H,D]; k, v, dk, dv [B,S,Hk,D]; lse [B,H,T]
// float32; the scratch [2, B, H, Tp] float32 (delta, lse2).

#include <dlfcn.h>

#include "attn_split.cuh"
#include "hopper.cuh"

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
  float* delta;             // [B, H, Tp]
  float* lse2;              // [B, H, Tp], base 2, +inf: p = 0
  void* dq;
  void* dk;
  void* dv;
  float* part;              // [2, n_split, B, S, Hk, D] (n_split > 1)
  const int* kv_map;        // [H] or null
  const int* group_off;     // [Hk + 1]: query heads of KV head j are
  const int* group_heads;   //   group_heads[group_off[j] .. group_off[j+1])
  int B, T, S, H, Hk, Tp, n_split;
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

// The row's lse as the float32 kernels read it: +inf for a row past T or
// with no visible key (so that every p of the row is 0).
__device__ __forceinline__ float row_lse(const Params& p, int b, int h, int i,
                                         float mul) {
  if (i >= p.T) return INFINITY;
  const float l = __ldg(p.lse + (static_cast<long long>(b) * p.H + h) * p.T + i);
  return l == -INFINITY ? INFINITY : l * mul;
}
__device__ __forceinline__ float row_delta(const Params& p, int b, int h,
                                           int i) {
  if (i >= p.T) return 0.f;
  return p.delta[(static_cast<long long>(b) * p.H + h) * p.Tp + i];
}

// ------------------------------------------------------- (a) delta, lse2
// The L lanes of a row (L the largest power of two up to 32 that divides
// D / V) each sum 16-byte chunks of V elements of it.
template <typename E>
__device__ __forceinline__ float dot16(const E* a, const E* b);
template <>
__device__ __forceinline__ float dot16<float>(const float* a, const float* b) {
  const float4 x = *reinterpret_cast<const float4*>(a);
  const float4 y = *reinterpret_cast<const float4*>(b);
  return x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
}
template <>
__device__ __forceinline__ float dot16<bf16>(const bf16* a, const bf16* b) {
  const uint4 x = *reinterpret_cast<const uint4*>(a);
  const uint4 y = *reinterpret_cast<const uint4*>(b);
  const __nv_bfloat162* xs = reinterpret_cast<const __nv_bfloat162*>(&x);
  const __nv_bfloat162* ys = reinterpret_cast<const __nv_bfloat162*>(&y);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(xs[i]), v = __bfloat1622float2(ys[i]);
    s = fmaf(u.x, v.x, fmaf(u.y, v.y, s));
  }
  return s;
}

template <typename E>
__global__ void __launch_bounds__(kThreads)
delta_kernel(const Params p, int D, int L) {
  constexpr int V = 16 / sizeof(E);
  const int sub = threadIdx.x % L;
  const long long r = (blockIdx.x * static_cast<long long>(kThreads) +
                       threadIdx.x) / L;         // row (b H + h) Tp + t
  const bool in = r < static_cast<long long>(p.B) * p.H * p.Tp;
  const int t = static_cast<int>(r % p.Tp);
  const long long bh = r / p.Tp, b = bh / p.H, h = bh % p.H;
  float s = 0.f;
  if (in && t < p.T) {
    const long long at = ((b * p.T + t) * p.H + h) * D;
    const E* o = static_cast<const E*>(p.o) + at;
    const E* d = static_cast<const E*>(p.dout) + at;
    for (int c = sub * V; c < D; c += L * V) s += dot16<E>(o + c, d + c);
  }
  for (int off = L / 2; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (in && sub == 0) {
    p.delta[r] = s;
    const float l = t < p.T ? p.lse[bh * p.T + t] : -INFINITY;
    p.lse2[r] = l == -INFINITY ? INFINITY : l * kLog2e;
  }
}

// --------------------------------------------- bfloat16: wgmma and TMA
constexpr int kTile = 64;   // keys a dK/dV block, query rows a step of it;
                            // query rows a dQ block, keys a step of it

template <int D>
struct Cfg {
  static constexpr int kWG = D > 128 ? 2 : 1;        // consumer warpgroups
  // warps 0 .. 4 kWG - 1 consume (a warpgroup starts at a warp index that
  // is a multiple of 4); warp 4 kWG is the producer
  static constexpr int kThreads = 128 * kWG + 32;
  // resident blocks an SM that the registers allow: ptxas caps a thread at
  // 65536 / (threads, rounded up to 128, x blocks) for the whole kernel
  // (-Xptxas -v on the H100's toolkit: 168 for 288 threads; setmaxnreg
  // moves registers at run time but the consumers' code is still compiled
  // under that cap), and dK/dV at D = 64 takes ~190, dQ up to ~160
  static constexpr int kDkdvBlocks = kWG == 1 && D == 64 ? 2 : 1;
  static constexpr int kDqBlocks = kWG == 2 ? 1 : D == 64 ? 3 : 2;
  static constexpr int kN = kTile / kWG;   // score columns a warpgroup
  static constexpr int kOut = D / kWG;     // output columns a warpgroup
  static constexpr int kStages = D <= 64 ? 3 : 2;
  static constexpr int kTileBytes = D / 64 * kChunkBytes;   // 64 x D bf16
  // p^T and ds^T (dK/dV) or ds (dQ) shared between two warpgroups
  static constexpr int kShare = kWG == 2 ? 2 * kChunkBytes : 0;
  static constexpr int kBars = 8 * (1 + 2 * kStages);
  // resident pair, kStages streamed pairs, share, (dK/dV) lse2 and delta;
  // + 1024 to align the base
  static constexpr int kSmemDkdv = 2 * kTileBytes + kStages * 2 * kTileBytes +
                                   kShare + kStages * 2 * kTile * 4 + kBars +
                                   1024;
  static constexpr int kSmemDq = 2 * kTileBytes + kStages * 2 * kTileBytes +
                                 kShare + kBars + 1024;
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = smem_addr(p);
  return p + ((1024 - (a & 1023)) & 1023);
}

// Byte offset of column c of a 64-row tile (swizzling follows the address,
// so a descriptor may start inside a chunk's rows).
__device__ __forceinline__ uint32_t column_at(int c) {
  return (c / 64) * kChunkBytes + (c % 64) * 2;
}

// acc (64 x N) = A (64 x D) B^T: A the 64-row tile at shared address a, B
// the N rows of the 64-row tile from shared address b; both K-major.
template <int D, int N>
__device__ __forceinline__ void gemm_nt(float (&acc)[N / 2], uint32_t a,
                                        uint32_t b) {
#ifdef BWD_PROBE_SKIP_SCORES   // tools/bwd_probe.py: a timing, wrong results
  return;
#endif
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * kChunkBytes + (kk % 4) * 32;
    Wgmma<N>::template ss<0, 0>(acc, kmajor_desc(a + off),
                                kmajor_desc(b + off), kk > 0 ? 1 : 0);
  }
}

// A 64 x 64 accumulator rounded to bf16 pairs: the register A fragments
// of four k16 steps, step j in a[4 j .. 4 j + 3]. Packed before the
// products and fenced, so that no register a product reads is written
// between two products (ptxas would insert a wait there, C7519).
__device__ __forceinline__ void pack_bf16(uint32_t (&a)[16],
                                          const float (&pr)[32]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) a[i] = bf16x2_bits(pr[2 * i], pr[2 * i + 1]);
  fence_regs(a);
}

// acc (64 x N) += P (64 x 64) B: P packed by pack_bf16; B N columns of a
// 64-row tile from shared address b (inside its chunks), MN-major.
template <int N>
__device__ __forceinline__ void gemm_rs(float (&acc)[N / 2],
                                        const uint32_t (&a)[16], uint32_t b) {
#ifdef BWD_PROBE_SKIP_OUT      // tools/bwd_probe.py: a timing, wrong results
  return;
#endif
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t f[4] = {a[4 * j], a[4 * j + 1], a[4 * j + 2], a[4 * j + 3]};
#ifdef BWD_PROBE_OUT_KMAJOR     // tools/bwd_probe.py: B read untransposed
    Wgmma<N>::template rs<0>(acc, f, kmajor_desc(b + j * 32), 1);
#else
    Wgmma<N>::template rs<1>(acc, f, mnmajor_desc(b + j * 2048), 1);
#endif
  }
}

// The same with P a shared chunk (K-major) at a.
template <int N>
__device__ __forceinline__ void gemm_ss(float (&acc)[N / 2], uint32_t a,
                                        uint32_t b) {
#ifdef BWD_PROBE_SKIP_OUT
  return;
#endif
#pragma unroll
  for (int j = 0; j < 4; ++j)
    Wgmma<N>::template ss<0, 1>(acc, kmajor_desc(a + j * 32),
                                mnmajor_desc(b + j * 2048), 1);
}

// Rows 16 w + g and + 8, columns n0 + 8 i + 2 t4 (+1) of a 64 x N
// accumulator, rounded to bf16, into a shared chunk (the other warpgroup's
// columns beside them).
template <int N>
__device__ __forceinline__ void store_share(unsigned char* chunk,
                                            const float (&acc)[N / 2],
                                            int row, int n0, int t4) {
#pragma unroll
  for (int i = 0; i < N / 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint32_t*>(chunk +
                                   sw128_at(row + 8 * h, n0 + 8 * i + 2 * t4)) =
          bf16x2_bits(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
}

template <int D>
__global__ void __launch_bounds__(Cfg<D>::kThreads, Cfg<D>::kDkdvBlocks)
dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tdo,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, const Params p) {
  using C = Cfg<D>;
  constexpr int kWG = C::kWG, kN = C::kN, kOut = C::kOut;
  constexpr int kStages = C::kStages, kTB = C::kTileBytes;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* k_s = align1024(smem_raw);
  unsigned char* v_s = k_s + kTB;
  unsigned char* qo_s = v_s + kTB;           // stage s: Q at 2 s, dO 2 s + 1
  unsigned char* share = qo_s + kStages * 2 * kTB;   // p^T, ds^T chunks
  // stage s: lse2 at ld_s + 2 s kTile, delta kTile further
  float* ld_s = reinterpret_cast<float*>(share + C::kShare);
  uint64_t* kv_bar = reinterpret_cast<uint64_t*>(ld_s + kStages * 2 * kTile);
  uint64_t* full = kv_bar + 1;
  uint64_t* empty = full + kStages;

  const int split = blockIdx.x % p.n_split;
  const int b = blockIdx.x / p.n_split / p.Hk;
  const int kvh = blockIdx.x / p.n_split % p.Hk;
  const int k0 = blockIdx.y * kTile;
  int i_begin, i_end;
  visible_rows(p, k0, kTile, &i_begin, &i_end);
  const int tb = i_begin / kTile;
  const int n_tiles = i_end > i_begin ? (i_end + kTile - 1) / kTile - tb : 0;
  const int h_off = __ldg(p.group_off + kvh);
  const int group = __ldg(p.group_off + kvh + 1) - h_off;
  const int per = (group + p.n_split - 1) / p.n_split;
  const int hs0 = min(group, split * per), hs1 = min(group, hs0 + per);
  const int steps = (hs1 - hs0) * n_tiles;

  if (threadIdx.x == 0) {
    mbar_init(kv_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 128 * kWG);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 128 * kWG) {            // the producer warp
    if (threadIdx.x == 128 * kWG) {
      mbar_expect_tx(kv_bar, 2 * kTB);
      for (int c = 0; c < D / 64; ++c) {
        tma_load_4d(k_s + c * kChunkBytes, &tk, kv_bar, 64 * c, kvh, k0, b);
        tma_load_4d(v_s + c * kChunkBytes, &tv, kv_bar, 64 * c, kvh, k0, b);
      }
      for (int step = 0; step < steps; ++step) {
        const int stage = step % kStages;
        mbar_wait(empty + stage, ((step / kStages) & 1) ^ 1);
        const int h = __ldg(p.group_heads + h_off + hs0 + step / n_tiles);
        const int i0 = (tb + step % n_tiles) * kTile;
        unsigned char* q_s = qo_s + 2 * stage * kTB;
        mbar_expect_tx(full + stage, 2 * kTB + 2 * kTile * 4);
        for (int c = 0; c < D / 64; ++c) {
          tma_load_4d(q_s + c * kChunkBytes, &tq, full + stage, 64 * c, h, i0,
                      b);
          tma_load_4d(q_s + kTB + c * kChunkBytes, &tdo, full + stage, 64 * c,
                      h, i0, b);
        }
        const long long r = (static_cast<long long>(b) * p.H + h) * p.Tp + i0;
        float* st = ld_s + 2 * stage * kTile;
        bulk_load(st, p.lse2 + r, kTile * 4, full + stage);
        bulk_load(st + kTile, p.delta + r, kTile * 4, full + stage);
      }
    }
  } else {                                   // the consumer warpgroups
    const int ct = threadIdx.x, wg = ct / 128;
    const int warp = ct % 128 / 32, lane = ct % 32;
    const int g = lane / 4, t4 = lane % 4;
    const int n0 = wg * kN;                  // this warpgroup's query rows
    const int row = 16 * warp + g;           // keys k0 + row and + 8
    float dk[kOut / 2], dv[kOut / 2];
#pragma unroll
    for (int i = 0; i < kOut / 2; ++i) dk[i] = dv[i] = 0.f;
    const float scale2 = p.scale * kLog2e;
    const uint32_t ks = smem_addr(k_s), vs = smem_addr(v_s);
    const uint32_t sh = smem_addr(share);
    mbar_wait(kv_bar, 0);

    for (int step = 0; step < steps; ++step) {
      const int stage = step % kStages;
      mbar_wait(full + stage, (step / kStages) & 1);
      const uint32_t qs = smem_addr(qo_s + 2 * stage * kTB), dos = qs + kTB;
      const float* lse_s = ld_s + 2 * stage * kTile;
      const float* dl_s = lse_s + kTile;
      const int i0 = (tb + step % n_tiles) * kTile;

      // S^T = K Q^T and dP^T = V dO^T: 64 keys x this warpgroup's rows
      float s[kN / 2], dp[kN / 2];
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
      gemm_nt<D, kN>(s, ks, qs + n0 * 128);
      gemm_nt<D, kN>(dp, vs, dos + n0 * 128);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);

      // p^T and ds^T; the mask only where the tile crosses S, the diagonal
      // or the window's edge (rows past T have lse2 = +inf: p = 0)
      const int qp0 = i0 + p.q_offset;
      const bool need_mask = k0 + kTile > p.S ||
                             (p.causal && k0 + kTile - 1 > qp0) ||
                             (p.window > 0 && qp0 + kTile - 1 - k0 >= p.window);
#pragma unroll
      for (int nt = 0; nt < kN / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = n0 + nt * 8 + 2 * t4 + (e & 1);
          float pr = fast_exp2(s[4 * nt + e] * scale2 - lse_s[col]);
          if (need_mask && !visible(p, qp0 + col, k0 + row + 8 * (e / 2)))
            pr = 0.f;
          s[4 * nt + e] = pr;
          dp[4 * nt + e] = pr * (dp[4 * nt + e] - dl_s[col]);
        }
      }

      // dV += p^T dO, dK += ds^T Q over this step's query rows: p^T and
      // ds^T as register A fragments with one warpgroup, through shared
      // memory (bf16) with two, each then taking half the columns
      if constexpr (kWG == 1) {
        uint32_t pa[16], da[16];
        pack_bf16(pa, s);
        pack_bf16(da, dp);
        fence_regs(dk);
        fence_regs(dv);
        wgmma_fence();
        gemm_rs<kOut>(dv, pa, dos);
        gemm_rs<kOut>(dk, da, qs);
      } else {
        named_sync(2, 256);   // both warpgroups are done with the last step's
        store_share<kN>(share, s, row, n0, t4);
        store_share<kN>(share + kChunkBytes, dp, row, n0, t4);
        fence_proxy_async();
        named_sync(1, 256);   // both halves of p^T and ds^T are written
        fence_regs(dk);
        fence_regs(dv);
        wgmma_fence();
        gemm_ss<kOut>(dv, sh, dos + column_at(wg * kOut));
        gemm_ss<kOut>(dk, sh + kChunkBytes, qs + column_at(wg * kOut));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dk);
      fence_regs(dv);
      mbar_arrive(empty + stage);  // the stage is free for the producer
    }

    const long long n_out = static_cast<long long>(p.B) * p.S * p.Hk * D;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = k0 + row + 8 * h;
      if (key >= p.S) continue;
      const long long at = (static_cast<long long>(b) * p.S + key) * p.Hk * D +
                           static_cast<long long>(kvh) * D + wg * kOut + 2 * t4;
#pragma unroll
      for (int i = 0; i < kOut / 8; ++i) {
        const float k0v = dk[4 * i + 2 * h] * p.scale;
        const float k1v = dk[4 * i + 2 * h + 1] * p.scale;
        const float v0 = dv[4 * i + 2 * h], v1 = dv[4 * i + 2 * h + 1];
        if (p.n_split == 1) {
          *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(p.dk) + at +
                                             8 * i) =
              __floats2bfloat162_rn(k0v, k1v);
          *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(p.dv) + at +
                                             8 * i) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          float* pk = p.part + split * n_out + at + 8 * i;
          *reinterpret_cast<float2*>(pk) = make_float2(k0v, k1v);
          *reinterpret_cast<float2*>(pk + p.n_split * n_out) =
              make_float2(v0, v1);
        }
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(Cfg<D>::kThreads, Cfg<D>::kDqBlocks)
dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tdo,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, const Params p) {
  using C = Cfg<D>;
  constexpr int kWG = C::kWG, kN = C::kN, kOut = C::kOut;
  constexpr int kStages = C::kStages, kTB = C::kTileBytes;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* q_s = align1024(smem_raw);
  unsigned char* do_s = q_s + kTB;
  unsigned char* kv_s = do_s + kTB;          // stage s: K at 2 s, V 2 s + 1
  unsigned char* share = kv_s + kStages * 2 * kTB;   // the ds chunk
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(share + C::kShare);
  uint64_t* full = q_bar + 1;
  uint64_t* empty = full + kStages;

  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;   // long rows first
  const int kvh = kv_head(p.kv_map, h, p.Hk);
  int j_begin, j_end;
  visible_keys(p, q0, kTile, &j_begin, &j_end);
  const int t0 = j_begin / kTile;
  const int n_tiles = j_end > j_begin ? (j_end + kTile - 1) / kTile - t0 : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 128 * kWG);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 128 * kWG) {            // the producer warp
    if (threadIdx.x == 128 * kWG) {
      mbar_expect_tx(q_bar, 2 * kTB);
      for (int c = 0; c < D / 64; ++c) {
        tma_load_4d(q_s + c * kChunkBytes, &tq, q_bar, 64 * c, h, q0, b);
        tma_load_4d(do_s + c * kChunkBytes, &tdo, q_bar, 64 * c, h, q0, b);
      }
      for (int step = 0; step < n_tiles; ++step) {
        const int stage = step % kStages;
        mbar_wait(empty + stage, ((step / kStages) & 1) ^ 1);
        const int k0 = (t0 + step) * kTile;
        unsigned char* k_s = kv_s + 2 * stage * kTB;
        mbar_expect_tx(full + stage, 2 * kTB);
        for (int c = 0; c < D / 64; ++c) {
          tma_load_4d(k_s + c * kChunkBytes, &tk, full + stage, 64 * c, kvh,
                      k0, b);
          tma_load_4d(k_s + kTB + c * kChunkBytes, &tv, full + stage, 64 * c,
                      kvh, k0, b);
        }
      }
    }
  } else {                                   // the consumer warpgroups
    const int ct = threadIdx.x, wg = ct / 128;
    const int warp = ct % 128 / 32, lane = ct % 32;
    const int g = lane / 4, t4 = lane % 4;
    const int n0 = wg * kN;                  // this warpgroup's keys
    const int row = 16 * warp + g;           // query rows q0 + row and + 8
    const long long rr = (static_cast<long long>(b) * p.H + h) * p.Tp + q0 +
                         row;
    const float lse2[2] = {__ldg(p.lse2 + rr), __ldg(p.lse2 + rr + 8)};
    const float dl[2] = {__ldg(p.delta + rr), __ldg(p.delta + rr + 8)};
    float dq[kOut / 2];
#pragma unroll
    for (int i = 0; i < kOut / 2; ++i) dq[i] = 0.f;
    const float scale2 = p.scale * kLog2e;
    const uint32_t qs = smem_addr(q_s), dos = smem_addr(do_s);
    const uint32_t sh = smem_addr(share);
    mbar_wait(q_bar, 0);

    for (int step = 0; step < n_tiles; ++step) {
      const int stage = step % kStages;
      mbar_wait(full + stage, (step / kStages) & 1);
      const uint32_t ks = smem_addr(kv_s + 2 * stage * kTB), vs = ks + kTB;
      const int k0 = (t0 + step) * kTile;

      // S = Q K^T and dP = dO V^T: 64 query rows x this warpgroup's keys
      float s[kN / 2], dp[kN / 2];
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
      gemm_nt<D, kN>(s, qs, ks + n0 * 128);
      gemm_nt<D, kN>(dp, dos, vs + n0 * 128);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);

      const int qp0 = q0 + p.q_offset;
      const bool need_mask = k0 + kTile > p.S ||
                             (p.causal && k0 + kTile - 1 > qp0) ||
                             (p.window > 0 && qp0 + kTile - 1 - k0 >= p.window);
#pragma unroll
      for (int nt = 0; nt < kN / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e / 2;
          const int key = k0 + n0 + nt * 8 + 2 * t4 + (e & 1);
          float pr = fast_exp2(s[4 * nt + e] * scale2 - lse2[i]);
          if (need_mask && !visible(p, qp0 + row + 8 * i, key)) pr = 0.f;
          dp[4 * nt + e] = pr * (dp[4 * nt + e] - dl[i]);
        }
      }

      // dQ += ds K (ds as in the dK/dV kernel)
      if constexpr (kWG == 1) {
        uint32_t da[16];
        pack_bf16(da, dp);
        fence_regs(dq);
        wgmma_fence();
        gemm_rs<kOut>(dq, da, ks);
      } else {
        named_sync(2, 256);
        store_share<kN>(share, dp, row, n0, t4);
        fence_proxy_async();
        named_sync(1, 256);
        fence_regs(dq);
        wgmma_fence();
        gemm_ss<kOut>(dq, sh, ks + column_at(wg * kOut));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);
      mbar_arrive(empty + stage);  // the stage is free for the producer
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qr = q0 + row + 8 * i;
      if (qr >= p.T) continue;
      bf16* out = static_cast<bf16*>(p.dq) +
                  (static_cast<long long>(b) * p.T + qr) * p.H * D +
                  static_cast<long long>(h) * D + wg * kOut + 2 * t4;
#pragma unroll
      for (int nt = 0; nt < kOut / 8; ++nt)
        *reinterpret_cast<__nv_bfloat162*>(out + nt * 8) =
            __floats2bfloat162_rn(dq[4 * nt + 2 * i] * p.scale,
                                  dq[4 * nt + 2 * i + 1] * p.scale);
    }
  }
}

// ------------------------------------------------- (c) the splits' sum
constexpr int kSumThreads = 256;

// dK (blockIdx.y = 0) or dV (1): part[y][0] + part[y][1] + ... in split
// order, 4 elements a thread, into bf16.
__global__ void __launch_bounds__(kSumThreads)
sum_splits_kernel(const float* __restrict__ part, int n_split, long long n4,
                  bf16* __restrict__ dk, bf16* __restrict__ dv) {
  const long long i = blockIdx.x * static_cast<long long>(kSumThreads) +
                      threadIdx.x;
  if (i >= n4) return;
  const float4* src = reinterpret_cast<const float4*>(part) +
                      blockIdx.y * n_split * n4 + i;
  float4 s = __ldg(src);
  for (int c = 1; c < n_split; ++c) {
    const float4 x = __ldg(src + c * n4);
    s.x += x.x;
    s.y += x.y;
    s.z += x.z;
    s.w += x.w;
  }
  store4((blockIdx.y ? dv : dk) + 4 * i, s);
}

struct Maps {
  CUtensorMap q, dout, k, v;
};

template <int D>
cudaError_t launch_bf16(const Params& p, const Maps& m, cudaStream_t stream) {
  using C = Cfg<D>;
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::kSmemDkdv);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dq_wgmma_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::kSmemDq);
  if (err != cudaSuccess) return err;
  const dim3 grid_kv(p.B * p.Hk * p.n_split, (p.S + kTile - 1) / kTile);
  dkdv_wgmma_kernel<D><<<grid_kv, C::kThreads, C::kSmemDkdv, stream>>>(
      m.q, m.dout, m.k, m.v, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (p.n_split > 1) {
    const long long n4 = static_cast<long long>(p.B) * p.S * p.Hk * D / 4;
    const dim3 grid_sum(
        static_cast<unsigned>((n4 + kSumThreads - 1) / kSumThreads), 2);
    sum_splits_kernel<<<grid_sum, kSumThreads, 0, stream>>>(
        p.part, p.n_split, n4, static_cast<bf16*>(p.dk),
        static_cast<bf16*>(p.dv));
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const dim3 grid_q(p.B * p.H, (p.T + kTile - 1) / kTile);
  dq_wgmma_kernel<D><<<grid_q, C::kThreads, C::kSmemDq, stream>>>(
      m.q, m.dout, m.k, m.v, p);
  return cudaGetLastError();
}

// cuTensorMapEncodeTiled from libcuda, found at run time (the library
// links against the runtime only).
using EncodeFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                              void*, const cuuint64_t*, const cuuint64_t*,
                              const cuuint32_t*, const cuuint32_t*,
                              CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion,
                              CUtensorMapFloatOOBfill);

EncodeFn encode_fn() {
  static EncodeFn fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib != nullptr)
      fn = reinterpret_cast<EncodeFn>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// The tensor map of a contiguous bf16 [B, len, heads, D]: 64 x 64 boxes
// (64 of D's columns of one head over 64 rows of len), swizzled 128 bytes;
// rows past len read as zeros.
bool make_map(EncodeFn encode, CUtensorMap* map, const void* base, int B,
              int len, int heads, int D) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(len),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(D) * 2;
  const cuuint64_t strides[3] = {row, row * heads, row * heads * len};
  const cuuint32_t box[4] = {64, 1, kTile, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

cudaError_t launch_bf16_any(const Params& p, int D, cudaStream_t stream) {
  const EncodeFn encode = encode_fn();
  if (encode == nullptr) return cudaErrorSharedObjectSymbolNotFound;
  Maps m;
  if (!make_map(encode, &m.q, p.q, p.B, p.T, p.H, D) ||
      !make_map(encode, &m.dout, p.dout, p.B, p.T, p.H, D) ||
      !make_map(encode, &m.k, p.k, p.B, p.S, p.Hk, D) ||
      !make_map(encode, &m.v, p.v, p.B, p.S, p.Hk, D))
    return cudaErrorInvalidValue;
  switch (D) {
    case 64: return launch_bf16<64>(p, m, stream);
    case 128: return launch_bf16<128>(p, m, stream);
    case 256: return launch_bf16<256>(p, m, stream);
    default: return cudaErrorInvalidValue;
  }
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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. kv_map is a device array of H int32 or
// null (then Hk == H); group_off [Hk + 1] and group_heads [H] are the
// inverse map on the device. scratch is [2, B, H, Tp] float32 (delta, then
// lse2), Tp = T rounded up to 64. bfloat16 takes D = 64, 128 or 256 and
// n_split >= 1 splits of each KV head's query heads; with n_split > 1, part
// is a float32 [2, n_split, B, S, Hk, D] scratch. float32 takes every D of
// the forward and n_split = 1. Launches the kernels on `stream`; returns
// the cudaError_t of the launches (0 on success).
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* scratch, void* dq, void* dk,
    void* dv, void* part, const void* kv_map, const void* group_off,
    const void* group_heads, int dtype, int B, int T, int S, int H, int Hk,
    int D, int causal, int window, int q_offset, float scale, int n_split,
    void* stream) {
  const int Tp = (T + kTile - 1) / kTile * kTile;
  float* delta = static_cast<float*>(scratch);
  const Params p{q, k, v, o, dout, static_cast<const float*>(lse), delta,
                 delta + static_cast<long long>(B) * H * Tp, dq, dk, dv,
                 static_cast<float*>(part), static_cast<const int*>(kv_map),
                 static_cast<const int*>(group_off),
                 static_cast<const int*>(group_heads), B, T, S, H, Hk, Tp,
                 n_split, causal, window, q_offset, scale};
  if (n_split < 1 || (n_split > 1 && (dtype != 1 || part == nullptr)))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  const int chunks = D / (dtype == 0 ? 4 : 8);   // 16-byte chunks a row
  const int L = min(chunks & -chunks, 32);
  const long long threads = static_cast<long long>(B) * H * Tp * L;
  const unsigned blocks =
      static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  if (dtype == 0)
    delta_kernel<float><<<blocks, kThreads, 0, st>>>(p, D, L);
  else
    delta_kernel<bf16><<<blocks, kThreads, 0, st>>>(p, D, L);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (dtype == 1) return launch_bf16_any(p, D, st);
  switch (D) {
    case 32: return launch_f32<32>(p, st);
    case 64: return launch_f32<64>(p, st);
    case 96: return launch_f32<96>(p, st);
    case 128: return launch_f32<128>(p, st);
    case 256: return launch_f32<256>(p, st);
    default: return cudaErrorInvalidValue;
  }
}
