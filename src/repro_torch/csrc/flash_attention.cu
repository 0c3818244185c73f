// Prefill attention forward for Hopper (sm_90a), online softmax, float32
// accumulation.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::flash_attention
// (Pallas, body `_kernel`). Same function: q [B,T,H,D], k/v [B,S,Hk,D],
// query head h reads stored KV head kv_map[h] (clamped to [0, Hk); without
// a map Hk = H and h reads h), query row i at position i + q_offset,
// optional causal mask and sliding window (qpos - kpos < window), keys >= S
// and fully masked rows give 0, output in the input type.
//
// Bound on the H100: 4*D flops per visible (query, key) pair against each
// input read once; at the serving shapes (T = S = 512, D = 64; T = S =
// 2112, D = 256, window 2048) that is far above the card's ~295 flop/byte
// ridge, so the bound is the tensor cores' arithmetic.
//
// bfloat16: FlashAttention-2's structure on mma.sync. A block of 4 warps
// owns 64 query rows, 16 a warp, and walks K/V tiles of 64 keys held in a
// 2-stage ring in shared memory, filled by 16-byte cp.async copies so that
// the next tile lands while this one is computed. Rows are padded by 16
// bytes, so the ldmatrix reads (.trans for V) are free of bank conflicts.
// S = Q K^T and O += P V run as mma.sync.m16n8k16 bf16 -> f32; the softmax
// runs in registers on the accumulator's layout (a row's max and sum
// reduce over the 4 lanes of a quad) and P goes to bf16 in registers as the
// A operand of P V, never through shared memory. Only tiles that cross the
// diagonal, the window's edge or S evaluate the mask; tiles no row sees
// are skipped. At D <= 128 the Q fragments stay in registers; at D = 256
// the O accumulator alone is 128 floats a thread, so Q stays in shared
// memory and is re-read by ldmatrix for each 16-wide slice of D, and the
// K/V tiles are 32 keys, so that the block's shared memory, Q 33,792 B +
// 2 x (K + V) 67,584 B = 101,376 B, lets two blocks share an SM (~245
// registers a thread, no spill; see block_n). When B*H*ceil(T/64) blocks
// would not fill the card (a short suffix over a long cache), the wrapper
// splits each query tile's
// visible tiles into n_split chunks on a third grid axis; each chunk writes
// a float32 partial and its log-sum-exp, which attn_split.cuh's combine
// kernel merges. A warp-specialised wgmma/TMA pipeline (FlashAttention-3's
// shape) is the next step.
//
// The row log-sum-exp for the backward (flash_attention_bwd.cu): when the
// caller passes lse_out ([B, H, T] float32), the kernel writes each row's
// log-sum-exp of its scaled scores in base e, lse = ln sum_k exp(scale q.k),
// and -inf for a row with no visible key. The bfloat16 kernel keeps its
// running max and sum in base 2 and writes (m + log2 l) ln 2; the split
// path's combine writes the merged chunks' (attn_split.cuh); the float32
// kernel's scores are in base e already. Serving passes null.
//
// float32 keeps the CUDA-core design: the tensor cores take float32 only
// as TF32, ~3 decimal digits, which cannot hold the 2e-5 to which the
// float32 kernel is held against its plain version; float32 serves the
// whole-model checks and the tests. One block per (batch*head, query tile)
// stages K/V tiles in shared memory as float32 and runs both products as
// scalar FMAs; 32-row query tiles at head dim 256 keep 64 accumulators a
// thread and 172,800 B of shared memory.
//
// Plain C interface (bound from Python with ctypes). The caller allocates
// the output [B,T,H,D] contiguous and, when n_split > 1, the float32 scratch
// opart [n_split, B*T*H, D] and lse [n_split, B*T*H]. Inputs may be strided
// except along D; on the bfloat16 path their addresses and strides are
// multiples of 16 bytes (the wrapper makes a copy otherwise).

#include "attn_split.cuh"
#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;
constexpr float kNegBig = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Strides {  // element strides of the batch, sequence and head axes
  long long b, t, h;
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* opart;        // [n_split, B*T*H, D] when n_split > 1
  float* lse;          // [n_split, B*T*H]
  float* lse_out;      // [B, H, T] base-e row log-sum-exp, or null
  const int* kv_map;   // [H] or null
  int B, T, S, H, Hk;
  Strides qs, ks, vs;
  int causal, window, q_offset;
  float scale;
  int n_split, tiles_per_split;
};

// ------------------------------------------------- bfloat16: tensor cores
constexpr int kBlockM = 64;   // query rows a block, 16 a warp

// keys a K/V tile: 64, or 32 at head dim 256, where a 64-key ring holds
// 168,960 B of shared memory and one block an SM; 32-key tiles hold
// 101,376 B, two blocks an SM, and were the faster of the two at the
// window-2048 prefill on the H100 (tools/attention_probe.py)
template <int D>
__host__ __device__ constexpr int block_n() { return D > 128 ? 32 : 64; }

template <int D>
struct Tile {
  static constexpr int kBN = block_n<D>();
  static constexpr int kRS = D + 8;   // shared row stride in bf16: +16 B
  static constexpr int kQ = kBlockM * kRS;
  static constexpr int kKV = kBN * kRS;
  static constexpr int kSmemBytes = (kQ + 4 * kKV) * 2;  // Q, 2 x (K, V)
  static constexpr bool kQInRegs = D <= 128;
};

// The tiles [t_begin, t_end) of kBN keys that any row of query tile q0
// sees. The wrapper splits the same range, so it repeats this formula.
__device__ __forceinline__ void visible_tiles(int q0, int rows, int bn,
                                              const Params& p, int* t_begin,
                                              int* t_end) {
  const int q_last = min(q0 + rows, p.T) - 1 + p.q_offset;
  const int kv_end = p.causal ? min(p.S, q_last + 1) : p.S;
  const int kv_begin = p.window > 0 ? max(0, q0 + p.q_offset - p.window + 1)
                                    : 0;
  *t_begin = kv_begin / bn;
  *t_end = kv_end > kv_begin ? (kv_end + bn - 1) / bn : *t_begin;
}

// rows x D elements from global (row r at base + r * stride) into shared
// (row stride kRS); rows at or past n_valid are zero-filled.
template <int D, int kRows>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* base,
                                          long long stride, int n_valid) {
  constexpr int kChunks = D / 8;   // 16-byte pieces a row
  for (int c = threadIdx.x; c < kRows * kChunks; c += kThreads) {
    const int r = c / kChunks, col = (c % kChunks) * 8;
    const bool ok = r < n_valid;
    cp_async16(dst + r * Tile<D>::kRS + col,
               base + (ok ? r * stride : 0) + col, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_mma_kernel(const Params p) {
  using L = Tile<D>;
  constexpr int kBN = L::kBN, kRS = L::kRS;
  constexpr int kNT = kBN / 8;    // 8-key column tiles of S
  constexpr int kDT = D / 8;      // 8-wide column tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* kv_s = q_s + L::kQ;       // stage s: K at 2s, V at 2s + 1

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;   // mma fragment row, column pair
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockM;  // long rows first
  const int split = blockIdx.z;
  const int kvh = kv_head(p.kv_map, h, p.Hk);
  const bf16* qb = static_cast<const bf16*>(p.q) + b * p.qs.b + h * p.qs.h;
  const bf16* kb = static_cast<const bf16*>(p.k) + b * p.ks.b + kvh * p.ks.h;
  const bf16* vb = static_cast<const bf16*>(p.v) + b * p.vs.b + kvh * p.vs.h;

  int t_begin, t_end;
  visible_tiles(q0, kBlockM, kBN, p, &t_begin, &t_end);
  const int t0 = t_begin + split * p.tiles_per_split;
  const int t1 = min(t_end, t0 + p.tiles_per_split);

  auto load_kv = [&](int stage, int tile) {
    const int k0 = tile * kBN;
    load_rows<D, kBN>(kv_s + (2 * stage) * L::kKV, kb + k0 * p.ks.t, p.ks.t,
                      p.S - k0);
    load_rows<D, kBN>(kv_s + (2 * stage + 1) * L::kKV, vb + k0 * p.vs.t,
                      p.vs.t, p.S - k0);
  };

  load_rows<D, kBlockM>(q_s, qb + q0 * p.qs.t, p.qs.t, p.T - q0);
  cp_async_commit();
  if (t0 < t1) load_kv(0, t0);
  cp_async_commit();
  cp_async_wait<1>();             // Q has landed
  __syncthreads();

  // A fragments of this warp's 16 rows: ldmatrix.x4 with lane -> (row
  // lane % 16, column 8 * (lane / 16)) of each 16-wide slice of D
  const bf16* q_frag = q_s + (warp * 16 + lane % 16) * kRS + (lane / 16) * 8;
  uint32_t qf[L::kQInRegs ? D / 16 : 1][4];
  if constexpr (L::kQInRegs) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) ldsm_x4(qf[kk], q_frag + kk * 16);
  }

  float oacc[kDT][4];
#pragma unroll
  for (int i = 0; i < kDT; ++i)
    oacc[i][0] = oacc[i][1] = oacc[i][2] = oacc[i][3] = 0.f;
  float m_row[2] = {kNegBig, kNegBig};   // running max (base-2 scores)
  float l_row[2] = {0.f, 0.f};           // this thread's share of the sum
  const float scale2 = p.scale * kLog2e;
  const int row0 = q0 + warp * 16 + g;   // rows row0 and row0 + 8

  // ldmatrix lane offsets: K (B of Q K^T) rows 8 * (lane / 16) + lane % 8,
  // column 8 * ((lane / 8) % 2); V (B of P V, transposed) rows
  // 8 * ((lane / 8) % 2) + lane % 8, column 8 * (lane / 16)
  const int k_off = (8 * (lane / 16) + lane % 8) * kRS + 8 * ((lane / 8) % 2);
  const int v_off = (8 * ((lane / 8) % 2) + lane % 8) * kRS + 8 * (lane / 16);

  for (int tile = t0; tile < t1; ++tile) {
    const int stage = (tile - t0) & 1;
    if (tile + 1 < t1) load_kv(stage ^ 1, tile + 1);
    cp_async_commit();
    cp_async_wait<1>();           // this tile has landed
    __syncthreads();
    const bf16* k_s = kv_s + (2 * stage) * L::kKV;
    const bf16* v_s = kv_s + (2 * stage + 1) * L::kKV;
    const int k0 = tile * kBN;

    // S = Q K^T
    float sacc[kNT][4];
#pragma unroll
    for (int i = 0; i < kNT; ++i)
      sacc[i][0] = sacc[i][1] = sacc[i][2] = sacc[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      if constexpr (L::kQInRegs) {
        a[0] = qf[kk][0]; a[1] = qf[kk][1]; a[2] = qf[kk][2]; a[3] = qf[kk][3];
      } else {
        ldsm_x4(a, q_frag + kk * 16);
      }
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        uint32_t bk[4];
        ldsm_x4(bk, k_s + np * 16 * kRS + kk * 16 + k_off);
        mma_bf16(sacc[2 * np], a, bk[0], bk[1]);
        mma_bf16(sacc[2 * np + 1], a, bk[2], bk[3]);
      }
    }

    // scale to base 2; mask only a tile that crosses the diagonal, the
    // window's edge or S (a masked key gets -inf: probability exactly 0)
    const int qpos_lo = q0 + p.q_offset, qpos_hi = qpos_lo + kBlockM - 1;
    const bool need_mask = k0 + kBN > p.S ||
                           (p.causal && k0 + kBN - 1 > qpos_lo) ||
                           (p.window > 0 && qpos_hi - k0 >= p.window);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float s = sacc[nt][e] * scale2;
        if (need_mask) {
          const int qpos = row0 + 8 * (e / 2) + p.q_offset;
          const int kpos = k0 + nt * 8 + 2 * t4 + (e & 1);
          bool ok = kpos < p.S;
          if (p.causal) ok = ok && qpos >= kpos;
          if (p.window > 0) ok = ok && qpos - kpos < p.window;
          if (!ok) s = -INFINITY;
        }
        sacc[nt][e] = s;
      }
    }

    // online softmax, one row per half of the accumulator
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = kNegBig;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
        mx = fmaxf(mx, fmaxf(sacc[nt][2 * i], sacc[nt][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_row[i], mx);   // finite: >= -1e30
      const float alpha = exp2f(m_row[i] - m_new);
      m_row[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const float p0 = exp2f(sacc[nt][2 * i] - m_new);
        const float p1 = exp2f(sacc[nt][2 * i + 1] - m_new);
        sacc[nt][2 * i] = p0;
        sacc[nt][2 * i + 1] = p1;
        sum += p0 + p1;
      }
      l_row[i] = l_row[i] * alpha + sum;
#pragma unroll
      for (int dt = 0; dt < kDT; ++dt) {
        oacc[dt][2 * i] *= alpha;
        oacc[dt][2 * i + 1] *= alpha;
      }
    }

    // O += P V, P as the A operand straight from the S accumulators
#pragma unroll
    for (int j = 0; j < kBN / 16; ++j) {
      const uint32_t pa[4] = {
          pack_bf16(sacc[2 * j][0], sacc[2 * j][1]),
          pack_bf16(sacc[2 * j][2], sacc[2 * j][3]),
          pack_bf16(sacc[2 * j + 1][0], sacc[2 * j + 1][1]),
          pack_bf16(sacc[2 * j + 1][2], sacc[2 * j + 1][3])};
#pragma unroll
      for (int np = 0; np < kDT / 2; ++np) {
        uint32_t bv[4];
        ldsm_x4_t(bv, v_s + j * 16 * kRS + np * 16 + v_off);
        mma_bf16(oacc[2 * np], pa, bv[0], bv[1]);
        mma_bf16(oacc[2 * np + 1], pa, bv[2], bv[3]);
      }
    }
    __syncthreads();              // the stage is free for the next load
  }

  // epilogue: the output (n_split == 1) or this chunk's partial
  const long long R = static_cast<long long>(p.B) * p.T * p.H;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_row[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = row0 + 8 * i;
    if (row >= p.T) continue;
    const float inv = l > 0.f ? 1.f / l : 0.f;
    const long long r = (static_cast<long long>(b) * p.T + row) * p.H + h;
    if (p.n_split == 1) {
      if (p.lse_out != nullptr && t4 == 0)
        p.lse_out[(static_cast<long long>(b) * p.H + h) * p.T + row] =
            l > 0.f ? (m_row[i] + log2f(l)) * kLn2 : -INFINITY;
      bf16* orow = static_cast<bf16*>(p.o) + r * D + 2 * t4;
#pragma unroll
      for (int dt = 0; dt < kDT; ++dt)
        *reinterpret_cast<__nv_bfloat162*>(orow + dt * 8) =
            __floats2bfloat162_rn(oacc[dt][2 * i] * inv,
                                  oacc[dt][2 * i + 1] * inv);
    } else {
      const long long pr = split * R + r;
      if (l > 0.f) {
        float* orow = p.opart + pr * D + 2 * t4;
#pragma unroll
        for (int dt = 0; dt < kDT; ++dt)
          *reinterpret_cast<float2*>(orow + dt * 8) =
              make_float2(oacc[dt][2 * i] * inv, oacc[dt][2 * i + 1] * inv);
      }
      if (t4 == 0) p.lse[pr] = l > 0.f ? m_row[i] + log2f(l) : -INFINITY;
    }
  }
}

template <int D>
cudaError_t launch_bf16(const Params& p, cudaStream_t stream) {
  constexpr int smem = Tile<D>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.B * p.H, (p.T + kBlockM - 1) / kBlockM, p.n_split);
  flash_mma_kernel<D><<<grid, kThreads, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.n_split == 1) return err;
  return launch_combine<bf16>(p.opart, p.lse, p.o, p.n_split,
                              static_cast<long long>(p.B) * p.T * p.H, D,
                              stream, p.lse_out, p.T, p.H);
}

template <int D>
cudaError_t tiling_bf16(int* bn, int* blocks_per_sm) {
  constexpr int smem = Tile<D>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  *bn = Tile<D>::kBN;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, flash_mma_kernel<D>, kThreads, smem);
}

// ------------------------------------------------ float32: CUDA cores
// query rows per block: 64, or 32 at head dim 256 (see the header)
template <int D>
__host__ __device__ constexpr int block_q() { return D > 128 ? 32 : 64; }
constexpr int kBlockK = 64;      // keys a tile; the softmax takes 2 a lane
constexpr int kWarps = kThreads / 32;

template <int D>
constexpr int smem_floats() {
  constexpr int kBlockQ = block_q<D>();
  return kBlockQ * D              // q tile, pre-scaled
         + kBlockK * (D + 1)      // k tile, padded row: no bank conflicts
         + kBlockK * D            // v tile
         + kBlockQ * (kBlockK + 1)  // scores, then probabilities
         + 3 * kBlockQ;           // running max, running sum, rescale
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_f32_kernel(const Params p) {
  constexpr int kBlockQ = block_q<D>();
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
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int q0 = blockIdx.y * kBlockQ;
  const int T = p.T, S = p.S;
  const int kvh = kv_head(p.kv_map, h, p.Hk);
  const float* qb = static_cast<const float*>(p.q) + b * p.qs.b + h * p.qs.h;
  const float* kb = static_cast<const float*>(p.k) + b * p.ks.b + kvh * p.ks.h;
  const float* vb = static_cast<const float*>(p.v) + b * p.vs.b + kvh * p.vs.h;

  constexpr int kAcc = kBlockQ * D / kThreads;  // output elements per thread
  float acc[kAcc];
#pragma unroll
  for (int r = 0; r < kAcc; ++r) acc[r] = 0.f;

  for (int idx = tid; idx < kBlockQ * D; idx += kThreads) {
    const int i = idx / D, d = idx % D;
    const int t = q0 + i;
    q_s[idx] = t < T ? qb[t * p.qs.t + d] * p.scale : 0.f;
  }
  for (int i = tid; i < kBlockQ; i += kThreads) {
    m_s[i] = kNegBig;
    l_s[i] = 0.f;
  }

  // KV range any row of this tile can see: tiles wholly above the diagonal
  // or wholly outside the window are skipped.
  const int q_last = min(q0 + kBlockQ, T) - 1 + p.q_offset;
  const int kv_end = p.causal ? min(S, q_last + 1) : S;
  int kv_begin = p.window > 0 ? max(0, q0 + p.q_offset - p.window + 1) : 0;
  kv_begin = (kv_begin / kBlockK) * kBlockK;
  __syncthreads();

  for (int k0 = kv_begin; k0 < kv_end; k0 += kBlockK) {
    for (int idx = tid; idx < kBlockK * D; idx += kThreads) {
      const int j = idx / D, d = idx % D;
      const int s = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (s < S) {
        kx = kb[s * p.ks.t + d];
        vx = vb[s * p.vs.t + d];
      }
      k_s[j * (D + 1) + d] = kx;
      v_s[j * D + d] = vx;
    }
    __syncthreads();

    // scores; a masked key gets -inf, so its probability is exactly 0
    for (int idx = tid; idx < kBlockQ * kBlockK; idx += kThreads) {
      const int i = idx / kBlockK, j = idx % kBlockK;
      const int qpos = q0 + i + p.q_offset, kpos = k0 + j;
      bool ok = kpos < S && q0 + i < T;
      if (p.causal) ok = ok && qpos >= kpos;
      if (p.window > 0) ok = ok && qpos - kpos < p.window;
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

  float* o = static_cast<float*>(p.o);
#pragma unroll
  for (int r = 0; r < kAcc; ++r) {
    const int idx = tid + r * kThreads;
    const int i = idx / D, d = idx % D;
    const int t = q0 + i;
    if (t < T) {
      const long long off =
          ((static_cast<long long>(b) * T + t) * p.H + h) * D + d;
      o[off] = acc[r] / fmaxf(l_s[i], 1e-30f);
    }
  }
  if (p.lse_out != nullptr) {
    for (int i = tid; i < kBlockQ && q0 + i < T; i += kThreads)
      p.lse_out[(static_cast<long long>(b) * p.H + h) * T + q0 + i] =
          l_s[i] > 0.f ? m_s[i] + logf(l_s[i]) : -INFINITY;
  }
}

template <int D>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  if (p.n_split != 1) return cudaErrorInvalidValue;
  const int smem = smem_floats<D>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.B * p.H, (p.T + block_q<D>() - 1) / block_q<D>());
  flash_f32_kernel<D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(int dtype, const Params& p, cudaStream_t stream) {
  if (dtype == 0) return launch_f32<D>(p, stream);
  if (dtype == 1) return launch_bf16<D>(p, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; kv_map is a
// device array of H int32 or null; opart/lse are the split scratch (null
// when n_split == 1; float32 takes n_split == 1 only); lse_out is the
// [B, H, T] float32 row log-sum-exp in base e, or null. Returns the
// cudaError_t of the launches (0 on success).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* opart,
    void* lse, void* lse_out, const void* kv_map, int dtype, int B, int T, int S, int H,
    int Hk, int D, long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_st, long long k_sh, long long v_sb,
    long long v_st, long long v_sh, int causal, int window, int q_offset,
    float scale, int n_split, int tiles_per_split, void* stream) {
  const Params p{q, k, v, o, static_cast<float*>(opart),
                 static_cast<float*>(lse), static_cast<float*>(lse_out),
                 static_cast<const int*>(kv_map),
                 B, T, S, H, Hk, {q_sb, q_st, q_sh}, {k_sb, k_st, k_sh},
                 {v_sb, v_st, v_sh}, causal, window, q_offset, scale,
                 n_split, tiles_per_split};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch<32>(dtype, p, st);
    case 64: return launch<64>(dtype, p, st);
    case 96: return launch<96>(dtype, p, st);
    case 128: return launch<128>(dtype, p, st);
    case 256: return launch<256>(dtype, p, st);
    default: return cudaErrorInvalidValue;
  }
}

// The bfloat16 kernel's key tile and resident blocks an SM at head dim D,
// from which the wrapper chooses n_split.
extern "C" int flash_attention_tiling(int D, int* block_n,
                                      int* blocks_per_sm) {
  switch (D) {
    case 32: return tiling_bf16<32>(block_n, blocks_per_sm);
    case 64: return tiling_bf16<64>(block_n, blocks_per_sm);
    case 96: return tiling_bf16<96>(block_n, blocks_per_sm);
    case 128: return tiling_bf16<128>(block_n, blocks_per_sm);
    case 256: return tiling_bf16<256>(block_n, blocks_per_sm);
    default: return cudaErrorInvalidValue;
  }
}
