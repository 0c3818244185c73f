// Decode attention for Hopper (sm_90a): one new query token per sequence
// against a padded KV cache, keys masked to kpos < lengths[b], online
// softmax in float32; flash-decoding over the stored KV heads.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py::decode_attention
// (Pallas, body `_kernel`). Same function: q [B,H,D], k/v [B,S,Hk,D],
// query head h reads stored KV head kv_map[h] (clamped to [0, Hk); without
// a map Hk = H and h reads h), lengths [B] int32; a sequence of length 0
// gives 0; output in q's type. K/V are in q's type or int8 codes, whose
// value is code * kv_scale (the JAX model's int8 KV cache: kv_scale =
// 1/32, kernels/decode_attention.py::kv_dequant).
//
// Bound on the H100: each stored key is read once and used for 4*D flops
// a query head that shares it. With one to four heads a KV head (smollm)
// that is a few flops a byte, so the bound is device-memory bytes (2 *
// sum(lengths) * Hk * D * sizeof(elem)); with 16 heads on one KV head
// (recurrentgemma's MQA) it is 32 flops a bf16 byte, past the ~20 flop/byte
// ridge of the float32 CUDA cores this kernel computes on, and the
// products bind (measured: ~30 us a 64-key block at D = 256, 16 heads;
// tensor-core products for a head group are the next step). The design
// reads each stored K/V row once, for every query head that maps to it,
// and spreads the keys over the card:
//   * the grid is (n_split, Hk, B * n_hb): a block takes one sequence, one
//     stored KV head and one chunk of `chunk` keys (n_split chunks cover S;
//     the wrapper picks them from S and the grid's other axes, so that the
//     grid covers the 132 SMs about four times); n_hb > 1 only when more
//     query heads share a KV
//     head than one block holds (kCap);
//   * the block starts copying its first 64-key tile into shared memory
//     (16-byte cp.async copies, coalesced: a row's bytes are contiguous and
//     neighbouring threads copy neighbouring pieces; K and V in two groups,
//     so the scores run while V lands), then loads the map, collects its
//     query heads and stages their q vectors in shared memory; a chunk of
//     several tiles walks them through a 2-stage ring, the next tile's copy
//     in flight while this one is computed;
//   * 8 warps a block, two a scheduler, so that a block alone on its SM
//     (a sequence's only chunk with keys) still hides shared-memory latency;
//   * scores: a thread takes one key and 4 heads at a time (one where the
//     group is smaller), reading 8 elements of the key's row with one
//     16-byte shared load (rows padded by 16 bytes: no bank conflicts),
//     with no branch inside a product so that a step's loads issue
//     together; online softmax per head, a warp per head; P V: a thread
//     owns 8 columns of D for up to 4 heads and a share of the keys,
//     partial sums folded through shared memory once at the end;
//   * a chunk at or past lengths[b] writes an empty partial; with n_split
//     > 1 the chunks' partials are merged by attn_split.cuh's combine
//     kernel, with n_split = 1 the block writes the output.
//
// Partial mode (a rank's share of a sequence-sharded cache): k/v are the
// rank's slots, lengths the keys it holds of each sequence (0 for a
// sequence none of whose keys it holds), and the output is the rank's
// partial in float32, normalised over those keys, with its base-2
// log-sum-exp lse [B, H] (-inf and an output of 0 for a row that sees no
// key): what a split-KV chunk writes, for the ranks' partials to be merged
// by the same combine (attn_merge.cu). With n_split = 1 the block writes
// both into the output and lse; with n_split > 1 the combine merges the
// chunks in float32 and writes the merged lse in base 2. The partial stays
// float32: rounded to q's type it would lose bits before the ranks' merge
// that one softmax over the whole cache keeps.
// bfloat16 and float32 take the same design and compute in float32 on the
// CUDA cores.
//
// int8 K/V (the KV cache at one byte an element, which halves the bytes
// that bind the step): the tiles are copied as they are stored, codes, by
// the same 16-byte cp.async rows (D bytes a row, D >= 32), and converted to
// float in registers as each product reads them (load8: 8 codes a 64-bit
// shared load). The dequant scale, a kernel argument, is not applied per
// element: it is folded into the staged q (for K: q . (c s) = (q s) . c)
// and into the output (for V: sum p_j c_j s = s sum p_j c_j), one multiply
// a query head and an output element instead of one a code. For a
// power-of-two scale, such as 1/32, both folds are exact in float32. No
// dequantised copy of the cache is ever made.
//
// Plain C interface (bound from Python with ctypes). The caller allocates
// the output [B,H,D] contiguous and, when n_split > 1, the float32 scratch
// opart [n_split, B*H, D] and lse [n_split, B*H]; in partial mode the
// output is float32 and lse_out [B*H] float32. Inputs may be strided
// except along D; their addresses and strides are multiples of 16 bytes
// (the wrapper makes a copy otherwise).

#include "attn_split.cuh"

namespace {

constexpr int kThreads = 256;    // 8 warps: two a scheduler
constexpr int kWarps = kThreads / 32;
constexpr int kBK = 64;          // keys a tile; the softmax takes 2 a lane
constexpr int kHS = kThreads / kBK;   // threads a key in the scores
constexpr int kSlots = 4;        // heads a thread accumulates in P V
constexpr float kNegBig = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {  // element strides of the batch, sequence and head axes
  long long b, s, h;
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* lengths;
  const int* kv_map;   // [H] or null
  void* o;
  float* opart;        // [n_split, B*H, D] when n_split > 1
  float* lse;          // [n_split, B*H]
  float* lse_out;      // [B*H], base 2, in partial mode (else null)
  int partial;         // 1: o is float32, lse_out written
  int B, S, H, Hk;
  long long q_sb, q_sh;
  Strides ks, vs;
  float scale;
  float kv_scale;      // the value of one K/V unit: 1, or an int8 code's
  int chunk, n_split, n_hb, cap;
  int stages;          // 2: a K/V ring when a chunk holds several tiles
};

// KV: the element type of the K/V rows (float, bfloat16 or int8 codes)
template <typename KV, int D>
struct Layout {
  static constexpr int kDC = D / 8;               // 8-column pieces of a row
  static constexpr int kHG = kThreads / kDC;      // thread groups in P V
  static constexpr int kCap = kHG * kSlots;       // query heads a block
  static constexpr int kRS = D + 16 / sizeof(KV); // shared row stride
};

// shared memory of a block holding `cap` query heads of H
template <typename KV, int D>
__host__ __device__ constexpr int smem_bytes(int cap, int H, int stages) {
  using L = Layout<KV, D>;
  return 2 * stages * kBK * L::kRS * static_cast<int>(sizeof(KV))  // K, V
         + L::kCap * D * 4                // q (scaled), later the P V sums
         + cap * (kBK + 1) * 4            // scores, then probabilities
         + 3 * cap * 4                    // running max, sum, rescale
         + (H + cap) * 4;                 // the map, this block's heads
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
// 8 int8 codes (8-byte aligned) as floats: each byte shifted to the top of
// a 32-bit word and shifted back arithmetically, which sign-extends it
__device__ __forceinline__ void load8(const int8_t* p, float (&x)[8]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[i] = static_cast<float>(static_cast<int>(u.x << (24 - 8 * i)) >> 24);
    x[4 + i] =
        static_cast<float>(static_cast<int>(u.y << (24 - 8 * i)) >> 24);
  }
}

// rows [k0, k0 + kBK) of one head into shared memory; rows at or past k_hi
// are zero-filled (their probability is 0, and 0 * 0 stays 0)
template <typename KV, int D>
__device__ __forceinline__ void load_tile(KV* dst, const KV* base,
                                          long long stride, int k0,
                                          int k_hi) {
  constexpr int kPieces = D * static_cast<int>(sizeof(KV)) / 16;
  constexpr int kPer = 16 / static_cast<int>(sizeof(KV));
  for (int c = threadIdx.x; c < kBK * kPieces; c += kThreads) {
    const int r = c / kPieces, col = (c % kPieces) * kPer;
    const bool ok = k0 + r < k_hi;
    cp_async16(dst + r * Layout<KV, D>::kRS + col,
               base + (ok ? (k0 + r) * stride : 0) + col, ok);
  }
}

// E: the type of q and the output; KV: that of the K/V rows
template <typename E, typename KV, int D>
__global__ void __launch_bounds__(kThreads) decode_kernel(const Params p) {
  using L = Layout<KV, D>;
  constexpr int kRS = L::kRS, kDC = L::kDC, kHG = L::kHG;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  KV* kv_s = reinterpret_cast<KV*>(smem_raw);   // stage s: K at 2s, V at 2s+1
  float* q_s = reinterpret_cast<float*>(kv_s + 2 * p.stages * kBK * kRS);
  float* s_s = q_s + L::kCap * D;                           // [cap][kBK+1]
  float* m_s = s_s + p.cap * (kBK + 1);
  float* l_s = m_s + p.cap;
  float* a_s = l_s + p.cap;
  int* map_s = reinterpret_cast<int*>(a_s + p.cap);         // [H]
  int* heads = map_s + p.H;                                 // [cap]
  __shared__ int n_heads;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int split = blockIdx.x, kvh = blockIdx.y;
  const int b = blockIdx.z / p.n_hb, hb = blockIdx.z % p.n_hb;

  // the first tile's copy starts before anything else, so that it lands
  // while the block gathers its heads and their q vectors
  const int len = min(max(p.lengths[b], 0), p.S);
  const int k_lo = split * p.chunk;
  const int k_hi = min(k_lo + p.chunk, len);
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + kBK - 1) / kBK : 0;
  const KV* kb = static_cast<const KV*>(p.k) + b * p.ks.b + kvh * p.ks.h;
  const KV* vb = static_cast<const KV*>(p.v) + b * p.vs.b + kvh * p.vs.h;
  auto issue = [&](int t) {       // tile t into stage t % stages: 2 groups
    KV* k_dst = kv_s + 2 * (t % p.stages) * kBK * kRS;
    load_tile<KV, D>(k_dst, kb, p.ks.s, k_lo + t * kBK, k_hi);
    cp_async_commit();
    load_tile<KV, D>(k_dst + kBK * kRS, vb, p.vs.s, k_lo + t * kBK, k_hi);
    cp_async_commit();
  };
  if (n_tiles > 0) issue(0);

  // this block's query heads: the hb-th run of `cap` heads mapping to kvh
  for (int h = tid; h < p.H; h += kThreads)
    map_s[h] = kv_head(p.kv_map, h, p.Hk);
  __syncthreads();
  if (tid == 0) {
    int n = 0;
    for (int h = 0; h < p.H; ++h) {
      if (map_s[h] != kvh) continue;
      const int slot = n++ - hb * p.cap;
      if (slot >= 0 && slot < p.cap) heads[slot] = h;
    }
    n_heads = min(max(n - hb * p.cap, 0), p.cap);
  }
  __syncthreads();
  const int G = n_heads;
  if (G == 0) {
    cp_async_wait<0>();           // no copy may land after the block exits
    return;
  }

  const E* qb = static_cast<const E*>(p.q) + b * p.q_sb;
  // base-2 scores; K's unit folded in (q . (c s) = (q s) . c)
  const float scale2 = p.scale * kLog2e * p.kv_scale;
  for (int i = tid; i < G * kDC; i += kThreads) {   // 8 elements a load
    const int g = i / kDC, c = i % kDC;
    float x[8];
    load8(qb + heads[g] * p.q_sh + c * 8, x);
    float4* dst = reinterpret_cast<float4*>(q_s + g * D + c * 8);
    dst[0] = make_float4(x[0] * scale2, x[1] * scale2, x[2] * scale2,
                         x[3] * scale2);
    dst[1] = make_float4(x[4] * scale2, x[5] * scale2, x[6] * scale2,
                         x[7] * scale2);
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegBig;
    l_s[g] = 0.f;
  }

  // P V ownership: columns [8 dc, 8 dc + 8), heads hg + i * n_hg (i <
  // kSlots), keys kg, kg + n_kg, ...; the kHG groups of kDC threads share
  // out the heads first, then the keys
  const int n_hg = (G + kSlots - 1) / kSlots;   // <= kHG
  const int n_kg = kHG / n_hg;
  const int dc = tid % kDC, u = tid / kDC;
  const int hg = u % n_hg, kg = u / n_hg;
  const bool pv = u < kHG && kg < n_kg;
  // slot i holds head hg + i * n_hg; a slot past G reads a real head's row
  // with probability 0 instead of branching
  int slot_g[kSlots];
  bool slot_ok[kSlots];
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    slot_ok[i] = hg + i * n_hg < G;
    slot_g[i] = slot_ok[i] ? hg + i * n_hg : G - 1;
  }
  float acc[kSlots][8];
#pragma unroll
  for (int i = 0; i < kSlots; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[i][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = k_lo + t * kBK;
    const KV* k_s = kv_s + 2 * (t % p.stages) * kBK * kRS;
    const KV* v_s = k_s + kBK * kRS;
    __syncthreads();              // q_s, or the reads of the stage, done
    // one stage: this tile's copy now; two: the next tile's, into the
    // stage the last tile used
    const bool ahead = p.stages == 2 && t + 1 < n_tiles;
    if (p.stages == 1 && t > 0) issue(t);
    if (ahead) {
      issue(t + 1);
      cp_async_wait<3>();         // K of tile t has landed
    } else {
      cp_async_wait<1>();
    }
    __syncthreads();

    // scores: key j; heads g0 + i * kHS (i < 4) at a time where the group
    // fills them, else one at a time. No branch inside a product, so the
    // shared loads of a step are issued together (a branch per head left
    // each load's latency exposed: ~26 us a block at D = 256). A key at or
    // past the chunk's end scores -inf without a product.
    {
      const int j = tid % kBK, hs = tid / kBK;
      const bool valid = k0 + j < k_hi;
      const KV* krow = k_s + j * kRS;
      int g = hs;
      for (; g + 3 * kHS < G; g += 4 * kHS) {
        float dot[4] = {0.f, 0.f, 0.f, 0.f};
        if (valid) {
#pragma unroll 4
          for (int c = 0; c < kDC; ++c) {
            float kx[8];
            load8(krow + c * 8, kx);
#pragma unroll
            for (int w = 0; w < 4; ++w) {
              float qx[8];
              load8(q_s + (g + kHS * w) * D + c * 8, qx);
#pragma unroll
              for (int e = 0; e < 8; ++e) dot[w] = fmaf(qx[e], kx[e], dot[w]);
            }
          }
        }
#pragma unroll
        for (int w = 0; w < 4; ++w)
          s_s[(g + kHS * w) * (kBK + 1) + j] = valid ? dot[w] : -INFINITY;
      }
      for (; g < G; g += kHS) {
        float dot[2] = {0.f, 0.f};
        if (valid) {
#pragma unroll 4
          for (int c = 0; c < kDC; ++c) {
            float kx[8], qx[8];
            load8(krow + c * 8, kx);
            load8(q_s + g * D + c * 8, qx);
#pragma unroll
            for (int e = 0; e < 8; ++e)
              dot[c & 1] = fmaf(qx[e], kx[e], dot[c & 1]);
          }
        }
        s_s[g * (kBK + 1) + j] = valid ? dot[0] + dot[1] : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax, a warp per head, two keys a lane
    for (int g = warp; g < G; g += kWarps) {
      float* row = s_s + g * (kBK + 1);
      const float s0 = row[lane], s1 = row[lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);   // finite: >= -1e30
      const float p0 = exp2f(s0 - m_new), p1 = exp2f(s1 - m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      row[lane] = p0;
      row[lane + 32] = p1;
      if (lane == 0) {
        const float alpha = exp2f(m_prev - m_new);
        a_s[g] = alpha;
        l_s[g] = alpha * l_s[g] + sum;
        m_s[g] = m_new;
      }
    }
    if (ahead)                    // V of tile t has landed
      cp_async_wait<2>();
    else
      cp_async_wait<0>();
    __syncthreads();

    if (pv) {
#pragma unroll
      for (int i = 0; i < kSlots; ++i) {
        const float a = a_s[slot_g[i]];
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[i][e] *= a;
      }
      const int n = min(kBK, k_hi - k0);
      for (int j = kg; j < n; j += n_kg) {
        float vx[8];
        load8(v_s + j * kRS + dc * 8, vx);
#pragma unroll
        for (int i = 0; i < kSlots; ++i) {
          const float pj =
              slot_ok[i] ? s_s[slot_g[i] * (kBK + 1) + j] : 0.f;
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[i][e] = fmaf(pj, vx[e], acc[i][e]);
        }
      }
    }
  }

  // fold the key groups' sums through shared memory (q_s is free now)
  __syncthreads();
  float* sums = q_s;              // [n_kg][G][D], n_kg * G <= kCap
  if (pv) {
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const int g = slot_g[i];
      if (slot_ok[i]) {
        float* dst = sums + (kg * G + g) * D + dc * 8;
#pragma unroll
        for (int e = 0; e < 8; ++e) dst[e] = acc[i][e];
      }
    }
  }
  __syncthreads();
  const long long R = static_cast<long long>(p.B) * p.H;
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    float x = 0.f;
    for (int k = 0; k < n_kg; ++k) x += sums[(k * G + g) * D + d];
    const float l = l_s[g];
    const float y = x / l * p.kv_scale;          // V's unit folded in
    const long long r = static_cast<long long>(b) * p.H + heads[g];
    if (p.n_split == 1 && !p.partial) {
      store(static_cast<E*>(p.o) + r * D + d, l > 0.f ? y : 0.f);
    } else {     // a chunk's partial, or the rank's (opart = o, lse = out)
      const long long pr = split * R + r;
      p.opart[pr * D + d] = l > 0.f ? y : 0.f;
      if (d == 0) p.lse[pr] = l > 0.f ? m_s[g] + log2f(l) : -INFINITY;
    }
  }
}

constexpr int kMaxSmem = 232448;   // a block's shared memory on sm_90

template <typename E, typename KV, int D>
cudaError_t launch(Params p, cudaStream_t stream) {
  // the ring where a chunk holds several tiles and two stages fit
  p.stages = p.chunk > kBK && smem_bytes<KV, D>(p.cap, p.H, 2) <= kMaxSmem
                 ? 2 : 1;
  const int smem = smem_bytes<KV, D>(p.cap, p.H, p.stages);
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<E, KV, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.n_split, p.Hk, p.B * p.n_hb);
  decode_kernel<E, KV, D><<<grid, kThreads, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.n_split == 1) return err;
  const long long R = static_cast<long long>(p.B) * p.H;
  if (p.partial)      // float32 output, the merged lse in base 2
    return launch_combine<float>(p.opart, p.lse, p.o, p.n_split, R, D,
                                 stream, p.lse_out, 1, p.H, 1.f);
  return launch_combine<E>(p.opart, p.lse, p.o, p.n_split, R, D, stream);
}

template <typename E, typename KV>
cudaError_t dispatch_d(int D, const Params& p, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<E, KV, 32>(p, stream);
    case 64: return launch<E, KV, 64>(p, stream);
    case 96: return launch<E, KV, 96>(p, stream);
    case 128: return launch<E, KV, 128>(p, stream);
    case 256: return launch<E, KV, 256>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

// K/V in q's type, or int8 codes (kv_dtype 2)
template <typename E>
cudaError_t dispatch_kv(int dtype, int kv_dtype, int D, const Params& p,
                        cudaStream_t stream) {
  if (kv_dtype == dtype) return dispatch_d<E, E>(D, p, stream);
  if (kv_dtype == 2) return dispatch_d<E, int8_t>(D, p, stream);
  return cudaErrorInvalidValue;
}

template <int D>
int cap_of() { return Layout<float, D>::kCap; }

}  // namespace

// The most query heads one block holds at head dim D (the same for both
// dtypes); the wrapper cuts a larger group into n_hb blocks.
extern "C" int decode_attention_cap(int D) {
  switch (D) {
    case 32: return cap_of<32>();
    case 64: return cap_of<64>();
    case 96: return cap_of<96>();
    case 128: return cap_of<128>();
    case 256: return cap_of<256>();
    default: return 0;
  }
}

// dtype (q and the output): 0 = float32, 1 = bfloat16; kv_dtype (K and V):
// dtype, or 2 = int8 codes of value code * kv_scale (kv_scale is 1 for K/V
// in q's type). Strides are in elements; lengths is a device array of B
// int32, kv_map one of H int32 or null; opart/lse are the split scratch
// (null when n_split == 1). With partial, o is float32 and lse_out the
// [B*H] float32 base-2 log-sum-exp (see the partial mode above). cap is the
// query heads a block holds (<= decode_attention_cap(D)), n_hb = ceil(H /
// cap). Returns the cudaError_t of the launches.
extern "C" int decode_attention_fwd(
    const void* q, const void* k, const void* v, const void* lengths,
    const void* kv_map, void* o, void* opart, void* lse, void* lse_out,
    int partial, int dtype,
    int kv_dtype, int B, int S, int H, int Hk, int D, long long q_sb,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, float scale,
    float kv_scale, int chunk, int n_split, int n_hb, int cap,
    void* stream) {
  Params p{q, k, v, static_cast<const int*>(lengths),
           static_cast<const int*>(kv_map), o,
           static_cast<float*>(opart), static_cast<float*>(lse),
           static_cast<float*>(lse_out), partial,
           B, S, H, Hk, q_sb, q_sh, {k_sb, k_ss, k_sh},
           {v_sb, v_ss, v_sh}, scale, kv_scale, chunk, n_split, n_hb,
           cap, 1};
  if (partial && n_split == 1) {     // the one chunk's partial is the rank's
    p.opart = static_cast<float*>(o);
    p.lse = p.lse_out;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_kv<float>(dtype, kv_dtype, D, p, st);
  if (dtype == 1)
    return dispatch_kv<__nv_bfloat16>(dtype, kv_dtype, D, p, st);
  return cudaErrorInvalidValue;
}
