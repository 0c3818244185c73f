// The merge of a sequence-sharded decode's partials (Hopper, sm_90a):
// attn_split.cuh's combine kernel launched on its own, with the ranks of
// the model axis as its chunks.
//
// Under the sequence-sharded decode cache each of the n ranks holds a block
// of every sequence's slots and runs the decode kernel in its partial mode:
// for each row (sequence, query head) the output normalised over the
// rank's keys, o_c (float32 [D]), and the base-2 log-sum-exp of its scores,
// lse_c (-inf where the rank holds none of the row's keys). The ranks
// exchange them, and each merges its rows:
//
//     out = sum_c 2^(lse_c - M) o_c / sum_c 2^(lse_c - M),  M = max_c lse_c
//
// (0 for a row no rank sees a key of), in the output's type: the function
// of kernels/attn_split.py::merge_partials, its plain version. MLA merges
// its latent accumulators the same way at D = its latent rank (512 for
// DeepSeek-V3). The kernel is bound by the bytes of the partials it reads,
// n R (D + 1) float32, one thread for 4 columns of a row.
//
// Plain C interface (bound from Python with ctypes): opart [n, R, D] and
// lse [n, R] float32, contiguous, 16-byte aligned, D a multiple of 4; out
// [R, D] contiguous in dtype (0 = float32, 1 = bfloat16). Returns the
// cudaError_t of the launch.

#include "attn_split.cuh"

extern "C" int attn_merge(const void* opart, const void* lse, void* out,
                          int dtype, int n, long long R, int D,
                          void* stream) {
  if (D % 4 != 0 || n < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* o = static_cast<const float*>(opart);
  const float* l = static_cast<const float*>(lse);
  if (dtype == 0) return launch_combine<float>(o, l, out, n, R, D, st);
  if (dtype == 1) return launch_combine<__nv_bfloat16>(o, l, out, n, R, D, st);
  return cudaErrorInvalidValue;
}
