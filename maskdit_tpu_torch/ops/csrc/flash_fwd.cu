// Per-(sample, head) attention forward with a saved logsumexp, for Hopper
// (sm_90a).
//
// Replaces the Pallas kernel maskdit_tpu/ops/flash.py::_flash_fwd (body
// _fwd_kernel). From q, k, v, each (N*H, L, hd) contiguous, it writes o
// (N*H, L, hd) in the input type and lse (N*H, 1, L) in fp32. As in
// _fwd_kernel, p / l is rounded once, from each row's final max and sum:
// fp32 logits s = (q . k) * scale; row max m; p = exp(s - m); l = sum p;
// (p / l) rounded to the input type before the fp32-accumulated product with
// v; o stored in the input type; lse = m + log l in fp32.
//
// What bounds it: two L x L x hd products per head, 4 N H L^2 hd operations
// against ~(4 L hd) elements of traffic per head: at the 512-px shapes
// (L 512 at hd 72, L 1024 at hd 32) far above the card's balance, so the
// kernel is bound by arithmetic.
//
// Both types run a tensor-core kernel in its SeparateHeads layout (grid
// (ceil(L / 64), N*H), blocks of 64 queries of one head, K and V streamed
// by cp.async, shared memory that does not grow with L):
//   * bf16 (the main path): attention_fwd_mma.cuh's kernel, shared with the
//     blocked forward #3: mma.sync products, two passes over the keys (m and
//     l, then p / l rounded once and P.V). It takes three products instead
//     of two, so it can reach at most 2/3 of the bound, and two expf per
//     logit (2 N H L^2; at (32, 1024, 16, 32) ~0.29 ms of the MUFU units),
//     which with the division bound it at hd 32. Shared memory 45,056 B at
//     hd 72, 20,480 B at hd 32.
//   * fp32 (model.use_flash with train.fp32: the released finetunes with
//     the flag; held to 1e-5 of max|ref|, no TF32): attention_fp32_mma.cuh's
//     forward, shared with #1 / #3 in fp32: fp32 tiles, each product as six
//     bf16 mma.sync products of exact bf16 pieces, one online-softmax pass
//     (rounding p / l to fp32 is the identity, so o = (sum e . v) / l), lse
//     from the final running max and sum. Shared memory 96,256 B at hd 72,
//     47,104 B at hd 32.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "attention_fp32_mma.cuh"
#include "attention_fwd_mma.cuh"

namespace {

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// Bytes of dynamic shared memory of one block, the same at every l: the
// bf16 (esize 2) or fp32 (esize 4) tensor-core kernel's.
size_t flash_fwd_smem_bytes(int hd, int esize) {
  if (esize == 2) return attention_fwd_mma::smem_bytes(hd);
  return attention_fp32_mma::fwd_smem_bytes(hd);
}

// dtype: 0 = bfloat16, 1 = float32. q, k, v and out are (n, l, hd)
// contiguous and 16-byte aligned, lse (n, l) fp32, all on the current
// device; hd a multiple of 8, at most 128. Returns the cudaError_t of the
// launch (0 on success).
int flash_fwd(const void* q, const void* k, const void* v, void* out, void* lse, int n, int l,
              int hd, float scale, int dtype, void* stream) {
  if (n <= 0 || l <= 0 || hd <= 0 || hd > attention_fwd_mma::kMaxHd || hd % 8 != 0 ||
      n > 65535 || !aligned16(q) || !aligned16(k) || !aligned16(v))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ls = static_cast<float*>(lse);
  switch (dtype) {
    case 0: {
      using attention_fwd_mma::bf16;
      const attention_fwd_mma::SeparateHeads layout{
          static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
          static_cast<bf16*>(out), ls, n};
      return static_cast<int>(attention_fwd_mma::launch(layout, l, hd, scale, s));
    }
    case 1: {
      const attention_fp32_mma::SeparateHeads layout{
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), static_cast<float*>(out), ls, n};
      return static_cast<int>(attention_fp32_mma::launch_fwd(layout, l, hd, scale, s));
    }
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* flash_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
