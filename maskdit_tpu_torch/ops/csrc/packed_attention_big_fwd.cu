// Blocked packed multi-head attention forward for Hopper (sm_90a), L >= 512.
//
// Replaces the Pallas kernel maskdit_tpu/ops/flash_big.py::_big_fwd (body
// _fwd_kernel). It reads the packed qkv Dense output (N, L, 3D) in place and
// writes (N, L, D): head h reads q at features [h*hd, (h+1)*hd), k at
// [D + h*hd, ...) and v at [2D + h*hd, ...) of each row. As in _fwd_kernel,
// p / denom is rounded once, from each row's final max and sum: fp32 logits
// and softmax, p / denom rounded to the input type before the product with v
// (flash_big.py:112-115), the product accumulated in fp32, the output stored
// in the input type.
//
// What bounds it: at the 512-px shapes (L 1024 or 512, hd 72 or 32) the
// two L x L x hd products are 4 N H L^2 hd operations against ~(4 L hd)
// bytes per head, far above the card's balance, so the kernel is bound by
// arithmetic.
//
// bf16 (sampling and the bf16 training) runs attention_fwd_mma.cuh's
// tensor-core kernel with the PackedQkv layout: blocks of 64 queries of one
// head, K and V read in place and streamed by cp.async, mma.sync products,
// two passes over the keys (m and l, then p / denom rounded once and P.V).
// It takes three products instead of two, so it can reach at most 2/3 of the
// bound, and two expf per logit (2 N H L^2; at (32, 1024, 16, 32) ~0.29 ms
// of the MUFU units), which with the division bound it at hd 32. Shared
// memory 45,056 B at hd 72, 20,480 B at hd 32, at every L.
//
// fp32 (the released finetunes, configs/finetune/*.yaml: train.fp32, TF32
// off; held to 1e-5 of max|ref|) runs attention_fp32_mma.cuh's tensor-core
// forward: the same blocks and streamed tiles, fp32 tiles in shared memory,
// every product as six bf16 mma.sync products of exact bf16 pieces of its
// fp32 operands, one online-softmax pass over the keys (nothing is rounded
// to an input type, so p / denom need not be formed before P.V). Shared
// memory 96,256 B at hd 72, 47,104 B at hd 32, at every L.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "attention_fp32_mma.cuh"
#include "attention_fwd_mma.cuh"

extern "C" {

// Bytes of dynamic shared memory one block needs: the bf16 (esize 2) or
// fp32 (esize 4) tensor-core kernel's, the same at every l.
size_t packed_attention_big_fwd_smem_bytes(int l, int hd, int esize) {
  (void)l;
  if (esize == 2) return attention_fwd_mma::smem_bytes(hd);
  return attention_fp32_mma::fwd_smem_bytes(hd);
}

// dtype: 0 = bfloat16, 1 = float32. qkv is (n, l, 3*heads*hd) contiguous and
// 16-byte aligned, out (n, l, heads*hd) contiguous, both on the current
// device; hd a multiple of 8, at most 128. Returns the cudaError_t of the
// launch (0 on success).
int packed_attention_big_fwd(const void* qkv, void* out, int n, int l, int heads, int hd,
                             float scale, int dtype, void* stream) {
  if (n <= 0 || l <= 0 || heads <= 0 || hd <= 0 || hd > attention_fwd_mma::kMaxHd ||
      hd % 8 != 0 || n > 65535 || heads > 65535 || reinterpret_cast<uintptr_t>(qkv) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: {
      using attention_fwd_mma::bf16;
      const attention_fwd_mma::PackedQkv layout{static_cast<const bf16*>(qkv),
                                                static_cast<bf16*>(out), n, heads};
      return static_cast<int>(attention_fwd_mma::launch(layout, l, hd, scale, s));
    }
    case 1: {
      const attention_fp32_mma::PackedQkv problem{static_cast<const float*>(qkv),
                                                   static_cast<float*>(out), n, heads};
      return static_cast<int>(attention_fp32_mma::launch_fwd(problem, l, hd, scale, s));
    }
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* packed_attention_big_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
