// Blocked packed multi-head attention backward for Hopper (sm_90a), L >= 512.
//
// Replaces the Pallas kernel maskdit_tpu/ops/flash_big.py::_big_bwd (body
// _bwd_kernel). From the packed qkv (N, L, 3D) and the output's gradient
// dout (N, L, D), both read in place, it writes dqkv (N, L, 3D): dq at
// features [h*hd, ...), dk at [D + h*hd, ...), dv at [2D + h*hd, ...).
// Nothing but qkv is saved by the forward: softmax, o and delta are
// recomputed, with the rounding points of _bwd_kernel (flash_big.py:
// 139-179): fp32 logits and softmax; pb = p rounded to the input type for o
// and dv; delta = sum(do * o) in fp32 from the unrounded o; ds = p * (dp -
// delta) * scale rounded to the input type before the dq and dk products;
// fp32 accumulation, dk and dv over all queries, each rounded once.
//
// What bounds it: six L x L x hd products per head (s, o, dv, dp, dq, dk),
// 12 N H L^2 hd operations against ~(10 L hd) bytes per head: bound by
// arithmetic.
//
// Both types run two launches, a query kernel and a key kernel over blocks
// of 64 rows, deterministic (the TPU kernel's sequential sum over query
// chunks becomes the key kernel's loop, not atomics), with Q, K, V and dO
// streamed in 64-row tiles by cp.async and shared memory that does not grow
// with L; the query kernel writes each row's max, sum and delta to an fp32
// (3, N, H, L) scratch that the wrapper allocates, the key kernel rebuilds
// p and ds from it bit for bit.
//
// bf16 (the bf16 training) runs attention_bwd_mma.cuh's tensor-core
// kernels, shared with packed_attention_bwd.cu: every product a bf16
// mma.sync with fp32 accumulators; shared memory 86,016 B at hd 72.
//
// fp32 (the released finetunes, configs/finetune/*.yaml: train.fp32, TF32
// off; held to 1e-5 of max|ref|) runs attention_fp32_mma.cuh's tensor-core
// kernels: fp32 tiles in shared memory, every product as six bf16 mma.sync
// products of exact bf16 pieces of its fp32 operands; the query kernel takes
// m, l and o in one online-softmax pass, then dq; shared memory 114,688 B
// at hd 72 (two blocks per SM), 94,208 B at hd 32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "attention_bwd_mma.cuh"
#include "attention_fp32_mma.cuh"

extern "C" {

// Bytes of dynamic shared memory the larger of the two kernels needs per
// block: the bf16 (esize 2) or fp32 (esize 4) tensor-core kernels', the
// same at every l.
size_t packed_attention_big_bwd_smem_bytes(int l, int hd, int esize) {
  (void)l;
  if (esize == 2) return attention_bwd_mma::smem_bytes(hd);
  return attention_fp32_mma::bwd_smem_bytes(hd);
}

// dtype: 0 = bfloat16, 1 = float32. qkv (n, l, 3*heads*hd), dout
// (n, l, heads*hd) and dqkv (n, l, 3*heads*hd) are contiguous in dtype, qkv
// and dout 16-byte aligned; stats is fp32 scratch of 3*n*heads*l; all on the
// current device; hd a multiple of 8, at most 128. Launches both passes on
// the stream and returns the cudaError_t (0 on success).
int packed_attention_big_bwd(const void* qkv, const void* dout, void* dqkv, void* stats,
                             int n, int l, int heads, int hd, float scale, int dtype,
                             void* stream) {
  if (n <= 0 || l <= 0 || heads <= 0 || hd <= 0 || hd > attention_fwd_mma::kMaxHd ||
      hd % 8 != 0 || n > 65535 || heads > 65535 || reinterpret_cast<uintptr_t>(qkv) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(dout) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* st = static_cast<float*>(stats);
  switch (dtype) {
    case 0: {
      using attention_bwd_mma::bf16;
      const attention_bwd_mma::PackedQkv problem{static_cast<const bf16*>(qkv),
                                                 static_cast<const bf16*>(dout),
                                                 static_cast<bf16*>(dqkv), st, n, heads};
      return static_cast<int>(attention_bwd_mma::launch(problem, l, hd, scale, s));
    }
    case 1: {
      const attention_fp32_mma::PackedQkvBwd problem{static_cast<const float*>(qkv),
                                                   static_cast<const float*>(dout),
                                                   static_cast<float*>(dqkv), st, n, heads};
      return static_cast<int>(attention_fp32_mma::launch_bwd(problem, l, hd, scale, s));
    }
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* packed_attention_big_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
