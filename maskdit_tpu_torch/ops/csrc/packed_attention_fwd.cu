// Packed multi-head attention forward for Hopper (sm_90a).
//
// Replaces the Pallas kernel maskdit_tpu/ops/flash_batched.py::_packed_fwd
// (body _fwd_kernel). It reads the packed qkv Dense output (N, L, 3D) in
// place and writes (N, L, D): head h reads q at features [h*hd, (h+1)*hd),
// k at [D + h*hd, ...) and v at [2D + h*hd, ...) of each row. Logits and
// softmax are fp32, the probabilities are rounded to the input type before
// the product with v (as flash_batched.py:89 and attention.py:49 do), the
// product accumulates in fp32 and the output is stored in the input type.
//
// What bounds it: at the sampling shapes (L=256, hd 72 or 32) one head's
// K and V are 18-74 KB, so the kernel is bound by arithmetic, not by device
// memory. This first version does that arithmetic with fp32 FMAs (hd=72 is
// not a multiple of the 16-wide bf16 MMA k-step, and the fp32 path needs
// FMAs anyway), so its ceiling is the card's fp32 rate, not its tensor
// cores; the loads from shared memory that feed each FMA are the next limit.
//
// The simple design:
//   * grid (ceil(L/32), H, N): one block per 32 queries of one head of one
//     sample, so even a CFG batch of 2x8 gives 2048 blocks for 132 SMs;
//   * the block copies the head's K (transposed to [hd][L]) and V ([L][hd])
//     once into dynamic shared memory, with 16-byte loads where the strides
//     allow; the TPU kernel's in-kernel tile transpose is not carried over;
//   * the (32, L) fp32 logits never leave shared memory: each warp computes
//     4 queries x 8 key columns per pass, the softmax runs over columns in
//     fp32, and each warp then accumulates its 4 queries' outputs.
// wgmma, TMA and pipelining are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBQ = 32;                  // queries per block
constexpr int kQPerWarp = kBQ / kWarps;  // 4: one float4 of probabilities
constexpr int kKeyCols = 8;              // 32-key columns per logits pass
constexpr int kMaxHdCols = 4;            // hd <= 128
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__host__ __device__ __forceinline__ size_t align16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

struct SmemLayout {
  size_t q, k, v, s, red, total;
};

// Shared memory of one block, in bytes, for keys padded to lp (a multiple
// of 32) and elements of esize bytes.
__host__ __device__ __forceinline__ SmemLayout smem_layout(int lp, int hd, int esize) {
  SmemLayout m;
  m.q = 0;                                                    // fp32 [hd][kBQ]
  m.k = align16(m.q + static_cast<size_t>(hd) * kBQ * 4);     // T [hd][lp]
  m.v = align16(m.k + static_cast<size_t>(hd) * lp * esize);  // T [lp][hd]
  m.s = align16(m.v + static_cast<size_t>(lp) * hd * esize);  // fp32 [lp][kBQ]
  m.red = align16(m.s + static_cast<size_t>(lp) * kBQ * 4);   // fp32 2x[kWarps][kBQ]
  m.total = m.red + 2 * kWarps * kBQ * 4;
  return m;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
packed_attention_fwd_kernel(const T* __restrict__ qkv, T* __restrict__ out,
                            int L, int H, int hd, float scale, int vec_ok) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lp = (L + 31) & ~31;
  const SmemLayout lay = smem_layout(lp, hd, sizeof(T));
  float* qs = reinterpret_cast<float*>(smem + lay.q);
  T* ks = reinterpret_cast<T*>(smem + lay.k);
  T* vs = reinterpret_cast<T*>(smem + lay.v);
  float* ss = reinterpret_cast<float*>(smem + lay.s);
  float* red_max = reinterpret_cast<float*>(smem + lay.red);
  float* red_sum = red_max + kWarps * kBQ;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int n = blockIdx.z;
  const int D = H * hd;
  const size_t row = 3 * static_cast<size_t>(D);
  const T* head = qkv + static_cast<size_t>(n) * L * row + static_cast<size_t>(h) * hd;

  // ---- 1. the head's K, V and this block's Q into shared memory ---------
  // Rows past L are zero: padded keys are masked below, and padded V rows
  // must not carry NaNs into 0 * v.
  if (vec_ok) {
    constexpr int kVec = 16 / sizeof(T);
    const int nv = hd / kVec;
    for (int idx = tid; idx < lp * nv; idx += kThreads) {
      const int j = idx / nv;
      const int d0 = (idx - j * nv) * kVec;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (j < L) {
        const T* src = head + j * row + d0;
        kv = *reinterpret_cast<const uint4*>(src + D);
        vv = *reinterpret_cast<const uint4*>(src + 2 * D);
      }
      const T* ke = reinterpret_cast<const T*>(&kv);
#pragma unroll
      for (int e = 0; e < kVec; ++e) ks[(d0 + e) * lp + j] = ke[e];
      *reinterpret_cast<uint4*>(vs + static_cast<size_t>(j) * hd + d0) = vv;
    }
    for (int idx = tid; idx < kBQ * nv; idx += kThreads) {
      const int i = idx / nv;
      const int d0 = (idx - i * nv) * kVec;
      uint4 qv = make_uint4(0, 0, 0, 0);
      if (q0 + i < L) qv = *reinterpret_cast<const uint4*>(head + (q0 + i) * row + d0);
      const T* qe = reinterpret_cast<const T*>(&qv);
#pragma unroll
      for (int e = 0; e < kVec; ++e) qs[(d0 + e) * kBQ + i] = to_f(qe[e]);
    }
  } else {
    for (int idx = tid; idx < lp * hd; idx += kThreads) {
      const int j = idx / hd;
      const int d = idx - j * hd;
      const T zero = from_f<T>(0.f);
      const T* src = head + j * row + d;
      ks[d * lp + j] = j < L ? src[D] : zero;
      vs[idx] = j < L ? src[2 * D] : zero;
    }
    for (int idx = tid; idx < kBQ * hd; idx += kThreads) {
      const int i = idx / hd;
      const int d = idx - i * hd;
      qs[d * kBQ + i] = q0 + i < L ? to_f(head[(q0 + i) * row + d]) : 0.f;
    }
  }
  __syncthreads();

  // ---- 2. logits: warp w takes queries 4w..4w+3, lane takes keys lane+32c
  const int qi = warp * kQPerWarp;
  const int ncol = lp / 32;
  for (int cb = 0; cb < ncol; cb += kKeyCols) {
    float acc[kQPerWarp][kKeyCols];
#pragma unroll
    for (int r = 0; r < kQPerWarp; ++r)
#pragma unroll
      for (int c = 0; c < kKeyCols; ++c) acc[r][c] = 0.f;
    for (int d = 0; d < hd; ++d) {
      const float4 q = *reinterpret_cast<const float4*>(qs + d * kBQ + qi);
      const T* krow = ks + d * lp + 32 * cb + lane;
#pragma unroll
      for (int c = 0; c < kKeyCols; ++c) {
        if (cb + c < ncol) {
          const float k = to_f(krow[32 * c]);
          acc[0][c] = fmaf(q.x, k, acc[0][c]);
          acc[1][c] = fmaf(q.y, k, acc[1][c]);
          acc[2][c] = fmaf(q.z, k, acc[2][c]);
          acc[3][c] = fmaf(q.w, k, acc[3][c]);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kKeyCols; ++c) {
      if (cb + c < ncol) {
        const int j = 32 * (cb + c) + lane;
        const bool valid = j < L;
        float4 s;
        s.x = valid ? acc[0][c] * scale : -INFINITY;
        s.y = valid ? acc[1][c] * scale : -INFINITY;
        s.z = valid ? acc[2][c] * scale : -INFINITY;
        s.w = valid ? acc[3][c] * scale : -INFINITY;
        *reinterpret_cast<float4*>(ss + j * kBQ + qi) = s;
      }
    }
  }
  __syncthreads();

  // ---- 3. fp32 softmax over keys: lane = query, warp = a strided key part
  {
    const int i = lane;
    float m = -INFINITY;
    for (int j = warp; j < lp; j += kWarps) m = fmaxf(m, ss[j * kBQ + i]);
    red_max[warp * kBQ + i] = m;
    __syncthreads();
    m = red_max[i];
    for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red_max[w * kBQ + i]);
    float l = 0.f;
    for (int j = warp; j < lp; j += kWarps) {
      const float e = expf(ss[j * kBQ + i] - m);
      ss[j * kBQ + i] = e;
      l += e;
    }
    red_sum[warp * kBQ + i] = l;
    __syncthreads();
    l = 0.f;
    for (int w = 0; w < kWarps; ++w) l += red_sum[w * kBQ + i];
    // probabilities rounded to the input type, as the reference does
    for (int j = warp; j < lp; j += kWarps)
      ss[j * kBQ + i] = to_f(from_f<T>(ss[j * kBQ + i] / l));
  }
  __syncthreads();

  // ---- 4. o = p @ v: warp w keeps its 4 queries, lane takes d = lane+32c
  float acc[kQPerWarp][kMaxHdCols];
#pragma unroll
  for (int r = 0; r < kQPerWarp; ++r)
#pragma unroll
    for (int c = 0; c < kMaxHdCols; ++c) acc[r][c] = 0.f;
  for (int j = 0; j < L; ++j) {
    const float4 p = *reinterpret_cast<const float4*>(ss + j * kBQ + qi);
    const T* vrow = vs + j * hd + lane;
#pragma unroll
    for (int c = 0; c < kMaxHdCols; ++c) {
      if (lane + 32 * c < hd) {
        const float v = to_f(vrow[32 * c]);
        acc[0][c] = fmaf(p.x, v, acc[0][c]);
        acc[1][c] = fmaf(p.y, v, acc[1][c]);
        acc[2][c] = fmaf(p.z, v, acc[2][c]);
        acc[3][c] = fmaf(p.w, v, acc[3][c]);
      }
    }
  }
  T* obase = out + static_cast<size_t>(n) * L * D + static_cast<size_t>(h) * hd;
#pragma unroll
  for (int r = 0; r < kQPerWarp; ++r) {
    const int i = q0 + qi + r;
    if (i >= L) continue;
#pragma unroll
    for (int c = 0; c < kMaxHdCols; ++c) {
      const int d = lane + 32 * c;
      if (d < hd) obase[static_cast<size_t>(i) * D + d] = from_f<T>(acc[r][c]);
    }
  }
}

template <typename T>
cudaError_t launch(const void* qkv, void* out, int n, int l, int heads, int hd,
                   float scale, cudaStream_t stream) {
  const int lp = (l + 31) & ~31;
  const size_t smem = smem_layout(lp, hd, sizeof(T)).total;
  // raise the kernel's dynamic shared-memory limit (48 KB by default) on
  // this device to the largest size asked for so far
  static size_t configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem > configured[dev]) {
    err = cudaFuncSetAttribute(packed_attention_fwd_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    configured[dev] = smem;
  }
  const int vec_ok = (reinterpret_cast<uintptr_t>(qkv) % 16 == 0) &&
                     (static_cast<size_t>(hd) * sizeof(T) % 16 == 0);
  const dim3 grid((l + kBQ - 1) / kBQ, heads, n);
  packed_attention_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), l, heads, hd, scale, vec_ok);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs; the caller checks it
// against the device's limit before a launch.
size_t packed_attention_fwd_smem_bytes(int l, int hd, int esize) {
  return smem_layout((l + 31) & ~31, hd, esize).total;
}

// dtype: 0 = bfloat16, 1 = float32. qkv is (n, l, 3*heads*hd) contiguous and
// out (n, l, heads*hd) contiguous, both on the current device. Returns the
// cudaError_t of the launch (0 on success).
int packed_attention_fwd(const void* qkv, void* out, int n, int l, int heads,
                         int hd, float scale, int dtype, void* stream) {
  if (n <= 0 || l <= 0 || heads <= 0 || hd <= 0 || hd > 32 * kMaxHdCols ||
      n > 65535 || heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(launch<__nv_bfloat16>(qkv, out, n, l, heads, hd, scale, s));
    case 1:
      return static_cast<int>(launch<float>(qkv, out, n, l, heads, hd, scale, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* packed_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
