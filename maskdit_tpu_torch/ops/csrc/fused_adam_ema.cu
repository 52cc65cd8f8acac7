// Fused Adam + EMA update for Hopper (sm_90a), in place.
//
// Replaces the Pallas kernel maskdit_tpu/ops/fused_adam.py::_leaf_update_pallas
// (body _adam_ema_kernel). For every element, in one read-modify-write sweep:
//
//   m <- b1*m + (1-b1)*g
//   v <- b2*v + (1-b2)*g*g
//   p <- p - lr*(m/bc1) / (sqrt(v/bc2) + eps)      (bc = 1 - b^t, t = count+1)
//   e <- d*e + (1-d)*p                             (EMA of the new params)
//
// g, p, v and e are fp32; m is fp32 or bf16 (stored rounded to nearest, the
// math stays fp32, as the Pallas kernel's narrow mu). The scalars arrive by
// value, computed on the host from the step count, so a step needs no
// device round trip.
//
// What bounds it: 5 reads and 4 writes of 4 bytes per element and ~20 flops:
// 36 bytes per parameter, ~26 GB for DiT-XL/2's ~730M parameters, a floor
// of ~8 ms at 3.35 TB/s. It is a pure streaming pass, so the design is about
// bytes in flight: the port keeps each of g, p, m, v and e as ONE flat
// buffer with the model's parameters as views into it, so a step is a
// single launch over all leaves (the TPU kernel runs one pallas_call per
// leaf and sends ragged leaves to jnp); a grid-stride loop moves 16 bytes
// per thread and array where the pointers allow, and masks the ragged tail
// with a scalar loop. Any length works, so no leaf falls back.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Scalars {
  float lr, bc1, bc2, decay, one_minus_decay;
  float b1, one_minus_b1, b2, one_minus_b2, eps;
};

__device__ __forceinline__ float load_m(const float* m, size_t i) { return m[i]; }
__device__ __forceinline__ float load_m(const __nv_bfloat16* m, size_t i) {
  return __bfloat162float(m[i]);
}
__device__ __forceinline__ void store_m(float* m, size_t i, float x) { m[i] = x; }
__device__ __forceinline__ void store_m(__nv_bfloat16* m, size_t i, float x) {
  m[i] = __float2bfloat16_rn(x);
}

// One element, in the operation order of _adam_ema_kernel.
__device__ __forceinline__ void update(const Scalars& s, float g, float& p, float& m,
                                       float& v, float& e) {
  m = s.b1 * m + s.one_minus_b1 * g;
  v = s.b2 * v + s.one_minus_b2 * g * g;
  const float denom = sqrtf(v / s.bc2) + s.eps;
  p = p - s.lr * (m / s.bc1) / denom;
  e = s.decay * e + s.one_minus_decay * p;
}

template <typename M>
__global__ void __launch_bounds__(kThreads)
fused_adam_ema_vec4(const float4* __restrict__ g, float4* __restrict__ p, M* __restrict__ m,
                    float4* __restrict__ v, float4* __restrict__ e, size_t n4, Scalars s) {
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n4;
       i += stride) {
    const float4 gi = g[i];
    float4 pi = p[i], vi = v[i], ei = e[i];
    float mi[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) mi[k] = load_m(m, 4 * i + k);
    update(s, gi.x, pi.x, mi[0], vi.x, ei.x);
    update(s, gi.y, pi.y, mi[1], vi.y, ei.y);
    update(s, gi.z, pi.z, mi[2], vi.z, ei.z);
    update(s, gi.w, pi.w, mi[3], vi.w, ei.w);
    p[i] = pi;
    v[i] = vi;
    e[i] = ei;
#pragma unroll
    for (int k = 0; k < 4; ++k) store_m(m, 4 * i + k, mi[k]);
  }
}

template <typename M>
__global__ void __launch_bounds__(kThreads)
fused_adam_ema_scalar(const float* __restrict__ g, float* __restrict__ p, M* __restrict__ m,
                      float* __restrict__ v, float* __restrict__ e, size_t begin, size_t n,
                      Scalars s) {
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t i = begin + static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float pi = p[i], mi = load_m(m, i), vi = v[i], ei = e[i];
    update(s, g[i], pi, mi, vi, ei);
    p[i] = pi;
    store_m(m, i, mi);
    v[i] = vi;
    e[i] = ei;
  }
}

unsigned grid_for(size_t work) {
  // enough blocks to fill 132 SMs several times over; the loop strides
  const size_t blocks = (work + kThreads - 1) / kThreads;
  const size_t cap = 132 * 16;
  return static_cast<unsigned>(blocks < cap ? (blocks > 0 ? blocks : 1) : cap);
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

template <typename M>
cudaError_t launch(const float* g, float* p, M* m, float* v, float* e, size_t n,
                   const Scalars& s, cudaStream_t stream) {
  size_t done = 0;
  if (aligned16(g) && aligned16(p) && aligned16(v) && aligned16(e) &&
      reinterpret_cast<uintptr_t>(m) % (4 * sizeof(M)) == 0) {
    const size_t n4 = n / 4;
    if (n4 > 0) {
      fused_adam_ema_vec4<M><<<grid_for(n4), kThreads, 0, stream>>>(
          reinterpret_cast<const float4*>(g), reinterpret_cast<float4*>(p), m,
          reinterpret_cast<float4*>(v), reinterpret_cast<float4*>(e), n4, s);
      cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
    done = 4 * n4;
  }
  if (done < n) {
    fused_adam_ema_scalar<M><<<grid_for(n - done), kThreads, 0, stream>>>(
        g, p, m, v, e, done, n, s);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// g, p, v, e: fp32, m: fp32 (m_dtype 1) or bf16 (m_dtype 0); n contiguous
// elements each, on the current device; p, m, v and e are updated in place.
// Returns the cudaError_t of the launch (0 on success).
int fused_adam_ema(const void* g, void* p, void* m, void* v, void* e, long long n,
                   int m_dtype, float lr, float bc1, float bc2, float decay,
                   float one_minus_decay, float b1, float one_minus_b1, float b2,
                   float one_minus_b2, float eps, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  const Scalars s{lr, bc1, bc2, decay, one_minus_decay, b1, one_minus_b1, b2, one_minus_b2, eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t count = static_cast<size_t>(n);
  switch (m_dtype) {
    case 0:
      return static_cast<int>(launch(static_cast<const float*>(g), static_cast<float*>(p),
                                     static_cast<__nv_bfloat16*>(m), static_cast<float*>(v),
                                     static_cast<float*>(e), count, s, st));
    case 1:
      return static_cast<int>(launch(static_cast<const float*>(g), static_cast<float*>(p),
                                     static_cast<float*>(m), static_cast<float*>(v),
                                     static_cast<float*>(e), count, s, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* fused_adam_ema_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
