// Fused Adam + EMA update for Hopper (sm_90a), in place.
//
// Replaces the Pallas kernel maskdit_tpu/ops/fused_adam.py::_leaf_update_pallas
// (body _adam_ema_kernel) and the jnp leaf update that JAX sends narrow-nu
// leaves to (_leaf_update_jnp). For every element, in one read-modify-write
// sweep:
//
//   m <- b1*m + (1-b1)*g
//   v <- b2*v + (1-b2)*g*g
//   p <- p - lr*(m/bc1) / (sqrt(v/bc2) + eps)      (bc = 1 - b^t, t = count+1)
//   e <- d*e + (1-d)*p                             (EMA of the new params)
//
// Storage types: p and e are fp32; g, m and v are each fp32 or bf16. The
// math is fp32: a bf16 g is upcast at the boundary (fused_adam.py:101), a
// bf16 m is stored rounded to nearest, and a bf16 v is stored with
// STOCHASTIC rounding (stochastic_round_bf16, fused_adam.py:44-69): 16
// random bits are added to the low half of the fp32 pattern, which is then
// truncated. Round-to-nearest would freeze v, whose per-step increment
// (1 - b2) is below bf16's resolution. The random bits are Philox4x32-10
// (Salmon et al., SC'11) with the key (0x6E75, count) (count = the
// pre-increment Adam step, as the JAX key folds it in) and the counter
// (i / 4, 0, 0) of the element's index i in the flat buffer; element i
// takes word i % 4 and uses its low 16 bits. So a resumed run rounds as a
// straight run does. On a shard of the mesh (parallel/sharded.py) i is the
// element's index in the UNSHARDED flat buffer, given by a table of
// segments: entry (local start, global start, rows, cols, row stride) maps
// local element local_start + r * cols + c to global_start + r * stride + c;
// the entries are sorted by local start and cover the buffer (an empty
// table: global = local). So a sharded run rounds as the unsharded one. The EMA-off mode (a step of ema_every > 1 without the
// EMA) neither reads nor writes e: JAX multiplies e by 1 and adds 0 * p
// there, the same value whenever p is finite.
//
// Rounding: the two first variants (fp32 g and v, EMA on; m fp32 or bf16)
// keep their original arithmetic (nvcc contracts a product and a sum into
// one FMA, within an ulp of the plain version). Every other variant computes
// with the round-to-nearest intrinsics, which are never contracted, in the
// plain version's operation order, so it equals
// ops/fused_adam.py::fused_adam_ema_reference bit for bit, v's stochastic
// rounding included.
//
// What bounds it: bytes. Per element it reads g, p, m, v, e and writes p,
// m, v, e: 36 bytes in fp32, 26 with g, m and v in bf16, 8 fewer with the
// EMA off; ~20 flops (+ ~40 integer ops for a Philox call per 4 elements).
// The port keeps each of g, p, m, v and e as ONE flat buffer with the
// model's parameters as views into it, so a step is a single launch over
// all leaves; a grid-stride loop moves 4 elements per thread and array with
// one 16-byte (fp32) or 8-byte (bf16) access where the pointers allow, and
// masks the ragged tail with a scalar loop. Any length works.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kSrKey = 0x6E75;

struct Scalars {
  float lr, bc1, bc2, decay, one_minus_decay;
  float b1, one_minus_b1, b2, one_minus_b2, eps;
};

// ---- Philox4x32-10 ---------------------------------------------------------

__device__ __forceinline__ uint4 philox_round(uint4 c, uint32_t k0, uint32_t k1) {
  const uint32_t lo0 = 0xD2511F53u * c.x, hi0 = __umulhi(0xD2511F53u, c.x);
  const uint32_t lo1 = 0xCD9E8D57u * c.z, hi1 = __umulhi(0xCD9E8D57u, c.z);
  return make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
}

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
  c = philox_round(c, k0, k1);
#pragma unroll
  for (int r = 1; r < 10; ++r) {
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
    c = philox_round(c, k0, k1);
  }
  return c;
}

// The 4 words of Philox for elements 4q .. 4q+3.
__device__ __forceinline__ uint4 sr_bits(size_t q, uint32_t count) {
  const uint64_t q64 = static_cast<uint64_t>(q);
  return philox4x32_10(make_uint4(static_cast<uint32_t>(q64), static_cast<uint32_t>(q64 >> 32),
                                  0u, 0u),
                       kSrKey, count);
}

__device__ __forceinline__ uint32_t word(const uint4& w, int k) {
  return k == 0 ? w.x : k == 1 ? w.y : k == 2 ? w.z : w.w;
}

// The unsharded index of local element i (binary search of the segments).
__device__ __forceinline__ size_t global_index(const long long* __restrict__ seg, int n_seg,
                                               size_t i) {
  int lo = 0, hi = n_seg - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (static_cast<size_t>(seg[5 * mid]) <= i) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  const long long* e = seg + 5 * lo;
  const size_t k = i - static_cast<size_t>(e[0]);
  const size_t cols = static_cast<size_t>(e[3]);
  return static_cast<size_t>(e[1]) + (k / cols) * static_cast<size_t>(e[4]) + k % cols;
}

// The random word of local element i.
__device__ __forceinline__ uint32_t element_bits(const long long* __restrict__ seg, int n_seg,
                                                 size_t i, uint32_t count) {
  const size_t gi = n_seg > 0 ? global_index(seg, n_seg, i) : i;
  return word(sr_bits(gi / 4, count), static_cast<int>(gi % 4));
}

// The words of local elements 4j .. 4j+3: one Philox call where they are
// four aligned consecutive unsharded elements (always without segments).
__device__ __forceinline__ uint4 group_bits(const long long* __restrict__ seg, int n_seg,
                                            size_t j, uint32_t count) {
  if (n_seg == 0) return sr_bits(j, count);
  const size_t g0 = global_index(seg, n_seg, 4 * j);
  if (g0 % 4 == 0 && global_index(seg, n_seg, 4 * j + 3) == g0 + 3) {
    return sr_bits(g0 / 4, count);
  }
  return make_uint4(element_bits(seg, n_seg, 4 * j, count),
                    element_bits(seg, n_seg, 4 * j + 1, count),
                    element_bits(seg, n_seg, 4 * j + 2, count),
                    element_bits(seg, n_seg, 4 * j + 3, count));
}

// stochastic_round_bf16: (bits(x) + (r & 0xFFFF)) & 0xFFFF0000, upper half
__device__ __forceinline__ unsigned short sr_bf16_bits(float x, uint32_t r) {
  const uint32_t u = __float_as_uint(x) + (r & 0xFFFFu);
  return static_cast<unsigned short>(u >> 16);
}

// ---- loads and stores of 1 or 4 elements as fp32 ----------------------------

__device__ __forceinline__ float load1(const float* a, size_t i) { return a[i]; }
__device__ __forceinline__ float load1(const __nv_bfloat16* a, size_t i) {
  return __bfloat162float(a[i]);
}
__device__ __forceinline__ void store1(float* a, size_t i, float x) { a[i] = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* a, size_t i, float x) {
  a[i] = __float2bfloat16_rn(x);
}

// elements 4j .. 4j+3
__device__ __forceinline__ void load4(const float* a, size_t j, float x[4]) {
  const float4 t = reinterpret_cast<const float4*>(a)[j];
  x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* a, size_t j, float x[4]) {
  const uint2 t = reinterpret_cast<const uint2*>(a)[j];
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&t.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&t.y);
  x[0] = __low2float(lo); x[1] = __high2float(lo);
  x[2] = __low2float(hi); x[3] = __high2float(hi);
}
__device__ __forceinline__ void store4(float* a, size_t j, const float x[4]) {
  reinterpret_cast<float4*>(a)[j] = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* a, size_t j, const float x[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(x[0], x[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x[2], x[3]);
  uint2 t;
  t.x = *reinterpret_cast<const uint32_t*>(&lo);
  t.y = *reinterpret_cast<const uint32_t*>(&hi);
  reinterpret_cast<uint2*>(a)[j] = t;
}

// v's store: fp32 as is; bf16 stochastically rounded with the element's bits
__device__ __forceinline__ void store_v1(float* a, size_t i, float x, uint32_t) { a[i] = x; }
__device__ __forceinline__ void store_v1(__nv_bfloat16* a, size_t i, float x, uint32_t r) {
  reinterpret_cast<unsigned short*>(a)[i] = sr_bf16_bits(x, r);
}
__device__ __forceinline__ void store_v4(float* a, size_t j, const float x[4], const uint4&) {
  store4(a, j, x);
}
__device__ __forceinline__ void store_v4(__nv_bfloat16* a, size_t j, const float x[4],
                                         const uint4& r) {
  uint2 t;
  t.x = sr_bf16_bits(x[0], r.x) | (static_cast<uint32_t>(sr_bf16_bits(x[1], r.y)) << 16);
  t.y = sr_bf16_bits(x[2], r.z) | (static_cast<uint32_t>(sr_bf16_bits(x[3], r.w)) << 16);
  reinterpret_cast<uint2*>(a)[j] = t;
}

// ---- one element -------------------------------------------------------------

// The first variants' arithmetic, in the operation order of
// _adam_ema_kernel (nvcc may contract into FMAs).
__device__ __forceinline__ void update_contracted(const Scalars& s, float g, float& p, float& m,
                                                  float& v, float& e, bool with_ema) {
  m = s.b1 * m + s.one_minus_b1 * g;
  v = s.b2 * v + s.one_minus_b2 * g * g;
  const float denom = sqrtf(v / s.bc2) + s.eps;
  p = p - s.lr * (m / s.bc1) / denom;
  if (with_ema) e = s.decay * e + s.one_minus_decay * p;
}

// The plain version's roundings, one per operation (never contracted).
__device__ __forceinline__ void update_exact(const Scalars& s, float g, float& p, float& m,
                                             float& v, float& e, bool with_ema) {
  m = __fadd_rn(__fmul_rn(s.b1, m), __fmul_rn(s.one_minus_b1, g));
  v = __fadd_rn(__fmul_rn(s.b2, v), __fmul_rn(__fmul_rn(s.one_minus_b2, g), g));
  const float denom = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, s.bc2)), s.eps);
  p = __fsub_rn(p, __fdiv_rn(__fmul_rn(s.lr, __fdiv_rn(m, s.bc1)), denom));
  if (with_ema) e = __fadd_rn(__fmul_rn(s.decay, e), __fmul_rn(s.one_minus_decay, p));
}

template <typename G, typename V, bool kEma>
__device__ __forceinline__ void update(const Scalars& s, float g, float& p, float& m, float& v,
                                       float& e) {
  constexpr bool kContracted = sizeof(G) == 4 && sizeof(V) == 4 && kEma;
  if constexpr (kContracted) {
    update_contracted(s, g, p, m, v, e, true);
  } else {
    update_exact(s, g, p, m, v, e, kEma);
  }
}

// kSeg: a shard's segment table is given (a bf16 v only); without it the
// kernels compile as they did before the table existed
template <typename G, typename M, typename V, bool kEma, bool kSeg>
__global__ void __launch_bounds__(kThreads)
fused_adam_ema_vec4(const G* __restrict__ g, float* __restrict__ p, M* __restrict__ m,
                    V* __restrict__ v, float* __restrict__ e, size_t n4, Scalars s,
                    uint32_t count, const long long* __restrict__ seg, int n_seg) {
  constexpr bool kSr = sizeof(V) == 2;
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t j = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; j < n4;
       j += stride) {
    float gj[4], pj[4], mj[4], vj[4], ej[4] = {0.f, 0.f, 0.f, 0.f};
    load4(g, j, gj);
    load4(p, j, pj);
    load4(m, j, mj);
    load4(v, j, vj);
    if constexpr (kEma) load4(e, j, ej);
#pragma unroll
    for (int k = 0; k < 4; ++k) update<G, V, kEma>(s, gj[k], pj[k], mj[k], vj[k], ej[k]);
    store4(p, j, pj);
    store4(m, j, mj);
    uint4 bits = make_uint4(0u, 0u, 0u, 0u);
    if constexpr (kSr && kSeg) {
      bits = group_bits(seg, n_seg, j, count);
    } else if constexpr (kSr) {
      bits = sr_bits(j, count);
    }
    store_v4(v, j, vj, bits);
    if constexpr (kEma) store4(e, j, ej);
  }
}

template <typename G, typename M, typename V, bool kEma, bool kSeg>
__global__ void __launch_bounds__(kThreads)
fused_adam_ema_scalar(const G* __restrict__ g, float* __restrict__ p, M* __restrict__ m,
                      V* __restrict__ v, float* __restrict__ e, size_t begin, size_t n,
                      Scalars s, uint32_t count, const long long* __restrict__ seg,
                      int n_seg) {
  constexpr bool kSr = sizeof(V) == 2;
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t i = begin + static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float pi = p[i], mi = load1(m, i), vi = load1(v, i), ei = kEma ? e[i] : 0.f;
    update<G, V, kEma>(s, load1(g, i), pi, mi, vi, ei);
    p[i] = pi;
    store1(m, i, mi);
    uint32_t r = 0u;
    if constexpr (kSr && kSeg) {
      r = element_bits(seg, n_seg, i, count);
    } else if constexpr (kSr) {
      r = word(sr_bits(i / 4, count), static_cast<int>(i % 4));
    }
    store_v1(v, i, vi, r);
    if constexpr (kEma) e[i] = ei;
  }
}

unsigned grid_for(size_t work) {
  // enough blocks to fill 132 SMs several times over; the loop strides
  const size_t blocks = (work + kThreads - 1) / kThreads;
  const size_t cap = 132 * 16;
  return static_cast<unsigned>(blocks < cap ? (blocks > 0 ? blocks : 1) : cap);
}

// 4 elements of T in one access: 16 bytes for fp32, 8 for bf16
template <typename T>
bool aligned4(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % (4 * sizeof(T)) == 0;
}

template <typename G, typename M, typename V, bool kEma, bool kSeg>
cudaError_t launch_with(const void* g_, void* p_, void* m_, void* v_, void* e_, size_t n,
                        const Scalars& s, uint32_t count, const long long* seg, int n_seg,
                        cudaStream_t stream) {
  const G* g = static_cast<const G*>(g_);
  float* p = static_cast<float*>(p_);
  M* m = static_cast<M*>(m_);
  V* v = static_cast<V*>(v_);
  float* e = static_cast<float*>(e_);
  size_t done = 0;
  if (aligned4<G>(g) && aligned4<float>(p) && aligned4<M>(m) && aligned4<V>(v) &&
      (!kEma || aligned4<float>(e))) {
    const size_t n4 = n / 4;
    if (n4 > 0) {
      fused_adam_ema_vec4<G, M, V, kEma, kSeg><<<grid_for(n4), kThreads, 0, stream>>>(
          g, p, m, v, e, n4, s, count, seg, n_seg);
      cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
    done = 4 * n4;
  }
  if (done < n) {
    fused_adam_ema_scalar<G, M, V, kEma, kSeg><<<grid_for(n - done), kThreads, 0, stream>>>(
        g, p, m, v, e, done, n, s, count, seg, n_seg);
  }
  return cudaGetLastError();
}

template <typename G, typename M, typename V, bool kEma>
cudaError_t launch(const void* g, void* p, void* m, void* v, void* e, size_t n,
                   const Scalars& s, uint32_t count, const long long* seg, int n_seg,
                   cudaStream_t stream) {
  if constexpr (sizeof(V) == 2) {
    if (n_seg > 0) return launch_with<G, M, V, kEma, true>(g, p, m, v, e, n, s, count, seg,
                                                           n_seg, stream);
  }
  return launch_with<G, M, V, kEma, false>(g, p, m, v, e, n, s, count, seg, n_seg, stream);
}

using Bf16 = __nv_bfloat16;
using Launcher = cudaError_t (*)(const void*, void*, void*, void*, void*, size_t,
                                 const Scalars&, uint32_t, const long long*, int,
                                 cudaStream_t);

template <typename G, typename M, typename V>
Launcher pick_ema(int with_ema) {
  return with_ema ? launch<G, M, V, true> : launch<G, M, V, false>;
}

template <typename G, typename M>
Launcher pick_v(int v_dtype, int with_ema) {
  return v_dtype == 0 ? pick_ema<G, M, Bf16>(with_ema) : pick_ema<G, M, float>(with_ema);
}

template <typename G>
Launcher pick_m(int m_dtype, int v_dtype, int with_ema) {
  return m_dtype == 0 ? pick_v<G, Bf16>(v_dtype, with_ema) : pick_v<G, float>(v_dtype, with_ema);
}

}  // namespace

extern "C" {

// p, e: fp32; g, m, v: fp32 (dtype code 1) or bf16 (0); n contiguous
// elements each, on the current device; p, m, v and e are updated in place
// (e is not touched when with_ema is 0). sr_count keys the stochastic
// rounding of a bf16 v (the pre-increment Adam count); seg (n_seg x 5
// int64 on the device, or n_seg 0) maps each element to its unsharded
// index for those bits. Returns the cudaError_t of the launch (0 on
// success).
int fused_adam_ema(const void* g, void* p, void* m, void* v, void* e, long long n,
                   int g_dtype, int m_dtype, int v_dtype, int with_ema, unsigned int sr_count,
                   float lr, float bc1, float bc2, float decay, float one_minus_decay, float b1,
                   float one_minus_b1, float b2, float one_minus_b2, float eps,
                   const void* seg, int n_seg, void* stream) {
  if (n < 0 || n_seg < 0 || (n_seg > 0 && seg == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto valid = [](int code) { return code == 0 || code == 1; };
  if (!valid(g_dtype) || !valid(m_dtype) || !valid(v_dtype)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaSuccess);
  const Scalars s{lr, bc1, bc2, decay, one_minus_decay, b1, one_minus_b1, b2, one_minus_b2, eps};
  const Launcher run = g_dtype == 0 ? pick_m<Bf16>(m_dtype, v_dtype, with_ema)
                                    : pick_m<float>(m_dtype, v_dtype, with_ema);
  return static_cast<int>(run(g, p, m, v, e, static_cast<size_t>(n), s, sr_count,
                              static_cast<const long long*>(seg), n_seg,
                              static_cast<cudaStream_t>(stream)));
}

const char* fused_adam_ema_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
