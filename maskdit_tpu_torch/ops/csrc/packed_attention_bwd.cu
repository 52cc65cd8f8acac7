// Packed multi-head attention backward for Hopper (sm_90a).
//
// Replaces the Pallas kernel maskdit_tpu/ops/flash_batched.py::_packed_bwd
// (body _bwd_kernel). From the packed qkv (N, L, 3D) and the output's
// gradient dout (N, L, D), both read in place, it writes dqkv (N, L, 3D):
// dq at features [h*hd, ...), dk at [D + h*hd, ...), dv at [2D + h*hd, ...).
// Nothing but qkv is saved by the forward: softmax, o and delta are
// recomputed here, with the rounding points of _bwd_kernel: fp32 logits and
// softmax; pb = p rounded to the input type for dv and for o; delta =
// sum(do * o) in fp32; ds = p * (dp - delta) * scale rounded to the input
// type before the dq and dk products; fp32 accumulation; dqkv stored in the
// input type.
//
// What bounds it: at the training shapes (L 128 hd 72, L 256 hd 32) one
// head's operands are 37-74 KB, so, like the forward, the kernel is bound
// by arithmetic: six (L x L x hd) products per head.
//
// bf16 at a head dim that is a multiple of 8 (every model's: the main path)
// runs attention_bwd_mma.cuh's tensor-core kernels, shared with
// packed_attention_big_bwd.cu (kernel #4 computes the same function): every
// product a bf16 mma.sync with fp32 accumulators, K, V, Q and dO streamed in
// 64-row tiles, so shared memory does not grow with L (86,016 B at hd 72).
//
// fp32 at a head dim that is a multiple of 8 (the released finetunes,
// configs/finetune/*.yaml: train.fp32, TF32 off; held to 1e-5 of max|ref|)
// runs attention_fp32_mma.cuh's tensor-core kernels, the ones kernel #4
// runs in fp32 (in fp32 every "round to the input type" is the identity):
// a query kernel (one online-softmax pass for m, l and o, delta, then dq)
// and a key kernel (its 64 keys' K and V kept, Q and dO streamed; dk, dv
// over all queries), fp32 tiles streamed by 16-byte cp.async and split into
// three exact bf16 pieces as each fragment is read, every product as six
// bf16 mma.sync products; no atomics, and shared memory that does not grow
// with L: 114,688 B at hd 72, 94,208 B at hd 32.
//
// bf16 and fp32 at other head dims keep the first design, fp32 FMAs from
// shared memory. The TPU kernel loops over all heads of one sample in one
// sequential grid step. Here blocks run in no order, and dk and dv are sums
// over all queries, so the work is split in two passes that need no
// atomics and give the same bits on every run:
//   * pass 1, grid (L/32 query blocks, H, N): a block recomputes the
//     logits of its 32 queries against all keys, the fp32 softmax, o and
//     delta, writes each row's max, sum and delta to an fp32 (3, N, H, L)
//     scratch that the wrapper allocates, and computes dq (which needs all
//     keys of its rows);
//   * pass 2, grid (L/32 key blocks, H, N): a block recomputes the logits of
//     its 32 keys against all queries, p = exp(s - max) / sum from the saved
//     row statistics, and dp, and sums dk and dv over all queries.
// Both passes form each logit and each dp with the same FMA chain, so pass
// 2's p and ds are bit for bit those of pass 1. Operands are widened to fp32
// in shared memory, rows padded to hd + 1 words so that a warp reads either
// 32 rows at one feature or 32 features of one row without bank conflicts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "attention_bwd_mma.cuh"
#include "attention_fp32_mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kB = 32;                  // queries (pass 1) or keys (pass 2) per block
constexpr int kPerWarp = kB / kWarps;   // 4: one float4 of a row's values
constexpr int kCols = 8;                // 32-wide column chunks per pass over L
constexpr int kMaxHdCols = 4;           // hd <= 128
constexpr int kMaxDevices = 64;
constexpr size_t kMaxSmem = 232448;     // a block's limit on sm_90

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T and widened back
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__host__ __device__ __forceinline__ size_t align16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

// Pass 1: q, do fp32 [hd][kB]; k, v fp32 [lp][hd+1]; s fp32 [lp][kB];
// two fp32 [kWarps][kB] reduction arrays.
struct QueryLayout {
  size_t q, dout, k, v, s, red, total;
};

__host__ __device__ __forceinline__ QueryLayout query_layout(int lp, int hd) {
  const size_t hdp = hd + 1;
  QueryLayout m;
  m.q = 0;
  m.dout = align16(m.q + static_cast<size_t>(hd) * kB * 4);
  m.k = align16(m.dout + static_cast<size_t>(hd) * kB * 4);
  m.v = align16(m.k + lp * hdp * 4);
  m.s = align16(m.v + lp * hdp * 4);
  m.red = align16(m.s + static_cast<size_t>(lp) * kB * 4);
  m.total = m.red + 2 * kWarps * kB * 4;
  return m;
}

// Pass 2: k, v fp32 [hd][kB]; q, do fp32 [lp][hd+1]; pb, ds fp32 [lp][kB];
// row max, sum and delta fp32 [lp] each.
struct KeyLayout {
  size_t k, v, q, dout, pb, ds, stats, total;
};

__host__ __device__ __forceinline__ KeyLayout key_layout(int lp, int hd) {
  const size_t hdp = hd + 1;
  KeyLayout m;
  m.k = 0;
  m.v = align16(m.k + static_cast<size_t>(hd) * kB * 4);
  m.q = align16(m.v + static_cast<size_t>(hd) * kB * 4);
  m.dout = align16(m.q + lp * hdp * 4);
  m.pb = align16(m.dout + lp * hdp * 4);
  m.ds = align16(m.pb + static_cast<size_t>(lp) * kB * 4);
  m.stats = align16(m.ds + static_cast<size_t>(lp) * kB * 4);
  m.total = m.stats + 3 * static_cast<size_t>(lp) * 4;
  return m;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_query_pass(const T* __restrict__ qkv, const T* __restrict__ dout,
               T* __restrict__ dqkv, float* __restrict__ stats,
               int L, int H, int hd, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lp = (L + 31) & ~31;
  const int hdp = hd + 1;
  const QueryLayout lay = query_layout(lp, hd);
  float* qs = reinterpret_cast<float*>(smem + lay.q);
  float* dos = reinterpret_cast<float*>(smem + lay.dout);
  float* ks = reinterpret_cast<float*>(smem + lay.k);
  float* vs = reinterpret_cast<float*>(smem + lay.v);
  float* ss = reinterpret_cast<float*>(smem + lay.s);
  float* red_max = reinterpret_cast<float*>(smem + lay.red);
  float* red_sum = red_max + kWarps * kB;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * kB;
  const int h = blockIdx.y;
  const int n = blockIdx.z;
  const int D = H * hd;
  const size_t row = 3 * static_cast<size_t>(D);
  const T* head = qkv + static_cast<size_t>(n) * L * row + static_cast<size_t>(h) * hd;
  const T* dhead = dout + static_cast<size_t>(n) * L * D + static_cast<size_t>(h) * hd;
  const size_t plane = static_cast<size_t>(gridDim.z) * H * L;
  float* st = stats + (static_cast<size_t>(n) * H + h) * L;

  // ---- 1. the head's K and V, this block's Q and dO, widened to fp32 -----
  // Rows past L are zero, so padded keys and queries carry no NaNs.
  for (int idx = tid; idx < lp * hd; idx += kThreads) {
    const int j = idx / hd;
    const int d = idx - j * hd;
    const T* src = head + j * row + d;
    ks[j * hdp + d] = j < L ? to_f(src[D]) : 0.f;
    vs[j * hdp + d] = j < L ? to_f(src[2 * D]) : 0.f;
  }
  for (int idx = tid; idx < kB * hd; idx += kThreads) {
    const int i = idx / hd;
    const int d = idx - i * hd;
    const bool ok = q0 + i < L;
    qs[d * kB + i] = ok ? to_f(head[(q0 + i) * row + d]) : 0.f;
    dos[d * kB + i] = ok ? to_f(dhead[static_cast<size_t>(q0 + i) * D + d]) : 0.f;
  }
  __syncthreads();

  // ---- 2. logits: warp w takes rows 4w..4w+3, lane takes keys lane+32c ---
  const int qi = warp * kPerWarp;
  const int ncol = lp / 32;
  for (int cb = 0; cb < ncol; cb += kCols) {
    float acc[kPerWarp][kCols];
#pragma unroll
    for (int r = 0; r < kPerWarp; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
    for (int d = 0; d < hd; ++d) {
      const float4 q = *reinterpret_cast<const float4*>(qs + d * kB + qi);
      const float* kcol = ks + (32 * cb + lane) * hdp + d;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        if (cb + c < ncol) {
          const float k = kcol[32 * c * hdp];
          acc[0][c] = fmaf(q.x, k, acc[0][c]);
          acc[1][c] = fmaf(q.y, k, acc[1][c]);
          acc[2][c] = fmaf(q.z, k, acc[2][c]);
          acc[3][c] = fmaf(q.w, k, acc[3][c]);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      if (cb + c < ncol) {
        const int j = 32 * (cb + c) + lane;
        const bool valid = j < L;
        float4 s;
        s.x = valid ? __fmul_rn(acc[0][c], scale) : -INFINITY;
        s.y = valid ? __fmul_rn(acc[1][c], scale) : -INFINITY;
        s.z = valid ? __fmul_rn(acc[2][c], scale) : -INFINITY;
        s.w = valid ? __fmul_rn(acc[3][c], scale) : -INFINITY;
        *reinterpret_cast<float4*>(ss + j * kB + qi) = s;
      }
    }
  }
  __syncthreads();

  // ---- 3. fp32 softmax over keys (lane = row); p stays fp32 ---------------
  {
    const int i = lane;
    float m = -INFINITY;
    for (int j = warp; j < lp; j += kWarps) m = fmaxf(m, ss[j * kB + i]);
    red_max[warp * kB + i] = m;
    __syncthreads();
    m = red_max[i];
    for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red_max[w * kB + i]);
    float l = 0.f;
    for (int j = warp; j < lp; j += kWarps) {
      const float e = expf(ss[j * kB + i] - m);
      ss[j * kB + i] = e;
      l += e;
    }
    red_sum[warp * kB + i] = l;
    __syncthreads();
    l = 0.f;
    for (int w = 0; w < kWarps; ++w) l += red_sum[w * kB + i];
    for (int j = warp; j < lp; j += kWarps) ss[j * kB + i] = ss[j * kB + i] / l;
    if (warp == 0 && q0 + i < L) {
      st[q0 + i] = m;
      st[plane + q0 + i] = l;
    }
  }
  __syncthreads();

  // From here on each warp reads and writes only its own 4 rows of ss.
  // ---- 4. o = pb v in fp32 and delta = sum_d do o: lane takes d ----------
  float delta[kPerWarp];
  {
    float o[kPerWarp][kMaxHdCols];
#pragma unroll
    for (int r = 0; r < kPerWarp; ++r)
#pragma unroll
      for (int c = 0; c < kMaxHdCols; ++c) o[r][c] = 0.f;
    for (int j = 0; j < L; ++j) {
      const float4 p = *reinterpret_cast<const float4*>(ss + j * kB + qi);
      const float pb[kPerWarp] = {round_to<T>(p.x), round_to<T>(p.y),
                                  round_to<T>(p.z), round_to<T>(p.w)};
      const float* vrow = vs + j * hdp + lane;
#pragma unroll
      for (int c = 0; c < kMaxHdCols; ++c) {
        if (lane + 32 * c < hd) {
          const float v = vrow[32 * c];
#pragma unroll
          for (int r = 0; r < kPerWarp; ++r) o[r][c] = fmaf(pb[r], v, o[r][c]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kPerWarp; ++r) {
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < kMaxHdCols; ++c) {
        const int d = lane + 32 * c;
        if (d < hd) part = fmaf(dos[d * kB + qi + r], o[r][c], part);
      }
      delta[r] = warp_sum(part);
      if (lane == 0 && q0 + qi + r < L) st[2 * plane + q0 + qi + r] = delta[r];
    }
  }

  // ---- 5. dp = do v^T, ds = p (dp - delta) scale rounded, in place of p ---
  for (int cb = 0; cb < ncol; cb += kCols) {
    float acc[kPerWarp][kCols];
#pragma unroll
    for (int r = 0; r < kPerWarp; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
    for (int d = 0; d < hd; ++d) {
      const float4 g = *reinterpret_cast<const float4*>(dos + d * kB + qi);
      const float* vcol = vs + (32 * cb + lane) * hdp + d;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        if (cb + c < ncol) {
          const float v = vcol[32 * c * hdp];
          acc[0][c] = fmaf(g.x, v, acc[0][c]);
          acc[1][c] = fmaf(g.y, v, acc[1][c]);
          acc[2][c] = fmaf(g.z, v, acc[2][c]);
          acc[3][c] = fmaf(g.w, v, acc[3][c]);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      if (cb + c < ncol) {
        const int j = 32 * (cb + c) + lane;
        float4* slot = reinterpret_cast<float4*>(ss + j * kB + qi);
        const float4 p = *slot;
        float4 ds;
        ds.x = round_to<T>(p.x * (acc[0][c] - delta[0]) * scale);
        ds.y = round_to<T>(p.y * (acc[1][c] - delta[1]) * scale);
        ds.z = round_to<T>(p.z * (acc[2][c] - delta[2]) * scale);
        ds.w = round_to<T>(p.w * (acc[3][c] - delta[3]) * scale);
        *slot = ds;
      }
    }
  }
  __syncwarp();

  // ---- 6. dq = ds k: lane takes d ------------------------------------------
  float dq[kPerWarp][kMaxHdCols];
#pragma unroll
  for (int r = 0; r < kPerWarp; ++r)
#pragma unroll
    for (int c = 0; c < kMaxHdCols; ++c) dq[r][c] = 0.f;
  for (int j = 0; j < L; ++j) {
    const float4 s = *reinterpret_cast<const float4*>(ss + j * kB + qi);
    const float* krow = ks + j * hdp + lane;
#pragma unroll
    for (int c = 0; c < kMaxHdCols; ++c) {
      if (lane + 32 * c < hd) {
        const float k = krow[32 * c];
        dq[0][c] = fmaf(s.x, k, dq[0][c]);
        dq[1][c] = fmaf(s.y, k, dq[1][c]);
        dq[2][c] = fmaf(s.z, k, dq[2][c]);
        dq[3][c] = fmaf(s.w, k, dq[3][c]);
      }
    }
  }
  T* dbase = dqkv + static_cast<size_t>(n) * L * row + static_cast<size_t>(h) * hd;
#pragma unroll
  for (int r = 0; r < kPerWarp; ++r) {
    const int i = q0 + qi + r;
    if (i >= L) continue;
#pragma unroll
    for (int c = 0; c < kMaxHdCols; ++c) {
      const int d = lane + 32 * c;
      if (d < hd) dbase[i * row + d] = from_f<T>(dq[r][c]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_key_pass(const T* __restrict__ qkv, const T* __restrict__ dout,
             T* __restrict__ dqkv, const float* __restrict__ stats,
             int L, int H, int hd, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lp = (L + 31) & ~31;
  const int hdp = hd + 1;
  const KeyLayout lay = key_layout(lp, hd);
  float* kT = reinterpret_cast<float*>(smem + lay.k);
  float* vT = reinterpret_cast<float*>(smem + lay.v);
  float* qs = reinterpret_cast<float*>(smem + lay.q);
  float* dos = reinterpret_cast<float*>(smem + lay.dout);
  float* pbs = reinterpret_cast<float*>(smem + lay.pb);
  float* dss = reinterpret_cast<float*>(smem + lay.ds);
  float* row_max = reinterpret_cast<float*>(smem + lay.stats);
  float* row_sum = row_max + lp;
  float* row_delta = row_sum + lp;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int k0 = blockIdx.x * kB;
  const int h = blockIdx.y;
  const int n = blockIdx.z;
  const int D = H * hd;
  const size_t row = 3 * static_cast<size_t>(D);
  const T* head = qkv + static_cast<size_t>(n) * L * row + static_cast<size_t>(h) * hd;
  const T* dhead = dout + static_cast<size_t>(n) * L * D + static_cast<size_t>(h) * hd;
  const size_t plane = static_cast<size_t>(gridDim.z) * H * L;
  const float* st = stats + (static_cast<size_t>(n) * H + h) * L;

  // ---- 1. the head's Q and dO, this block's K and V, the row statistics --
  for (int idx = tid; idx < lp * hd; idx += kThreads) {
    const int i = idx / hd;
    const int d = idx - i * hd;
    qs[i * hdp + d] = i < L ? to_f(head[i * row + d]) : 0.f;
    dos[i * hdp + d] = i < L ? to_f(dhead[static_cast<size_t>(i) * D + d]) : 0.f;
  }
  for (int idx = tid; idx < kB * hd; idx += kThreads) {
    const int j = idx / hd;
    const int d = idx - j * hd;
    const bool ok = k0 + j < L;
    const T* src = head + (k0 + j) * row + d;
    kT[d * kB + j] = ok ? to_f(src[D]) : 0.f;
    vT[d * kB + j] = ok ? to_f(src[2 * D]) : 0.f;
  }
  for (int i = tid; i < lp; i += kThreads) {
    const bool ok = i < L;
    row_max[i] = ok ? st[i] : 0.f;
    row_sum[i] = ok ? st[plane + i] : 1.f;
    row_delta[i] = ok ? st[2 * plane + i] : 0.f;
  }
  __syncthreads();

  // ---- 2. per key column: s, p, dp, pb and ds against every query ---------
  // warp w takes keys 4w..4w+3, lane takes queries lane+32c. Each warp
  // writes only its own 4 columns of pbs and dss.
  const int kj = warp * kPerWarp;
  const int ncol = lp / 32;
  for (int cb = 0; cb < ncol; cb += kCols) {
    float sa[kPerWarp][kCols], pa[kPerWarp][kCols];
#pragma unroll
    for (int r = 0; r < kPerWarp; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c) sa[r][c] = pa[r][c] = 0.f;
    for (int d = 0; d < hd; ++d) {
      const float4 k = *reinterpret_cast<const float4*>(kT + d * kB + kj);
      const float4 v = *reinterpret_cast<const float4*>(vT + d * kB + kj);
      const float* qcol = qs + (32 * cb + lane) * hdp + d;
      const float* gcol = dos + (32 * cb + lane) * hdp + d;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        if (cb + c < ncol) {
          // the same operand order as pass 1, so the same bits
          const float q = qcol[32 * c * hdp];
          const float g = gcol[32 * c * hdp];
          sa[0][c] = fmaf(q, k.x, sa[0][c]);
          sa[1][c] = fmaf(q, k.y, sa[1][c]);
          sa[2][c] = fmaf(q, k.z, sa[2][c]);
          sa[3][c] = fmaf(q, k.w, sa[3][c]);
          pa[0][c] = fmaf(g, v.x, pa[0][c]);
          pa[1][c] = fmaf(g, v.y, pa[1][c]);
          pa[2][c] = fmaf(g, v.z, pa[2][c]);
          pa[3][c] = fmaf(g, v.w, pa[3][c]);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      if (cb + c < ncol) {
        const int i = 32 * (cb + c) + lane;
        float pb[kPerWarp], ds[kPerWarp];
        const float m = row_max[i], l = row_sum[i], dl = row_delta[i];
#pragma unroll
        for (int r = 0; r < kPerWarp; ++r) {
          const bool valid = i < L && k0 + kj + r < L;
          // __fmul_rn: no FMA contraction of the scale into "- m", so
          // the logit is pass 1's
          const float p = valid ? expf(__fmul_rn(sa[r][c], scale) - m) / l : 0.f;
          pb[r] = round_to<T>(p);
          ds[r] = round_to<T>(p * (pa[r][c] - dl) * scale);
        }
        *reinterpret_cast<float4*>(pbs + i * kB + kj) = make_float4(pb[0], pb[1], pb[2], pb[3]);
        *reinterpret_cast<float4*>(dss + i * kB + kj) = make_float4(ds[0], ds[1], ds[2], ds[3]);
      }
    }
  }
  __syncwarp();

  // ---- 3. dv = pb^T do, dk = ds^T q over all queries: lane takes d -------
  float dk[kPerWarp][kMaxHdCols], dv[kPerWarp][kMaxHdCols];
#pragma unroll
  for (int r = 0; r < kPerWarp; ++r)
#pragma unroll
    for (int c = 0; c < kMaxHdCols; ++c) dk[r][c] = dv[r][c] = 0.f;
  for (int i = 0; i < L; ++i) {
    const float4 pb = *reinterpret_cast<const float4*>(pbs + i * kB + kj);
    const float4 ds = *reinterpret_cast<const float4*>(dss + i * kB + kj);
    const float* qrow = qs + i * hdp + lane;
    const float* grow = dos + i * hdp + lane;
#pragma unroll
    for (int c = 0; c < kMaxHdCols; ++c) {
      if (lane + 32 * c < hd) {
        const float q = qrow[32 * c];
        const float g = grow[32 * c];
        dv[0][c] = fmaf(pb.x, g, dv[0][c]);
        dv[1][c] = fmaf(pb.y, g, dv[1][c]);
        dv[2][c] = fmaf(pb.z, g, dv[2][c]);
        dv[3][c] = fmaf(pb.w, g, dv[3][c]);
        dk[0][c] = fmaf(ds.x, q, dk[0][c]);
        dk[1][c] = fmaf(ds.y, q, dk[1][c]);
        dk[2][c] = fmaf(ds.z, q, dk[2][c]);
        dk[3][c] = fmaf(ds.w, q, dk[3][c]);
      }
    }
  }
  T* dbase = dqkv + static_cast<size_t>(n) * L * row + static_cast<size_t>(h) * hd;
#pragma unroll
  for (int r = 0; r < kPerWarp; ++r) {
    const int j = k0 + kj + r;
    if (j >= L) continue;
#pragma unroll
    for (int c = 0; c < kMaxHdCols; ++c) {
      const int d = lane + 32 * c;
      if (d < hd) {
        dbase[j * row + D + d] = from_f<T>(dk[r][c]);
        dbase[j * row + 2 * D + d] = from_f<T>(dv[r][c]);
      }
    }
  }
}

// Raise a kernel's dynamic shared-memory limit (48 KB by default) on the
// current device to the largest size asked for so far.
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem, size_t* configured) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem > configured[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    configured[dev] = smem;
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t launch(const void* qkv, const void* dout, void* dqkv, float* stats,
                   int n, int l, int heads, int hd, float scale, cudaStream_t stream) {
  const int lp = (l + 31) & ~31;
  const size_t smem_q = query_layout(lp, hd).total;
  const size_t smem_k = key_layout(lp, hd).total;
  if (smem_q > kMaxSmem || smem_k > kMaxSmem) return cudaErrorInvalidValue;
  static size_t configured_q[kMaxDevices] = {};
  static size_t configured_k[kMaxDevices] = {};
  cudaError_t err = allow_smem(bwd_query_pass<T>, smem_q, configured_q);
  if (err != cudaSuccess) return err;
  err = allow_smem(bwd_key_pass<T>, smem_k, configured_k);
  if (err != cudaSuccess) return err;
  const dim3 grid(lp / kB, heads, n);
  bwd_query_pass<T><<<grid, kThreads, smem_q, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(dout), static_cast<T*>(dqkv),
      stats, l, heads, hd, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_key_pass<T><<<grid, kThreads, smem_k, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(dout), static_cast<T*>(dqkv),
      stats, l, heads, hd, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory the larger of the two kernels needs per
// block: at a head dim that is a multiple of 8 the tensor-core kernels',
// bf16 (esize 2) or fp32 (esize 4), the same at every l; else the two
// passes' (operands widened to fp32).
size_t packed_attention_bwd_smem_bytes(int l, int hd, int esize) {
  if (esize == 2 && hd % 8 == 0) return attention_bwd_mma::smem_bytes(hd);
  if (esize == 4 && hd % 8 == 0) return attention_fp32_mma::bwd_smem_bytes(hd);
  const int lp = (l + 31) & ~31;
  const size_t q = query_layout(lp, hd).total;
  const size_t k = key_layout(lp, hd).total;
  return q > k ? q : k;
}

// dtype: 0 = bfloat16, 1 = float32. qkv (n, l, 3*heads*hd), dout
// (n, l, heads*hd) and dqkv (n, l, 3*heads*hd) are contiguous in dtype;
// stats is fp32 scratch of 3*n*heads*l; all on the current device; at a
// head dim that is a multiple of 8, qkv and dout 16-byte aligned.
// Launches both kernels on the stream and returns the cudaError_t (0 on
// success).
int packed_attention_bwd(const void* qkv, const void* dout, void* dqkv, void* stats,
                         int n, int l, int heads, int hd, float scale, int dtype,
                         void* stream) {
  if (n <= 0 || l <= 0 || heads <= 0 || hd <= 0 || hd > 32 * kMaxHdCols ||
      n > 65535 || heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* st = static_cast<float*>(stats);
  switch (dtype) {
    case 0: {
      if (hd % 8 != 0)
        return static_cast<int>(
            launch<__nv_bfloat16>(qkv, dout, dqkv, st, n, l, heads, hd, scale, s));
      if (reinterpret_cast<uintptr_t>(qkv) % 16 != 0 ||
          reinterpret_cast<uintptr_t>(dout) % 16 != 0)
        return static_cast<int>(cudaErrorInvalidValue);
      using attention_bwd_mma::bf16;
      const attention_bwd_mma::PackedQkv problem{static_cast<const bf16*>(qkv),
                                                 static_cast<const bf16*>(dout),
                                                 static_cast<bf16*>(dqkv), st, n, heads};
      return static_cast<int>(attention_bwd_mma::launch(problem, l, hd, scale, s));
    }
    case 1: {
      if (hd % 8 != 0)
        return static_cast<int>(launch<float>(qkv, dout, dqkv, st, n, l, heads, hd, scale, s));
      if (reinterpret_cast<uintptr_t>(qkv) % 16 != 0 ||
          reinterpret_cast<uintptr_t>(dout) % 16 != 0)
        return static_cast<int>(cudaErrorInvalidValue);
      const attention_fp32_mma::PackedQkvBwd problem{static_cast<const float*>(qkv),
                                                   static_cast<const float*>(dout),
                                                   static_cast<float*>(dqkv), st, n, heads};
      return static_cast<int>(attention_fp32_mma::launch_bwd(problem, l, hd, scale, s));
    }
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* packed_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
