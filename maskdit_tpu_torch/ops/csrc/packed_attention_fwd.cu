// Packed multi-head attention forward for Hopper (sm_90a).
//
// Replaces the Pallas kernel maskdit_tpu/ops/flash_batched.py::_packed_fwd
// (body _fwd_kernel). It reads the packed qkv Dense output (N, L, 3D) in
// place and writes (N, L, D): head h reads q at features [h*hd, (h+1)*hd),
// k at [D + h*hd, ...) and v at [2D + h*hd, ...) of each row. Logits and
// softmax are fp32 over the whole row: s = (q k) scale, m = max s, p =
// exp(s - m), l = sum p; p / l is rounded once to the input type before the
// product with v (flash_batched.py:89, attention.py:49), which accumulates
// in fp32; the output is stored in the input type.
//
// What bounds it: the TPU kernel's two L x L x hd products, 4 N H L^2 hd
// operations, against ~4 N L D elements of traffic: at the main path's
// shapes (L 128 or 256) the card's memory rate and its tensor-core rate set
// bounds within ~2x of each other, so both count.
//
// bf16 at a head dim that is a multiple of 8 (every model's, the main path):
// the tensor cores, one pass over the keys with s kept on chip. The route
// (models/layers.attention_route) only sends shapes whose whole row fits a
// block, so unlike the blocked forward (attention_fwd_mma.cuh's two passes)
// s is formed once. Grid (ceil(L / 64), H, N), 4 warps of 16 queries, each
// holding its Q rows as mma A fragments (mma.sync m16n8k16, bf16 in, fp32
// accumulate; the header's tiles, cp.async rings, ldmatrix and div_rn):
//   1. over the key tiles: S = Q K^T, the exact row max m, and s itself,
//      which each thread keeps in shared memory in its own accumulator
//      layout (float4 per n-tile, lane-major: no bank conflicts and no
//      barrier), L / 2 floats per thread;
//   2. over s on chip: e = exp(s - m), written back in place, l = sum e
//      (by tiles, then across the quad);
//   3. over the value tiles: p = div_rn(e, l), correctly rounded as e / l,
//      rounded to bf16 in registers, where the m16n8 accumulators become
//      the A fragments of o += P V.
// Two products and one expf per logit. Keys past L get s = -inf; queries
// past L are not stored. Shared memory: the K and V rings, 4 bf16
// [64][hd16 + 8] tiles, and s, 64 x L fp32 (L padded to 64): 77,824 B at
// (L 128, hd 72), 110,592 B at (256, 72), 86,016 B at (256, 32). Where
// that exceeds a block's limit (hd 8 and 16 at L above 832) the FMA kernel
// below runs.
//
// fp32 at a head dim that is a multiple of 8 (the released finetunes,
// configs/finetune/*.yaml: train.fp32, TF32 off; held to 1e-5 of max|ref|)
// runs attention_fp32_mma.cuh's tensor-core forward, the one kernel #3
// (packed_attention_big_fwd.cu) runs in fp32: in fp32 every "round to the
// input type" of the TPU kernels is the identity, so the whole-row and the
// blocked kernels compute the same function. Blocks of 64 queries of one
// head, K and V streamed in 64-row fp32 tiles by 16-byte cp.async, each
// fragment split into three exact bf16 pieces as it is read, every product
// as six bf16 mma.sync products, one online-softmax pass over the keys.
// Shared memory 96,256 B at hd 72, 47,104 B at hd 32, at every L.
//
// bf16 and fp32 at other head dims keep the first design, fp32 FMAs: grid
// (ceil(L/32), H, N); the block copies the head's K (transposed to [hd][L])
// and V once into shared memory, the (32, L) fp32 logits stay there, each
// warp computes 4 queries x 8 key columns per pass, the softmax runs over
// columns in fp32, and each warp accumulates its 4 queries' outputs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "attention_fp32_mma.cuh"
#include "attention_fwd_mma.cuh"

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

// ---- bf16: the whole-row tensor-core kernel ---------------------------------
namespace mma_fwd {

using attention_fwd_mma::bf16;
using attention_fwd_mma::cp_async_commit;
using attention_fwd_mma::cp_async_wait;
using attention_fwd_mma::div_rn;
using attention_fwd_mma::kKeys;
using attention_fwd_mma::kRows;
using attention_fwd_mma::kThreads;
using attention_fwd_mma::ldmatrix_x2_trans;
using attention_fwd_mma::ldmatrix_x4;
using attention_fwd_mma::ldmatrix_x4_trans;
using attention_fwd_mma::load_tile;
using attention_fwd_mma::mma;
using attention_fwd_mma::pack_bf16;
using attention_fwd_mma::PackedQkv;
using attention_fwd_mma::padded_hd;
using attention_fwd_mma::smem_addr;
using attention_fwd_mma::tile_logits;
using attention_fwd_mma::tile_stride;

constexpr size_t kMaxSmem = 232448;  // a block's limit on sm_90

// dynamic shared memory of one block at (L, hd): the K and V rings, 4 bf16
// [64][hd16 + 8] tiles, and the block's s, 64 x L fp32 (L padded to 64)
__host__ __device__ constexpr size_t smem_bytes(int l, int hd) {
  return 4 * static_cast<size_t>(kKeys) * tile_stride(hd) * sizeof(bf16) +
         static_cast<size_t>(kRows) * ((l + kKeys - 1) / kKeys * kKeys) * sizeof(float);
}

// this kernel runs (L, hd) in bf16: hd a multiple of 8, s within the limit
__host__ __device__ constexpr bool takes(int l, int hd) {
  return hd % 8 == 0 && hd <= attention_fwd_mma::kMaxHd && smem_bytes(l, hd) <= kMaxSmem;
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
packed_attention_fwd_mma(PackedQkv layout, int L, float scale) {
  constexpr int kSteps = padded_hd(HD) / 16;  // k-steps of Q.K^T
  constexpr int kDimTiles = HD / 8;           // n-tiles of P.V
  constexpr int kStride = tile_stride(HD);
  constexpr int kTile = kKeys * kStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // K ring, 2 tiles
  bf16* vs = ks + 2 * kTile;                     // V ring, 2 tiles; Q passes through vs[0]
  const int ntiles = (L + kKeys - 1) / kKeys;
  // this warp's s: per key tile 8 float4 (one per n-tile) for each lane
  float4* sw = reinterpret_cast<float4*>(vs + 2 * kTile) + (threadIdx.x >> 5) * ntiles * 8 * 32 +
               (threadIdx.x & 31);

  const attention_fwd_mma::Head head = layout.head(L, HD);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * kRows;

  if (padded_hd(HD) != HD)
    for (int r = tid; r < 4 * kKeys; r += kThreads)
      *reinterpret_cast<uint4*>(ks + r * kStride + HD) = make_uint4(0u, 0u, 0u, 0u);

  // ---- this warp's 16 queries as A fragments ---------------------------------
  uint32_t qf[kSteps][4];
  load_tile<HD>(vs, head.q, head.in_stride, q0, L);
  load_tile<HD>(ks, head.k, head.in_stride, 0, L);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk)
    ldmatrix_x4(qf[kk], smem_addr(vs + (16 * warp + (lane & 15)) * kStride + 16 * kk +
                                  ((lane >> 4) << 3)));

  // ---- 1. s over all keys, kept on chip, and its exact row max (rows g,
  //         g + 8) ---------------------------------------------------------------
  float m[2] = {-INFINITY, -INFINITY};
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles)
      load_tile<HD>(ks + ((t + 1) & 1) * kTile, head.k, head.in_stride, (t + 1) * kKeys, L);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    float s[8][4];
    tile_logits<HD>(s, qf, ks + (t & 1) * kTile, t * kKeys, L, scale);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      m[0] = fmaxf(m[0], fmaxf(s[j][0], s[j][1]));
      m[1] = fmaxf(m[1], fmaxf(s[j][2], s[j][3]));
      sw[(t * 8 + j) * 32] = make_float4(s[j][0], s[j][1], s[j][2], s[j][3]);
    }
    __syncthreads();
  }
  // the quad's four threads hold the row's keys
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 2));
  }
  // the first value tile is in flight during step 2 (Q's tile is free)
  load_tile<HD>(vs, head.v, head.in_stride, 0, L);
  cp_async_commit();

  // ---- 2. e = exp(s - m) in place, l = sum e ---------------------------------
  float l[2] = {0.f, 0.f};
  for (int t = 0; t < ntiles; ++t) {
    float part[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float4 x = sw[(t * 8 + j) * 32];
      x.x = expf(x.x - m[0]);
      x.y = expf(x.y - m[0]);
      x.z = expf(x.z - m[1]);
      x.w = expf(x.w - m[1]);
      part[0] += x.x + x.y;
      part[1] += x.z + x.w;
      sw[(t * 8 + j) * 32] = x;
    }
    l[0] += part[0];
    l[1] += part[1];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const float rl[2] = {__frcp_rn(l[0]), __frcp_rn(l[1])};

  // ---- 3. o = (e / l rounded to bf16) . v ------------------------------------
  float o[kDimTiles][4];
#pragma unroll
  for (int j = 0; j < kDimTiles; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[j][c] = 0.f;
  // ldmatrix.trans of V rows: lanes 0-7 address keys 0-7 (b0), 8-15 keys
  // 8-15 (b1) of the n-tile at dims d..d+7; lanes 16-31 the same at d+8
  const int vkey = lane & 15;
  const int vdim = (lane >> 4) << 3;
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles)
      load_tile<HD>(vs + ((t + 1) & 1) * kTile, head.v, head.in_stride, (t + 1) * kKeys, L);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    // m16n8 accumulators of n-tiles 2kk, 2kk + 1 = the m16k16 A fragment of
    // keys 16kk .. 16kk + 15
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 e = sw[(t * 8 + 2 * kk + h) * 32];
        pa[kk][2 * h] = pack_bf16(div_rn(e.x, l[0], rl[0]), div_rn(e.y, l[0], rl[0]));
        pa[kk][2 * h + 1] = pack_bf16(div_rn(e.z, l[1], rl[1]), div_rn(e.w, l[1], rl[1]));
      }
    const bf16* vt = vs + (t & 1) * kTile;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int j = 0; j + 1 < kDimTiles; j += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, smem_addr(vt + (16 * kk + vkey) * kStride + 8 * j + vdim));
        mma(o[j], pa[kk], b[0], b[1]);
        mma(o[j + 1], pa[kk], b[2], b[3]);
      }
      if (kDimTiles % 2) {
        uint32_t b[2];
        ldmatrix_x2_trans(b, smem_addr(vt + (16 * kk + vkey) * kStride + 8 * (kDimTiles - 1)));
        mma(o[kDimTiles - 1], pa[kk], b[0], b[1]);
      }
    }
    __syncthreads();
  }

  // ---- o in bf16: rows g and g + 8 of the warp, features 8j + 2t, +1 -------
  const int row0 = q0 + 16 * warp + (lane >> 2);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= L) continue;
    bf16* out = head.o + static_cast<size_t>(row) * head.out_stride + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < kDimTiles; ++j)
      *reinterpret_cast<uint32_t*>(out + 8 * j) = pack_bf16(o[j][2 * r], o[j][2 * r + 1]);
  }
}

template <int HD>
cudaError_t launch_hd(const PackedQkv& layout, int L, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(L, HD);
  // raise the kernel's dynamic shared-memory limit on this device to the
  // largest size asked for so far (internal linkage: this library's own)
  static size_t configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem > configured[dev]) {
    err = cudaFuncSetAttribute(packed_attention_fwd_mma<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(packed_attention_fwd_mma<HD>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    configured[dev] = smem;
  }
  packed_attention_fwd_mma<HD><<<layout.grid(L), kThreads, smem, stream>>>(layout, L, scale);
  return cudaGetLastError();
}

// The kernel at head dim hd (a multiple of 8, at most 128): one
// instantiation per hd, so every loop over hd unrolls.
template <int HD = 8>
cudaError_t launch(const PackedQkv& layout, int L, int hd, float scale, cudaStream_t stream) {
  if (hd == HD) return launch_hd<HD>(layout, L, scale, stream);
  if constexpr (HD < attention_fwd_mma::kMaxHd) {
    return launch<HD + 8>(layout, L, hd, scale, stream);
  } else {
    return cudaErrorInvalidValue;
  }
}

}  // namespace mma_fwd

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

// fp32 runs the tensor-core kernel at a head dim that is a multiple of 8,
// at most 128 (its shared memory does not depend on l)
bool fp32_mma_takes(int hd) { return hd % 8 == 0 && hd <= attention_fwd_mma::kMaxHd; }

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs; the caller checks it
// against the device's limit before a launch. bf16 (esize 2) where the
// tensor-core kernel takes (l, hd): its layout; fp32 (esize 4) at a head
// dim that is a multiple of 8: attention_fp32_mma.cuh's forward's, the same
// at every l; else the FMA kernel's.
size_t packed_attention_fwd_smem_bytes(int l, int hd, int esize) {
  if (esize == 2 && mma_fwd::takes(l, hd)) return mma_fwd::smem_bytes(l, hd);
  if (esize == 4 && fp32_mma_takes(hd)) return attention_fp32_mma::fwd_smem_bytes(hd);
  return smem_layout((l + 31) & ~31, hd, esize).total;
}

// dtype: 0 = bfloat16, 1 = float32. qkv is (n, l, 3*heads*hd) contiguous and
// out (n, l, heads*hd) contiguous, both on the current device; where a
// tensor-core kernel runs (bf16 where mma_fwd::takes, fp32 at a head dim
// that is a multiple of 8), qkv is 16-byte aligned. Returns the cudaError_t
// of the launch (0 on success).
int packed_attention_fwd(const void* qkv, void* out, int n, int l, int heads,
                         int hd, float scale, int dtype, void* stream) {
  if (n <= 0 || l <= 0 || heads <= 0 || hd <= 0 || hd > 32 * kMaxHdCols ||
      n > 65535 || heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: {
      if (!mma_fwd::takes(l, hd))
        return static_cast<int>(launch<__nv_bfloat16>(qkv, out, n, l, heads, hd, scale, s));
      if (reinterpret_cast<uintptr_t>(qkv) % 16 != 0)
        return static_cast<int>(cudaErrorInvalidValue);
      using mma_fwd::bf16;
      const attention_fwd_mma::PackedQkv layout{static_cast<const bf16*>(qkv),
                                                static_cast<bf16*>(out), n, heads};
      return static_cast<int>(mma_fwd::launch(layout, l, hd, scale, s));
    }
    case 1: {
      if (!fp32_mma_takes(hd))
        return static_cast<int>(launch<float>(qkv, out, n, l, heads, hd, scale, s));
      if (reinterpret_cast<uintptr_t>(qkv) % 16 != 0)
        return static_cast<int>(cudaErrorInvalidValue);
      const attention_fp32_mma::PackedQkv problem{static_cast<const float*>(qkv),
                                                   static_cast<float*>(out), n, heads};
      return static_cast<int>(attention_fp32_mma::launch_fwd(problem, l, hd, scale, s));
    }
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* packed_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
