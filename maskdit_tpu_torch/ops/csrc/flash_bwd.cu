// Per-(sample, head) attention backward from a saved logsumexp, for Hopper
// (sm_90a).
//
// Replaces the Pallas kernel maskdit_tpu/ops/flash.py::_flash_bwd (body
// _bwd_kernel). From the forward's residuals q, k, v, o (each (N*H, L, hd)
// contiguous), lse (N*H, L) fp32 and o's gradient do, it writes dq, dk, dv
// in the input type. Its rounding points are _bwd_kernel's (flash.py:
// 57-78), which differ from the packed kernels': everything stays fp32 until
// the three stores. p = exp(s - lse) is not rounded (dv = p^T do uses the
// fp32 p), ds = p (dp - delta) scale is not rounded, and delta = sum(do o)
// reads the STORED o, already rounded to the input type.
//
// What bounds it: five L x L x hd products per head (s, dv, dp, dq, dk),
// 10 N H L^2 hd operations against ~(8 L hd) elements of traffic per head:
// far above the card's balance, so the bound is the arithmetic rate.
//
// bf16 (every head dim the wrapper takes is a multiple of 8): the tensor
// cores, mma.sync m16n8k16 (bf16 in, fp32 accumulate), by the tiles, rings
// and fragment helpers of attention_fwd_mma.cuh / attention_bwd_mma.cuh
// but with this kernel's own rounding. Three of the five products have an
// fp32 operand (p or ds) against a bf16 one (do, k or q). Each fp32 value
// x of p and ds is split exactly into three bf16 pieces, x0 = bf16(x),
// x1 = bf16(x - x0), x2 = x - x0 - x1 (every subtraction exact in fp32, x2
// exact in bf16: 24 significand bits in three pieces of 8); a piece times a
// bf16 value is exact in fp32, so with fp32 accumulators p^T do, ds k and
// ds^T q are the reference's products up to summation order. Two pieces
// (16 bits) would approximate them. So the design runs 13 bf16 products
// where the reference runs 5 (at most 5/13 of the bound), three launches,
// deterministic, without atomics:
//   * delta pass: one warp per query row, delta = sum_d do o in fp32, into
//     an fp32 (N*H, L) scratch that the wrapper allocates;
//   * key kernel, grid (ceil(L / 64), N*H), 4 warps: the block's 64 keys of
//     K and V stay in shared memory, Q and dO stream in 64-row tiles through
//     cp.async rings. Per tile each warp takes 16 queries: S = Q K^T and
//     dP = dO V^T (Q and dO as A fragments), p = exp(s - lse) and ds, stored
//     fp32 and transposed ([key][query]) in shared memory; then each warp
//     takes 16 keys, splits its rows of p^T and ds^T into three bf16 A
//     fragments each, and adds p^T dO to dv and ds^T Q to dk (each B
//     fragment loaded once for the three pieces);
//   * query kernel, same grid over queries: each warp holds its 16 rows of
//     Q and dO as A fragments; K and V stream through rings; per tile S, dP,
//     ds, whose three pieces go from the accumulators straight into A
//     fragments in registers, then dq += ds K.
//   p and ds are bit for bit the same in both kernels: S = Q K^T with Q as
//   the A operand in both (the same mma sequence, tile_logits), dP by
//   tile_dots in both, the same expf, ds = (p (dp - delta)) scale with
//   pinned multiplies. Keys past L get s = -inf, queries past L lse = +inf,
//   so their p and ds are 0. Shared memory does not grow with L: the key
//   kernel 6 bf16 [64][hd16 + 8] tiles and two fp32 [64][72] tiles
//   (104,448 B at hd 72, 67,584 B at hd 32), the query kernel 4 tiles.
//
// fp32 (model.use_flash with train.fp32: the released finetunes with the
// flag; held to 1e-5 of max|ref|, no TF32) runs the same delta pass, then
// attention_fp32_mma.cuh's key and query kernels in their SeparateHeads
// layout, shared with #2 / #4 in fp32: fp32 tiles in shared memory, every
// product as six bf16 mma.sync products of exact bf16 pieces of its fp32
// operands, p = exp(s - lse) from the forward's lse (so the query kernel
// runs no forward pass: s, dp, ds and dq += ds . k only; the key kernel s,
// dp, then dv += p^T . do and dk += ds^T . q), p and ds bit for bit alike
// in both. Shared memory 114,688 B at hd 72 (the query kernel; the key
// kernel's rings one tile deep, 112,640 B, so that two blocks share an SM),
// 94,208 B at hd 32, at every L.

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
constexpr int kMaxHd = 128;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ delta,
                size_t rows, int hd) {
  const size_t row = static_cast<size_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  float part = 0.f;
  for (int d = lane; d < hd; d += 32)
    part = fmaf(to_f(dout[row * hd + d]), to_f(o[row * hd + d]), part);
  part = warp_sum(part);
  if (lane == 0) delta[row] = part;
}

// ---- bf16: the tensor-core kernels ------------------------------------------
namespace mma_bwd {

using attention_bwd_mma::bf16;
using attention_bwd_mma::configure;
using attention_bwd_mma::cp_async_commit;
using attention_bwd_mma::cp_async_wait;
using attention_bwd_mma::dscore;
using attention_bwd_mma::kKeys;
using attention_bwd_mma::kRows;
using attention_bwd_mma::ldmatrix_x2_trans;
using attention_bwd_mma::ldmatrix_x4_trans;
using attention_bwd_mma::load_rows;
using attention_bwd_mma::load_tile;
using attention_bwd_mma::mma;
using attention_bwd_mma::padded_hd;
using attention_bwd_mma::smem_addr;
using attention_bwd_mma::store_rows;
using attention_bwd_mma::tile_dots;
using attention_bwd_mma::tile_logits;
using attention_bwd_mma::tile_stride;
using attention_fp32_mma::split3;

constexpr int kThreads = attention_bwd_mma::kThreads;  // 4 warps
// floats between rows of the key kernel's fp32 p^T and ds^T tiles (64
// queries + 8: the float2 reads of the A fragments hit no bank twice)
constexpr int kTStride = kRows + 8;

// dynamic shared memory of a query-kernel block: the K and V rings
__host__ __device__ constexpr size_t query_smem_bytes(int hd) {
  return 4 * static_cast<size_t>(kKeys) * tile_stride(hd) * sizeof(bf16);
}

// of a key-kernel block: its K and V tiles, the Q and dO rings, p^T and ds^T
__host__ __device__ constexpr size_t key_smem_bytes(int hd) {
  return 6 * static_cast<size_t>(kKeys) * tile_stride(hd) * sizeof(bf16) +
         2 * static_cast<size_t>(kKeys) * kTStride * sizeof(float);
}

// acc (16 x HD, n-tiles of 8) += (a[0] + a[1] + a[2]) . t: the three pieces'
// A fragments of 16 rows x 64 (four k-steps), t the 64 rows of a tile read
// transposed (ldmatrix.trans, as attention_bwd_mma's tile_accumulate), each
// B fragment loaded once for the three products
template <int HD>
__device__ __forceinline__ void tile_accumulate3(float (&acc)[HD / 8][4],
                                                 const uint32_t (&a)[3][4][4], const bf16* t) {
  constexpr int kDimTiles = HD / 8;
  const int lane = threadIdx.x & 31;
  const int row = lane & 15;
  const int dim = (lane >> 4) << 3;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int j = 0; j + 1 < kDimTiles; j += 2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, smem_addr(t + (16 * kk + row) * tile_stride(HD) + 8 * j + dim));
#pragma unroll
      for (int x = 0; x < 3; ++x) {
        mma(acc[j], a[x][kk], b[0], b[1]);
        mma(acc[j + 1], a[x][kk], b[2], b[3]);
      }
    }
    if (kDimTiles % 2) {
      uint32_t b[2];
      ldmatrix_x2_trans(b, smem_addr(t + (16 * kk + row) * tile_stride(HD) + 8 * (kDimTiles - 1)));
#pragma unroll
      for (int x = 0; x < 3; ++x) mma(acc[kDimTiles - 1], a[x][kk], b[0], b[1]);
    }
  }
}

// The three pieces of the transpose of 16 rows (keys 16 warp ..) of an fp32
// [key][query] tile as A fragments (rows = keys, k = the 64 queries): thread
// (g, t) reads keys g and g + 8 at queries 16kk + 2t, +1 and + 8, +9.
__device__ __forceinline__ void split_rows(uint32_t (&a)[3][4][4], const float* pt, int warp) {
  const int lane = threadIdx.x & 31;
  const float* base = pt + (16 * warp + (lane >> 2)) * kTStride + 2 * (lane & 3);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // a0: key g, a1: key g + 8, a2/a3: queries + 8
      const float2 x = *reinterpret_cast<const float2*>(base + (i & 1) * 8 * kTStride +
                                                        16 * kk + (i >> 1) * 8);
      split3(x.x, x.y, a[0][kk][i], a[1][kk][i], a[2][kk][i]);
    }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_key_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const float* __restrict__ lse,
                     const bf16* __restrict__ dout, const float* __restrict__ delta,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int L, float scale) {
  constexpr int kStride = tile_stride(HD);
  constexpr int kTile = kKeys * kStride;
  constexpr int kSteps = padded_hd(HD) / 16;
  constexpr int kDimTiles = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* kb = reinterpret_cast<bf16*>(smem_raw);  // this block's K tile
  bf16* vb = kb + kTile;                         // and V tile
  bf16* qs = vb + kTile;                         // Q ring, 2 tiles
  bf16* gs = qs + 2 * kTile;                     // dO ring, 2 tiles
  float* pt = reinterpret_cast<float*>(gs + 2 * kTile);  // p^T, [64 keys][kTStride]
  float* dst = pt + kKeys * kTStride;                    // ds^T, the same

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int k0 = blockIdx.x * kKeys;
  const size_t head = static_cast<size_t>(blockIdx.y) * L;  // first row of this head
  const bf16* qh = q + head * HD;
  const bf16* gh = dout + head * HD;
  const int ntiles = (L + kRows - 1) / kRows;

  if (padded_hd(HD) != HD)
    for (int r = tid; r < 6 * kKeys; r += kThreads)
      *reinterpret_cast<uint4*>(kb + r * kStride + HD) = make_uint4(0u, 0u, 0u, 0u);

  float dka[kDimTiles][4], dva[kDimTiles][4];
#pragma unroll
  for (int j = 0; j < kDimTiles; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) dka[j][c] = dva[j][c] = 0.f;

  load_tile<HD>(kb, k + head * HD, HD, k0, L);
  load_tile<HD>(vb, v + head * HD, HD, k0, L);
  load_tile<HD>(qs, qh, HD, 0, L);
  load_tile<HD>(gs, gh, HD, 0, L);
  cp_async_commit();
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {
      load_tile<HD>(qs + ((t + 1) & 1) * kTile, qh, HD, (t + 1) * kRows, L);
      load_tile<HD>(gs + ((t + 1) & 1) * kTile, gh, HD, (t + 1) * kRows, L);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* qt = qs + (t & 1) * kTile;
    const bf16* gt = gs + (t & 1) * kTile;

    // ---- this warp's 16 queries of the tile against the block's 64 keys:
    //      p and ds in fp32, stored transposed
    {
      uint32_t qf[kSteps][4], gf[kSteps][4];
      load_rows<HD>(qf, qt, warp);
      load_rows<HD>(gf, gt, warp);
      float s[8][4], dp[8][4];
      tile_logits<HD>(s, qf, kb, k0, L, scale);
      tile_dots<HD>(dp, gf, vb);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int ql = 16 * warp + (lane >> 2) + 8 * r;  // query within the tile
        const int row = t * kRows + ql;
        // a query past L: lse = +inf makes its p, and so its ds, 0
        const bool valid = row < L;
        const float ls = valid ? lse[head + row] : INFINITY;
        const float dl = valid ? delta[head + row] : 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int key = 8 * j + 2 * (lane & 3) + c;
            const float p = expf(s[j][2 * r + c] - ls);
            pt[key * kTStride + ql] = p;
            dst[key * kTStride + ql] = dscore(p, dp[j][2 * r + c], dl, scale);
          }
      }
    }
    __syncthreads();

    // ---- this warp's 16 keys: dv += p^T . dO, dk += ds^T . Q, three pieces
    {
      uint32_t a[3][4][4];
      split_rows(a, pt, warp);
      tile_accumulate3<HD>(dva, a, gt);
      split_rows(a, dst, warp);
      tile_accumulate3<HD>(dka, a, qt);
    }
    __syncthreads();
  }
  store_rows<HD>(dk + head * HD, HD, dka, k0 + 16 * warp, L);
  store_rows<HD>(dv + head * HD, HD, dva, k0 + 16 * warp, L);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_query_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const float* __restrict__ lse,
                       const bf16* __restrict__ dout, const float* __restrict__ delta,
                       bf16* __restrict__ dq, int L, float scale) {
  constexpr int kStride = tile_stride(HD);
  constexpr int kTile = kKeys * kStride;
  constexpr int kSteps = padded_hd(HD) / 16;
  constexpr int kDimTiles = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // K ring; Q and dO pass through first
  bf16* vs = ks + 2 * kTile;                     // V ring

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * kRows;
  const size_t head = static_cast<size_t>(blockIdx.y) * L;
  const bf16* kh = k + head * HD;
  const bf16* vh = v + head * HD;
  const int ntiles = (L + kKeys - 1) / kKeys;

  if (padded_hd(HD) != HD)
    for (int r = tid; r < 4 * kKeys; r += kThreads)
      *reinterpret_cast<uint4*>(ks + r * kStride + HD) = make_uint4(0u, 0u, 0u, 0u);

  // ---- this warp's 16 queries of Q and dO as A fragments; their lse, delta
  uint32_t qf[kSteps][4], gf[kSteps][4];
  load_tile<HD>(ks, q + head * HD, HD, q0, L);
  load_tile<HD>(vs, dout + head * HD, HD, q0, L);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  load_rows<HD>(qf, ks, warp);
  load_rows<HD>(gf, vs, warp);
  float ls[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + 16 * warp + (lane >> 2) + 8 * r;
    ls[r] = row < L ? lse[head + row] : INFINITY;
    dl[r] = row < L ? delta[head + row] : 0.f;
  }
  __syncthreads();  // every warp holds its fragments before the rings refill

  float dqa[kDimTiles][4];
#pragma unroll
  for (int j = 0; j < kDimTiles; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) dqa[j][c] = 0.f;
  load_tile<HD>(ks, kh, HD, 0, L);
  load_tile<HD>(vs, vh, HD, 0, L);
  cp_async_commit();
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {
      load_tile<HD>(ks + ((t + 1) & 1) * kTile, kh, HD, (t + 1) * kKeys, L);
      load_tile<HD>(vs + ((t + 1) & 1) * kTile, vh, HD, (t + 1) * kKeys, L);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* kt = ks + (t & 1) * kTile;
    float s[8][4], dp[8][4];
    tile_logits<HD>(s, qf, kt, t * kKeys, L, scale);
    tile_dots<HD>(dp, gf, vs + (t & 1) * kTile);
    // m16n8 accumulators of n-tiles 2kk, 2kk + 1 = the m16k16 A fragment of
    // keys 16kk .. 16kk + 15; ds in three pieces
    uint32_t a[3][4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int j = 2 * kk + h;
          const float d0 = dscore(expf(s[j][2 * r] - ls[r]), dp[j][2 * r], dl[r], scale);
          const float d1 = dscore(expf(s[j][2 * r + 1] - ls[r]), dp[j][2 * r + 1], dl[r], scale);
          split3(d0, d1, a[0][kk][2 * h + r], a[1][kk][2 * h + r], a[2][kk][2 * h + r]);
        }
    tile_accumulate3<HD>(dqa, a, kt);
    __syncthreads();
  }
  store_rows<HD>(dq + head * HD, HD, dqa, q0 + 16 * warp, L);
}

template <int HD>
cudaError_t launch_hd(const bf16* q, const bf16* k, const bf16* v, const float* lse,
                      const bf16* dout, const float* delta, bf16* dq, bf16* dk, bf16* dv, int n,
                      int L, float scale, cudaStream_t stream) {
  // internal linkage (the anonymous namespace): no other library's copy
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!configured[dev]) {
    err = configure(flash_bwd_key_kernel<HD>, key_smem_bytes(HD));
    if (err != cudaSuccess) return err;
    err = configure(flash_bwd_query_kernel<HD>, query_smem_bytes(HD));
    if (err != cudaSuccess) return err;
    configured[dev] = true;
  }
  const dim3 grid((L + kRows - 1) / kRows, n);
  flash_bwd_key_kernel<HD><<<grid, kThreads, key_smem_bytes(HD), stream>>>(
      q, k, v, lse, dout, delta, dk, dv, L, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_query_kernel<HD><<<grid, kThreads, query_smem_bytes(HD), stream>>>(
      q, k, v, lse, dout, delta, dq, L, scale);
  return cudaGetLastError();
}

// Both kernels at head dim hd (a multiple of 8, at most kMaxHd): one
// instantiation per hd, so every loop over hd unrolls.
template <int HD = 8>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, const float* lse,
                   const bf16* dout, const float* delta, bf16* dq, bf16* dk, bf16* dv, int n,
                   int L, int hd, float scale, cudaStream_t stream) {
  if (hd == HD) return launch_hd<HD>(q, k, v, lse, dout, delta, dq, dk, dv, n, L, scale, stream);
  if constexpr (HD < kMaxHd) {
    return launch<HD + 8>(q, k, v, lse, dout, delta, dq, dk, dv, n, L, hd, scale, stream);
  } else {
    return cudaErrorInvalidValue;
  }
}

}  // namespace mma_bwd

// the delta pass: delta = sum(do * o) per query row, from the stored o
template <typename T>
cudaError_t launch_delta(const void* o, const void* dout, float* delta, size_t rows, int hd,
                         cudaStream_t stream) {
  flash_bwd_delta<T><<<static_cast<unsigned>((rows + kWarps - 1) / kWarps), kThreads, 0,
                       stream>>>(static_cast<const T*>(o), static_cast<const T*>(dout), delta,
                                 rows, hd);
  return cudaGetLastError();
}

// fp32: the delta pass, then the tensor-core key and query kernels of
// attention_fp32_mma.cuh
cudaError_t launch_fp32(const float* q, const float* k, const float* v, const float* o,
                        const float* lse, const float* dout, float* dq, float* dk, float* dv,
                        float* delta, int n, int l, int hd, float scale, cudaStream_t stream) {
  const cudaError_t err = launch_delta<float>(o, dout, delta, static_cast<size_t>(n) * l, hd,
                                              stream);
  if (err != cudaSuccess) return err;
  const attention_fp32_mma::SeparateHeadsBwd layout{q, k, v, dout, dq, dk, dv, lse, delta, n};
  return attention_fp32_mma::launch_bwd(layout, l, hd, scale, stream);
}

// bf16: the delta pass, then the tensor-core key and query kernels
cudaError_t launch_bf16(const void* q, const void* k, const void* v, const void* o,
                        const float* lse, const void* dout, void* dq, void* dk, void* dv,
                        float* delta, int n, int l, int hd, float scale, cudaStream_t stream) {
  using mma_bwd::bf16;
  cudaError_t err = launch_delta<bf16>(o, dout, delta, static_cast<size_t>(n) * l, hd, stream);
  if (err != cudaSuccess) return err;
  return mma_bwd::launch(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                         static_cast<const bf16*>(v), lse, static_cast<const bf16*>(dout),
                         delta, static_cast<bf16*>(dq), static_cast<bf16*>(dk),
                         static_cast<bf16*>(dv), n, l, hd, scale, stream);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// Bytes of dynamic shared memory the larger of the two tensor-core kernels
// needs per block for inputs of esize bytes, at any L: bf16 (2) the key
// kernel's, fp32 (4) attention_fp32_mma.cuh's.
size_t flash_bwd_smem_bytes(int hd, int esize) {
  return esize == 2 ? mma_bwd::key_smem_bytes(hd) : attention_fp32_mma::bwd_smem_bytes(hd);
}

// dtype: 0 = bfloat16, 1 = float32. q, k, v, o, dout, dq, dk and dv are
// (n, l, hd) contiguous in dtype, q, k, v and dout 16-byte aligned; lse is
// (n, l) fp32 and delta fp32 scratch of n * l; all on the current device;
// hd a multiple of 8, at most 128. Launches the three kernels on the stream
// and returns the cudaError_t (0 on success).
int flash_bwd(const void* q, const void* k, const void* v, const void* o, const void* lse,
              const void* dout, void* dq, void* dk, void* dv, void* delta, int n, int l, int hd,
              float scale, int dtype, void* stream) {
  if (n <= 0 || l <= 0 || hd <= 0 || hd > kMaxHd || hd % 8 != 0 || n > 65535 ||
      !aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(dout))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ls = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  switch (dtype) {
    case 0:
      return static_cast<int>(
          launch_bf16(q, k, v, o, ls, dout, dq, dk, dv, dl, n, l, hd, scale, s));
    case 1:
      return static_cast<int>(launch_fp32(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), static_cast<const float*>(o), ls,
          static_cast<const float*>(dout), static_cast<float*>(dq), static_cast<float*>(dk),
          static_cast<float*>(dv), dl, n, l, hd, scale, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
