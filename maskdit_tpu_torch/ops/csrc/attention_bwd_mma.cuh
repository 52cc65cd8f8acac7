// The bf16 attention backward on Hopper's tensor cores (sm_90a), shared by
// packed_attention_bwd.cu (kernel #2, flash_batched._packed_bwd) and
// packed_attention_big_bwd.cu (kernel #4, flash_big._big_bwd); flash_bwd.cu
// (#6) builds its kernels from the helpers below, with its own rounding.
// #2 and #4 compute, per (sample, head), from q, k, v (rows of the packed
// qkv) and do:
//   s = (q . k) * scale (fp32); m = max s; e = exp(s - m); l = sum e;
//   p = e / l (fp32); pb = bf16(p); o = pb . v (fp32, not rounded);
//   delta = sum(do * o) (fp32); dv = pb^T . do; dp = do . v^T;
//   ds = bf16(p * (dp - delta) * scale); dq = ds . k; dk = ds^T . q;
// with fp32 accumulators, each output rounded once to bf16. Every product
// has bf16 operands (pb and ds are rounded before theirs), so all of them
// run as mma.sync m16n8k16 (bf16 in, fp32 accumulate) without changing the
// function.
//
// What bounds it: the TPU kernel's six L x L x hd products are 12 N H L^2 hd
// operations against ~7 N L D elements of traffic, far above the card's
// balance, so the bound is the tensor cores' rate. Deterministic stages
// without atomics recompute s in each (below): ten products, so this design
// can reach at most 0.6 of that bound; and it takes four expf per logit.
//
// The design (the backward twin of attention_fwd_mma.cuh, whose helpers,
// tile shapes and rounding it reuses), two launches per call:
//   * query kernel, grid (ceil(L / 64), heads, n), 4 warps of 16 queries,
//     each holding its Q and dO rows in registers as mma A fragments:
//       pass 1 over the keys: s, the row max m and the sum l, rescaled as m
//         grows (the forward's pass 1);
//       pass 2: s again (the same instructions, the same bits), p =
//         div_rn(exp(s - m), l) rounded to bf16 in registers, o += pb . v;
//         then delta = sum(do * o) from the unrounded fp32 o; m, l and
//         delta go to the fp32 (3, n, heads, L) scratch;
//       pass 3: s, p, dp = do . v^T and ds, rounded to bf16 in registers,
//         then dq += ds . k;
//   * key kernel, same grid over keys: 4 warps, 64 keys whose K and V tiles
//     stay in shared memory; Q and dO stream in tiles of 64 queries. Per
//     tile, each warp takes 16 queries: s = Q . K^T and dp = dO . V^T by the
//     query kernel's instructions, p from the saved m and l, pb and ds,
//     stored as bf16 64 x 64 tiles in shared memory; then each warp takes
//     16 keys and reads those tiles transposed (ldmatrix.trans) as the A
//     fragments of dv += pb^T . dO and dk += ds^T . Q.
//   So s, p, dp and ds in the key kernel are bit for bit the query kernel's:
//   s and dp come from the same mma sequence (S = Q . K^T in both, not K .
//   Q^T), p from the same expf and correctly rounded division (div_rn, with
//   the same 1 / l), ds = (p * (dp - delta)) * scale with pinned multiplies
//   (__fmul_rn), so no FMA contraction differs between the two.
// Tiles: 64 rows of hd16 + 8 bf16 (hd16 = hd padded to the mma k-step of
// 16), filled by 16-byte cp.async.cg (zeros at rows past L), two-deep rings;
// the pad columns hd .. hd16 are zeroed once, so hd 72 pads to 80 only in the
// contractions over hd (Q . K^T, dO . V^T); the products whose output runs
// over hd (P . V, dS . K, P^T . dO, dS^T . Q) take hd / 8 n-tiles of 8 (nine
// at hd 72). Queries past L get m = +inf in the key kernel, so their p and
// ds are 0 and they add nothing to dk or dv; keys past L get s = -inf.
// Shared memory does not grow with L: the query kernel 4 tiles (45,056 B at
// hd 72), the key kernel 6 tiles and the two 64 x 72 bf16 tiles of pb and
// ds (86,016 B at hd 72, 49,152 B at hd 32).

#pragma once

#include "attention_fwd_mma.cuh"

namespace attention_bwd_mma {
// Internal linkage: packed_attention_bwd.cu, packed_attention_big_bwd.cu
// and flash_bwd.cu each build a copy into their own library, and all are
// loaded into one process. A template's static (launch_hd's ``configured`` flags)
// with external linkage is one object process-wide (a GNU unique symbol),
// so the second library's kernels would skip their shared-memory opt-in.
namespace {

using attention_fwd_mma::bf16;
using attention_fwd_mma::cp_async_commit;
using attention_fwd_mma::cp_async_wait;
using attention_fwd_mma::div_rn;
using attention_fwd_mma::kKeys;
using attention_fwd_mma::kMaxDevices;
using attention_fwd_mma::kMaxHd;
using attention_fwd_mma::kRows;
using attention_fwd_mma::kThreads;
using attention_fwd_mma::ldmatrix_x2_trans;
using attention_fwd_mma::ldmatrix_x4;
using attention_fwd_mma::ldmatrix_x4_trans;
using attention_fwd_mma::load_tile;
using attention_fwd_mma::mma;
using attention_fwd_mma::pack_bf16;
using attention_fwd_mma::padded_hd;
using attention_fwd_mma::smem_addr;
using attention_fwd_mma::tile_logits;
using attention_fwd_mma::tile_stride;

static_assert(kRows == kKeys, "query and key tiles are both 64 rows");

// elements between rows of a pb or ds tile (64 keys + 8: an odd number of
// 16-byte units, so ldmatrix.trans reads without bank conflicts)
constexpr int kPStride = kKeys + 8;

// dynamic shared memory of a query-kernel block: the K and V rings
__host__ __device__ constexpr size_t query_smem_bytes(int hd) {
  return 4 * static_cast<size_t>(kKeys) * tile_stride(hd) * sizeof(bf16);
}

// of a key-kernel block: its K and V tiles, the Q and dO rings, pb and ds
__host__ __device__ constexpr size_t key_smem_bytes(int hd) {
  return 6 * static_cast<size_t>(kKeys) * tile_stride(hd) * sizeof(bf16) +
         2 * static_cast<size_t>(kRows) * kPStride * sizeof(bf16);
}

// the larger of the two
__host__ __device__ constexpr size_t smem_bytes(int hd) { return key_smem_bytes(hd); }

// one (sample, head): its q, k, v rows (row r at q + r * in_stride, ...),
// its do rows, its dq, dk, dv rows (at the same strides as q, k, v) and its
// row statistics (L floats each)
struct Head {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  size_t in_stride;
  const bf16* dout;
  size_t dout_stride;
  bf16* dq;
  bf16* dk;
  bf16* dv;
  float* m;
  float* l;
  float* delta;
};

// packed qkv and dqkv (n, L, 3D), head h at features h*hd, D + h*hd and
// 2D + h*hd of each row; dout (n, L, D); stats (3, n, heads, L) fp32: the
// row max, sum and delta; grid (ceil(L / 64), heads, n)
struct PackedQkv {
  const bf16* qkv;
  const bf16* dout;
  bf16* dqkv;
  float* stats;
  int n, heads;

  __device__ Head head(int L, int hd) const {
    const size_t d = static_cast<size_t>(heads) * hd;
    const size_t off = static_cast<size_t>(blockIdx.z) * L * 3 * d +
                       static_cast<size_t>(blockIdx.y) * hd;
    const size_t plane = static_cast<size_t>(n) * heads * L;
    float* st = stats + (static_cast<size_t>(blockIdx.z) * heads + blockIdx.y) * L;
    return {qkv + off, qkv + off + d, qkv + off + 2 * d, 3 * d,
            dout + static_cast<size_t>(blockIdx.z) * L * d + static_cast<size_t>(blockIdx.y) * hd,
            d, dqkv + off, dqkv + off + d, dqkv + off + 2 * d, st, st + plane, st + 2 * plane};
  }
  dim3 grid(int L) const { return dim3((L + kRows - 1) / kRows, heads, n); }
};

// A fragments of rows 16 warp .. 16 warp + 15 of a tile over the padded hd:
// ldmatrix.x4 lanes 0-15 address rows 0-15 at dims 0-7, 16-31 at dims 8-15
template <int HD>
__device__ __forceinline__ void load_rows(uint32_t (&a)[padded_hd(HD) / 16][4], const bf16* tile,
                                          int warp) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < padded_hd(HD) / 16; ++kk)
    ldmatrix_x4(a[kk], smem_addr(tile + (16 * warp + (lane & 15)) * tile_stride(HD) + 16 * kk +
                                 ((lane >> 4) << 3)));
}

// acc = a . b^T over the padded hd, unscaled: a one warp's 16 rows (A
// fragments), b the 64 rows of a tile; tile_logits's instructions, so dp is
// formed the same way in both kernels
template <int HD>
__device__ __forceinline__ void tile_dots(float (&acc)[8][4],
                                          const uint32_t (&a)[padded_hd(HD) / 16][4],
                                          const bf16* bt) {
  const int lane = threadIdx.x & 31;
  const int row = ((lane >> 4) << 3) + (lane & 7);
  const int dim = ((lane >> 3) & 1) << 3;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;
#pragma unroll
  for (int kk = 0; kk < padded_hd(HD) / 16; ++kk) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t b[4];
      ldmatrix_x4(b, smem_addr(bt + (16 * j + row) * tile_stride(HD) + 16 * kk + dim));
      mma(acc[2 * j], a[kk], b[0], b[1]);
      mma(acc[2 * j + 1], a[kk], b[2], b[3]);
    }
  }
}

// acc (16 x HD, n-tiles of 8) += a . t: a the A fragments of 16 rows x 64
// (four k-steps), t the 64 rows of a tile read transposed (ldmatrix.trans:
// lanes 0-7 rows 0-7 (b0), 8-15 rows 8-15 (b1) at dims d..d+7, lanes 16-31
// the same at d+8)
template <int HD>
__device__ __forceinline__ void tile_accumulate(float (&acc)[HD / 8][4], const uint32_t (&a)[4][4],
                                                const bf16* t) {
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
      mma(acc[j], a[kk], b[0], b[1]);
      mma(acc[j + 1], a[kk], b[2], b[3]);
    }
    if (kDimTiles % 2) {
      uint32_t b[2];
      ldmatrix_x2_trans(b, smem_addr(t + (16 * kk + row) * tile_stride(HD) + 8 * (kDimTiles - 1)));
      mma(acc[kDimTiles - 1], a[kk], b[0], b[1]);
    }
  }
}

// The A fragments of the transpose of 16 columns (16 warp .. 16 warp + 15)
// of a 64 x 64 pb or ds tile: rows = those columns (keys), k = the tile's 64
// rows (queries). ldmatrix.x4.trans: lanes 8i..8i+7 address the rows of 8x8
// block i, which is a0 (keys 0-7, queries 0-7), a1 (keys 8-15), a2 (queries
// 8-15), a3 (both); .trans hands thread (g, t) the tile's [2t][g], [2t+1][g]
__device__ __forceinline__ void load_columns(uint32_t (&a)[4][4], const bf16* p, int warp) {
  const int lane = threadIdx.x & 31;
  const int row = ((lane >> 4) << 3) + (lane & 7);
  const int col = 16 * warp + (((lane >> 3) & 1) << 3);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    ldmatrix_x4_trans(a[kk], smem_addr(p + (16 * kk + row) * kPStride + col));
}

// p = exp(s - m) / l correctly rounded, with r = 1 / l: the forward's
// second-pass probability
__device__ __forceinline__ float prob(float s, float m, float l, float r) {
  return div_rn(expf(s - m), l, r);
}

// ds = (p * (dp - delta)) * scale, each multiply rounded on its own (no FMA
// contraction), in the order the reference evaluates it
__device__ __forceinline__ float dscore(float p, float dp, float delta, float scale) {
  return __fmul_rn(__fmul_rn(p, dp - delta), scale);
}

// 16 x HD accumulators of one warp (rows g and g + 8 of 16 rows starting at
// row0, features 8j + 2t, +1) rounded to bf16 into rows r of dst (at r *
// stride), for rows below L
template <int HD>
__device__ __forceinline__ void store_rows(bf16* dst, size_t stride, const float (&acc)[HD / 8][4],
                                           int row0, int L) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + (lane >> 2) + 8 * r;
    if (row >= L) continue;
    bf16* out = dst + static_cast<size_t>(row) * stride + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<uint32_t*>(out + 8 * j) = pack_bf16(acc[j][2 * r], acc[j][2 * r + 1]);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
attention_bwd_query_kernel(PackedQkv problem, int L, float scale) {
  constexpr int kSteps = padded_hd(HD) / 16;
  constexpr int kDimTiles = HD / 8;
  constexpr int kStride = tile_stride(HD);
  constexpr int kTile = kKeys * kStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // K ring; Q and dO pass through vs
  bf16* vs = ks + 2 * kTile;                     // V ring

  const Head head = problem.head(L, HD);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * kRows;
  const int ntiles = (L + kKeys - 1) / kKeys;

  if (padded_hd(HD) != HD)
    for (int r = tid; r < 4 * kKeys; r += kThreads)
      *reinterpret_cast<uint4*>(ks + r * kStride + HD) = make_uint4(0u, 0u, 0u, 0u);

  // ---- this warp's 16 queries of Q and dO as A fragments --------------------
  uint32_t qf[kSteps][4], gf[kSteps][4];
  load_tile<HD>(vs, head.q, head.in_stride, q0, L);
  load_tile<HD>(vs + kTile, head.dout, head.dout_stride, q0, L);
  load_tile<HD>(ks, head.k, head.in_stride, 0, L);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  load_rows<HD>(qf, vs, warp);
  load_rows<HD>(gf, vs + kTile, warp);

  // ---- pass 1: the row max m and sum l over all keys (rows g and g + 8) ----
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles)
      load_tile<HD>(ks + ((t + 1) & 1) * kTile, head.k, head.in_stride, (t + 1) * kKeys, L);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    float s[8][4];
    tile_logits<HD>(s, qf, ks + (t & 1) * kTile, t * kKeys, L, scale);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mn = fmaxf(m[r], mx);
      float sum = l[r] * expf(m[r] - mn);
#pragma unroll
      for (int j = 0; j < 8; ++j) sum += expf(s[j][2 * r] - mn) + expf(s[j][2 * r + 1] - mn);
      m[r] = mn;
      l[r] = sum;
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const float rl[2] = {__frcp_rn(l[0]), __frcp_rn(l[1])};
  const int row0 = q0 + 16 * warp + (lane >> 2);

  // ---- pass 2: o = pb . v in fp32, then delta = sum(do * o) ----------------
  float delta[2];
  {
    float o[kDimTiles][4];
#pragma unroll
    for (int j = 0; j < kDimTiles; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) o[j][c] = 0.f;
    load_tile<HD>(ks, head.k, head.in_stride, 0, L);
    load_tile<HD>(vs, head.v, head.in_stride, 0, L);
    cp_async_commit();
    for (int t = 0; t < ntiles; ++t) {
      if (t + 1 < ntiles) {
        load_tile<HD>(ks + ((t + 1) & 1) * kTile, head.k, head.in_stride, (t + 1) * kKeys, L);
        load_tile<HD>(vs + ((t + 1) & 1) * kTile, head.v, head.in_stride, (t + 1) * kKeys, L);
      }
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      float s[8][4];
      tile_logits<HD>(s, qf, ks + (t & 1) * kTile, t * kKeys, L, scale);
      // m16n8 accumulators of n-tiles 2kk, 2kk + 1 = the m16k16 A fragment
      // of keys 16kk .. 16kk + 15
      uint32_t pa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int r = 0; r < 2; ++r)
            pa[kk][2 * h + r] = pack_bf16(prob(s[2 * kk + h][2 * r], m[r], l[r], rl[r]),
                                          prob(s[2 * kk + h][2 * r + 1], m[r], l[r], rl[r]));
      tile_accumulate<HD>(o, pa, vs + (t & 1) * kTile);
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      float part = 0.f;
      if (row < L) {
        const bf16* g = head.dout + static_cast<size_t>(row) * head.dout_stride + 2 * (lane & 3);
#pragma unroll
        for (int j = 0; j < kDimTiles; ++j) {
          const __nv_bfloat162 d2 = *reinterpret_cast<const __nv_bfloat162*>(g + 8 * j);
          part = fmaf(__low2float(d2), o[j][2 * r], part);
          part = fmaf(__high2float(d2), o[j][2 * r + 1], part);
        }
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      delta[r] = part;
      if ((lane & 3) == 0 && row < L) {
        head.m[row] = m[r];
        head.l[row] = l[r];
        head.delta[row] = part;
      }
    }
  }

  // ---- pass 3: dp = do . v^T, ds rounded to bf16, dq += ds . k -------------
  float dq[kDimTiles][4];
#pragma unroll
  for (int j = 0; j < kDimTiles; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) dq[j][c] = 0.f;
  load_tile<HD>(ks, head.k, head.in_stride, 0, L);
  load_tile<HD>(vs, head.v, head.in_stride, 0, L);
  cp_async_commit();
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {
      load_tile<HD>(ks + ((t + 1) & 1) * kTile, head.k, head.in_stride, (t + 1) * kKeys, L);
      load_tile<HD>(vs + ((t + 1) & 1) * kTile, head.v, head.in_stride, (t + 1) * kKeys, L);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* kt = ks + (t & 1) * kTile;
    float s[8][4], dp[8][4];
    tile_logits<HD>(s, qf, kt, t * kKeys, L, scale);
    tile_dots<HD>(dp, gf, vs + (t & 1) * kTile);
    uint32_t da[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int j = 2 * kk + h;
          const float p0 = prob(s[j][2 * r], m[r], l[r], rl[r]);
          const float p1 = prob(s[j][2 * r + 1], m[r], l[r], rl[r]);
          da[kk][2 * h + r] = pack_bf16(dscore(p0, dp[j][2 * r], delta[r], scale),
                                        dscore(p1, dp[j][2 * r + 1], delta[r], scale));
        }
    tile_accumulate<HD>(dq, da, kt);
    __syncthreads();
  }
  store_rows<HD>(head.dq, head.in_stride, dq, q0 + 16 * warp, L);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
attention_bwd_key_kernel(PackedQkv problem, int L, float scale) {
  constexpr int kSteps = padded_hd(HD) / 16;
  constexpr int kDimTiles = HD / 8;
  constexpr int kStride = tile_stride(HD);
  constexpr int kTile = kKeys * kStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* kb = reinterpret_cast<bf16*>(smem_raw);  // this block's K tile
  bf16* vb = kb + kTile;                         // and V tile
  bf16* qs = vb + kTile;                         // Q ring, 2 tiles
  bf16* gs = qs + 2 * kTile;                     // dO ring, 2 tiles
  bf16* ps = gs + 2 * kTile;                     // pb, 64 queries x 64 keys
  bf16* dss = ps + kRows * kPStride;             // ds, the same

  const Head head = problem.head(L, HD);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int k0 = blockIdx.x * kKeys;
  const int ntiles = (L + kRows - 1) / kRows;

  if (padded_hd(HD) != HD)
    for (int r = tid; r < 6 * kKeys; r += kThreads)
      *reinterpret_cast<uint4*>(kb + r * kStride + HD) = make_uint4(0u, 0u, 0u, 0u);

  float dk[kDimTiles][4], dv[kDimTiles][4];
#pragma unroll
  for (int j = 0; j < kDimTiles; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk[j][c] = dv[j][c] = 0.f;

  load_tile<HD>(kb, head.k, head.in_stride, k0, L);
  load_tile<HD>(vb, head.v, head.in_stride, k0, L);
  load_tile<HD>(qs, head.q, head.in_stride, 0, L);
  load_tile<HD>(gs, head.dout, head.dout_stride, 0, L);
  cp_async_commit();
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {
      load_tile<HD>(qs + ((t + 1) & 1) * kTile, head.q, head.in_stride, (t + 1) * kRows, L);
      load_tile<HD>(gs + ((t + 1) & 1) * kTile, head.dout, head.dout_stride, (t + 1) * kRows, L);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* qt = qs + (t & 1) * kTile;
    const bf16* gt = gs + (t & 1) * kTile;

    // ---- this warp's 16 queries of the tile against the block's 64 keys ---
    {
      uint32_t qf[kSteps][4], gf[kSteps][4];
      load_rows<HD>(qf, qt, warp);
      load_rows<HD>(gf, gt, warp);
      float s[8][4], dp[8][4];
      tile_logits<HD>(s, qf, kb, k0, L, scale);
      tile_dots<HD>(dp, gf, vb);
      const int row0 = t * kRows + 16 * warp + (lane >> 2);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        // a query past L: m = +inf makes its p, and so its ds, 0
        const bool valid = row < L;
        const float m = valid ? head.m[row] : INFINITY;
        const float l = valid ? head.l[row] : 1.f;
        const float dl = valid ? head.delta[row] : 0.f;
        const float rl = __frcp_rn(l);
        bf16* prow = ps + (16 * warp + (lane >> 2) + 8 * r) * kPStride + 2 * (lane & 3);
        bf16* drow = dss + (prow - ps);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float p0 = prob(s[j][2 * r], m, l, rl);
          const float p1 = prob(s[j][2 * r + 1], m, l, rl);
          *reinterpret_cast<uint32_t*>(prow + 8 * j) = pack_bf16(p0, p1);
          *reinterpret_cast<uint32_t*>(drow + 8 * j) = pack_bf16(
              dscore(p0, dp[j][2 * r], dl, scale), dscore(p1, dp[j][2 * r + 1], dl, scale));
        }
      }
    }
    __syncthreads();

    // ---- this warp's 16 keys: dv += pb^T . dO, dk += ds^T . Q ---------------
    {
      uint32_t a[4][4];
      load_columns(a, ps, warp);
      tile_accumulate<HD>(dv, a, gt);
      load_columns(a, dss, warp);
      tile_accumulate<HD>(dk, a, qt);
    }
    __syncthreads();
  }
  store_rows<HD>(head.dk, head.in_stride, dk, k0 + 16 * warp, L);
  store_rows<HD>(head.dv, head.in_stride, dv, k0 + 16 * warp, L);
}

// Raise a kernel's dynamic shared-memory limit (48 KB by default) and
// prefer the largest shared-memory carveout.
template <typename K>
cudaError_t configure(K kernel, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <int HD>
cudaError_t launch_hd(const PackedQkv& problem, int L, float scale, cudaStream_t stream) {
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!configured[dev]) {
    err = configure(attention_bwd_query_kernel<HD>, query_smem_bytes(HD));
    if (err != cudaSuccess) return err;
    err = configure(attention_bwd_key_kernel<HD>, key_smem_bytes(HD));
    if (err != cudaSuccess) return err;
    configured[dev] = true;
  }
  attention_bwd_query_kernel<HD>
      <<<problem.grid(L), kThreads, query_smem_bytes(HD), stream>>>(problem, L, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_bwd_key_kernel<HD>
      <<<problem.grid(L), kThreads, key_smem_bytes(HD), stream>>>(problem, L, scale);
  return cudaGetLastError();
}

// Both kernels at head dim hd (a multiple of 8, at most kMaxHd), one
// instantiation per hd, so every loop over hd unrolls. qkv and dout must be
// 16-byte aligned (cp.async).
template <int HD = 8>
cudaError_t launch(const PackedQkv& problem, int L, int hd, float scale, cudaStream_t stream) {
  if (hd == HD) return launch_hd<HD>(problem, L, scale, stream);
  if constexpr (HD < kMaxHd) {
    return launch<HD + 8>(problem, L, hd, scale, stream);
  } else {
    return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace attention_bwd_mma
