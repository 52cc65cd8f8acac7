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
// fp32 (the parity path) keeps the first design, fp32 FMAs from shared
// memory, in the same three launches: the key pass (grid (ceil(L/32),
// N*H)) keeps its 32 keys' K and V (fp32 [hd][32]) and streams Q and dO in
// tiles of 64 rows; per tile it forms s and dp, p and ds, then adds p^T do
// to dv and ds^T q to dk in registers; the query pass keeps its 32 queries'
// Q and dO and streams K and V, adding ds k to dq. Both form each logit and
// each dp with the same FMA chain and a pinned scale multiply (__fmul_rn),
// so p and ds are bit for bit the same in both. Tiles are fetched into
// registers with 16-byte loads while the block computes on the previous
// one, and stored as fp32 [64][hd + 1] (an odd row stride: no bank
// conflicts). Shared memory (key pass; the query pass has 8 KB less):
// 109,568 B at hd 72, 58,368 B at hd 32, at every L.

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
constexpr int kB = 32;                  // keys (key pass) or queries (query pass) per block
constexpr int kPerWarp = kB / kWarps;   // 4: one float4 of a block row
constexpr int kTile = 64;               // rows per streamed tile
constexpr int kTileCols = kTile / 32;   // 32-row columns per tile
constexpr int kMaxHd = 128;
constexpr int kMaxHdCols = kMaxHd / 32;
constexpr int kMaxDevices = 64;
constexpr size_t kMaxSmem = 232448;     // a block's limit on sm_90

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// 16 bytes of T widened to fp32, exactly
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void widen(const uint4& x, float* f) {
    f[0] = __uint_as_float(x.x); f[1] = __uint_as_float(x.y);
    f[2] = __uint_as_float(x.z); f[3] = __uint_as_float(x.w);
  }
};

__host__ __device__ __forceinline__ size_t align16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

// Bytes of one fp32 [kTile][hd + 1] tile.
__host__ __device__ __forceinline__ size_t tile_bytes(int hd) {
  return static_cast<size_t>(kTile) * (hd + 1) * 4;
}

// Both passes: the block's two operands fp32 [hd][kB] (K and V, or Q and
// dO); two buffers of a pair of streamed tiles; p (key pass only) and ds
// fp32 [kTile][kB]. Independent of L.
struct Layout {
  size_t a, b, tile, p, ds, total;
};

__host__ __device__ __forceinline__ Layout layout(int hd, bool with_p) {
  Layout m;
  m.a = 0;
  m.b = align16(static_cast<size_t>(hd) * kB * 4);
  m.tile = align16(m.b + static_cast<size_t>(hd) * kB * 4);
  m.p = align16(m.tile + 4 * tile_bytes(hd));
  m.ds = with_p ? align16(m.p + static_cast<size_t>(kTile) * kB * 4) : m.p;
  m.total = m.ds + static_cast<size_t>(kTile) * kB * 4;
  return m;
}

// kTile rows of one head's Q, dO, K or V, fetched from device memory into
// registers with 16-byte loads, then widened into shared memory as fp32
// [kTile][hd + 1]. Rows at or past L are zero.
template <typename T>
struct TileFetch {
  static constexpr int kVec = Vec<T>::kN;
  static constexpr int kMaxVecs = kTile * kMaxHd / kVec / kThreads;
  uint4 regs[kMaxVecs];

  // rows r0 .. r0 + kTile - 1 of a row-major (L, hd) matrix at base
  __device__ __forceinline__ void fetch(const T* base, int r0, int L, int hd) {
    const int nv = hd / kVec;
#pragma unroll
    for (int u = 0; u < kMaxVecs; ++u) {
      const int idx = threadIdx.x + u * kThreads;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (idx < kTile * nv) {
        const int j = idx / nv;
        if (r0 + j < L)
          x = __ldg(reinterpret_cast<const uint4*>(
              base + static_cast<size_t>(r0 + j) * hd + (idx - j * nv) * kVec));
      }
      regs[u] = x;
    }
  }

  __device__ __forceinline__ void store(float* tile, int hd) const {
    const int nv = hd / kVec;
    const int hdp = hd + 1;
#pragma unroll
    for (int u = 0; u < kMaxVecs; ++u) {
      const int idx = threadIdx.x + u * kThreads;
      if (idx < kTile * nv) {
        const int j = idx / nv;
        float f[kVec];
        Vec<T>::widen(regs[u], f);
        float* dst = tile + j * hdp + (idx - j * nv) * kVec;
#pragma unroll
        for (int e = 0; e < kVec; ++e) dst[e] = f[e];
      }
    }
  }
};

// Run body(t, tile_a, tile_b) over the ceil(L / kTile) tiles of rows of two
// (L, hd) matrices at a and b, double-buffered: buffer x holds a tile of a
// at tiles + 2x * te and one of b at tiles + (2x + 1) * te; tile t + 1 is in
// flight while the block computes on tile t. Ends synchronised; the body
// must not synchronise the block itself.
template <typename T, typename Body>
__device__ __forceinline__ void for_each_tile_pair(const T* a, const T* b, int L, int hd,
                                                   float* tiles, Body body) {
  const int ntiles = (L + kTile - 1) / kTile;
  const int te = kTile * (hd + 1);
  TileFetch<T> fa, fb;
  fa.fetch(a, 0, L, hd);
  fb.fetch(b, 0, L, hd);
  fa.store(tiles, hd);
  fb.store(tiles + te, hd);
  __syncthreads();
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {
      fa.fetch(a, (t + 1) * kTile, L, hd);
      fb.fetch(b, (t + 1) * kTile, L, hd);
    }
    const float* buf = tiles + 2 * (t & 1) * te;
    body(t, buf, buf + te);
    if (t + 1 < ntiles) {
      float* next = tiles + 2 * ((t + 1) & 1) * te;
      fa.store(next, hd);
      fb.store(next + te, hd);
    }
    __syncthreads();
  }
}

// this block's kB rows of two (L, hd) matrices, as fp32 [hd][kB], zero past L
template <typename T>
__device__ __forceinline__ void load_block(const T* a, const T* b, int r0, int L, int hd,
                                           float* as, float* bs) {
  for (int idx = threadIdx.x; idx < kB * hd; idx += kThreads) {
    const int i = idx / hd;
    const int d = idx - i * hd;
    const bool ok = r0 + i < L;
    const size_t at = static_cast<size_t>(r0 + i) * hd + d;
    as[d * kB + i] = ok ? to_f(a[at]) : 0.f;
    bs[d * kB + i] = ok ? to_f(b[at]) : 0.f;
  }
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_key_pass(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const float* __restrict__ lse, const T* __restrict__ dout,
                   const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                   int L, int hd, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int hdp = hd + 1;
  const Layout lay = layout(hd, true);
  float* kT = reinterpret_cast<float*>(smem + lay.a);
  float* vT = reinterpret_cast<float*>(smem + lay.b);
  float* tiles = reinterpret_cast<float*>(smem + lay.tile);
  float* ps = reinterpret_cast<float*>(smem + lay.p);
  float* dss = reinterpret_cast<float*>(smem + lay.ds);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int k0 = blockIdx.x * kB;
  const size_t head = static_cast<size_t>(blockIdx.y) * L;  // first row of this head
  const float* lse_h = lse + head;
  const float* delta_h = delta + head;

  // ---- 1. this block's K and V, fp32 [hd][kB] ------------------------------
  load_block(k + head * hd, v + head * hd, k0, L, hd, kT, vT);
  // (for_each_tile_pair synchronises before its first body)

  // ---- 2. per tile of queries: s, dp, p and ds, then dv += p^T do and
  //         dk += ds^T q. In the first half warp w takes keys kj .. kj + 3
  //         and lane takes queries lane + 32c; in the second lane takes
  //         features d. Each warp reads and writes only its own 4 columns of
  //         ps and dss.
  const int kj = warp * kPerWarp;
  float dkr[kPerWarp][kMaxHdCols], dvr[kPerWarp][kMaxHdCols];
#pragma unroll
  for (int r = 0; r < kPerWarp; ++r)
#pragma unroll
    for (int c = 0; c < kMaxHdCols; ++c) dkr[r][c] = dvr[r][c] = 0.f;
  for_each_tile_pair<T>(q + head * hd, dout + head * hd, L, hd, tiles,
                        [&](int t, const float* qt, const float* gt) {
    float sa[kPerWarp][kTileCols], pa[kPerWarp][kTileCols];
#pragma unroll
    for (int r = 0; r < kPerWarp; ++r)
#pragma unroll
      for (int c = 0; c < kTileCols; ++c) sa[r][c] = pa[r][c] = 0.f;
    for (int d = 0; d < hd; ++d) {
      const float4 kk = *reinterpret_cast<const float4*>(kT + d * kB + kj);
      const float4 vv = *reinterpret_cast<const float4*>(vT + d * kB + kj);
#pragma unroll
      for (int c = 0; c < kTileCols; ++c) {
        // the query pass's operands in the query pass's order: the same bits
        const float qq = qt[(lane + 32 * c) * hdp + d];
        const float g = gt[(lane + 32 * c) * hdp + d];
        sa[0][c] = fmaf(qq, kk.x, sa[0][c]);
        sa[1][c] = fmaf(qq, kk.y, sa[1][c]);
        sa[2][c] = fmaf(qq, kk.z, sa[2][c]);
        sa[3][c] = fmaf(qq, kk.w, sa[3][c]);
        pa[0][c] = fmaf(g, vv.x, pa[0][c]);
        pa[1][c] = fmaf(g, vv.y, pa[1][c]);
        pa[2][c] = fmaf(g, vv.z, pa[2][c]);
        pa[3][c] = fmaf(g, vv.w, pa[3][c]);
      }
    }
#pragma unroll
    for (int c = 0; c < kTileCols; ++c) {
      const int il = 32 * c + lane;
      const int i = t * kTile + il;
      const bool row_ok = i < L;
      const float ls = row_ok ? lse_h[i] : 0.f;
      const float dl = row_ok ? delta_h[i] : 0.f;
      float p[kPerWarp], ds[kPerWarp];
#pragma unroll
      for (int r = 0; r < kPerWarp; ++r) {
        const bool valid = row_ok && k0 + kj + r < L;
        // __fmul_rn: no FMA contraction of the scale into "- lse"
        p[r] = valid ? expf(__fmul_rn(sa[r][c], scale) - ls) : 0.f;
        ds[r] = p[r] * (pa[r][c] - dl) * scale;
      }
      *reinterpret_cast<float4*>(ps + il * kB + kj) = make_float4(p[0], p[1], p[2], p[3]);
      *reinterpret_cast<float4*>(dss + il * kB + kj) = make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncwarp();
    for (int il = 0; il < kTile; ++il) {
      const float4 p = *reinterpret_cast<const float4*>(ps + il * kB + kj);
      const float4 ds = *reinterpret_cast<const float4*>(dss + il * kB + kj);
      const float* qrow = qt + il * hdp + lane;
      const float* grow = gt + il * hdp + lane;
#pragma unroll
      for (int c = 0; c < kMaxHdCols; ++c) {
        if (lane + 32 * c < hd) {
          const float qq = qrow[32 * c];
          const float g = grow[32 * c];
          dvr[0][c] = fmaf(p.x, g, dvr[0][c]);
          dvr[1][c] = fmaf(p.y, g, dvr[1][c]);
          dvr[2][c] = fmaf(p.z, g, dvr[2][c]);
          dvr[3][c] = fmaf(p.w, g, dvr[3][c]);
          dkr[0][c] = fmaf(ds.x, qq, dkr[0][c]);
          dkr[1][c] = fmaf(ds.y, qq, dkr[1][c]);
          dkr[2][c] = fmaf(ds.z, qq, dkr[2][c]);
          dkr[3][c] = fmaf(ds.w, qq, dkr[3][c]);
        }
      }
    }
  });
#pragma unroll
  for (int r = 0; r < kPerWarp; ++r) {
    const int j = k0 + kj + r;
    if (j >= L) continue;
#pragma unroll
    for (int c = 0; c < kMaxHdCols; ++c) {
      const int d = lane + 32 * c;
      if (d < hd) {
        dk[(head + j) * hd + d] = from_f<T>(dkr[r][c]);
        dv[(head + j) * hd + d] = from_f<T>(dvr[r][c]);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_query_pass(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const float* __restrict__ lse, const T* __restrict__ dout,
                     const float* __restrict__ delta, T* __restrict__ dq,
                     int L, int hd, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int hdp = hd + 1;
  const Layout lay = layout(hd, false);
  float* qs = reinterpret_cast<float*>(smem + lay.a);
  float* dos = reinterpret_cast<float*>(smem + lay.b);
  float* tiles = reinterpret_cast<float*>(smem + lay.tile);
  float* dss = reinterpret_cast<float*>(smem + lay.ds);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * kB;
  const size_t head = static_cast<size_t>(blockIdx.y) * L;

  // ---- 1. this block's Q and dO, fp32 [hd][kB]; its rows' lse and delta ---
  load_block(q + head * hd, dout + head * hd, q0, L, hd, qs, dos);
  const int qi = warp * kPerWarp;
  float ls[kPerWarp], dl[kPerWarp];
#pragma unroll
  for (int r = 0; r < kPerWarp; ++r) {
    const bool ok = q0 + qi + r < L;
    ls[r] = ok ? lse[head + q0 + qi + r] : 0.f;
    dl[r] = ok ? delta[head + q0 + qi + r] : 0.f;
  }

  // ---- 2. per tile of keys: s, dp, p and ds, then dq += ds k. In the first
  //         half warp w takes queries qi .. qi + 3 and lane takes keys
  //         lane + 32c; in the second lane takes features d. Each warp reads
  //         and writes only its own 4 columns of dss.
  float dqr[kPerWarp][kMaxHdCols];
#pragma unroll
  for (int r = 0; r < kPerWarp; ++r)
#pragma unroll
    for (int c = 0; c < kMaxHdCols; ++c) dqr[r][c] = 0.f;
  for_each_tile_pair<T>(k + head * hd, v + head * hd, L, hd, tiles,
                        [&](int t, const float* kt, const float* vt) {
    float sa[kPerWarp][kTileCols], pa[kPerWarp][kTileCols];
#pragma unroll
    for (int r = 0; r < kPerWarp; ++r)
#pragma unroll
      for (int c = 0; c < kTileCols; ++c) sa[r][c] = pa[r][c] = 0.f;
    for (int d = 0; d < hd; ++d) {
      const float4 qq = *reinterpret_cast<const float4*>(qs + d * kB + qi);
      const float4 g = *reinterpret_cast<const float4*>(dos + d * kB + qi);
#pragma unroll
      for (int c = 0; c < kTileCols; ++c) {
        const float kk = kt[(lane + 32 * c) * hdp + d];
        const float vv = vt[(lane + 32 * c) * hdp + d];
        sa[0][c] = fmaf(qq.x, kk, sa[0][c]);
        sa[1][c] = fmaf(qq.y, kk, sa[1][c]);
        sa[2][c] = fmaf(qq.z, kk, sa[2][c]);
        sa[3][c] = fmaf(qq.w, kk, sa[3][c]);
        pa[0][c] = fmaf(g.x, vv, pa[0][c]);
        pa[1][c] = fmaf(g.y, vv, pa[1][c]);
        pa[2][c] = fmaf(g.z, vv, pa[2][c]);
        pa[3][c] = fmaf(g.w, vv, pa[3][c]);
      }
    }
#pragma unroll
    for (int c = 0; c < kTileCols; ++c) {
      const int jl = 32 * c + lane;
      const bool key_ok = t * kTile + jl < L;
      float ds[kPerWarp];
#pragma unroll
      for (int r = 0; r < kPerWarp; ++r) {
        const bool valid = key_ok && q0 + qi + r < L;
        const float p = valid ? expf(__fmul_rn(sa[r][c], scale) - ls[r]) : 0.f;
        ds[r] = p * (pa[r][c] - dl[r]) * scale;
      }
      *reinterpret_cast<float4*>(dss + jl * kB + qi) = make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncwarp();
    for (int jl = 0; jl < kTile; ++jl) {
      const float4 ds = *reinterpret_cast<const float4*>(dss + jl * kB + qi);
      const float* krow = kt + jl * hdp + lane;
#pragma unroll
      for (int c = 0; c < kMaxHdCols; ++c) {
        if (lane + 32 * c < hd) {
          const float kk = krow[32 * c];
          dqr[0][c] = fmaf(ds.x, kk, dqr[0][c]);
          dqr[1][c] = fmaf(ds.y, kk, dqr[1][c]);
          dqr[2][c] = fmaf(ds.z, kk, dqr[2][c]);
          dqr[3][c] = fmaf(ds.w, kk, dqr[3][c]);
        }
      }
    }
  });
#pragma unroll
  for (int r = 0; r < kPerWarp; ++r) {
    const int i = q0 + qi + r;
    if (i >= L) continue;
#pragma unroll
    for (int c = 0; c < kMaxHdCols; ++c) {
      const int d = lane + 32 * c;
      if (d < hd) dq[(head + i) * hd + d] = from_f<T>(dqr[r][c]);
    }
  }
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

// the delta pass: delta = sum(do * o) per query row, from the stored o
template <typename T>
cudaError_t launch_delta(const void* o, const void* dout, float* delta, size_t rows, int hd,
                         cudaStream_t stream) {
  flash_bwd_delta<T><<<static_cast<unsigned>((rows + kWarps - 1) / kWarps), kThreads, 0,
                       stream>>>(static_cast<const T*>(o), static_cast<const T*>(dout), delta,
                                 rows, hd);
  return cudaGetLastError();
}

// fp32: the delta pass, then the FMA key and query passes
cudaError_t launch_fp32(const float* q, const float* k, const float* v, const float* o,
                        const float* lse, const float* dout, float* dq, float* dk, float* dv,
                        float* delta, int n, int l, int hd, float scale, cudaStream_t stream) {
  const size_t smem_k = layout(hd, true).total;
  const size_t smem_q = layout(hd, false).total;
  if (smem_k > kMaxSmem) return cudaErrorInvalidValue;
  static size_t configured_k[kMaxDevices] = {};
  static size_t configured_q[kMaxDevices] = {};
  cudaError_t err = allow_smem(flash_bwd_key_pass<float>, smem_k, configured_k);
  if (err != cudaSuccess) return err;
  err = allow_smem(flash_bwd_query_pass<float>, smem_q, configured_q);
  if (err != cudaSuccess) return err;
  err = launch_delta<float>(o, dout, delta, static_cast<size_t>(n) * l, hd, stream);
  if (err != cudaSuccess) return err;
  const dim3 grid((l + kB - 1) / kB, n);
  flash_bwd_key_pass<float><<<grid, kThreads, smem_k, stream>>>(q, k, v, lse, dout, delta, dk,
                                                                dv, l, hd, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_query_pass<float><<<grid, kThreads, smem_q, stream>>>(q, k, v, lse, dout, delta, dq,
                                                                  l, hd, scale);
  return cudaGetLastError();
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

// Bytes of dynamic shared memory the larger of the two kernels (the key
// kernel) needs per block for inputs of esize bytes, at any L: bf16 (2) the
// tensor-core kernels', fp32 the FMA passes' (operands widened to fp32).
size_t flash_bwd_smem_bytes(int hd, int esize) {
  return esize == 2 ? mma_bwd::key_smem_bytes(hd) : layout(hd, true).total;
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
