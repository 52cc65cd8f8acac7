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
// What bounds it: five L x L x hd products per head (s, dv, dp, dq, dk;
// seven here, with s and dp formed in both passes), 10-14 N H L^2 hd
// operations against ~(10 L hd) elements of traffic per head: bound by
// arithmetic, done with fp32 FMAs from shared memory as in the forward;
// tensor cores are later work.
//
// The design. The TPU kernel holds a whole (L, L) probability block per head
// in VMEM. Given lse, p can be formed tile by tile, so no block of logits
// rows is needed and shared memory does not grow with L. Three launches,
// deterministic, without atomics:
//   * delta pass: one warp per query row, delta = sum_d do o in fp32, into
//     an fp32 (N*H, L) scratch that the wrapper allocates;
//   * key pass, grid (ceil(L/32), N*H): the block keeps its 32 keys' K and V
//     (fp32 [hd][32]) and streams Q and dO in tiles of 64 rows; per tile it
//     forms s and dp, p and ds, then adds p^T do to dv and ds^T q to dk in
//     registers; each is stored once;
//   * query pass, grid (ceil(L/32), N*H): the block keeps its 32 queries' Q
//     and dO and streams K and V in tiles of 64 keys; per tile it forms s,
//     dp, p and ds, then adds ds k to dq.
// Both passes form each logit and each dp with the same FMA chain over the
// head dim, and multiply by the scale after the dot product (flash.py:57-59)
// with a pinned multiply (__fmul_rn), so p and ds are bit for bit the same
// in both. Tiles are fetched into registers with 16-byte loads while the
// block computes on the previous tile, and widened into shared memory as
// fp32 [64][hd + 1] (an odd row stride: no bank conflicts).
// Shared memory (key pass; the query pass has 8 KB less): 109,568 B at hd 72,
// 58,368 B at hd 32, at every L.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

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
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

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
template <> struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void widen(const uint4& x, float* f) {
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
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
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const float* lse,
                   const void* dout, void* dq, void* dk, void* dv, float* delta, int n, int l,
                   int hd, float scale, cudaStream_t stream) {
  const size_t smem_k = layout(hd, true).total;
  const size_t smem_q = layout(hd, false).total;
  if (smem_k > kMaxSmem) return cudaErrorInvalidValue;
  static size_t configured_k[kMaxDevices] = {};
  static size_t configured_q[kMaxDevices] = {};
  cudaError_t err = allow_smem(flash_bwd_key_pass<T>, smem_k, configured_k);
  if (err != cudaSuccess) return err;
  err = allow_smem(flash_bwd_query_pass<T>, smem_q, configured_q);
  if (err != cudaSuccess) return err;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(dout);
  const size_t rows = static_cast<size_t>(n) * l;
  flash_bwd_delta<T><<<static_cast<unsigned>((rows + kWarps - 1) / kWarps), kThreads, 0,
                       stream>>>(static_cast<const T*>(o), gt, delta, rows, hd);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid((l + kB - 1) / kB, n);
  flash_bwd_key_pass<T><<<grid, kThreads, smem_k, stream>>>(
      qt, kt, vt, lse, gt, delta, static_cast<T*>(dk), static_cast<T*>(dv), l, hd, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_query_pass<T><<<grid, kThreads, smem_q, stream>>>(
      qt, kt, vt, lse, gt, delta, static_cast<T*>(dq), l, hd, scale);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// Bytes of dynamic shared memory the larger of the two passes (the key
// pass) needs per block, at any L (the same for bf16 and fp32: operands are
// widened to fp32).
size_t flash_bwd_smem_bytes(int hd) { return layout(hd, true).total; }

// dtype: 0 = bfloat16, 1 = float32. q, k, v, o, dout, dq, dk and dv are
// (n, l, hd) contiguous in dtype, q, k, v and dout 16-byte aligned; lse is
// (n, l) fp32 and delta fp32 scratch of n * l; all on the current device;
// hd a multiple of 8, at most 128. Launches the three passes on the stream
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
      return static_cast<int>(launch<__nv_bfloat16>(q, k, v, o, ls, dout, dq, dk, dv, dl, n, l,
                                                    hd, scale, s));
    case 1:
      return static_cast<int>(
          launch<float>(q, k, v, o, ls, dout, dq, dk, dv, dl, n, l, hd, scale, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
