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
// What bounds it: six L x L x hd products per head (s, o, dv, dp, dq, dk;
// eight here, with the key pass's recomputed s and dp), 12-16 N H L^2 hd
// operations against ~(10 L hd) bytes per head: bound by arithmetic, done
// with fp32 FMAs from shared memory as in the forward; wgmma is later work.
//
// The design keeps the deterministic two-pass structure of
// packed_attention_bwd.cu (the TPU kernel's sequential sum over query
// chunks becomes a second pass, not atomics), with K, V, Q and dO streamed
// in tiles of 64 rows because one head's operands at L 1024 do not fit a
// block's shared memory:
//   * query pass, grid (ceil(L/32), H, N): the block keeps its (32, L) fp32
//     row block in shared memory; it streams K to form the logits and the
//     softmax p, V to recompute o and delta, V again for dp and ds (rounded,
//     in place of p), and K again for dq. It writes each row's max, sum and
//     delta to an fp32 (3, N, H, L) scratch that the wrapper allocates;
//   * key pass, grid (ceil(L/32), H, N): the block keeps its 32 keys' K and
//     V and streams Q and dO tiles; per tile it recomputes p from the saved
//     row statistics, dp and ds, and adds pb^T do to dv and ds^T q to dk.
// Both passes form each logit and each dp with the same FMA chain, and the
// scale multiply is pinned (__fmul_rn), so the key pass's p and ds are bit
// for bit the query pass's. Tiles are fetched into registers with 16-byte
// loads while the block computes on the previous tile, and widened into
// shared memory as fp32 [64][hd + 1] (an odd row stride: no bank conflicts).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kB = 32;                  // queries (query pass) or keys (key pass) per block
constexpr int kPerWarp = kB / kWarps;   // 4: one float4 of a row's values
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

// x rounded to T and widened back
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
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

// Query pass: q, do fp32 [hd][kB]; the row block fp32 [lp][kB]; two tiles;
// two fp32 [kWarps][kB] reductions.
struct QueryLayout {
  size_t q, dout, s, tile, red, total;
};

__host__ __device__ __forceinline__ QueryLayout query_layout(int lp, int hd) {
  QueryLayout m;
  m.q = 0;
  m.dout = align16(static_cast<size_t>(hd) * kB * 4);
  m.s = align16(m.dout + static_cast<size_t>(hd) * kB * 4);
  m.tile = align16(m.s + static_cast<size_t>(lp) * kB * 4);
  m.red = align16(m.tile + 2 * tile_bytes(hd));
  m.total = m.red + 2 * kWarps * kB * 4;
  return m;
}

// Key pass: k, v fp32 [hd][kB]; two buffers of a Q tile and a dO tile;
// pb, ds fp32 [kTile][kB]. Independent of L.
struct KeyLayout {
  size_t k, v, tile, pb, ds, total;
};

__host__ __device__ __forceinline__ KeyLayout key_layout(int hd) {
  KeyLayout m;
  m.k = 0;
  m.v = align16(static_cast<size_t>(hd) * kB * 4);
  m.tile = align16(m.v + static_cast<size_t>(hd) * kB * 4);
  m.pb = align16(m.tile + 4 * tile_bytes(hd));
  m.ds = align16(m.pb + static_cast<size_t>(kTile) * kB * 4);
  m.total = m.ds + static_cast<size_t>(kTile) * kB * 4;
  return m;
}

// kTile rows of one head's K, V, Q or dO, fetched from device memory into
// registers with 16-byte loads, then widened into shared memory as fp32
// [kTile][hd + 1]. Rows at or past L are zero.
template <typename T>
struct TileFetch {
  static constexpr int kVec = Vec<T>::kN;
  static constexpr int kMaxVecs = kTile * kMaxHd / kVec / kThreads;
  uint4 regs[kMaxVecs];

  // rows r0 .. r0 + kTile - 1 of a matrix whose row r starts at base + r * stride
  __device__ __forceinline__ void fetch(const T* base, size_t stride, int r0, int L, int hd) {
    const int nv = hd / kVec;
#pragma unroll
    for (int u = 0; u < kMaxVecs; ++u) {
      const int idx = threadIdx.x + u * kThreads;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (idx < kTile * nv) {
        const int j = idx / nv;
        if (r0 + j < L)
          x = __ldg(reinterpret_cast<const uint4*>(
              base + static_cast<size_t>(r0 + j) * stride + (idx - j * nv) * kVec));
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

// Run body(t, tile) over the ceil(L / kTile) tiles of rows of the matrix at
// base, double-buffered (2 x [kTile][hd + 1] fp32 at tiles): tile t + 1 is
// in flight while the block computes on tile t. Ends synchronised; the body
// must not synchronise the block itself.
template <typename T, typename Body>
__device__ __forceinline__ void for_each_tile(const T* base, size_t stride, int L, int hd,
                                              float* tiles, Body body) {
  const int ntiles = (L + kTile - 1) / kTile;
  const int te = kTile * (hd + 1);
  TileFetch<T> f;
  f.fetch(base, stride, 0, L, hd);
  f.store(tiles, hd);
  __syncthreads();
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) f.fetch(base, stride, (t + 1) * kTile, L, hd);
    body(t, static_cast<const float*>(tiles + (t & 1) * te));
    if (t + 1 < ntiles) f.store(tiles + ((t + 1) & 1) * te, hd);
    __syncthreads();
  }
}

// The same over two matrices with the same rows (Q and dO): buffer b holds
// a tile of a at tiles + 2b * te and one of b at tiles + (2b + 1) * te.
template <typename T, typename Body>
__device__ __forceinline__ void for_each_tile_pair(const T* a, size_t stride_a, const T* b,
                                                   size_t stride_b, int L, int hd,
                                                   float* tiles, Body body) {
  const int ntiles = (L + kTile - 1) / kTile;
  const int te = kTile * (hd + 1);
  TileFetch<T> fa, fb;
  fa.fetch(a, stride_a, 0, L, hd);
  fb.fetch(b, stride_b, 0, L, hd);
  fa.store(tiles, hd);
  fb.store(tiles + te, hd);
  __syncthreads();
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {
      fa.fetch(a, stride_a, (t + 1) * kTile, L, hd);
      fb.fetch(b, stride_b, (t + 1) * kTile, L, hd);
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
big_bwd_query_pass(const T* __restrict__ qkv, const T* __restrict__ dout,
                   T* __restrict__ dqkv, float* __restrict__ stats,
                   int L, int H, int hd, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lp = (L + kTile - 1) / kTile * kTile;
  const int hdp = hd + 1;
  const QueryLayout lay = query_layout(lp, hd);
  float* qs = reinterpret_cast<float*>(smem + lay.q);
  float* dos = reinterpret_cast<float*>(smem + lay.dout);
  float* ss = reinterpret_cast<float*>(smem + lay.s);
  float* tiles = reinterpret_cast<float*>(smem + lay.tile);
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

  // ---- 1. this block's Q and dO, fp32 [hd][kB], zero past L --------------
  for (int idx = tid; idx < kB * hd; idx += kThreads) {
    const int i = idx / hd;
    const int d = idx - i * hd;
    const bool ok = q0 + i < L;
    qs[d * kB + i] = ok ? to_f(head[static_cast<size_t>(q0 + i) * row + d]) : 0.f;
    dos[d * kB + i] = ok ? to_f(dhead[static_cast<size_t>(q0 + i) * D + d]) : 0.f;
  }

  // ---- 2. logits, streaming K: warp w takes rows 4w..4w+3, lane takes keys
  //         lane + 32c of each tile ------------------------------------------
  const int qi = warp * kPerWarp;
  for_each_tile<T>(head + D, row, L, hd, tiles, [&](int t, const float* kt) {
    float acc[kPerWarp][kTileCols];
#pragma unroll
    for (int r = 0; r < kPerWarp; ++r)
#pragma unroll
      for (int c = 0; c < kTileCols; ++c) acc[r][c] = 0.f;
    for (int d = 0; d < hd; ++d) {
      const float4 q = *reinterpret_cast<const float4*>(qs + d * kB + qi);
#pragma unroll
      for (int c = 0; c < kTileCols; ++c) {
        const float k = kt[(lane + 32 * c) * hdp + d];
        acc[0][c] = fmaf(q.x, k, acc[0][c]);
        acc[1][c] = fmaf(q.y, k, acc[1][c]);
        acc[2][c] = fmaf(q.z, k, acc[2][c]);
        acc[3][c] = fmaf(q.w, k, acc[3][c]);
      }
    }
#pragma unroll
    for (int c = 0; c < kTileCols; ++c) {
      const int j = t * kTile + 32 * c + lane;
      const bool valid = j < L;
      float4 s;
      s.x = valid ? __fmul_rn(acc[0][c], scale) : -INFINITY;
      s.y = valid ? __fmul_rn(acc[1][c], scale) : -INFINITY;
      s.z = valid ? __fmul_rn(acc[2][c], scale) : -INFINITY;
      s.w = valid ? __fmul_rn(acc[3][c], scale) : -INFINITY;
      *reinterpret_cast<float4*>(ss + j * kB + qi) = s;
    }
  });

  // ---- 3. fp32 softmax over each complete row (lane = row); p stays fp32 --
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
  // From here on each warp reads and writes only its own 4 rows of ss.

  // ---- 4. o = pb v in fp32, streaming V, and delta = sum_d do o -----------
  float delta[kPerWarp];
  {
    float o[kPerWarp][kMaxHdCols];
#pragma unroll
    for (int r = 0; r < kPerWarp; ++r)
#pragma unroll
      for (int c = 0; c < kMaxHdCols; ++c) o[r][c] = 0.f;
    for_each_tile<T>(head + 2 * D, row, L, hd, tiles, [&](int t, const float* vt) {
      for (int j = 0; j < kTile; ++j) {
        const float4 p = *reinterpret_cast<const float4*>(ss + (t * kTile + j) * kB + qi);
        const float pb[kPerWarp] = {round_to<T>(p.x), round_to<T>(p.y),
                                    round_to<T>(p.z), round_to<T>(p.w)};
        const float* vrow = vt + j * hdp + lane;
#pragma unroll
        for (int c = 0; c < kMaxHdCols; ++c) {
          if (lane + 32 * c < hd) {
            const float v = vrow[32 * c];
#pragma unroll
            for (int r = 0; r < kPerWarp; ++r) o[r][c] = fmaf(pb[r], v, o[r][c]);
          }
        }
      }
    });
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

  // ---- 5. dp = do v^T, streaming V again; ds = p (dp - delta) scale,
  //         rounded, in place of p -------------------------------------------
  for_each_tile<T>(head + 2 * D, row, L, hd, tiles, [&](int t, const float* vt) {
    float acc[kPerWarp][kTileCols];
#pragma unroll
    for (int r = 0; r < kPerWarp; ++r)
#pragma unroll
      for (int c = 0; c < kTileCols; ++c) acc[r][c] = 0.f;
    for (int d = 0; d < hd; ++d) {
      const float4 g = *reinterpret_cast<const float4*>(dos + d * kB + qi);
#pragma unroll
      for (int c = 0; c < kTileCols; ++c) {
        const float v = vt[(lane + 32 * c) * hdp + d];
        acc[0][c] = fmaf(g.x, v, acc[0][c]);
        acc[1][c] = fmaf(g.y, v, acc[1][c]);
        acc[2][c] = fmaf(g.z, v, acc[2][c]);
        acc[3][c] = fmaf(g.w, v, acc[3][c]);
      }
    }
#pragma unroll
    for (int c = 0; c < kTileCols; ++c) {
      float4* slot = reinterpret_cast<float4*>(ss + (t * kTile + 32 * c + lane) * kB + qi);
      const float4 p = *slot;
      float4 ds;
      ds.x = round_to<T>(p.x * (acc[0][c] - delta[0]) * scale);
      ds.y = round_to<T>(p.y * (acc[1][c] - delta[1]) * scale);
      ds.z = round_to<T>(p.z * (acc[2][c] - delta[2]) * scale);
      ds.w = round_to<T>(p.w * (acc[3][c] - delta[3]) * scale);
      *slot = ds;
    }
  });

  // ---- 6. dq = ds k, streaming K again: lane takes features d ---------------
  float dq[kPerWarp][kMaxHdCols];
#pragma unroll
  for (int r = 0; r < kPerWarp; ++r)
#pragma unroll
    for (int c = 0; c < kMaxHdCols; ++c) dq[r][c] = 0.f;
  for_each_tile<T>(head + D, row, L, hd, tiles, [&](int t, const float* kt) {
    for (int j = 0; j < kTile; ++j) {
      const float4 s = *reinterpret_cast<const float4*>(ss + (t * kTile + j) * kB + qi);
      const float* krow = kt + j * hdp + lane;
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
  });
  T* dbase = dqkv + static_cast<size_t>(n) * L * row + static_cast<size_t>(h) * hd;
#pragma unroll
  for (int r = 0; r < kPerWarp; ++r) {
    const int i = q0 + qi + r;
    if (i >= L) continue;
#pragma unroll
    for (int c = 0; c < kMaxHdCols; ++c) {
      const int d = lane + 32 * c;
      if (d < hd) dbase[static_cast<size_t>(i) * row + d] = from_f<T>(dq[r][c]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
big_bwd_key_pass(const T* __restrict__ qkv, const T* __restrict__ dout,
                 T* __restrict__ dqkv, const float* __restrict__ stats,
                 int L, int H, int hd, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int hdp = hd + 1;
  const KeyLayout lay = key_layout(hd);
  float* kT = reinterpret_cast<float*>(smem + lay.k);
  float* vT = reinterpret_cast<float*>(smem + lay.v);
  float* tiles = reinterpret_cast<float*>(smem + lay.tile);
  float* pbs = reinterpret_cast<float*>(smem + lay.pb);
  float* dss = reinterpret_cast<float*>(smem + lay.ds);

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

  // ---- 1. this block's K and V, fp32 [hd][kB], zero past L ----------------
  for (int idx = tid; idx < kB * hd; idx += kThreads) {
    const int j = idx / hd;
    const int d = idx - j * hd;
    const bool ok = k0 + j < L;
    const T* src = head + static_cast<size_t>(k0 + j) * row + d;
    kT[d * kB + j] = ok ? to_f(src[D]) : 0.f;
    vT[d * kB + j] = ok ? to_f(src[2 * D]) : 0.f;
  }

  // ---- 2. per tile of queries: s, p, dp, pb and ds, then dv += pb^T do and
  //         dk += ds^T q. In the first half warp w takes keys 4w..4w+3 and
  //         lane takes queries lane + 32c; in the second lane takes features
  //         d. Each warp reads and writes only its own 4 columns of pbs, dss.
  const int kj = warp * kPerWarp;
  float dk[kPerWarp][kMaxHdCols], dv[kPerWarp][kMaxHdCols];
#pragma unroll
  for (int r = 0; r < kPerWarp; ++r)
#pragma unroll
    for (int c = 0; c < kMaxHdCols; ++c) dk[r][c] = dv[r][c] = 0.f;
  for_each_tile_pair<T>(head, row, dhead, D, L, hd, tiles,
                        [&](int t, const float* qt, const float* gt) {
    float sa[kPerWarp][kTileCols], pa[kPerWarp][kTileCols];
#pragma unroll
    for (int r = 0; r < kPerWarp; ++r)
#pragma unroll
      for (int c = 0; c < kTileCols; ++c) sa[r][c] = pa[r][c] = 0.f;
    for (int d = 0; d < hd; ++d) {
      const float4 k = *reinterpret_cast<const float4*>(kT + d * kB + kj);
      const float4 v = *reinterpret_cast<const float4*>(vT + d * kB + kj);
#pragma unroll
      for (int c = 0; c < kTileCols; ++c) {
        // the same operand order as the query pass, so the same bits
        const float q = qt[(lane + 32 * c) * hdp + d];
        const float g = gt[(lane + 32 * c) * hdp + d];
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
#pragma unroll
    for (int c = 0; c < kTileCols; ++c) {
      const int il = 32 * c + lane;
      const int i = t * kTile + il;
      const bool row_ok = i < L;
      const float m = row_ok ? st[i] : 0.f;
      const float l = row_ok ? st[plane + i] : 1.f;
      const float dl = row_ok ? st[2 * plane + i] : 0.f;
      float pb[kPerWarp], ds[kPerWarp];
#pragma unroll
      for (int r = 0; r < kPerWarp; ++r) {
        const bool valid = row_ok && k0 + kj + r < L;
        // __fmul_rn: no FMA contraction of the scale into "- m", so the
        // logit is the query pass's
        const float p = valid ? expf(__fmul_rn(sa[r][c], scale) - m) / l : 0.f;
        pb[r] = round_to<T>(p);
        ds[r] = round_to<T>(p * (pa[r][c] - dl) * scale);
      }
      *reinterpret_cast<float4*>(pbs + il * kB + kj) = make_float4(pb[0], pb[1], pb[2], pb[3]);
      *reinterpret_cast<float4*>(dss + il * kB + kj) = make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncwarp();
    for (int il = 0; il < kTile; ++il) {
      const float4 pb = *reinterpret_cast<const float4*>(pbs + il * kB + kj);
      const float4 ds = *reinterpret_cast<const float4*>(dss + il * kB + kj);
      const float* qrow = qt + il * hdp + lane;
      const float* grow = gt + il * hdp + lane;
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
  });
  T* dbase = dqkv + static_cast<size_t>(n) * L * row + static_cast<size_t>(h) * hd;
#pragma unroll
  for (int r = 0; r < kPerWarp; ++r) {
    const int j = k0 + kj + r;
    if (j >= L) continue;
#pragma unroll
    for (int c = 0; c < kMaxHdCols; ++c) {
      const int d = lane + 32 * c;
      if (d < hd) {
        dbase[static_cast<size_t>(j) * row + D + d] = from_f<T>(dk[r][c]);
        dbase[static_cast<size_t>(j) * row + 2 * D + d] = from_f<T>(dv[r][c]);
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
  const int lp = (l + kTile - 1) / kTile * kTile;
  const size_t smem_q = query_layout(lp, hd).total;
  const size_t smem_k = key_layout(hd).total;
  if (smem_q > kMaxSmem || smem_k > kMaxSmem) return cudaErrorInvalidValue;
  static size_t configured_q[kMaxDevices] = {};
  static size_t configured_k[kMaxDevices] = {};
  cudaError_t err = allow_smem(big_bwd_query_pass<T>, smem_q, configured_q);
  if (err != cudaSuccess) return err;
  err = allow_smem(big_bwd_key_pass<T>, smem_k, configured_k);
  if (err != cudaSuccess) return err;
  const dim3 grid((l + kB - 1) / kB, heads, n);
  big_bwd_query_pass<T><<<grid, kThreads, smem_q, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(dout), static_cast<T*>(dqkv),
      stats, l, heads, hd, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  big_bwd_key_pass<T><<<grid, kThreads, smem_k, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(dout), static_cast<T*>(dqkv),
      stats, l, heads, hd, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory the larger of the two passes needs per
// block (the same for bf16 and fp32: operands are widened to fp32).
size_t packed_attention_big_bwd_smem_bytes(int l, int hd) {
  const size_t q = query_layout((l + kTile - 1) / kTile * kTile, hd).total;
  const size_t k = key_layout(hd).total;
  return q > k ? q : k;
}

// dtype: 0 = bfloat16, 1 = float32. qkv (n, l, 3*heads*hd), dout
// (n, l, heads*hd) and dqkv (n, l, 3*heads*hd) are contiguous in dtype, qkv
// and dout 16-byte aligned; stats is fp32 scratch of 3*n*heads*l; all on the
// current device; hd a multiple of 8, at most 128. Launches both passes on
// the stream and returns the cudaError_t (0 on success).
int packed_attention_big_bwd(const void* qkv, const void* dout, void* dqkv, void* stats,
                             int n, int l, int heads, int hd, float scale, int dtype,
                             void* stream) {
  if (n <= 0 || l <= 0 || heads <= 0 || hd <= 0 || hd > kMaxHd || hd % 8 != 0 ||
      n > 65535 || heads > 65535 || reinterpret_cast<uintptr_t>(qkv) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(dout) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* st = static_cast<float*>(stats);
  switch (dtype) {
    case 0:
      return static_cast<int>(
          launch<__nv_bfloat16>(qkv, dout, dqkv, st, n, l, heads, hd, scale, s));
    case 1:
      return static_cast<int>(launch<float>(qkv, dout, dqkv, st, n, l, heads, hd, scale, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* packed_attention_big_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
