// Per-(sample, head) attention forward with a saved logsumexp, for Hopper
// (sm_90a).
//
// Replaces the Pallas kernel maskdit_tpu/ops/flash.py::_flash_fwd (body
// _fwd_kernel). From q, k, v, each (N*H, L, hd) contiguous, it writes o
// (N*H, L, hd) in the input type and lse (N*H, 1, L) in fp32. As in
// _fwd_kernel, p / l is rounded once, from each row's final max and sum:
// fp32 logits s = (q . k) * scale; row max m; p = exp(s - m); l = sum p;
// (p / l) rounded to the input type before the fp32-accumulated product with
// v; o stored in the input type; lse = m + log l in fp32.
//
// What bounds it: two L x L x hd products per head, 4 N H L^2 hd operations
// against ~(4 L hd) elements of traffic per head: at the 512-px shapes
// (L 512 at hd 72, L 1024 at hd 32) far above the card's balance, so the
// kernel is bound by arithmetic.
//
// bf16 (the main path) runs attention_fwd_mma.cuh's tensor-core kernel with
// the SeparateHeads layout: blocks of 64 queries, K and V streamed by
// cp.async, mma.sync products, two passes over the keys (m and l, then p / l
// rounded once and P.V). It takes three products instead of two, so it can
// reach at most 2/3 of the bound, and two expf per logit (2 N H L^2; at
// (32, 1024, 16, 32) ~0.29 ms of the MUFU units), which with the division
// bound it at hd 32. Shared memory 45,056 B at hd 72, 20,480 B at hd 32, at
// every L.
//
// fp32 (the parity path, held to 1e-5 of max|ref|: no TF32) keeps the first
// design, fp32 FMAs from shared memory:
//   * grid (ceil(L / BQ), N*H): one block per BQ queries of one head of one
//     sample; BQ is 32, or 16 where a (32, L) fp32 logits block would not
//     fit a block's shared memory (above L 1408 at hd 72; at L 2048 the 32
//     rows alone would take 256 KB of the 227 KB a block may have);
//   * the block keeps its (BQ, L) fp32 logits row block in shared memory,
//     what _fwd_kernel keeps as ``s``;
//   * K is streamed in tiles of 64 keys to fill it, then the fp32 softmax
//     runs over each complete row, then V is streamed in tiles of 64 keys
//     for the product. Each tile is fetched into registers with 16-byte
//     loads while the block computes on the previous one, and stored in
//     shared memory as [64][hd + 1] (rows padded to an odd number of words:
//     no bank conflicts).
// Shared memory: 114,176 B at L 512, hd 72 (two blocks per SM); 154,112 B at
// L 1024, hd 32; 175,104 B at L 2048, hd 72 with 16 rows.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "attention_fwd_mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;                // keys per streamed tile
constexpr int kTileCols = kTile / 32;    // 32-key columns per tile
constexpr int kMaxHd = 128;
constexpr int kMaxHdCols = kMaxHd / 32;
constexpr int kMaxDevices = 64;
constexpr size_t kMaxSmem = 232448;      // a block's limit on sm_90

// R consecutive fp32 values of shared memory (R = 4 or 2), one vector load
template <int R> struct Rows;
template <> struct Rows<4> {
  __device__ __forceinline__ static void load(const float* p, float* r) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    r[0] = x.x; r[1] = x.y; r[2] = x.z; r[3] = x.w;
  }
  __device__ __forceinline__ static void store(float* p, const float* r) {
    *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
  }
};
template <> struct Rows<2> {
  __device__ __forceinline__ static void load(const float* p, float* r) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    r[0] = x.x; r[1] = x.y;
  }
  __device__ __forceinline__ static void store(float* p, const float* r) {
    *reinterpret_cast<float2*>(p) = make_float2(r[0], r[1]);
  }
};

__host__ __device__ __forceinline__ size_t align16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

struct SmemLayout {
  size_t q, s, tile, red, total;
};

// Shared memory of one fp32 block of bq queries, in bytes, for keys padded
// to lp (a multiple of kTile): q [hd][bq]; logits [lp][bq]; two
// [kTile][hd + 1] tiles; two [kThreads] reductions.
__host__ __device__ __forceinline__ SmemLayout smem_layout(int lp, int hd, int bq) {
  const size_t hdp = hd + 1;
  SmemLayout m;
  m.q = 0;
  m.s = align16(static_cast<size_t>(hd) * bq * 4);
  m.tile = align16(m.s + static_cast<size_t>(lp) * bq * 4);
  m.red = align16(m.tile + 2 * kTile * hdp * 4);
  m.total = m.red + 2 * kThreads * 4;
  return m;
}

// kTile rows of one head's K or V, fetched from device memory into
// registers with 16-byte loads, then stored in shared memory as
// [kTile][hd + 1]. Rows at or past L are zero, so padded keys carry no NaNs
// into 0 * v.
struct TileFetch {
  static constexpr int kVec = 4;
  static constexpr int kMaxVecs = kTile * kMaxHd / kVec / kThreads;
  uint4 regs[kMaxVecs];

  // rows r0 .. r0 + kTile - 1 of a row-major (L, hd) matrix at base
  __device__ __forceinline__ void fetch(const float* base, int r0, int L, int hd) {
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
        float* dst = tile + j * hdp + (idx - j * nv) * kVec;
        dst[0] = __uint_as_float(regs[u].x);
        dst[1] = __uint_as_float(regs[u].y);
        dst[2] = __uint_as_float(regs[u].z);
        dst[3] = __uint_as_float(regs[u].w);
      }
    }
  }
};

// Run body(t, tile) over the ceil(L / kTile) tiles of rows of the (L, hd)
// matrix at base, double-buffered (2 x [kTile][hd + 1] fp32): tile t + 1 is
// in flight while the block computes on tile t. Ends synchronised; the body
// must not synchronise the block itself.
template <typename Body>
__device__ __forceinline__ void for_each_tile(const float* base, int L, int hd, float* tiles,
                                              Body body) {
  const int ntiles = (L + kTile - 1) / kTile;
  const int tile_elems = kTile * (hd + 1);
  TileFetch f;
  f.fetch(base, 0, L, hd);
  f.store(tiles, hd);
  __syncthreads();
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) f.fetch(base, (t + 1) * kTile, L, hd);
    body(t, static_cast<const float*>(tiles + (t & 1) * tile_elems));
    if (t + 1 < ntiles) f.store(tiles + ((t + 1) & 1) * tile_elems, hd);
    __syncthreads();
  }
}

template <int BQ>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, float* __restrict__ lse,
                 int L, int hd, float scale) {
  constexpr int kQPerWarp = BQ / kWarps;   // 4 or 2 queries per warp
  constexpr int kParts = kThreads / BQ;    // key strides of the softmax
  extern __shared__ __align__(16) unsigned char smem[];
  const int lp = (L + kTile - 1) / kTile * kTile;
  const int hdp = hd + 1;
  const SmemLayout lay = smem_layout(lp, hd, BQ);
  float* qs = reinterpret_cast<float*>(smem + lay.q);
  float* ss = reinterpret_cast<float*>(smem + lay.s);
  float* tiles = reinterpret_cast<float*>(smem + lay.tile);
  float* red_max = reinterpret_cast<float*>(smem + lay.red);
  float* red_sum = red_max + kThreads;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * BQ;
  const size_t head = static_cast<size_t>(blockIdx.y) * L;  // first row of this head

  // ---- 1. this block's queries, [hd][BQ], zero past L ---------------------
  for (int idx = tid; idx < BQ * hd; idx += kThreads) {
    const int i = idx / hd;
    const int d = idx - i * hd;
    qs[d * BQ + i] = q0 + i < L ? q[(head + q0 + i) * hd + d] : 0.f;
  }
  // (for_each_tile synchronises before its first body)

  // ---- 2. logits, streaming K: warp w takes queries qi .. qi + kQPerWarp - 1,
  //         lane takes keys lane + 32c of each tile --------------------------
  const int qi = warp * kQPerWarp;
  for_each_tile(k + head * hd, L, hd, tiles, [&](int t, const float* kt) {
    float acc[kQPerWarp][kTileCols];
#pragma unroll
    for (int r = 0; r < kQPerWarp; ++r)
#pragma unroll
      for (int c = 0; c < kTileCols; ++c) acc[r][c] = 0.f;
    for (int d = 0; d < hd; ++d) {
      float qv[kQPerWarp];
      Rows<kQPerWarp>::load(qs + d * BQ + qi, qv);
#pragma unroll
      for (int c = 0; c < kTileCols; ++c) {
        const float kv = kt[(lane + 32 * c) * hdp + d];
#pragma unroll
        for (int r = 0; r < kQPerWarp; ++r) acc[r][c] = fmaf(qv[r], kv, acc[r][c]);
      }
    }
#pragma unroll
    for (int c = 0; c < kTileCols; ++c) {
      const int j = t * kTile + 32 * c + lane;
      const bool valid = j < L;
      float s[kQPerWarp];
#pragma unroll
      for (int r = 0; r < kQPerWarp; ++r) s[r] = valid ? acc[r][c] * scale : -INFINITY;
      Rows<kQPerWarp>::store(ss + j * BQ + qi, s);
    }
  });

  // ---- 3. fp32 softmax over each complete row: thread tid takes query
  //         tid % BQ and every kParts-th key from tid / BQ -----------------
  {
    const int i = tid % BQ;
    const int part = tid / BQ;
    float m = -INFINITY;
    for (int j = part; j < lp; j += kParts) m = fmaxf(m, ss[j * BQ + i]);
    red_max[part * BQ + i] = m;
    __syncthreads();
    m = red_max[i];
    for (int w = 1; w < kParts; ++w) m = fmaxf(m, red_max[w * BQ + i]);
    float l = 0.f;
    for (int j = part; j < lp; j += kParts) {
      const float e = expf(ss[j * BQ + i] - m);
      ss[j * BQ + i] = e;
      l += e;
    }
    red_sum[part * BQ + i] = l;
    __syncthreads();
    l = 0.f;
    for (int w = 0; w < kParts; ++w) l += red_sum[w * BQ + i];
    // p / l (flash.py:41; rounding to fp32 is the identity)
    for (int j = part; j < lp; j += kParts) ss[j * BQ + i] /= l;
    if (part == 0 && q0 + i < L) lse[head + q0 + i] = m + logf(l);
  }
  // (for_each_tile synchronises before its first body)

  // ---- 4. o = p v, streaming V: warp w keeps its queries, lane takes
  //         features d = lane + 32c -------------------------------------------
  float o[kQPerWarp][kMaxHdCols];
#pragma unroll
  for (int r = 0; r < kQPerWarp; ++r)
#pragma unroll
    for (int c = 0; c < kMaxHdCols; ++c) o[r][c] = 0.f;
  for_each_tile(v + head * hd, L, hd, tiles, [&](int t, const float* vt) {
    for (int j = 0; j < kTile; ++j) {
      float p[kQPerWarp];
      Rows<kQPerWarp>::load(ss + (t * kTile + j) * BQ + qi, p);
      const float* vrow = vt + j * hdp + lane;
#pragma unroll
      for (int c = 0; c < kMaxHdCols; ++c) {
        if (lane + 32 * c < hd) {
          const float vv = vrow[32 * c];
#pragma unroll
          for (int r = 0; r < kQPerWarp; ++r) o[r][c] = fmaf(p[r], vv, o[r][c]);
        }
      }
    }
  });
#pragma unroll
  for (int r = 0; r < kQPerWarp; ++r) {
    const int i = q0 + qi + r;
    if (i >= L) continue;
#pragma unroll
    for (int c = 0; c < kMaxHdCols; ++c) {
      const int d = lane + 32 * c;
      if (d < hd) out[(head + i) * hd + d] = o[r][c];
    }
  }
}

// Queries per fp32 block at (lp, hd): 32 where that layout fits, else 16,
// else 0.
__host__ __forceinline__ int block_rows(int lp, int hd) {
  if (smem_layout(lp, hd, 32).total <= kMaxSmem) return 32;
  if (smem_layout(lp, hd, 16).total <= kMaxSmem) return 16;
  return 0;
}

template <int BQ>
cudaError_t launch_rows(const float* q, const float* k, const float* v, float* out, float* lse,
                        int n, int l, int hd, float scale, cudaStream_t stream) {
  const int lp = (l + kTile - 1) / kTile * kTile;
  const size_t smem = smem_layout(lp, hd, BQ).total;
  // raise the kernel's dynamic shared-memory limit (48 KB by default) on
  // this device to the largest size asked for so far
  static size_t configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem > configured[dev]) {
    err = cudaFuncSetAttribute(flash_fwd_kernel<BQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    configured[dev] = smem;
  }
  const dim3 grid((l + BQ - 1) / BQ, n);
  flash_fwd_kernel<BQ><<<grid, kThreads, smem, stream>>>(q, k, v, out, lse, l, hd, scale);
  return cudaGetLastError();
}

cudaError_t launch_fp32(const void* q, const void* k, const void* v, void* out, float* lse,
                        int n, int l, int hd, float scale, cudaStream_t stream) {
  const float *fq = static_cast<const float*>(q), *fk = static_cast<const float*>(k),
              *fv = static_cast<const float*>(v);
  float* fo = static_cast<float*>(out);
  switch (block_rows((l + kTile - 1) / kTile * kTile, hd)) {
    case 32:
      return launch_rows<32>(fq, fk, fv, fo, lse, n, l, hd, scale, stream);
    case 16:
      return launch_rows<16>(fq, fk, fv, fo, lse, n, l, hd, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// Bytes of dynamic shared memory of one block: for bf16 (esize 2) the
// tensor-core kernel's, the same at every l and rows; for fp32 (esize 4)
// that of a block of `rows` queries.
size_t flash_fwd_smem_bytes(int l, int hd, int rows, int esize) {
  if (esize == 2) return attention_fwd_mma::smem_bytes(hd);
  return smem_layout((l + kTile - 1) / kTile * kTile, hd, rows).total;
}

// dtype: 0 = bfloat16, 1 = float32. q, k, v and out are (n, l, hd)
// contiguous and 16-byte aligned, lse (n, l) fp32, all on the current
// device; hd a multiple of 8, at most 128. Returns the cudaError_t of the
// launch (0 on success).
int flash_fwd(const void* q, const void* k, const void* v, void* out, void* lse, int n, int l,
              int hd, float scale, int dtype, void* stream) {
  if (n <= 0 || l <= 0 || hd <= 0 || hd > kMaxHd || hd % 8 != 0 || n > 65535 ||
      !aligned16(q) || !aligned16(k) || !aligned16(v))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ls = static_cast<float*>(lse);
  switch (dtype) {
    case 0: {
      using attention_fwd_mma::bf16;
      const attention_fwd_mma::SeparateHeads layout{
          static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
          static_cast<bf16*>(out), ls, n};
      return static_cast<int>(attention_fwd_mma::launch(layout, l, hd, scale, s));
    }
    case 1:
      return static_cast<int>(launch_fp32(q, k, v, out, ls, n, l, hd, scale, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* flash_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
