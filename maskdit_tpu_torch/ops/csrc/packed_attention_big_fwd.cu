// Blocked packed multi-head attention forward for Hopper (sm_90a), L >= 512.
//
// Replaces the Pallas kernel maskdit_tpu/ops/flash_big.py::_big_fwd (body
// _fwd_kernel). It reads the packed qkv Dense output (N, L, 3D) in place and
// writes (N, L, D): head h reads q at features [h*hd, (h+1)*hd), k at
// [D + h*hd, ...) and v at [2D + h*hd, ...) of each row. As in _fwd_kernel,
// each softmax row completes in one pass over all keys (no online-softmax
// rescaling): fp32 logits and softmax, p / denom rounded to the input type
// before the product with v (flash_big.py:112-115), the product accumulated
// in fp32, the output stored in the input type.
//
// What bounds it: at the 512-px shapes (L 1024 or 512, hd 72 or 32) the
// two L x L x hd products are 4 N H L^2 hd operations against ~(4 L hd)
// bytes per head, far above the card's balance, so the kernel is bound by
// arithmetic. This first version does it with fp32 FMAs from shared memory
// (hd 72 is not a multiple of the bf16 MMA k-step, and fp32 inputs take the
// same path), so its ceiling is the card's fp32 rate; wgmma with hd padded
// to 80 is later work.
//
// The design. The TPU kernel keeps a whole head's K and V in VMEM. Here one
// head's K and V at L 1024 (up to 590 KB in fp32) do not fit a block's
// 227 KB of shared memory next to the logits, so they are streamed:
//   * grid (ceil(L/32), H, N): one block per 32 queries of one head of one
//     sample;
//   * the block keeps its (32, L) fp32 logits row block in shared memory
//     (128 KB at L 1024), what _fwd_kernel keeps as ``s``;
//   * K is streamed in tiles of 64 keys to fill it, then the fp32 softmax
//     runs over each complete row, then V is streamed in tiles of 64 keys
//     for the product. Each tile is fetched into registers with 16-byte
//     loads while the block computes on the previous one, and widened into
//     shared memory as fp32 [64][hd + 1] (rows padded to an odd number of
//     words, so a warp reads 32 rows at one feature, or 32 features of one
//     row, without bank conflicts).
// Shared memory: 179,712 B at L 1024, hd 72 (one block per SM); 114,176 B
// at L 512 (two).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBQ = 32;                  // queries per block
constexpr int kQPerWarp = kBQ / kWarps;  // 4: one float4 of a key's logits
constexpr int kTile = 64;                // keys per streamed tile
constexpr int kTileCols = kTile / 32;    // 32-key columns per tile
constexpr int kMaxHd = 128;
constexpr int kMaxHdCols = kMaxHd / 32;
constexpr int kMaxDevices = 64;
constexpr size_t kMaxSmem = 232448;      // a block's limit on sm_90

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

struct SmemLayout {
  size_t q, s, tile, red, total;
};

// Shared memory of one block, in bytes, for keys padded to lp (a multiple
// of kTile): q fp32 [hd][kBQ]; logits fp32 [lp][kBQ]; two fp32
// [kTile][hd + 1] tiles; two fp32 [kWarps][kBQ] reductions.
__host__ __device__ __forceinline__ SmemLayout smem_layout(int lp, int hd) {
  const size_t hdp = hd + 1;
  SmemLayout m;
  m.q = 0;
  m.s = align16(static_cast<size_t>(hd) * kBQ * 4);
  m.tile = align16(m.s + static_cast<size_t>(lp) * kBQ * 4);
  m.red = align16(m.tile + 2 * kTile * hdp * 4);
  m.total = m.red + 2 * kWarps * kBQ * 4;
  return m;
}

// kTile rows of one head's K or V, fetched from device memory into
// registers with 16-byte loads, then widened into shared memory as fp32
// [kTile][hd + 1]. Rows at or past L are zero, so padded keys carry no NaNs
// into 0 * v.
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
// base, double-buffered in tiles (2 x [kTile][hd + 1] fp32): tile t + 1 is
// in flight while the block computes on tile t. Ends synchronised; the body
// must not synchronise the block itself.
template <typename T, typename Body>
__device__ __forceinline__ void for_each_tile(const T* base, size_t stride, int L, int hd,
                                              float* tiles, Body body) {
  const int ntiles = (L + kTile - 1) / kTile;
  const int tile_elems = kTile * (hd + 1);
  TileFetch<T> f;
  f.fetch(base, stride, 0, L, hd);
  f.store(tiles, hd);
  __syncthreads();
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) f.fetch(base, stride, (t + 1) * kTile, L, hd);
    body(t, static_cast<const float*>(tiles + (t & 1) * tile_elems));
    if (t + 1 < ntiles) f.store(tiles + ((t + 1) & 1) * tile_elems, hd);
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
big_fwd_kernel(const T* __restrict__ qkv, T* __restrict__ out, int L, int H, int hd,
               float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lp = (L + kTile - 1) / kTile * kTile;
  const int hdp = hd + 1;
  const SmemLayout lay = smem_layout(lp, hd);
  float* qs = reinterpret_cast<float*>(smem + lay.q);
  float* ss = reinterpret_cast<float*>(smem + lay.s);
  float* tiles = reinterpret_cast<float*>(smem + lay.tile);
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

  // ---- 1. this block's queries, fp32 [hd][kBQ], zero past L ---------------
  for (int idx = tid; idx < kBQ * hd; idx += kThreads) {
    const int i = idx / hd;
    const int d = idx - i * hd;
    qs[d * kBQ + i] = q0 + i < L ? to_f(head[static_cast<size_t>(q0 + i) * row + d]) : 0.f;
  }
  // (for_each_tile synchronises before its first body)

  // ---- 2. logits, streaming K: warp w takes queries 4w..4w+3, lane takes
  //         keys lane + 32c of each tile ----------------------------------
  const int qi = warp * kQPerWarp;
  for_each_tile<T>(head + D, row, L, hd, tiles, [&](int t, const float* kt) {
    float acc[kQPerWarp][kTileCols];
#pragma unroll
    for (int r = 0; r < kQPerWarp; ++r)
#pragma unroll
      for (int c = 0; c < kTileCols; ++c) acc[r][c] = 0.f;
    for (int d = 0; d < hd; ++d) {
      const float4 q = *reinterpret_cast<const float4*>(qs + d * kBQ + qi);
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
      s.x = valid ? acc[0][c] * scale : -INFINITY;
      s.y = valid ? acc[1][c] * scale : -INFINITY;
      s.z = valid ? acc[2][c] * scale : -INFINITY;
      s.w = valid ? acc[3][c] * scale : -INFINITY;
      *reinterpret_cast<float4*>(ss + j * kBQ + qi) = s;
    }
  });

  // ---- 3. fp32 softmax over each complete row: lane = query, warp = a
  //         strided part of the keys ---------------------------------------
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
    // p / denom rounded to the input type (flash_big.py:115)
    for (int j = warp; j < lp; j += kWarps) ss[j * kBQ + i] = round_to<T>(ss[j * kBQ + i] / l);
  }
  // (for_each_tile synchronises before its first body)

  // ---- 4. o = pb v, streaming V: warp w keeps its 4 queries, lane takes
  //         features d = lane + 32c ------------------------------------------
  float o[kQPerWarp][kMaxHdCols];
#pragma unroll
  for (int r = 0; r < kQPerWarp; ++r)
#pragma unroll
    for (int c = 0; c < kMaxHdCols; ++c) o[r][c] = 0.f;
  for_each_tile<T>(head + 2 * D, row, L, hd, tiles, [&](int t, const float* vt) {
    for (int j = 0; j < kTile; ++j) {
      const float4 p = *reinterpret_cast<const float4*>(ss + (t * kTile + j) * kBQ + qi);
      const float* vrow = vt + j * hdp + lane;
#pragma unroll
      for (int c = 0; c < kMaxHdCols; ++c) {
        if (lane + 32 * c < hd) {
          const float v = vrow[32 * c];
          o[0][c] = fmaf(p.x, v, o[0][c]);
          o[1][c] = fmaf(p.y, v, o[1][c]);
          o[2][c] = fmaf(p.z, v, o[2][c]);
          o[3][c] = fmaf(p.w, v, o[3][c]);
        }
      }
    }
  });
  T* obase = out + static_cast<size_t>(n) * L * D + static_cast<size_t>(h) * hd;
#pragma unroll
  for (int r = 0; r < kQPerWarp; ++r) {
    const int i = q0 + qi + r;
    if (i >= L) continue;
#pragma unroll
    for (int c = 0; c < kMaxHdCols; ++c) {
      const int d = lane + 32 * c;
      if (d < hd) obase[static_cast<size_t>(i) * D + d] = from_f<T>(o[r][c]);
    }
  }
}

template <typename T>
cudaError_t launch(const void* qkv, void* out, int n, int l, int heads, int hd,
                   float scale, cudaStream_t stream) {
  const int lp = (l + kTile - 1) / kTile * kTile;
  const size_t smem = smem_layout(lp, hd).total;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  // raise the kernel's dynamic shared-memory limit (48 KB by default) on
  // this device to the largest size asked for so far
  static size_t configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem > configured[dev]) {
    err = cudaFuncSetAttribute(big_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    configured[dev] = smem;
  }
  const dim3 grid((l + kBQ - 1) / kBQ, heads, n);
  big_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), l, heads, hd, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs (the same for bf16 and
// fp32 inputs: tiles are widened to fp32).
size_t packed_attention_big_fwd_smem_bytes(int l, int hd) {
  return smem_layout((l + kTile - 1) / kTile * kTile, hd).total;
}

// dtype: 0 = bfloat16, 1 = float32. qkv is (n, l, 3*heads*hd) contiguous and
// 16-byte aligned, out (n, l, heads*hd) contiguous, both on the current
// device; hd a multiple of 8, at most 128. Returns the cudaError_t of the
// launch (0 on success).
int packed_attention_big_fwd(const void* qkv, void* out, int n, int l, int heads, int hd,
                             float scale, int dtype, void* stream) {
  if (n <= 0 || l <= 0 || heads <= 0 || hd <= 0 || hd > kMaxHd || hd % 8 != 0 ||
      n > 65535 || heads > 65535 || reinterpret_cast<uintptr_t>(qkv) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(launch<__nv_bfloat16>(qkv, out, n, l, heads, hd, scale, s));
    case 1:
      return static_cast<int>(launch<float>(qkv, out, n, l, heads, hd, scale, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* packed_attention_big_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
