// The bf16 attention forward on Hopper's tensor cores (sm_90a), shared by
// flash_fwd.cu (kernel #5, flash._flash_fwd) and packed_attention_big_fwd.cu
// (kernel #3, flash_big._big_fwd); packed_attention_fwd.cu (#1) builds its
// one-pass kernel from the helpers below. Both compute, per (sample, head):
//   s = (q . k) * scale in fp32; m = max s; p = exp(s - m); l = sum p;
//   o = (p / l rounded to bf16) . v accumulated in fp32, stored in bf16;
// #5 also writes lse = m + log l in fp32. They differ only in where a head's
// rows lie, which a layout policy gives (SeparateHeads, PackedQkv below).
//
// What bounds it: the TPU kernel's two L x L x hd products are 4 N H L^2 hd
// operations against ~4 N L D elements of traffic, far above the card's
// balance at every main-path shape (L 512 or 1024, hd 72 or 32), so the
// bound is the tensor cores' rate. This design computes three products (Q.K^T
// twice, see below), so it can reach at most 2/3 of that bound; and it takes
// two exps per logit (2 N H L^2 expf, ~0.29 ms of the MUFU units at
// (32, 1024, 16, 32)) and one division, which at hd 32 cost more than the
// products.
//
// The design (FA2's structure, with the reference's rounding points kept):
//   * grid (ceil(L / 64), heads...): one block of 4 warps per 64 queries of
//     one head; each warp owns 16 query rows, whose Q it holds in registers
//     as mma A fragments for the whole kernel;
//   * K and V stream in tiles of 64 keys through rings of two bf16 tiles
//     filled by 16-byte cp.async.cg (zero-fill for keys at or past L); a
//     tile row is hd16 + 8 elements (hd16 = hd padded to the mma k-step of
//     16), an odd number of 16-byte units, so ldmatrix reads without bank
//     conflicts. The pad columns hd..hd16 of every tile are zeroed once and
//     never written by the copies, so they add nothing to Q.K^T;
//   * products by mma.sync.m16n8k16 (bf16 in, fp32 accumulate): K^T's B
//     fragments by ldmatrix, V's by ldmatrix.trans; P.V runs over hd in
//     n-tiles of 8 (no padding: hd 72 is nine);
//   * pass 1 over the keys: s, a running row max m and a running sum l
//     rescaled by exp(m_old - m_new). The final m is exact; l differs from
//     the reference's sum by summation order only (a few fp32 ulps);
//   * pass 2 over the keys: s recomputed by the same instructions (bit for
//     bit pass 1's), p = expf(s - m) / l correctly rounded (div_rn), rounded
//     to bf16 in registers, where the m16n8 accumulators become the m16k16 A
//     fragments of P.V without shared memory. So p / l is rounded once, from
//     the final m and l, as _fwd_kernel rounds it; the usual online-softmax
//     output (o rescaled, divided by l at the end) would round unnormalised
//     probabilities and change over 20% of the bf16 outputs.
// Shared memory does not grow with L: 4 tiles of 64 x (hd16 + 8) bf16,
// 45,056 B at hd 72 and 20,480 B at hd 32. No wgmma or TMA: a 144-byte row
// at hd 72 is above TMA's 128-byte swizzle, which needs its own design.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace attention_fwd_mma {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;               // 16 query rows each
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kWarps * 16;      // queries per block
constexpr int kKeys = 64;               // keys per streamed tile
constexpr int kMaxHd = 128;
constexpr int kMaxDevices = 64;

// hd padded to the mma k-step of 16
__host__ __device__ constexpr int padded_hd(int hd) { return (hd + 15) / 16 * 16; }

// elements between rows of a shared-memory tile
__host__ __device__ constexpr int tile_stride(int hd) { return padded_hd(hd) + 8; }

// dynamic shared memory of one block: the K and V rings, two tiles each
__host__ __device__ constexpr size_t smem_bytes(int hd) {
  return 4 * static_cast<size_t>(kKeys) * tile_stride(hd) * sizeof(bf16);
}

// one (sample, head): its q, k and v rows (row r at q + r * in_stride, ...),
// its output rows, and its logsumexp row (or null)
struct Head {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  size_t in_stride;
  bf16* o;
  size_t out_stride;
  float* lse;
};

// q, k, v and o (heads, L, hd) contiguous, lse (heads, L) fp32; grid
// (ceil(L / kRows), heads)
struct SeparateHeads {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  float* lse;
  int heads;

  __device__ Head head(int L, int hd) const {
    const size_t base = static_cast<size_t>(blockIdx.y) * L * hd;
    return {q + base, k + base, v + base, static_cast<size_t>(hd), o + base,
            static_cast<size_t>(hd), lse + static_cast<size_t>(blockIdx.y) * L};
  }
  dim3 grid(int L) const { return dim3((L + kRows - 1) / kRows, heads); }
};

// packed qkv (n, L, 3D), head h at features h*hd, D + h*hd and 2D + h*hd of
// each row; o (n, L, D); grid (ceil(L / kRows), heads, n)
struct PackedQkv {
  const bf16* qkv;
  bf16* o;
  int n, heads;

  __device__ Head head(int L, int hd) const {
    const size_t d = static_cast<size_t>(heads) * hd;
    const bf16* base = qkv + static_cast<size_t>(blockIdx.z) * L * 3 * d +
                       static_cast<size_t>(blockIdx.y) * hd;
    return {base, base + d, base + 2 * d, 3 * d,
            o + static_cast<size_t>(blockIdx.z) * L * d + static_cast<size_t>(blockIdx.y) * hd,
            d, nullptr};
  }
  dim3 grid(int L) const { return dim3((L + kRows - 1) / kRows, heads, n); }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; zeros where !valid (src-size 0)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most n groups of copies are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
}

// d += a . b: a 16 x 16 bf16 (row), b 16 x 8 bf16 (col), d 16 x 8 fp32
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// e / l correctly rounded, as an IEEE division rounds it, from r = 1 / l
// correctly rounded (once per row): q = e r is within an ulp of e / l, the
// residual e - q l is exact in an FMA, and q + (e - q l) r rounds to e / l
// (Markstein's correction; tests/test_torch_flash_big.py checks the
// sequence in exact arithmetic). Here e = exp(s - m) lies in [0, 1] and l in
// [1, L]: no overflow. Three instructions instead of div.rn's sequence.
__device__ __forceinline__ float div_rn(float e, float l, float r) {
  const float q = __fmul_rn(e, r);
  return __fmaf_rn(__fmaf_rn(-q, l, e), r, q);
}

// two fp32 values rounded to bf16 (nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// rows r0 .. r0 + kKeys - 1 of a head's (L, HD) matrix (row r at
// src + r * stride) into a tile, by cp.async; rows at or past L are zeros
template <int HD>
__device__ __forceinline__ void load_tile(bf16* tile, const bf16* src, size_t stride, int r0,
                                          int L) {
  constexpr int kChunks = HD / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < kKeys * kChunks; c += kThreads) {
    const int row = c / kChunks;
    const int col = (c - row * kChunks) * 8;
    const bool valid = r0 + row < L;
    cp_async16(smem_addr(tile + row * tile_stride(HD) + col),
               src + static_cast<size_t>(valid ? r0 + row : 0) * stride + col, valid);
  }
}

// The fp32 logits of one warp's 16 queries against one tile of 64 keys, s =
// (q . k) * scale, -inf at keys >= L (only the last tile can hold any).
// Accumulator layout of m16n8: thread (g = lane / 4, t = lane % 4) holds
// s[j][0..1] at row g, keys 8j + 2t, 8j + 2t + 1, and s[j][2..3] at row
// g + 8. The same instructions in both passes, so both see the same bits;
// the scale multiply is pinned (no FMA contraction), as the reference
// rounds s before subtracting m.
template <int HD>
__device__ __forceinline__ void tile_logits(float (&s)[8][4],
                                            const uint32_t (&qf)[padded_hd(HD) / 16][4],
                                            const bf16* kt, int key0, int L, float scale) {
  constexpr int kSteps = padded_hd(HD) / 16;
  const int lane = threadIdx.x & 31;
  // ldmatrix.x4 of K rows: lanes 0-7 address keys 0-7 at dims 0-7 (b0 of
  // n-tile 2j), 8-15 keys 0-7 at dims 8-15 (b1), 16-23 and 24-31 keys 8-15
  // (b0, b1 of n-tile 2j + 1)
  const int key = ((lane >> 4) << 3) + (lane & 7);
  const int dim = ((lane >> 3) & 1) << 3;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[j][c] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t b[4];
      ldmatrix_x4(b, smem_addr(kt + (16 * j + key) * tile_stride(HD) + 16 * kk + dim));
      mma(s[2 * j], qf[kk], b[0], b[1]);
      mma(s[2 * j + 1], qf[kk], b[2], b[3]);
    }
  }
  if (key0 + kKeys <= L) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[j][c] = __fmul_rn(s[j][c], scale);
  } else {
    const int col = key0 + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        s[j][c] = col + 8 * j + (c & 1) < L ? __fmul_rn(s[j][c], scale) : -INFINITY;
  }
}

template <int HD, class Layout>
__global__ void __launch_bounds__(kThreads)
attention_fwd_kernel(Layout layout, int L, float scale) {
  constexpr int kSteps = padded_hd(HD) / 16;  // k-steps of Q.K^T
  constexpr int kDimTiles = HD / 8;           // n-tiles of P.V
  constexpr int kStride = tile_stride(HD);
  constexpr int kTile = kKeys * kStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // K ring, 2 tiles
  bf16* vs = ks + 2 * kTile;                     // V ring, 2 tiles; Q passes through vs[0]
  static_assert(kRows == kKeys, "the query block is loaded as one tile");

  const Head head = layout.head(L, HD);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * kRows;
  const int ntiles = (L + kKeys - 1) / kKeys;

  // the pad columns HD .. padded_hd(HD) of all four tiles, zero once
  if (padded_hd(HD) != HD)
    for (int r = tid; r < 4 * kKeys; r += kThreads)
      *reinterpret_cast<uint4*>(ks + r * kStride + HD) = make_uint4(0u, 0u, 0u, 0u);

  // ---- this warp's 16 queries as A fragments: ldmatrix.x4 lanes 0-15
  //      address rows 0-15 at dims 0-7, lanes 16-31 rows 0-15 at dims 8-15
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

  // ---- pass 1: the row max m and sum l over all keys (rows g and g + 8) --
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
      // the quad's four threads hold the row's 64 keys of this tile
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
  const int row0 = q0 + 16 * warp + (lane >> 2);
  if (head.lse != nullptr && (lane & 3) == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row0 + 8 * r < L) head.lse[row0 + 8 * r] = m[r] + logf(l[r]);
  }
  const float rl[2] = {__frcp_rn(l[0]), __frcp_rn(l[1])};

  // ---- pass 2: o = (p / l rounded to bf16) . v -----------------------------
  float o[kDimTiles][4];
#pragma unroll
  for (int j = 0; j < kDimTiles; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[j][c] = 0.f;
  // ldmatrix.trans of V rows: lanes 0-7 address keys 0-7 (b0), 8-15 keys
  // 8-15 (b1) of the n-tile at dims d..d+7; lanes 16-31 the same at d+8
  const int vkey = lane & 15;
  const int vdim = (lane >> 4) << 3;
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
    // m16n8 accumulators of n-tiles 2kk, 2kk + 1 = the m16k16 A fragment of
    // keys 16kk .. 16kk + 15
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          pa[kk][2 * h + r] = pack_bf16(div_rn(expf(s[2 * kk + h][2 * r] - m[r]), l[r], rl[r]),
                                        div_rn(expf(s[2 * kk + h][2 * r + 1] - m[r]), l[r], rl[r]));
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

  // ---- o in bf16: rows g and g + 8 of the warp, features 8j + 2t, +1 ------
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

template <int HD, class Layout>
cudaError_t launch_hd(const Layout& layout, int L, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(HD);
  // above 48 KB a kernel needs its dynamic shared-memory limit raised, once
  // per device; prefer the largest shared-memory carveout (several blocks
  // per SM)
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(attention_fwd_kernel<HD, Layout>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(attention_fwd_kernel<HD, Layout>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    configured[dev] = true;
  }
  attention_fwd_kernel<HD, Layout><<<layout.grid(L), kThreads, smem, stream>>>(layout, L, scale);
  return cudaGetLastError();
}

// The kernel at head dim hd (a multiple of 8, at most kMaxHd): one
// instantiation per hd, so every loop over hd unrolls.
template <class Layout, int HD = 8>
cudaError_t launch(const Layout& layout, int L, int hd, float scale, cudaStream_t stream) {
  if (hd == HD) return launch_hd<HD>(layout, L, scale, stream);
  if constexpr (HD < kMaxHd) {
    return launch<Layout, HD + 8>(layout, L, hd, scale, stream);
  } else {
    return cudaErrorInvalidValue;
  }
}

}  // namespace attention_fwd_mma
