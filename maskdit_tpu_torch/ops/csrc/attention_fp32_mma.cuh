// The fp32 attention on Hopper's tensor cores (sm_90a): the forward and the
// backward for fp32 at a head dim that is a multiple of 8, the path of the
// released finetunes (configs/finetune/*.yaml train with train.fp32 and TF32
// off), with or without model.use_flash. In fp32 the whole-row kernels #1 /
// #2 (flash_batched._packed_fwd / _packed_bwd) and the blocked kernels #3 /
// #4 (flash_big._big_fwd / _big_bwd) compute one function on packed qkv, so
// packed_attention_fwd.cu, packed_attention_bwd.cu,
// packed_attention_big_fwd.cu and packed_attention_big_bwd.cu all launch
// these kernels in the PackedQkv layout; the flash kernels #5 / #6
// (flash._flash_fwd / _flash_bwd: separate q, k, v and a saved logsumexp)
// launch them in the SeparateHeads layout from flash_fwd.cu and
// flash_bwd.cu. Per (sample, head), in fp32, with every "round to the input
// type" of the TPU kernels the identity:
//   s = (q . k) * scale; p = softmax(s) (the final max and sum); o = p . v;
//   delta = sum(do * o); ds = p * (dp - delta) * scale with dp = do . v^T;
//   dq = ds . k, dk = ds^T . q, dv = p^T . do (dk, dv over all queries).
// The flash pair differs where _flash_fwd / _flash_bwd do: the forward also
// writes lse = m + log l, and the backward forms p = exp(s - lse) (not
// exp(s - m) / l; the two differ in their last bits) with delta from the
// stored o, which flash_bwd.cu's delta pass sums before these kernels run.
//
// What bounds it: the forward's two and the backward's six (flash: five)
// L x L x hd products (4 and 12 N H L^2 hd operations) against a few N L D fp32
// elements of traffic: above the card's balance at every L the finetunes
// run (128-1024), so arithmetic. On fp32 FMAs (67 TFLOP/s) that
// bound is ~15x the bf16 tensor cores' (989 TFLOP/s); plain TF32 (one
// product of 11-bit operands) misses the 1e-5 bound these paths are held to.
//
// The design: exact bf16 pieces on mma.sync. Each fp32 operand x is split
// exactly into three bf16 pieces (split3: x0 = bf16(x), x1 = bf16(x - x0),
// x2 = x - x0 - x1; 24 significand bits in three of 8), a bf16 x bf16
// product is exact in fp32 and the m16n8k16 accumulators are fp32, so an
// fp32 product a . b runs as the six bf16 products a_i . b_j with
// i + j <= 2, dropping the three terms of i + j >= 3, each at most ~2^-24
// of |a_i b_j| summed (tests/test_torch_fp32_pieces.py emulates six and
// nine terms: the same error; on the card nine ran slower, PERF.md).
// So a product costs six bf16 ones, still ~2.5x under the fp32 FMA bound.
//
// The kernels keep the bf16 designs' structure (attention_fwd_mma.cuh,
// attention_bwd_mma.cuh): blocks of 64 rows of one head, 4 warps of 16
// rows, K, V, Q and dO streamed in 64-row tiles by cp.async, shared memory
// that does not grow with L, deterministic, no atomics:
//   * forward, grid (ceil(L / 64), heads, n) (separate heads: (ceil(L /
//     64), N*H)): ONE pass over the keys, s, a running row max m and sum l,
//     o += e . v with e = exp(s - m), o and l rescaled by exp(m_old - m_new)
//     as m grows, o / l at the end, and lse = m + log l where the layout
//     keeps one. (The bf16 forward takes two passes so that p / l is rounded
//     to bf16 once, from the final m and l; in fp32 nothing is rounded there
//     and the rescale adds a few fp32 roundings, far inside 1e-5: one
//     product fewer.)
//   * backward query kernel, the same grid: in the packed layout the
//     forward's pass gives m, l and o; delta = sum(do * o); m, l, delta go
//     to the fp32 (3, n, heads, L) scratch; with separate heads lse and
//     delta are read instead and that pass is not run. Then one pass forms
//     s, p (exp(s - m) / l, or exp(s - lse)), dp and ds and adds ds . k to
//     dq;
//   * backward key kernel, grid over keys: its 64 keys' K and V stay in
//     shared memory, Q and dO stream; per tile each warp takes 16 queries,
//     forms s and dp, p from the saved m and l (or lse), and ds, stored
//     fp32 and transposed; then each warp takes 16 keys and adds p^T . dO
//     to dv and ds^T . Q to dk.
// s and dp come from the same helper (tile_dots: the same pieces, the same
// mma sequence, S = Q . K^T in both kernels), p from the same expf and
// correctly rounded division (div_rn; row_prob), ds with pinned multiplies
// (dscore), so the key kernel's p and ds are bit for bit the query
// kernel's.
//
// Where the pieces are formed. Three bf16 pieces of a tile take 1.5x its
// fp32 bytes, and the key kernel's six tiles plus p^T and ds^T would not fit
// a block at hd 72 (202,752 B of pieces). So tiles stay fp32 in shared
// memory, filled by 16-byte cp.async of the fp32 rows, and each fragment is
// split into its pieces in registers as it is loaded: ldmatrix moves 16-bit
// elements only, so the fragments are read with 64-bit (pairs along a row)
// or 32-bit (pairs down a column) ld.shared in the mma layouts. The A
// fragments of Q and dO are read from shared memory per tile too: held as
// three pieces in registers they would take 120 registers at hd 80 before
// any accumulator. p and ds go from the accumulators straight into A
// fragments (forward, query kernel) or through the fp32 p^T / ds^T tiles
// (key kernel), split once.
//   Row strides (floats): tiles read only as A fragments or as the rows of
// B^T take a_stride (= 8 mod 16: a half-warp's 64-bit reads of rows g and
// columns 2t hit 16 distinct bank pairs), tiles read down their columns
// take b_stride = hd + 4 (rows 2t at one column: 32 distinct banks; their
// 64-bit reads conflict two-way). The contraction over hd runs in k-steps
// of 16 and, where hd = 8 mod 16 (hd 72, 40), one m16n8k8 step for the last
// 8 columns: no padding, and the padding columns are never read.
//   Shared memory at hd 32 / 72 / 128: forward 47,104 / 96,256 / 169,984 B
// (Q and two-tile K and V rings); query kernel 57,344 / 114,688 / 204,800
// (Q, dO, the rings); key kernel (its K and V, Q and dO rings of
// key_depth tiles, p^T and ds^T [64][72]) 94,208 (two-deep) / 112,640 /
// 174,080 (one-deep): a ring is two-deep where that keeps two blocks on an
// SM, else one tile deep, so that at hd 72 two blocks share an SM.
//   Accumulation. An mma.sync's fp32 accumulation is not IEEE
// round-to-nearest: chained over a whole row of keys (384 mma.sync per
// output at L 1024) the error of a first build of this design grew with L
// to near the bound of 1e-5 on the card. So the a0 . b0 products go into
// one accumulator and the five smaller ones into a second (~2^-8 of the
// first, so its error is ~2^-8 smaller), added once by a round-to-nearest
// add; the contractions over keys or queries (o, dq, dk, dv) sum each
// tile's 24 mma.sync in zeroed accumulators and add them to the running
// fp32 sums once per tile. chip_smoke.py's fp32 rows then measure at most
// 3.3e-6 of max|ref|.
//   Registers: a warp holds 16 x hd fp32 accumulators (o, dq, or dk and
// dv), 8 x 4 of s or dp and their second accumulators, and the pieces of
// one k-step; __launch_bounds__(128, 2) gives each thread up to 255 (two
// blocks per SM at hd 72, as shared memory allows). The build's -Xptxas -v
// report (beside the library) lists spills: none at hd <= 64 in the packed
// layout (the separate-heads key kernel 4 B at hd 56-72, the packed one at
// hd 72), up to 144 B at hd 104-128.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "attention_fwd_mma.cuh"

namespace attention_fp32_mma {
// Internal linkage, as attention_bwd_mma: each library builds its own copy.
namespace {

using attention_fwd_mma::cp_async16;
using attention_fwd_mma::cp_async_commit;
using attention_fwd_mma::cp_async_wait;
using attention_fwd_mma::div_rn;
using attention_fwd_mma::kKeys;
using attention_fwd_mma::kMaxDevices;
using attention_fwd_mma::kMaxHd;
using attention_fwd_mma::kRows;
using attention_fwd_mma::kThreads;
using attention_fwd_mma::mma;
using attention_fwd_mma::smem_addr;

static_assert(kRows == kKeys, "query and key tiles are both 64 rows");

// floats between rows of the key kernel's p^T and ds^T tiles ([key][query])
constexpr int kTStride = kRows + 8;
// an SM's shared memory, and what the system keeps of it per block
constexpr size_t kSmemPerSm = 233472;
constexpr size_t kBlockReserve = 1024;

// row strides, in floats, of tiles read as A fragments or B^T rows, and of
// tiles read down their columns
__host__ __device__ constexpr int a_stride(int hd) { return hd % 16 == 8 ? hd : hd + 8; }
__host__ __device__ constexpr int b_stride(int hd) { return hd + 4; }

__host__ __device__ constexpr size_t tile_bytes(int stride) {
  return static_cast<size_t>(kRows) * stride * sizeof(float);
}

// the forward: the Q tile, the K and V rings (two tiles each)
__host__ __device__ constexpr size_t fwd_smem_bytes(int hd) {
  return tile_bytes(a_stride(hd)) + 4 * tile_bytes(b_stride(hd));
}

// the backward query kernel: the Q and dO tiles, the K and V rings
__host__ __device__ constexpr size_t query_smem_bytes(int hd) {
  return 2 * tile_bytes(a_stride(hd)) + 4 * tile_bytes(b_stride(hd));
}

// the key kernel with Q and dO rings of ``depth`` tiles: its K and V tiles,
// the rings, p^T and ds^T
__host__ __device__ constexpr size_t key_smem_bytes_at(int hd, int depth) {
  return 2 * tile_bytes(a_stride(hd)) + 2 * depth * tile_bytes(b_stride(hd)) +
         2 * tile_bytes(kTStride);
}

// two-deep rings where two blocks still share an SM, else one tile deep
__host__ __device__ constexpr int key_depth(int hd) {
  return 2 * (key_smem_bytes_at(hd, 2) + kBlockReserve) <= kSmemPerSm ? 2 : 1;
}

__host__ __device__ constexpr size_t key_smem_bytes(int hd) {
  return key_smem_bytes_at(hd, key_depth(hd));
}

// the larger of the backward's two
__host__ __device__ constexpr size_t bwd_smem_bytes(int hd) {
  return query_smem_bytes(hd) > key_smem_bytes(hd) ? query_smem_bytes(hd) : key_smem_bytes(hd);
}

// x = x0 + x1 + x2 exactly, each piece bf16, for both halves of a pair (lo
// in the low half of each word): x0 = bf16(x), x1 = bf16(x - x0), x2 = x -
// x0 - x1. Each subtraction is exact in fp32 and x2 fits bf16, so the last
// conversion does not round; the pinned subtractions keep the compiler
// from contracting any of it. flash_bwd.cu (#6) splits p and ds with it.
__device__ __forceinline__ void split3(float lo, float hi, uint32_t& p0, uint32_t& p1,
                                       uint32_t& p2) {
  const __nv_bfloat162 h0 = __floats2bfloat162_rn(lo, hi);
  const float2 f0 = __bfloat1622float2(h0);
  const float rlo = __fsub_rn(lo, f0.x), rhi = __fsub_rn(hi, f0.y);
  const __nv_bfloat162 h1 = __floats2bfloat162_rn(rlo, rhi);
  const float2 f1 = __bfloat1622float2(h1);
  const __nv_bfloat162 h2 = __floats2bfloat162_rn(__fsub_rn(rlo, f1.x), __fsub_rn(rhi, f1.y));
  p0 = *reinterpret_cast<const uint32_t*>(&h0);
  p1 = *reinterpret_cast<const uint32_t*>(&h1);
  p2 = *reinterpret_cast<const uint32_t*>(&h2);
}

// the pieces of the fp32 pair p[0], p[1] (one 64-bit read)
__device__ __forceinline__ void split_pair(const float* p, uint32_t& w0, uint32_t& w1,
                                           uint32_t& w2) {
  const float2 x = *reinterpret_cast<const float2*>(p);
  split3(x.x, x.y, w0, w1, w2);
}

// Fragment layouts of mma.sync m16n8k16 (bf16), thread (g, t) = (lane / 4,
// lane % 4): A (16 x 16, row) a0 = A[g][2t, 2t+1], a1 = A[g+8][2t, 2t+1],
// a2 = A[g][2t+8, 2t+9], a3 = A[g+8][2t+8, 2t+9]; B (16 x 8, col) b0 =
// B[2t, 2t+1][g], b1 = B[2t+8, 2t+9][g]; C c0, c1 = C[g][2t, 2t+1], c2, c3 =
// C[g+8][2t, 2t+1]. m16n8k8 takes a0, a1 and b0. The lower k in the low half.

// the pieces of the A fragment of rows 0-15 of x (row r at x + r * stride),
// columns c .. c + 15
__device__ __forceinline__ void load_a(uint32_t (&a)[3][4], const float* x, int stride, int c) {
  const int lane = threadIdx.x & 31;
  const float* p = x + (lane >> 2) * stride + c + 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < 4; ++i)  // a0: row g, a1: row g + 8, a2, a3: columns + 8
    split_pair(p + (i & 1) * 8 * stride + (i >> 1) * 8, a[0][i], a[1][i], a[2][i]);
}

// the same for the m16n8k8 step at columns c .. c + 7
__device__ __forceinline__ void load_a8(uint32_t (&a)[3][2], const float* x, int stride, int c) {
  const int lane = threadIdx.x & 31;
  const float* p = x + (lane >> 2) * stride + c + 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < 2; ++i) split_pair(p + i * 8 * stride, a[0][i], a[1][i], a[2][i]);
}

// the pieces of the B fragment of y^T: B[k][n] = y[n][c + k], n = rows 0-7
// of y (row r at y + r * stride)
__device__ __forceinline__ void load_bt(uint32_t (&b)[3][2], const float* y, int stride, int c) {
  const int lane = threadIdx.x & 31;
  const float* p = y + (lane >> 2) * stride + c + 2 * (lane & 3);
  split_pair(p, b[0][0], b[1][0], b[2][0]);
  split_pair(p + 8, b[0][1], b[1][1], b[2][1]);
}

// the same for the m16n8k8 step
__device__ __forceinline__ void load_bt8(uint32_t (&b)[3], const float* y, int stride, int c) {
  const int lane = threadIdx.x & 31;
  split_pair(y + (lane >> 2) * stride + c + 2 * (lane & 3), b[0], b[1], b[2]);
}

// the pieces of the B fragment of y itself: B[k][n] = y[k][c + n], k = rows
// 0-15 of y; a pair runs down a column (two 32-bit reads)
__device__ __forceinline__ void load_b(uint32_t (&b)[3][2], const float* y, int stride, int c) {
  const int lane = threadIdx.x & 31;
  const float* p = y + 2 * (lane & 3) * stride + c + (lane >> 2);
  split3(p[0], p[stride], b[0][0], b[1][0], b[2][0]);
  split3(p[8 * stride], p[9 * stride], b[0][1], b[1][1], b[2][1]);
}

__device__ __forceinline__ void mma8(float (&d)[4], const uint32_t (&a)[2], uint32_t b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

// d += a . b for the pieces a = a0 + a1 + a2, b = b0 + b1 + b2: a0 . b0
// into d, the five other products a_i . b_j of i + j <= 2 (smaller terms
// first) into e, a second accumulator whose values are ~2^-8 of d's
__device__ __forceinline__ void mma_pieces(float (&d)[4], float (&e)[4], const uint32_t (&a)[3][4],
                                           const uint32_t (&b)[3][2]) {
#pragma unroll
  for (int s = 2; s >= 1; --s)
#pragma unroll
    for (int i = s; i >= 0; --i) mma(e, a[i], b[s - i][0], b[s - i][1]);
  mma(d, a[0], b[0][0], b[0][1]);
}

__device__ __forceinline__ void mma_pieces8(float (&d)[4], float (&e)[4],
                                            const uint32_t (&a)[3][2], const uint32_t (&b)[3]) {
#pragma unroll
  for (int s = 2; s >= 1; --s)
#pragma unroll
    for (int i = s; i >= 0; --i) mma8(e, a[i], b[s - i]);
  mma8(d, a[0], b[0]);
}

// acc = x . y^T over HD columns, unscaled: x one warp's 16 rows (stride
// SX), y a tile's 64 rows (stride SY). Every s and dp of both backward
// kernels is formed by this one sequence, so both see the same bits.
template <int HD, int SX, int SY>
__device__ __forceinline__ void tile_dots(float (&acc)[8][4], const float* x, const float* y) {
  float e[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = e[j][c] = 0.f;
  // not unrolled: a k-step holds 48 mma.sync and its pieces; rolled, the
  // loop ran faster on the card than unrolled (fewer registers and
  // spills) and builds in about half the time
#pragma unroll 1
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t a[3][4];
    load_a(a, x, SX, 16 * kk);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t b[3][2];
      load_bt(b, y + 8 * j * SY, SY, 16 * kk);
      mma_pieces(acc[j], e[j], a, b);
    }
  }
  if constexpr (HD % 16 != 0) {
    uint32_t a[3][2];
    load_a8(a, x, SX, HD - 8);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t b[3];
      load_bt8(b, y + 8 * j * SY, SY, HD - 8);
      mma_pieces8(acc[j], e[j], a, b);
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = __fadd_rn(acc[j][c], e[j][c]);
}

// The logits of one warp's 16 queries against a tile of 64 keys: s = (q .
// k) * scale with the multiply pinned (the reference rounds s before
// subtracting m), -inf at keys >= L.
template <int HD, int SX, int SY>
__device__ __forceinline__ void tile_logits(float (&s)[8][4], const float* x, const float* y,
                                            int key0, int L, float scale) {
  tile_dots<HD, SX, SY>(s, x, y);
  const int col = key0 + 2 * (threadIdx.x & 3);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      s[j][c] = col + 8 * j + (c & 1) < L ? __fmul_rn(s[j][c], scale) : -INFINITY;
}

// acc (16 x HD, n-tiles of 8) += a . y: a the pieces of the A fragments of
// 16 rows x 64 (four k-steps), y the 64 rows of a tile (stride SY). Each
// n-tile's 24 mma.sync go into zeroed accumulators (a0 . b0's and the
// corrections') that one round-to-nearest add puts into acc: chained over
// a whole row of keys or queries, the mma.sync accumulation's error grows
// with L (see the head of this file). The contractions over hd, at most
// 48 mma.sync, chain.
template <int HD, int SY>
__device__ __forceinline__ void tile_accumulate(float (&acc)[HD / 8][4],
                                                const uint32_t (&a)[4][3][4], const float* y) {
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    float t[4] = {0.f, 0.f, 0.f, 0.f}, e[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t b[3][2];
      load_b(b, y + 16 * kk * SY, SY, 8 * j);
      mma_pieces(t, e, a[kk], b);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = __fadd_rn(acc[j][c], __fadd_rn(t[c], e[c]));
  }
}

// The pieces of the m16k16 A fragments of 16 rows x 64 from m16n8
// accumulators: n-tiles 2kk and 2kk + 1 are the k-step kk (the C and A
// layouts line up), each pair split as it stands.
__device__ __forceinline__ void split_accumulators(uint32_t (&a)[4][3][4], const float (&x)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        split3(x[2 * kk + h][2 * r], x[2 * kk + h][2 * r + 1], a[kk][0][2 * h + r],
               a[kk][1][2 * h + r], a[kk][2][2 * h + r]);
}

// rows r0 .. r0 + 63 of a head's (L, HD) fp32 matrix (row r at src + r *
// stride) into a tile of row stride S floats, by 16-byte cp.async; rows at
// or past L are zeros
template <int HD, int S>
__device__ __forceinline__ void load_tile(float* tile, const float* src, size_t stride, int r0,
                                          int L) {
  constexpr int kChunks = HD / 4;
  for (int c = threadIdx.x; c < kRows * kChunks; c += kThreads) {
    const int row = c / kChunks;
    const int col = (c - row * kChunks) * 4;
    const bool valid = r0 + row < L;
    cp_async16(smem_addr(tile + row * S + col),
               src + static_cast<size_t>(valid ? r0 + row : 0) * stride + col, valid);
  }
}

// one warp's 16 x HD accumulators (rows g and g + 8 from row0, features 8j +
// 2t, +1) into rows r of dst (at r * stride), for rows below L
template <int HD>
__device__ __forceinline__ void store_rows(float* dst, size_t stride,
                                           const float (&acc)[HD / 8][4], int row0, int L) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + (lane >> 2) + 8 * r;
    if (row >= L) continue;
    float* out = dst + static_cast<size_t>(row) * stride + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<float2*>(out + 8 * j) = make_float2(acc[j][2 * r], acc[j][2 * r + 1]);
  }
}

// p = exp(s - m) / l correctly rounded, with r = 1 / l
__device__ __forceinline__ float prob(float s, float m, float l, float r) {
  return div_rn(expf(s - m), l, r);
}

// ds = (p * (dp - delta)) * scale, each multiply rounded on its own
__device__ __forceinline__ float dscore(float p, float dp, float delta, float scale) {
  return __fmul_rn(__fmul_rn(p, dp - delta), scale);
}

// where one block's (sample, head) lies for the forward: its q, k and v
// rows (row r at q + r * stride, ...), its o rows (at o + r * out_stride)
// and, in a layout with one, its logsumexp row
struct FwdHead {
  const float* q;
  const float* k;
  const float* v;
  size_t stride;
  float* o;
  size_t out_stride;
  float* lse;
};

// packed qkv (n, L, 3D) fp32, head h at features h*hd, D + h*hd and 2D +
// h*hd of each row; o (n, L, D); grid (ceil(L / 64), heads, n)
struct PackedQkv {
  static constexpr bool kLse = false;
  const float* qkv;
  float* o;
  int n, heads;

  dim3 grid(int L) const { return dim3((L + kRows - 1) / kRows, heads, n); }
  __device__ FwdHead head(int L, int hd) const {
    const size_t d = static_cast<size_t>(heads) * hd;
    const float* q = qkv + static_cast<size_t>(blockIdx.z) * L * 3 * d +
                     static_cast<size_t>(blockIdx.y) * hd;
    return {q, q + d, q + 2 * d, 3 * d,
            o + static_cast<size_t>(blockIdx.z) * L * d + static_cast<size_t>(blockIdx.y) * hd, d,
            nullptr};
  }
};

// q, k, v and o (heads, L, hd) contiguous, lse (heads, L) fp32 = m + log l
// from the final running max and sum; grid (ceil(L / 64), heads)
struct SeparateHeads {
  static constexpr bool kLse = true;
  const float* q;
  const float* k;
  const float* v;
  float* o;
  float* lse;
  int heads;

  dim3 grid(int L) const { return dim3((L + kRows - 1) / kRows, heads); }
  __device__ FwdHead head(int L, int hd) const {
    const size_t base = static_cast<size_t>(blockIdx.y) * L * hd;
    return {q + base, k + base, v + base, static_cast<size_t>(hd), o + base,
            static_cast<size_t>(hd), lse + static_cast<size_t>(blockIdx.y) * L};
  }
};

// and for the backward: q, k, v rows as above, dO's rows (at dout + r *
// dout_stride), the gradients' (at dq + r * grad_stride, ...) and each
// row's statistics at [r]: in the packed layout the max m, the sum l and
// delta, which its query kernel writes and its key kernel reads; with
// separate heads the forward's lse and delta = sum(do * o) from the stored
// o, which the caller gives
struct BwdHead {
  const float* q;
  const float* k;
  const float* v;
  size_t stride;
  const float* dout;
  size_t dout_stride;
  float* dq;
  float* dk;
  float* dv;
  size_t grad_stride;
  float* m;
  float* l;
  const float* lse;
  float* delta;
};

// packed: dout (n, L, D), dqkv like qkv, stats (3, n, heads, L) fp32: the
// row max, sum and delta
struct PackedQkvBwd {
  static constexpr bool kLse = false;
  const float* qkv;
  const float* dout;
  float* dqkv;
  float* stats;
  int n, heads;

  dim3 grid(int L) const { return dim3((L + kRows - 1) / kRows, heads, n); }
  __device__ BwdHead head(int L, int hd) const {
    const size_t d = static_cast<size_t>(heads) * hd;
    const size_t in = static_cast<size_t>(blockIdx.z) * L * 3 * d +
                      static_cast<size_t>(blockIdx.y) * hd;
    const size_t plane = static_cast<size_t>(n) * heads * L;
    float* m = stats + (static_cast<size_t>(blockIdx.z) * heads + blockIdx.y) * L;
    return {qkv + in, qkv + in + d, qkv + in + 2 * d, 3 * d,
            dout + static_cast<size_t>(blockIdx.z) * L * d + static_cast<size_t>(blockIdx.y) * hd,
            d, dqkv + in, dqkv + in + d, dqkv + in + 2 * d, 3 * d, m, m + plane, nullptr,
            m + 2 * plane};
  }
};

// separate heads: q, k, v, dout, dq, dk, dv (heads, L, hd) contiguous, lse
// and delta (heads, L) fp32; grid (ceil(L / 64), heads)
struct SeparateHeadsBwd {
  static constexpr bool kLse = true;
  const float* q;
  const float* k;
  const float* v;
  const float* dout;
  float* dq;
  float* dk;
  float* dv;
  const float* lse;
  float* delta;
  int heads;

  dim3 grid(int L) const { return dim3((L + kRows - 1) / kRows, heads); }
  __device__ BwdHead head(int L, int hd) const {
    const size_t base = static_cast<size_t>(blockIdx.y) * L * hd;
    const size_t row = static_cast<size_t>(blockIdx.y) * L;
    const size_t s = static_cast<size_t>(hd);
    return {q + base, k + base, v + base, s, dout + base, s, dq + base,
            dk + base, dv + base, s, nullptr, nullptr, lse + row, delta + row};
  }
};

// p from s and a row's statistics: with an lse (kLse; m holds it) p =
// exp(s - lse), _flash_bwd's function; else exp(s - m) / l correctly
// rounded, r = 1 / l
template <bool kLse>
__device__ __forceinline__ float row_prob(float s, float m, float l, float r) {
  if constexpr (kLse) {
    return expf(s - m);
  } else {
    return prob(s, m, l, r);
  }
}

// One pass over all keys for this warp's 16 queries (rows 16 warp .. of
// the Q tile qs, stride SQ): s by tile_logits, the running row max m and
// sum l, o = sum e . v with e = exp(s - m), o and l rescaled by exp(m_old -
// m_new) when m grows. K and V (rows at k, v + r * stride) stream through
// the two-tile rings ks and vs; the caller has issued the Q tile's copies,
// which the first wait covers. Ends synchronised, with o = o / l and m, l
// of rows g and g + 8.
template <int HD, int SQ>
__device__ __forceinline__ void attend(float (&o)[HD / 8][4], float (&m)[2], float (&l)[2],
                                       const float* qs, float* ks, float* vs, const float* k,
                                       const float* v, size_t stride, int L, float scale) {
  constexpr int SB = b_stride(HD);
  constexpr int kTile = kKeys * SB;
  const float* qw = qs + 16 * (threadIdx.x >> 5) * SQ;
  const int ntiles = (L + kKeys - 1) / kKeys;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[j][c] = 0.f;
  m[0] = m[1] = -INFINITY;
  l[0] = l[1] = 0.f;
  load_tile<HD, SB>(ks, k, stride, 0, L);
  load_tile<HD, SB>(vs, v, stride, 0, L);
  cp_async_commit();
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {
      load_tile<HD, SB>(ks + ((t + 1) & 1) * kTile, k, stride, (t + 1) * kKeys, L);
      load_tile<HD, SB>(vs + ((t + 1) & 1) * kTile, v, stride, (t + 1) * kKeys, L);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    float s[8][4];
    tile_logits<HD, SQ, SB>(s, qw, ks + (t & 1) * kTile, t * kKeys, L, scale);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      // the quad's four threads hold the row's 64 keys of this tile
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // every tile holds a key below L, so mn is finite; at the first tile
      // alpha = exp(-inf) = 0 scales the zeros
      const float mn = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - mn);
      l[r] *= alpha;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        o[j][2 * r] *= alpha;
        o[j][2 * r + 1] *= alpha;
      }
      m[r] = mn;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[j][2 * r] = expf(s[j][2 * r] - mn);
        s[j][2 * r + 1] = expf(s[j][2 * r + 1] - mn);
        l[r] += s[j][2 * r] + s[j][2 * r + 1];
      }
    }
    uint32_t pa[4][3][4];
    split_accumulators(pa, s);
    tile_accumulate<HD, SB>(o, pa, vs + (t & 1) * kTile);
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      o[j][2 * r] = __fdiv_rn(o[j][2 * r], l[r]);
      o[j][2 * r + 1] = __fdiv_rn(o[j][2 * r + 1], l[r]);
    }
  }
}

template <int HD, class Layout>
__global__ void __launch_bounds__(kThreads, 2)
attention_fwd_kernel(Layout layout, int L, float scale) {
  constexpr int SQ = a_stride(HD);
  constexpr int SB = b_stride(HD);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);  // this block's Q
  float* ks = qs + kRows * SQ;                      // K ring, 2 tiles
  float* vs = ks + 2 * kKeys * SB;                  // V ring, 2 tiles

  const FwdHead h = layout.head(L, HD);
  const int q0 = blockIdx.x * kRows;
  const int row0 = q0 + 16 * (threadIdx.x >> 5);
  load_tile<HD, SQ>(qs, h.q, h.stride, q0, L);
  float o[HD / 8][4], m[2], l[2];
  attend<HD, SQ>(o, m, l, qs, ks, vs, h.k, h.v, h.stride, L, scale);
  store_rows<HD>(h.o, h.out_stride, o, row0, L);
  if constexpr (Layout::kLse) {
    // lse = m + log l of rows g and g + 8, from the quad's first thread
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + (lane >> 2) + 8 * r;
      if ((lane & 3) == 0 && row < L) h.lse[row] = m[r] + logf(l[r]);
    }
  }
}

// The query kernel: dq += ds . k over all keys. With the packed layout its
// first pass is the forward's, for m, l and o, then delta = sum(do * o); it
// writes m, l and delta for the key kernel. With an lse it reads lse and
// delta and runs the second pass alone.
template <int HD, class Layout>
__global__ void __launch_bounds__(kThreads, 2)
attention_bwd_query_kernel(Layout layout, int L, float scale) {
  constexpr int SA = a_stride(HD);
  constexpr int SB = b_stride(HD);
  constexpr int kTile = kKeys * SB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);  // this block's Q
  float* gs = qs + kRows * SA;                      // and dO
  float* ks = gs + kRows * SA;                      // K ring, 2 tiles
  float* vs = ks + 2 * kTile;                       // V ring, 2 tiles

  const BwdHead h = layout.head(L, HD);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * kRows;
  const int ntiles = (L + kKeys - 1) / kKeys;
  const float* qw = qs + 16 * warp * SA;
  const float* gw = gs + 16 * warp * SA;

  load_tile<HD, SA>(qs, h.q, h.stride, q0, L);
  load_tile<HD, SA>(gs, h.dout, h.dout_stride, q0, L);
  // rows g and g + 8: m (or the lse), l and delta
  float m[2], l[2], delta[2];
  if constexpr (Layout::kLse) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // a query past L: lse = +inf makes its p, and so its ds, 0
      const int row = q0 + 16 * warp + (lane >> 2) + 8 * r;
      const bool valid = row < L;
      m[r] = valid ? h.lse[row] : INFINITY;
      l[r] = 1.f;
      delta[r] = valid ? h.delta[row] : 0.f;
    }
  } else {
    // ---- the forward's pass: m, l and o; then delta = sum(do * o) --------
    float o[HD / 8][4];
    attend<HD, SA>(o, m, l, qs, ks, vs, h.k, h.v, h.stride, L, scale);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float* g = gw + ((lane >> 2) + 8 * r) * SA + 2 * (lane & 3);
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        part = fmaf(g[8 * j], o[j][2 * r], part);
        part = fmaf(g[8 * j + 1], o[j][2 * r + 1], part);
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      delta[r] = part;
      const int row = q0 + 16 * warp + (lane >> 2) + 8 * r;
      if ((lane & 3) == 0 && row < L) {
        h.m[row] = m[r];
        h.l[row] = l[r];
        h.delta[row] = part;
      }
    }
  }
  const float rl[2] = {__frcp_rn(l[0]), __frcp_rn(l[1])};

  // ---- s, p, dp, ds over the key tiles; dq += ds . k -----------------------
  float dq[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) dq[j][c] = 0.f;
  load_tile<HD, SB>(ks, h.k, h.stride, 0, L);
  load_tile<HD, SB>(vs, h.v, h.stride, 0, L);
  cp_async_commit();
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {
      load_tile<HD, SB>(ks + ((t + 1) & 1) * kTile, h.k, h.stride, (t + 1) * kKeys, L);
      load_tile<HD, SB>(vs + ((t + 1) & 1) * kTile, h.v, h.stride, (t + 1) * kKeys, L);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* kt = ks + (t & 1) * kTile;
    float s[8][4], dp[8][4];
    tile_logits<HD, SA, SB>(s, qw, kt, t * kKeys, L, scale);
    tile_dots<HD, SA, SB>(dp, gw, vs + (t & 1) * kTile);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = c >> 1;
        s[j][c] = dscore(row_prob<Layout::kLse>(s[j][c], m[r], l[r], rl[r]), dp[j][c], delta[r],
                         scale);
      }
    uint32_t da[4][3][4];
    split_accumulators(da, s);
    tile_accumulate<HD, SB>(dq, da, kt);
    __syncthreads();
  }
  store_rows<HD>(h.dq, h.grad_stride, dq, q0 + 16 * warp, L);
}

template <int HD, class Layout>
__global__ void __launch_bounds__(kThreads, 2)
attention_bwd_key_kernel(Layout layout, int L, float scale) {
  constexpr int SA = a_stride(HD);
  constexpr int SB = b_stride(HD);
  constexpr int kDepth = key_depth(HD);
  constexpr int kTile = kRows * SB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* kb = reinterpret_cast<float*>(smem_raw);  // this block's K
  float* vb = kb + kKeys * SA;                      // and V
  float* qs = vb + kKeys * SA;                      // Q ring, kDepth tiles
  float* gs = qs + kDepth * kTile;                  // dO ring, the same
  float* pt = gs + kDepth * kTile;                  // p^T, [64 keys][kTStride]
  float* dt = pt + kKeys * kTStride;                // ds^T, the same

  const BwdHead h = layout.head(L, HD);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int k0 = blockIdx.x * kKeys;
  const int ntiles = (L + kRows - 1) / kRows;

  float dk[HD / 8][4], dv[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk[j][c] = dv[j][c] = 0.f;

  load_tile<HD, SA>(kb, h.k, h.stride, k0, L);
  load_tile<HD, SA>(vb, h.v, h.stride, k0, L);
  load_tile<HD, SB>(qs, h.q, h.stride, 0, L);
  load_tile<HD, SB>(gs, h.dout, h.dout_stride, 0, L);
  cp_async_commit();
  for (int t = 0; t < ntiles; ++t) {
    // two-deep: tile t + 1 is in flight while the block computes on tile t;
    // one-deep: tile t was issued at the end of the last iteration
    if (kDepth == 2 && t + 1 < ntiles) {
      load_tile<HD, SB>(qs + ((t + 1) & 1) * kTile, h.q, h.stride, (t + 1) * kRows, L);
      load_tile<HD, SB>(gs + ((t + 1) & 1) * kTile, h.dout, h.dout_stride, (t + 1) * kRows, L);
    }
    cp_async_commit();
    cp_async_wait<kDepth - 1>();
    __syncthreads();
    const int buf = kDepth == 2 ? (t & 1) : 0;
    const float* qt = qs + buf * kTile;
    const float* gt = gs + buf * kTile;

    // ---- this warp's 16 queries of the tile against the block's 64 keys:
    //      p and ds in fp32, stored transposed; p first, then dp and ds
    //      (each thread reads back the p it stored), so s and dp are not
    //      both live
    float m[2], l[2], dl[2], rl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = t * kRows + 16 * warp + (lane >> 2) + 8 * r;
      // a query past L: m (or lse) = +inf makes its p, and so its ds, 0
      const bool valid = row < L;
      if constexpr (Layout::kLse) {
        m[r] = valid ? h.lse[row] : INFINITY;
        l[r] = 1.f;
      } else {
        m[r] = valid ? h.m[row] : INFINITY;
        l[r] = valid ? h.l[row] : 1.f;
      }
      dl[r] = valid ? h.delta[row] : 0.f;
      rl[r] = __frcp_rn(l[r]);
    }
    // element (j, c) of row r: key 8j + 2t + (c & 1), query ql(r) of the tile
    float* prow = pt + 2 * (lane & 3) * kTStride + 16 * warp + (lane >> 2);
    float* drow = dt + (prow - pt);
    {
      float s[8][4];
      tile_logits<HD, SB, SA>(s, qt + 16 * warp * SB, kb, k0, L, scale);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          prow[(8 * j + (c & 1)) * kTStride + 8 * (c >> 1)] =
              row_prob<Layout::kLse>(s[j][c], m[c >> 1], l[c >> 1], rl[c >> 1]);
    }
    {
      float dp[8][4];
      tile_dots<HD, SB, SA>(dp, gt + 16 * warp * SB, vb);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int at = (8 * j + (c & 1)) * kTStride + 8 * (c >> 1);
          drow[at] = dscore(prow[at], dp[j][c], dl[c >> 1], scale);
        }
    }
    __syncthreads();

    // ---- this warp's 16 keys: dv += p^T . dO, then dk += ds^T . Q ----------
    {
      uint32_t a[4][3][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) load_a(a[kk], pt + 16 * warp * kTStride, kTStride, 16 * kk);
      tile_accumulate<HD, SB>(dv, a, gt);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) load_a(a[kk], dt + 16 * warp * kTStride, kTStride, 16 * kk);
      tile_accumulate<HD, SB>(dk, a, qt);
    }
    __syncthreads();
    if (kDepth == 1 && t + 1 < ntiles) {
      load_tile<HD, SB>(qs, h.q, h.stride, (t + 1) * kRows, L);
      load_tile<HD, SB>(gs, h.dout, h.dout_stride, (t + 1) * kRows, L);
    }
  }
  store_rows<HD>(h.dk, h.grad_stride, dk, k0 + 16 * warp, L);
  store_rows<HD>(h.dv, h.grad_stride, dv, k0 + 16 * warp, L);
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

// the current device's index, below kMaxDevices
inline cudaError_t device_index(int& dev) {
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return dev < kMaxDevices ? cudaSuccess : cudaErrorInvalidDevice;
}

template <int HD, class Layout>
cudaError_t launch_fwd_hd(const Layout& layout, int L, float scale, cudaStream_t stream) {
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = device_index(dev);
  if (err != cudaSuccess) return err;
  if (!configured[dev]) {
    err = configure(attention_fwd_kernel<HD, Layout>, fwd_smem_bytes(HD));
    if (err != cudaSuccess) return err;
    configured[dev] = true;
  }
  attention_fwd_kernel<HD, Layout>
      <<<layout.grid(L), kThreads, fwd_smem_bytes(HD), stream>>>(layout, L, scale);
  return cudaGetLastError();
}

template <int HD, class Layout>
cudaError_t launch_bwd_hd(const Layout& layout, int L, float scale, cudaStream_t stream) {
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = device_index(dev);
  if (err != cudaSuccess) return err;
  if (!configured[dev]) {
    err = configure(attention_bwd_query_kernel<HD, Layout>, query_smem_bytes(HD));
    if (err != cudaSuccess) return err;
    err = configure(attention_bwd_key_kernel<HD, Layout>, key_smem_bytes(HD));
    if (err != cudaSuccess) return err;
    configured[dev] = true;
  }
  attention_bwd_query_kernel<HD, Layout>
      <<<layout.grid(L), kThreads, query_smem_bytes(HD), stream>>>(layout, L, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_bwd_key_kernel<HD, Layout>
      <<<layout.grid(L), kThreads, key_smem_bytes(HD), stream>>>(layout, L, scale);
  return cudaGetLastError();
}

// The forward at head dim hd (a multiple of 8, at most kMaxHd) in a layout
// (PackedQkv, SeparateHeads), one instantiation per hd, so every loop over
// hd unrolls. q, k and v must be 16-byte aligned (cp.async).
template <class Layout, int HD = 8>
cudaError_t launch_fwd(const Layout& layout, int L, int hd, float scale, cudaStream_t stream) {
  if (hd == HD) return launch_fwd_hd<HD>(layout, L, scale, stream);
  if constexpr (HD < kMaxHd) {
    return launch_fwd<Layout, HD + 8>(layout, L, hd, scale, stream);
  } else {
    return cudaErrorInvalidValue;
  }
}

// Both backward kernels (PackedQkvBwd, SeparateHeadsBwd), likewise; q, k,
// v and dout 16-byte aligned.
template <class Layout, int HD = 8>
cudaError_t launch_bwd(const Layout& layout, int L, int hd, float scale, cudaStream_t stream) {
  if (hd == HD) return launch_bwd_hd<HD>(layout, L, scale, stream);
  if constexpr (HD < kMaxHd) {
    return launch_bwd<Layout, HD + 8>(layout, L, hd, scale, stream);
  } else {
    return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace attention_fp32_mma
