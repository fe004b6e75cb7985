// The tensor-core pieces of the bf16 ConditionalLogBinomial MLP, with the
// condition projected at low resolution: the tiles, weight layouts and mma
// helpers that csrc/clb_pt.cu's bf16 kernel (whose design note is in
// csrc/clb_pt.cu) and csrc/clb_depth.cu's kernel share.
#pragma once

#include "common.cuh"

namespace pf {
namespace tc {

constexpr int kHid = pf::kClbHidden;  // 80: ten 8-column n-tiles
constexpr int kNT = kHid / 8;
constexpr int kCc = 128;              // condition channels
constexpr int kCinPad = 48;           // input channels, padded to 3 k-steps
constexpr int kKAll = kCinPad + kCc;  // W1 rows as staged
constexpr int kWStride = kKAll + 8;   // bf16 per staged W1 row (n)
constexpr int kTH = 8, kTW = 32;      // output tile
constexpr int kTilePx = kTH * kTW;    // 256 = 16 m-tiles of 16 pixels
constexpr int kLastStride = kTilePx + 8;  // bf16 per staged channel row
constexpr int kProjStride = kHid + 8;     // f32 per projected pixel
constexpr int kW2Stride = kHid + 8;       // bf16 per W2 row (output n)
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
static_assert(kTilePx / 16 == 2 * kWarps, "two m-tiles of a tile per warp");

// Shared memory of the bf16 kernel, in bytes, for a footprint of fpad
// (a multiple of 16) low-resolution pixels.
__host__ __device__ constexpr size_t bf16_smem_bytes(int fpad) {
  return 2 * static_cast<size_t>(kHid) * kWStride * 2  // W1 hi, lo
         + 8 * kW2Stride * 2                           // W2 (n padded to 8)
         + (kHid + 4) * 4                              // b1, b2
         + static_cast<size_t>(kCinPad) * kLastStride * 2  // last_cat tile
         + static_cast<size_t>(kCc) * (fpad + 8) * 2       // cond footprint
         + static_cast<size_t>(fpad) * kProjStride * 4;    // projection
}

// The largest footprint of a tile of `tile` outputs over a resize of
// `out` -> `in` with align_corners (taps i0 = floor(d (in-1)/(out-1)) and
// i0 + 1): the span of the tile's first and last taps, plus one.
__host__ __device__ inline int max_footprint(int tile, int out, int in) {
  if (out <= 1) return 2;
  const double r = static_cast<double>(in - 1) / (out - 1);
  int f = static_cast<int>(r * (tile - 1)) + 3;
  return f < in ? f : in;
}

// Staged footprint pixels, padded to the m-tiles of the projection: rows
// of up to max_footprint + 7 columns rounded to 8 (the vector loads' left
// shift).
inline int footprint_pad(int OH, int OW, int IH, int IW) {
  const int w = (max_footprint(kTW, OW, IW) + 7 + 7) & ~7;
  return (max_footprint(kTH, OH, IH) * w + 15) / 16 * 16;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d += a (16x16 bf16, row) . b (16x8 bf16, col), f32 accumulate.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment (16 pixels x 16 channels) of a channel-major smem array
// (rows = channels k, each row `stride` bf16 along pixels m) at (k0, m0):
// four 8x8 matrices through ldmatrix.trans.
__device__ __forceinline__ void load_a_trans(uint32_t (&a)[4],
                                             const __nv_bfloat16* base,
                                             int stride, int k0, int m0) {
  const int lane = threadIdx.x & 31;
  const int mat = lane >> 3, r = lane & 7;
  // matrices: (m 0-7, k 0-7), (m 8-15, k 0-7), (m 0-7, k 8-15),
  // (m 8-15, k 8-15), i.e. the fragment registers a0 .. a3
  const __nv_bfloat16* p =
      base + (k0 + r + 8 * (mat >> 1)) * stride + m0 + 8 * (mat & 1);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(smem_u32(p)));
}

// The B fragments (16 input channels k0 .. k0 + 15) of hidden n-tiles n0
// and n0 + 8 from a staged (hidden, k) weight: one ldmatrix.x4, b0 and b1
// of n0, then of n0 + 8.
__device__ __forceinline__ void load_b_pair(uint32_t (&b)[4],
                                            const __nv_bfloat16* w, int n0,
                                            int k0) {
  const int lane = threadIdx.x & 31;
  const int mat = lane >> 3, r = lane & 7;
  const __nv_bfloat16* p =
      w + (n0 + r + 8 * (mat >> 1)) * kWStride + k0 + 8 * (mat & 1);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
      : "r"(smem_u32(p)));
}

// acc[m] += a[m] . W1[k0 .. k0 + 15, :] for M m-tiles and all ten hidden
// n-tiles, W1 as its bf16 hi and lo parts; each B fragment is loaded once
// for the M m-tiles.
template <int M>
__device__ __forceinline__ void mma_w1(float (&acc)[M][kNT][4],
                                       const uint32_t (&a)[M][4],
                                       const __nv_bfloat16* w_hi,
                                       const __nv_bfloat16* w_lo, int k0) {
#pragma unroll
  for (int np = 0; np < kNT / 2; ++np)
#pragma unroll
    for (int part = 0; part < 2; ++part) {
      uint32_t b[4];
      load_b_pair(b, part ? w_lo : w_hi, 16 * np, k0);
#pragma unroll
      for (int m = 0; m < M; ++m) {
        mma_16816(acc[m][2 * np], a[m], b[0], b[1]);
        mma_16816(acc[m][2 * np + 1], a[m], b[2], b[3]);
      }
    }
}

// i / d and i % d for the small divisors of the staging loops: one
// multiply-high with m = ceil(2^32 / d), exact for i d < 2^32.
struct FastDiv {
  uint64_t m;
  uint32_t d;
  __device__ explicit FastDiv(uint32_t div)
      : m(((1ull << 32) + div - 1) / div), d(div) {}
  __device__ __forceinline__ uint32_t div(uint32_t i) const {
    return static_cast<uint32_t>((i * m) >> 32);
  }
};

__device__ __forceinline__ float bf16r(float x) {
  return pf::round_to<__nv_bfloat16>(x);
}

// A tile's place and its footprint: rows iy_lo .. iy_lo + fy - 1 and
// columns ix_lo .. ix_lo + fx - 1 of cond_lo, staged as fy rows of w
// pixels from column ix_lo - shift (w >= fx + shift; the vector loads
// start at 16-byte boundaries).
struct TileGeom {
  int b, y0, x0, iy_lo, ix_lo, fy, fx, shift, w;
};

__device__ __forceinline__ TileGeom tile_geom(int tile, int tiles_y,
                                              int tiles_x, int OH, int OW,
                                              int IH, int IW) {
  TileGeom g;
  g.x0 = (tile % tiles_x) * kTW;
  g.y0 = ((tile / tiles_x) % tiles_y) * kTH;
  g.b = tile / (tiles_x * tiles_y);
  const int y1 = min(g.y0 + kTH, OH) - 1, x1 = min(g.x0 + kTW, OW) - 1;
  g.iy_lo = pf::align_corners_tap(g.y0, OH, IH).i0;
  g.ix_lo = pf::align_corners_tap(g.x0, OW, IW).i0;
  g.fy = pf::align_corners_tap(y1, OH, IH).i1 - g.iy_lo + 1;
  g.fx = pf::align_corners_tap(x1, OW, IW).i1 - g.ix_lo + 1;
  g.shift = 0;
  g.w = g.fx;
  return g;
}

// Whether a (B, H, W, C) view is a permuted NCHW tensor whose rows start
// on `align`-element boundaries: then its rows are read in vectors.
__device__ __forceinline__ bool rows_aligned(const void* base, pf::Strides4 s,
                                             int align) {
  return s.x == 1 && s.y % align == 0 && s.c % align == 0 &&
         s.b % align == 0 &&
         reinterpret_cast<uintptr_t>(base) % (2 * align) == 0;
}

}  // namespace tc
}  // namespace pf
