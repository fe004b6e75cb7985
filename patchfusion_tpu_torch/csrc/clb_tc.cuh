// The bf16 ConditionalLogBinomial MLP on tensor cores, with the condition
// projected at low resolution: the body of csrc/clb_pt.cu's bf16 kernel
// and, with kDepth, of csrc/clb_depth.cu's, which adds the log-binomial
// depth expectation (pf::logbinom_depth) per output pixel: the tile's
// footprint of the bin centers is staged in the condition's buffer once
// the projection is done with it, and each lane of a warp takes one of the
// warp's 32 pixels. The design note is in csrc/clb_pt.cu.
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

// What the fused kernel adds: the bin centers (B, IH, IW, K) and their
// strides, the temperatures, and the depth output.
struct DepthArgs {
  const __nv_bfloat16* centers;
  Strides4 zs;
  int K;
  float min_temp, max_temp;
  float* out;
};

template <bool kDepth>
__global__ void __launch_bounds__(kThreads, 1)
clb_tc_kernel(const __nv_bfloat16* __restrict__ last,
                   const __nv_bfloat16* __restrict__ cond,
                   const float* __restrict__ w1, const float* __restrict__ b1,
                   const float* __restrict__ w2, const float* __restrict__ b2,
                   float* __restrict__ p_out, float* __restrict__ t_out,
                   int B, int OH, int OW, int IH, int IW, int Cin,
                   pf::Strides4 ls, pf::Strides4 cs, float p_eps, int fpad,
                   DepthArgs dz) {
  extern __shared__ __align__(16) uint8_t smem_bf16[];
  __nv_bfloat16* w_hi = reinterpret_cast<__nv_bfloat16*>(smem_bf16);
  __nv_bfloat16* w_lo = w_hi + kHid * kWStride;
  __nv_bfloat16* w2s = w_lo + kHid * kWStride;
  float* b1s = reinterpret_cast<float*>(w2s + 8 * kW2Stride);
  float* b2s = b1s + kHid;
  __nv_bfloat16* last_s = reinterpret_cast<__nv_bfloat16*>(b2s + 4);
  __nv_bfloat16* cond_s = last_s + kCinPad * kLastStride;
  const int cstride = fpad + 8;
  float* proj = reinterpret_cast<float*>(cond_s + kCc * cstride);
  float* c0 = proj + fpad * kProjStride;  // with kDepth: log C(K-1, k)

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  // ---- weights, once per block: W1 (Cin + Cc, H) f32 -> (H, k) bf16 hi
  // and lo with the input rows padded to 48; W2 (H, 4) -> (8, H) bf16
  for (int i = threadIdx.x; i < kHid * kKAll; i += kThreads) {
    const int n = i / kKAll, k = i % kKAll;
    float v = 0.f;
    if (k < kCinPad) {
      if (k < Cin) v = w1[k * kHid + n];
    } else {
      v = w1[(Cin + k - kCinPad) * kHid + n];
    }
    const __nv_bfloat16 hi = __float2bfloat16(v);
    w_hi[n * kWStride + k] = hi;
    w_lo[n * kWStride + k] = __float2bfloat16(v - __bfloat162float(hi));
  }
  for (int i = threadIdx.x; i < 8 * kHid; i += kThreads) {
    const int n = i / kHid, k = i % kHid;
    w2s[n * kW2Stride + k] = __float2bfloat16(n < 4 ? w2[k * 4 + n] : 0.f);
  }
  for (int i = threadIdx.x; i < kHid; i += kThreads) b1s[i] = b1[i];
  if (threadIdx.x < 4) b2s[threadIdx.x] = b2[threadIdx.x];
  if (kDepth) pf::fill_log_binom_c0(c0, dz.K);
  // the padding input channels stay zero for every tile
  for (int i = threadIdx.x; i < (kCinPad - Cin) * kTilePx; i += kThreads)
    last_s[(Cin + i / kTilePx) * kLastStride + i % kTilePx] =
        __float2bfloat16(0.f);

  const bool last_vec = rows_aligned(last, ls, 2);
  const bool cond_vec = rows_aligned(cond, cs, 8);
  // the centers share the condition's staged geometry, so they take vector
  // loads only where it does
  const bool cent_vec =
      kDepth && cond_vec && rows_aligned(dz.centers, dz.zs, 8);
  const int tiles_x = (OW + kTW - 1) / kTW, tiles_y = (OH + kTH - 1) / kTH;
  const int n_tiles = B * tiles_x * tiles_y;
  // a tile's geometry, with the vector loads' row width and shift
  auto geom = [&](int tile) {
    TileGeom g2 = tile_geom(tile, tiles_y, tiles_x, OH, OW, IH, IW);
    if (cond_vec) {
      g2.shift = g2.ix_lo & 7;
      g2.w = (g2.fx + g2.shift + 7) & ~7;
    }
    return g2;
  };
  // the footprint of channels 0 .. n_c - 1 of a low-resolution map (cond_lo,
  // or with kDepth the centers) into cond_s, channel-major: in 16-byte
  // vectors (channel, row, vector) from the 8-pixel boundary at or before
  // ix_lo, kCU per thread in flight at once, where the map's rows allow;
  // else one element per load, at the same places
  constexpr int kCU = 12;
  auto stage_lo = [&](const TileGeom& g2, const __nv_bfloat16* src,
                      const pf::Strides4& s, int n_c, bool vec) {
    if (vec) {
      const int nv = g2.w >> 3, per_c = g2.fy * nv;
      const FastDiv by_c(per_c), by_v(nv);
      for (int i0 = 0; i0 < n_c * per_c; i0 += kCU * kThreads) {
        uint4 v[kCU];
#pragma unroll
        for (int u = 0; u < kCU; ++u) {
          const int i = i0 + threadIdx.x + u * kThreads;
          v[u] = make_uint4(0u, 0u, 0u, 0u);
          if (i < n_c * per_c) {
            const int c = by_c.div(i), rv = i - c * per_c;
            const int row = by_v.div(rv);
            const int iy = g2.iy_lo + row;
            const int ix = g2.ix_lo - g2.shift + 8 * (rv - row * nv);
            if (ix < IW)
              v[u] = *reinterpret_cast<const uint4*>(
                  src + g2.b * s.b + iy * s.y + ix + c * s.c);
          }
        }
#pragma unroll
        for (int u = 0; u < kCU; ++u) {
          const int i = i0 + threadIdx.x + u * kThreads;
          if (i < n_c * per_c) {
            const int c = by_c.div(i), rv = i - c * per_c;
            const int row = by_v.div(rv);
            *reinterpret_cast<uint4*>(cond_s + c * cstride + row * g2.w +
                                      8 * (rv - row * nv)) = v[u];
          }
        }
      }
    } else {
      const int per_c = g2.fy * g2.fx;
      for (int i = threadIdx.x; i < n_c * per_c; i += kThreads) {
        const int c = i / per_c, p = i % per_c;
        const int row = p / g2.fx, col = p % g2.fx;
        cond_s[c * cstride + row * g2.w + g2.shift + col] =
            src[g2.b * s.b + (g2.iy_lo + row) * s.y + (g2.ix_lo + col) * s.x +
                c * s.c];
      }
    }
  };

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const TileGeom tg = geom(tile);
    const int F = tg.fy * tg.w;
    __syncthreads();  // the previous tile is done with the staging buffers

    // ---- stage the tile's last_cat (Cin x 256) and the footprint of
    // cond_lo (128 x fy x w), channel-major. In permuted-NCHW views x is
    // contiguous: a warp reads a channel row of last_cat as 4-byte pairs
    // and a footprint row of cond_lo as 16-byte vectors from the 8-pixel
    // boundary at or before ix_lo, all of a thread's loads in flight at
    // once; other layouts take one element per load.
    if (last_vec) {
      // runs (channel, row): 16 lanes x 2 pixels each
      constexpr int kU = 9;  // runs per half-warp and batch
      const int half = lane >> 4, j = lane & 15;
      for (int r0 = 2 * kU * warp; r0 < Cin * kTH; r0 += 2 * kU * kWarps) {
        uint32_t v[kU];
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const int run = r0 + 2 * u + half;
          const int c = run / kTH, y = tg.y0 + run % kTH;
          const int x = tg.x0 + 2 * j;
          v[u] = 0u;
          if (run < Cin * kTH && y < OH && x < OW)
            v[u] = *reinterpret_cast<const uint32_t*>(
                last + tg.b * ls.b + y * ls.y + x + c * ls.c);
        }
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const int run = r0 + 2 * u + half;
          if (run < Cin * kTH)
            *reinterpret_cast<uint32_t*>(
                last_s + (run / kTH) * kLastStride + (run % kTH) * kTW +
                2 * j) = v[u];
        }
      }
    } else {
      for (int i = threadIdx.x; i < Cin * kTilePx; i += kThreads) {
        const int c = i / kTilePx, px = i % kTilePx;
        const int y = tg.y0 + px / kTW, x = tg.x0 + px % kTW;
        if (y < OH && x < OW)
          last_s[c * kLastStride + px] =
              last[tg.b * ls.b + y * ls.y + x * ls.x + c * ls.c];
      }
    }
    stage_lo(tg, cond, cs, kCc, cond_vec);
    __syncthreads();

    // ---- project the footprint: proj (F, 80) = cond (F, 128) . W1[Cin:]
    // in f32 from the hi and lo products
    for (int mt = warp; mt * 16 < F; mt += kWarps) {
      float acc[1][kNT][4] = {};
#pragma unroll
      for (int ks = 0; ks < kCc / 16; ++ks) {
        uint32_t a[1][4];
        load_a_trans(a[0], cond_s, cstride, 16 * ks, 16 * mt);
        mma_w1<1>(acc, a, w_hi, w_lo, kCinPad + 16 * ks);
      }
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<float2*>(
              proj + (16 * mt + g + 8 * r) * kProjStride + 8 * n + 2 * t) =
              make_float2(acc[0][n][2 * r], acc[0][n][2 * r + 1]);
    }
    __syncthreads();
    // the centers' footprint takes the condition's place (K <= 128); read
    // after the __syncthreads before the depth epilogue
    if constexpr (kDepth) stage_lo(tg, dz.centers, dz.zs, dz.K, cent_vec);

    // ---- per m-tile of 16 output pixels (one row, 16 columns): the input
    // term, the lerped condition term, GELU, W2, softplus, p and t
    // the input term of the warp's two m-tiles, warp and warp + 8
    float acc2[2][kNT][4] = {};
    // with kDepth: (p or t) of pixels g and g + 8 of each m-tile, as pt
    float ptm[2][2] = {};
#pragma unroll
    for (int ks = 0; ks < kCinPad / 16; ++ks) {
      uint32_t a[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m)
        load_a_trans(a[m], last_s, kLastStride, 16 * ks,
                     16 * (warp + kWarps * m));
      mma_w1<2>(acc2, a, w_hi, w_lo, 16 * ks);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int mt = warp + kWarps * mi;
      const int y = tg.y0 + mt / (kTW / 16);
      if (y >= OH) continue;
      const int xm = tg.x0 + 16 * (mt % (kTW / 16));
      float (&acc)[kNT][4] = acc2[mi];
      // this thread's pixels: columns xm + g and xm + g + 8
      const pf::Tap ty = pf::align_corners_tap(y, OH, IH);
      const float* c00[2];
      const float* c01[2];
      const float* c10[2];
      const float* c11[2];
      float wx[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int x = min(xm + g + 8 * r, OW - 1);
        const pf::Tap tx = pf::align_corners_tap(x, OW, IW);
        wx[r] = tx.w;
        const int p00 =
            (ty.i0 - tg.iy_lo) * tg.w + tx.i0 - tg.ix_lo + tg.shift;
        const int p10 =
            (ty.i1 - tg.iy_lo) * tg.w + tx.i0 - tg.ix_lo + tg.shift;
        const int dx = tx.i1 - tx.i0;
        c00[r] = proj + p00 * kProjStride + 2 * t;
        c01[r] = c00[r] + dx * kProjStride;
        c10[r] = proj + p10 * kProjStride + 2 * t;
        c11[r] = c10[r] + dx * kProjStride;
      }
      // h = input term + lerp(condition term) + b1, rounded; GELU, rounded
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        const float2 bb = *reinterpret_cast<const float2*>(b1s + 8 * n + 2 * t);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int o = 8 * n;
          const float2 v00 = *reinterpret_cast<const float2*>(c00[r] + o);
          const float2 v10 = *reinterpret_cast<const float2*>(c10[r] + o);
          const float2 v01 = *reinterpret_cast<const float2*>(c01[r] + o);
          const float2 v11 = *reinterpret_cast<const float2*>(c11[r] + o);
          // H lerp, then W lerp (pf::Corners::at's order)
          const float a0x = v00.x * (1.f - ty.w) + v10.x * ty.w;
          const float a1x = v01.x * (1.f - ty.w) + v11.x * ty.w;
          const float a0y = v00.y * (1.f - ty.w) + v10.y * ty.w;
          const float a1y = v01.y * (1.f - ty.w) + v11.y * ty.w;
          const float ux = a0x * (1.f - wx[r]) + a1x * wx[r];
          const float uy = a0y * (1.f - wx[r]) + a1y * wx[r];
          acc[n][2 * r] = bf16r(
              pf::gelu_tanh<__nv_bfloat16>(bf16r(acc[n][2 * r] + ux + bb.x)));
          acc[n][2 * r + 1] = bf16r(pf::gelu_tanh<__nv_bfloat16>(
              bf16r(acc[n][2 * r + 1] + uy + bb.y)));
        }
      }
      // (p0, p1, t0, t1) = GELU . W2: the accumulators of hidden columns
      // 16 kk .. 16 kk + 15 are the A fragment of k-step kk
      float out[4] = {};
#pragma unroll
      for (int kk = 0; kk < kHid / 16; ++kk) {
        const uint32_t a[4] = {
            pack_bf16x2(acc[2 * kk][0], acc[2 * kk][1]),
            pack_bf16x2(acc[2 * kk][2], acc[2 * kk][3]),
            pack_bf16x2(acc[2 * kk + 1][0], acc[2 * kk + 1][1]),
            pack_bf16x2(acc[2 * kk + 1][2], acc[2 * kk + 1][3])};
        const __nv_bfloat16* wr = w2s + g * kW2Stride + 16 * kk + 2 * t;
        mma_16816(out, a, *reinterpret_cast<const uint32_t*>(wr),
                  *reinterpret_cast<const uint32_t*>(wr + 8));
      }
      // thread t = 0 holds (p0, p1), t = 1 holds (t0, t1), of pixels g and
      // g + 8
      float pt[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int o = 2 * (t & 1);
        const float s0 = pf::softplus(out[2 * r] + b2s[o]) + p_eps;
        const float s1 = pf::softplus(out[2 * r + 1] + b2s[o + 1]) + p_eps;
        pt[r] = s0 / (s0 + s1);
      }
      if constexpr (kDepth) {
        ptm[mi][0] = pt[0];
        ptm[mi][1] = pt[1];
      } else if (t < 2) {
        float* dst = t == 0 ? p_out : t_out;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int x = xm + g + 8 * r;
          if (x < OW)
            dst[(static_cast<long long>(tg.b) * OH + y) * OW + x] = pt[r];
        }
      }
    }

    if constexpr (kDepth) {
      // the depth of the warp's 32 pixels, one per lane: lane L takes
      // column j = L % 16 of m-tile warp + 8 (L / 16), whose p and t lanes
      // 4 (j % 8) and 4 (j % 8) + 1 hold in ptm[L / 16][j / 8]
      const int mi = lane >> 4, j = lane & 15, src = 4 * (j & 7);
      float pq[2][2], tq[2][2];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          pq[m][r] = __shfl_sync(0xffffffffu, ptm[m][r], src);
          tq[m][r] = __shfl_sync(0xffffffffu, ptm[m][r], src + 1);
        }
      const bool hi = j >= 8;
      const float pp =
          mi ? (hi ? pq[1][1] : pq[1][0]) : (hi ? pq[0][1] : pq[0][0]);
      const float tt =
          mi ? (hi ? tq[1][1] : tq[1][0]) : (hi ? tq[0][1] : tq[0][0]);
      const int mt = warp + kWarps * mi;
      const int y = tg.y0 + mt / (kTW / 16);
      const int x = tg.x0 + 16 * (mt % (kTW / 16)) + j;
      __syncthreads();  // the centers are staged
      if (y < OH && x < OW) {
        // the centers' window in cond_s starts at (iy_lo, ix_lo - shift)
        const pf::Corners<__nv_bfloat16> cent(
            cond_s, pf::Strides4{0, tg.w, 1, cstride},
            pf::align_corners_tap(y, OH, IH), pf::align_corners_tap(x, OW, IW),
            tg.iy_lo, tg.ix_lo - tg.shift);
        dz.out[(static_cast<long long>(tg.b) * OH + y) * OW + x] =
            pf::logbinom_depth(pp, tt, cent, c0, dz.K, dz.min_temp,
                               dz.max_temp);
      }
    }
  }
}

// Shared memory of the kernel, in bytes, for these sizes and K bins (0
// without kDepth).
inline size_t smem_bytes(int OH, int OW, int IH, int IW, int K) {
  return bf16_smem_bytes(footprint_pad(OH, OW, IH, IW)) +
         static_cast<size_t>(K) * 4;
}

template <bool kDepth>
cudaError_t launch(const __nv_bfloat16* last, const __nv_bfloat16* cond,
                   const float* w1, const float* b1, const float* w2,
                   const float* b2, float* p_out, float* t_out, int B, int OH,
                   int OW, int IH, int IW, int Cin, int Cc, pf::Strides4 ls,
                   pf::Strides4 cs, float p_eps, DepthArgs dz, int device,
                   cudaStream_t stream) {
  if (Cc != kCc || Cin < 1 || Cin > kCinPad || IH > OH || IW > OW ||
      (kDepth && (dz.K < 1 || dz.K > kCc)))
    return cudaErrorInvalidValue;
  const int fpad = footprint_pad(OH, OW, IH, IW);
  const size_t smem = smem_bytes(OH, OW, IH, IW, kDepth ? dz.K : 0);
  cudaError_t err = cudaFuncSetAttribute(
      clb_tc_kernel<kDepth>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long tiles = static_cast<long long>(B) *
                          ((OH + kTH - 1) / kTH) * ((OW + kTW - 1) / kTW);
  if (tiles == 0) return cudaSuccess;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const int blocks = static_cast<int>(tiles < sms ? tiles : sms);
  clb_tc_kernel<kDepth><<<blocks, kThreads, smem, stream>>>(
      last, cond, w1, b1, w2, b2, p_out, t_out, B, OH, OW, IH, IW, Cin, ls,
      cs, p_eps, fpad, dz);
  return cudaGetLastError();
}

}  // namespace tc
}  // namespace pf
