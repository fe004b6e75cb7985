// ConditionalLogBinomial MLP of the metric-bins head, for sm_90a.
//
// Replaces: patchfusion_tpu/ops/pallas_head.py::clb_pt (Pallas kernel
// _clb_pt_impl). Per output pixel (b, y, x):
//   h   = last_cat[b,y,x,:] . W1[:Cin] + up(cond_lo . W1[Cin:])[b,y,x] + b1
//         (H = 80; up = bilinear align_corners=True from IH x IW)
//   g   = tanh-GELU(h) at the input dtype
//   s   = softplus(g . W2 + b2)                                 (4 values)
//   p   = (s0+eps) / (s0+s1+2eps),  t = (s2+eps) / (s2+s3+2eps)
// writing only p and t; the full-resolution 80-channel bottleneck never
// reaches memory.
//
// What bounds it on the H100: it reads Cin = 33 bf16 per output pixel and
// 128 per low-resolution pixel and writes 8 bytes per output pixel: 128 MB
// at B = 4, 392x518 from 224x296, ~38 us at 3.35 TB/s. Its products, with
// the condition projected at low resolution, are ~13 GFLOP, ~13 us on the
// tensor cores. So it is bound by bytes, with the per-pixel epilogue
// (lerp of 80 channels, GELU, W2, softplus) on the FMA pipes beside.
//
// bf16 design (the main path's inputs):
//   * persistent blocks of 8 warps, each staging the weights once: W1 split
//     into bf16 hi + lo parts (the TPU kernel multiplies by an f32 W1; two
//     bf16 products keep ~16 bits of it), as mma B operands laid out
//     (hidden, input channel), and W2 rounded to bf16 like the TPU kernel's
//     W2 at the input dtype.
//   * per output tile of 8 rows x 32 columns: its low-resolution footprint
//     of cond_lo, 128 channels, is staged channel-major (each channel's row
//     is contiguous along x in the permuted-NCHW view, so the loads
//     coalesce) and projected through W1[Cin:] on the tensor cores
//     (mma.sync m16n8k16, A from ldmatrix.trans) into an f32 (footprint
//     pixel, 80) array: the TPU kernel's order (project, then lerp), so the
//     128 x 80 product runs on the low-resolution pixels only.
//   * the tile's last_cat pixels, Cin channels zero-padded to 48, go
//     through W1[:Cin] the same way; each output pixel then adds the lerp
//     of its four corners' 80 projected channels and b1 in the mma
//     accumulator layout, rounds to bf16, applies tanh-GELU with
//     tanh.approx.f32 (its error lies under the bf16 rounding that
//     follows), rounds again, and multiplies by W2 as one more mma (N = 4
//     padded to 8) whose A fragments are the accumulators repacked.
//   * softplus, p and t as pf::clb_pixel does.
// f32 inputs (not on the main path) keep the first design: one thread per
// pixel with pf::clb_pixel (common.cuh), shared with csrc/clb_depth.cu.

#include "clb_tc.cuh"
#include "common.cuh"

namespace pf {
namespace tc {

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads, 1)
clb_tc_kernel(const __nv_bfloat16* __restrict__ last,
                   const __nv_bfloat16* __restrict__ cond,
                   const float* __restrict__ w1, const float* __restrict__ b1,
                   const float* __restrict__ w2, const float* __restrict__ b2,
                   float* __restrict__ p_out, float* __restrict__ t_out,
                   int B, int OH, int OW, int IH, int IW, int Cin,
                   pf::Strides4 ls, pf::Strides4 cs, float p_eps, int fpad) {
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
  // the padding input channels stay zero for every tile
  for (int i = threadIdx.x; i < (kCinPad - Cin) * kTilePx; i += kThreads)
    last_s[(Cin + i / kTilePx) * kLastStride + i % kTilePx] =
        __float2bfloat16(0.f);

  const bool last_vec = rows_aligned(last, ls, 2);
  const bool cond_vec = rows_aligned(cond, cs, 8);
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
  // the footprint of channels 0 .. n_c - 1 of cond_lo into cond_s,
  // channel-major: in 16-byte
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

    // ---- per m-tile of 16 output pixels (one row, 16 columns): the input
    // term, the lerped condition term, GELU, W2, softplus, p and t
    // the input term of the warp's two m-tiles, warp and warp + 8
    float acc2[2][kNT][4] = {};
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
      if (t < 2) {
        float* dst = t == 0 ? p_out : t_out;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int x = xm + g + 8 * r;
          if (x < OW)
            dst[(static_cast<long long>(tg.b) * OH + y) * OW + x] = pt[r];
        }
      }
    }
  }
}

// Shared memory of the kernel, in bytes, for these sizes.
inline size_t smem_bytes(int OH, int OW, int IH, int IW) {
  return bf16_smem_bytes(footprint_pad(OH, OW, IH, IW));
}

inline cudaError_t launch(const __nv_bfloat16* last, const __nv_bfloat16* cond,
                   const float* w1, const float* b1, const float* w2,
                   const float* b2, float* p_out, float* t_out, int B, int OH,
                   int OW, int IH, int IW, int Cin, int Cc, pf::Strides4 ls,
                   pf::Strides4 cs, float p_eps, int device,
                   cudaStream_t stream) {
  if (Cc != kCc || Cin < 1 || Cin > kCinPad || IH > OH || IW > OW)
    return cudaErrorInvalidValue;
  const int fpad = footprint_pad(OH, OW, IH, IW);
  const size_t smem = smem_bytes(OH, OW, IH, IW);
  cudaError_t err = cudaFuncSetAttribute(
      clb_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
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
  clb_tc_kernel<<<blocks, kThreads, smem, stream>>>(
      last, cond, w1, b1, w2, b2, p_out, t_out, B, OH, OW, IH, IW, Cin, ls,
      cs, p_eps, fpad);
  return cudaGetLastError();
}

}  // namespace tc
}  // namespace pf

namespace {

// ---------------------------------------------------------------------------
// f32: one thread per pixel
// ---------------------------------------------------------------------------

constexpr int kF32Threads = 128;

__global__ void __launch_bounds__(kF32Threads)
clb_pt_f32_kernel(const float* __restrict__ last,
                  const float* __restrict__ cond,
                  const float* __restrict__ w1, const float* __restrict__ b1,
                  const float* __restrict__ w2, const float* __restrict__ b2,
                  float* __restrict__ p_out, float* __restrict__ t_out, int B,
                  int OH, int OW, int IH, int IW, int Cin, int Cc,
                  pf::Strides4 ls, pf::Strides4 cs, float p_eps) {
  extern __shared__ float smem[];
  const pf::ClbWeights w =
      pf::clb_stage_weights(smem, w1, b1, w2, b2, Cin + Cc);
  const long long total = static_cast<long long>(B) * OH * OW;
  for (long long idx =
           static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       idx < total; idx += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int x = static_cast<int>(idx % OW);
    const int y = static_cast<int>((idx / OW) % OH);
    const int b = static_cast<int>(idx / (static_cast<long long>(OW) * OH));
    const float2 pt = pf::clb_pixel(last, cond, ls, cs, w, b, y, x, OH, OW,
                                    IH, IW, Cin, Cc, p_eps);
    p_out[idx] = pt.x;
    t_out[idx] = pt.y;
  }
}

cudaError_t launch_f32(const float* last, const float* cond, const float* w1,
                       const float* b1, const float* w2, const float* b2,
                       float* p_out, float* t_out, int B, int OH, int OW,
                       int IH, int IW, int Cin, int Cc, pf::Strides4 ls,
                       pf::Strides4 cs, float p_eps, int device,
                       cudaStream_t stream) {
  const size_t smem = pf::clb_smem_floats(Cin + Cc) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      clb_pt_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, clb_pt_f32_kernel, kF32Threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long total = static_cast<long long>(B) * OH * OW;
  long long blocks = (total + kF32Threads - 1) / kF32Threads;
  const long long resident = static_cast<long long>(sms) * per_sm;
  if (blocks > resident) blocks = resident;
  clb_pt_f32_kernel<<<static_cast<unsigned>(blocks), kF32Threads, smem,
                      stream>>>(last, cond, w1, b1, w2, b2, p_out, t_out, B,
                                OH, OW, IH, IW, Cin, Cc, ls, cs, p_eps);
  return cudaGetLastError();
}

}  // namespace

// Shared memory the bf16 kernel needs for these sizes, in bytes; the
// wrapper checks it against the card's 227 KB.
extern "C" long long pf_clb_tc_smem(int OH, int OW, int IH, int IW) {
  return static_cast<long long>(pf::tc::smem_bytes(OH, OW, IH, IW));
}

// C entry point. last_cat (B, OH, OW, Cin) and cond_lo (B, IH, IW, Cc) are
// device tensors of one dtype, float32 (inputs_bf16 = 0) or bfloat16 (= 1),
// with the given element strides; w1 (Cin+Cc, hidden), b1 (hidden,),
// w2 (hidden, 4) and b2 (4,) are contiguous float32; p_out and t_out are
// contiguous (B, OH, OW) float32. bfloat16 takes Cin <= 48, Cc = 128 and
// an upsample (IH <= OH, IW <= OW). Returns the cudaError_t of the launch.
extern "C" int pf_clb_pt(const void* last, const void* cond, const void* w1,
                         const void* b1, const void* w2, const void* b2,
                         void* p_out, void* t_out, int inputs_bf16, int B,
                         int OH, int OW, int IH, int IW, int Cin, int Cc,
                         int hidden, long long lb, long long ly, long long lx,
                         long long lc, long long cb, long long cy,
                         long long cx, long long cc, float p_eps, int device,
                         void* stream) {
  if (hidden != pf::kClbHidden) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const pf::Strides4 ls{lb, ly, lx, lc};
  const pf::Strides4 cs{cb, cy, cx, cc};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* w1f = static_cast<const float*>(w1);
  const float* b1f = static_cast<const float*>(b1);
  const float* w2f = static_cast<const float*>(w2);
  const float* b2f = static_cast<const float*>(b2);
  float* po = static_cast<float*>(p_out);
  float* to = static_cast<float*>(t_out);
  if (inputs_bf16)
    err = pf::tc::launch(static_cast<const __nv_bfloat16*>(last),
                         static_cast<const __nv_bfloat16*>(cond), w1f, b1f,
                         w2f, b2f, po, to, B, OH, OW, IH, IW, Cin, Cc, ls, cs,
                         p_eps, device, s);
  else
    err = launch_f32(static_cast<const float*>(last),
                     static_cast<const float*>(cond), w1f, b1f, w2f, b2f, po,
                     to, B, OH, OW, IH, IW, Cin, Cc, ls, cs, p_eps, device, s);
  return static_cast<int>(err);
}
