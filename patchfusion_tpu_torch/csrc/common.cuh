// Helpers shared by the port's kernels: dtype rounding, bilinear taps,
// strides, and the two per-pixel bodies of the metric-bins head
// (the ConditionalLogBinomial MLP and the log-binomial depth expectation),
// which csrc/clb_pt.cu, csrc/logbinomial_depth.cu and csrc/clb_depth.cu
// compose.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pf {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Rounds through T: the identity for float, bf16 round-to-nearest-even for
// __nv_bfloat16 (the JAX kernel's "at the input dtype" steps).
template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// Bilinear align_corners=True source taps for output index d of an
// out -> in resize, float32 arithmetic as in PyTorch and in the JAX
// package's _source_coords: src = d * ((in - 1) / (out - 1)).
struct Tap {
  int i0, i1;
  float w;  // weight of i1; i0 gets 1 - w
};

__device__ __forceinline__ Tap align_corners_tap(int d, int out, int in) {
  float src = 0.f;
  if (out > 1) {
    const float s = static_cast<float>(in - 1) / static_cast<float>(out - 1);
    src = __fmul_rn(static_cast<float>(d), s);
  }
  src = fminf(fmaxf(src, 0.f), static_cast<float>(in - 1));
  Tap t;
  t.i0 = min(max(static_cast<int>(floorf(src)), 0), in - 1);
  t.i1 = min(t.i0 + 1, in - 1);
  t.w = src - static_cast<float>(t.i0);
  return t;
}

// Strides, in elements, of a 4-D channels-last view (B, H, W, C). Any
// strides are accepted, so a permuted NCHW tensor needs no copy.
struct Strides4 {
  long long b, y, x, c;
};

// The four corner rows of one output pixel's bilinear upsample of a
// (B, IH, IW, C) map: each points at channel 0 and steps by s.c.
template <typename T>
struct Corners {
  const T *r00, *r10, *r01, *r11;
  Tap ty, tx;
  long long c;

  // Taps ty, tx into a window of the map: base points at the window's
  // pixel (y0, x0) and s steps through it (s.b unused).
  __device__ __forceinline__ Corners(const T* base, Strides4 s, Tap ty_,
                                     Tap tx_, int y0, int x0)
      : ty(ty_), tx(tx_), c(s.c) {
    r00 = base + (ty.i0 - y0) * s.y + (tx.i0 - x0) * s.x;
    r10 = base + (ty.i1 - y0) * s.y + (tx.i0 - x0) * s.x;
    r01 = base + (ty.i0 - y0) * s.y + (tx.i1 - x0) * s.x;
    r11 = base + (ty.i1 - y0) * s.y + (tx.i1 - x0) * s.x;
  }

  __device__ __forceinline__ Corners(const T* map, Strides4 s, int b, int y,
                                     int x, int OH, int OW, int IH, int IW)
      : Corners(map + b * s.b, s, align_corners_tap(y, OH, IH),
                align_corners_tap(x, OW, IW), 0, 0) {}

  // Channel ch of the upsampled pixel: H lerp, then W lerp (the reference
  // interpolate's axis order).
  __device__ __forceinline__ float at(int ch) const {
    const long long o = ch * c;
    const float a0 = to_f32(r00[o]) * (1.f - ty.w) + to_f32(r10[o]) * ty.w;
    const float a1 = to_f32(r01[o]) * (1.f - ty.w) + to_f32(r11[o]) * ty.w;
    return a0 * (1.f - tx.w) + a1 * tx.w;
  }
};

// ---------------------------------------------------------------------------
// ConditionalLogBinomial MLP, one output pixel (pallas_head.py clb_pt):
//   h = last[b,y,x,:] . W1[:Cin] + up(cond)[b,y,x,:] . W1[Cin:] + b1
//   g = tanh-GELU(h),  s = softplus(g . W2 + b2)
//   p = (s0+eps) / (s0+s1+2eps),  t = (s2+eps) / (s2+s3+2eps)
// in f32 here; the bf16 body (csrc/clb_tc.cuh) rounds h, g and W2 to bf16.
// ---------------------------------------------------------------------------

constexpr int kClbHidden = 80;  // (33 + 128) // 2, fixed by the head's widths

// tanh-GELU at T: float takes the accurate tanhf; bf16 (the kernels of
// csrc/clb_tc.cuh) MUFU's tanh.approx.f32, whose error lies under the bf16
// rounding of the result.
template <typename T>
__device__ __forceinline__ float gelu_tanh(float x);
template <>
__device__ __forceinline__ float gelu_tanh<float>(float x) {
  const float k = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.f + tanhf(k * (x + 0.044715f * x * x * x)));
}
template <>
__device__ __forceinline__ float gelu_tanh<__nv_bfloat16>(float x) {
  const float k = 0.7978845608028654f;
  float th;
  asm("tanh.approx.f32 %0, %1;"
      : "=f"(th)
      : "f"(k * (x + 0.044715f * x * x * x)));
  return 0.5f * x * (1.f + th);
}

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

// Floats of shared memory clb_stage_weights fills.
__host__ __device__ constexpr int clb_smem_floats(int n_in) {
  return n_in * kClbHidden + 5 * kClbHidden + 4;
}

// The MLP weights in shared memory: W1 (Cin + Cc, H), b1 (H,), W2 (H, 4),
// b2 (4,).
struct ClbWeights {
  const float *w1, *b1, *w2, *b2;
};

// Block-wide copy of the f32 weights into smem (clb_smem_floats(Cin + Cc)
// floats); ends with __syncthreads.
__device__ __forceinline__ ClbWeights clb_stage_weights(
    float* smem, const float* __restrict__ w1, const float* __restrict__ b1,
    const float* __restrict__ w2, const float* __restrict__ b2, int n_in) {
  const int n_w1 = n_in * kClbHidden;
  float* w1s = smem;
  float* b1s = w1s + n_w1;
  float* w2s = b1s + kClbHidden;
  float* b2s = w2s + kClbHidden * 4;
  for (int i = threadIdx.x; i < n_w1; i += blockDim.x) w1s[i] = w1[i];
  for (int i = threadIdx.x; i < kClbHidden; i += blockDim.x) b1s[i] = b1[i];
  for (int i = threadIdx.x; i < kClbHidden * 4; i += blockDim.x)
    w2s[i] = w2[i];
  if (threadIdx.x < 4) b2s[threadIdx.x] = b2[threadIdx.x];
  __syncthreads();
  return ClbWeights{w1s, b1s, w2s, b2s};
}

// (p, t) of pixel (b, y, x) of f32 maps (the bf16 body is csrc/clb_tc.cuh).
// The 80 accumulators live in registers; every weight read is the same
// smem address across the warp (a broadcast).
__device__ __forceinline__ float2 clb_pixel(
    const float* __restrict__ last, const float* __restrict__ cond,
    Strides4 ls, Strides4 cs, const ClbWeights& w, int b, int y, int x,
    int OH, int OW, int IH, int IW, int Cin, int Cc, float p_eps) {
  float h[kClbHidden];
#pragma unroll
  for (int j = 0; j < kClbHidden; ++j) h[j] = 0.f;

  const float* lrow = last + b * ls.b + y * ls.y + x * ls.x;
  for (int c = 0; c < Cin; ++c) {
    const float v = lrow[c * ls.c];
    const float* wr = w.w1 + c * kClbHidden;
#pragma unroll
    for (int j = 0; j < kClbHidden; ++j) h[j] = fmaf(v, wr[j], h[j]);
  }

  const Corners<float> cu(cond, cs, b, y, x, OH, OW, IH, IW);
  for (int c = 0; c < Cc; ++c) {
    const float v = cu.at(c);
    const float* wr = w.w1 + (Cin + c) * kClbHidden;
#pragma unroll
    for (int j = 0; j < kClbHidden; ++j) h[j] = fmaf(v, wr[j], h[j]);
  }

  float o0 = 0.f, o1 = 0.f, o2 = 0.f, o3 = 0.f;
#pragma unroll
  for (int j = 0; j < kClbHidden; ++j) {
    const float g = gelu_tanh<float>(h[j] + w.b1[j]);
    o0 = fmaf(g, w.w2[4 * j + 0], o0);
    o1 = fmaf(g, w.w2[4 * j + 1], o1);
    o2 = fmaf(g, w.w2[4 * j + 2], o2);
    o3 = fmaf(g, w.w2[4 * j + 3], o3);
  }
  const float p0 = softplus(o0 + w.b2[0]) + p_eps;
  const float p1 = softplus(o1 + w.b2[1]) + p_eps;
  const float t0 = softplus(o2 + w.b2[2]) + p_eps;
  const float t1 = softplus(o3 + w.b2[3]) + p_eps;
  return make_float2(p0 / (p0 + p1), t0 / (t0 + t1));
}

// ---------------------------------------------------------------------------
// Log-binomial depth expectation, one output pixel
// (pallas_head.py logbinomial_depth):
//   pc = clip(p, 1e-4, 1), q = clip(1 - pc, 1e-4, 1)
//   y[k] = (c0[k] + k log pc + (K-1-k) log q) / (t (max-min) + min)
//   depth = sum_k softmax(y)[k] up(centers)[b,y,x,k]
//
// What bounds it on the H100: per (pixel, bin) one exp and a handful of
// FMAs; at the main-path shape (4 x 392 x 518 pixels, K = 64: 52 M pairs)
// the exps alone take ~0.013 ms on MUFU (16 a clock per SM), as long as
// moving the bytes (p, t, out and the centers once: ~0.013 ms). The body
// below keeps the per-pair cost near that: (K-1) log q is the same for
// every k and cancels in the softmax, so y[k] ~ u[k] = c0[k] + k A with
// A = log pc - log q; the softmax's shift is the max of u, which is
// concave in k (log C(K-1, k) is), so a bisection over the c0 table
// finds it in log2 K steps instead of a pass over K; each bin is then one
// FMA for u, one FMA by log2(e) / tv minus the shift, one ex2.approx.ftz,
// and three sums: the normaliser and the weighted sums of the pixel's two
// source columns, each lerped along H first; the W lerp follows once per
// pixel at the end (H, then W, the reference interpolate's axis order).
// Only the order of the sums and ex2.approx part it from the twin (2e-4
// of max |depth| on the card).
// ---------------------------------------------------------------------------

// The K-entry table log C(K-1, k) in the reference's Stirling form
// (dist_layers.py:29-33), in double as the host computes it; block-wide,
// ends with __syncthreads. (The f32 fused kernel fills it once per block;
// the other kernels take the wrapper's cached table.)
__device__ __forceinline__ void fill_log_binom_c0(float* c0, int K) {
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const double e = 1e-7;
    const double n = static_cast<double>(K - 1) + e;
    const double kk = static_cast<double>(k) + e;
    const double d = fmax(n - kk, 0.0);
    c0[k] = static_cast<float>(n * log(n) - kk * log(kk) - d * log(d + e));
  }
  __syncthreads();
}

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One pixel's softmax constants: bin k weighs ex2(u[k] scale + shift),
// u[k] = c0[k] + k a.
struct LogBinom {
  float a, scale, shift;

  __device__ __forceinline__ float weight(float c0k, float kf) const {
    return ex2_approx(fmaf(fmaf(kf, a, c0k), scale, shift));
  }
};

// c0: the K-entry table, in shared or global memory.
__device__ __forceinline__ LogBinom logbinom_setup(float p, float t,
                                                   const float* c0, int K,
                                                   float min_temp,
                                                   float max_temp) {
  const float pc = fminf(fmaxf(p, 1e-4f), 1.f);
  const float q = fminf(fmaxf(1.f - pc, 1e-4f), 1.f);
  LogBinom lb;
  lb.a = logf(pc) - logf(q);
  lb.scale = 1.4426950408889634f / (t * (max_temp - min_temp) + min_temp);
  // u is concave in k: its max sits where it stops rising, its min at an
  // end; a shift within rounding of the true extreme cancels in se
  float ref;
  if (lb.scale > 0.f) {
    int lo = 0, hi = K - 1;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      const float u0 = fmaf(static_cast<float>(mid), lb.a, c0[mid]);
      const float u1 = fmaf(static_cast<float>(mid + 1), lb.a, c0[mid + 1]);
      if (u1 > u0)
        lo = mid + 1;
      else
        hi = mid;
    }
    ref = fmaf(static_cast<float>(lo), lb.a, c0[lo]);
  } else {
    ref = fminf(c0[0], fmaf(static_cast<float>(K - 1), lb.a, c0[K - 1]));
  }
  lb.shift = -ref * lb.scale;
  return lb;
}

// The H lerp of two rows' values: a at i0, b at i1, w the weight of i1.
__device__ __forceinline__ float lerp(float a, float b, float w) {
  return a * (1.f - w) + b * w;
}

// The sums of one pixel: the normaliser and the weighted sums of its two
// H-lerped columns (v0 at x i0, v1 at x i1).
struct DepthSums {
  float se = 0.f, s0 = 0.f, s1 = 0.f;

  __device__ __forceinline__ void add(float e, float v0, float v1) {
    se = se + e;
    s0 = fmaf(e, v0, s0);
    s1 = fmaf(e, v1, s1);
  }

  // The W lerp over the normalised sums.
  __device__ __forceinline__ float finish(float wx) const {
    return lerp(s0, s1, wx) / se;
  }
};

// The depth of one pixel from its four corners of the centers map, in
// global or shared memory.
template <typename T>
__device__ __forceinline__ float logbinom_depth(float p, float t,
                                                const Corners<T>& cent,
                                                const float* c0, int K,
                                                float min_temp,
                                                float max_temp) {
  const LogBinom lb = logbinom_setup(p, t, c0, K, min_temp, max_temp);
  DepthSums s;
  const float wy = cent.ty.w;
  for (int k = 0; k < K; ++k) {
    const long long o = k * cent.c;
    s.add(lb.weight(c0[k], static_cast<float>(k)),
          lerp(to_f32(cent.r00[o]), to_f32(cent.r10[o]), wy),
          lerp(to_f32(cent.r01[o]), to_f32(cent.r11[o]), wy));
  }
  return s.finish(cent.tx.w);
}

// The same for pixel (b, y, x) of a (B, OH, OW) output, the centers read
// from global memory through their strides.
template <typename T>
__device__ __forceinline__ float logbinom_depth_pixel(
    float p, float t, const T* __restrict__ centers, Strides4 cs,
    const float* c0, int b, int y, int x, int OH, int OW, int IH, int IW,
    int K, float min_temp, float max_temp) {
  return logbinom_depth(p, t,
                        Corners<T>(centers, cs, b, y, x, OH, OW, IH, IW), c0,
                        K, min_temp, max_temp);
}

}  // namespace pf
