// Bilinear and bicubic resize with F.interpolate's semantics, for sm_90a.
//
// Replaces no TPU kernel: the JAX package resizes with separable matrices
// (patchfusion_tpu/ops/resize.py), which XLA turns into matrix products,
// and the port's plain version (ops/resize.interpolate on the CPU) is
// F.interpolate. On the card F.interpolate gives one thread to each output
// pixel and loops it over batch x channels, so a many-plane call of small
// planes (the DPT's refinenets, 16 tiles x 256 channels) runs on a handful
// of SMs, and a channels-last call (the DINOv2 pos-embed) strides through
// memory one channel at a time.
//
// What bounds it on the H100: bytes. Each input element is read about once
// and each output written once, a few FMAs apiece, so the least time is
// (input + output bytes) / 3.35 TB/s. At a x2 upsample the stores are 4/5
// of the bytes, and an issue budget of ~22 instructions per bf16 output
// keeps the SMs at the memory's pace.
//
// The input is viewed as (L, IH, IW, T): the axes before H flattened to L,
// those after W to T; the output is written as a contiguous (L, OH, OW, T)
// with no copy on either side. The arithmetic is PyTorch's NCHW CUDA
// kernels' (UpSampleBilinear2d.cu, UpSampleBicubic2d.cu, UpSample.cuh), in
// f32 and in the same order of operations, with FMAs where nvcc put them
// there: the source index scale * (d + 0.5) - 0.5 (clamped at 0 for
// bilinear), the lambdas, cubic A = -0.75 with clamped taps, the W
// combination of each source row before the H combination. So the result
// is bit-equal to F.interpolate of a contiguous NCHW tensor, whatever the
// layout (PyTorch's own channels-last bilinear kernel, which it takes from
// 16 channels up, contracts otherwise and parts from its NCHW kernel).
//
// Design, by shape, in one entry point:
//  * T = 1 (NCHW planes; the model's calls, the tiles' crop resize, rN's
//    count map): a block takes a band of output rows of one plane, or
//    whole planes where a plane is small (16 tiles x 512 channels of
//    28x37), sized to ~12K outputs and to fill the card. Memory is
//    touched 16 bytes a thread where the layout allows: a 2-byte store or
//    gather a thread costs ~4x a 16-byte one on the H100 (3.3 GB of bf16
//    stores take 3.9 ms one value a thread, 1.0 ms eight), which is what
//    keeps F.interpolate's kernel far from the bound even at its largest
//    call. So the band's source rows come into shared memory by 16-byte
//    loads; pass 1 combines each along W, once, into f32 rows (threads on
//    adjacent columns, a column's taps computed once); pass 2 combines
//    those along H into V = 16 bytes of adjacent outputs a thread, on the
//    output's own 16-byte grid whatever the row width, stored as one
//    vector.
//  * T > 1 (channels last; the pos-embed): a thread takes 16 bytes of
//    adjacent channels of one output pixel, with one 16-byte load per tap,
//    or one channel where the channel axis is not contiguous and aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>
#include <cmath>


namespace {

constexpr int kThreads = 256;
// T = 1: outputs a block takes (8K and 16K measured slower at the DA
// shapes), and the shared memory it keeps to (four blocks an SM)
constexpr int kBlockOutputs = 12288;
constexpr int kBlockSmem = 56 * 1024;
constexpr int kMaxSmem = 200 * 1024;  // of the 227 KB a block may opt into
constexpr int kTargetBlocks = 2 * 132;  // two blocks for each SM
constexpr int kMinBlocks = 4;  // resident blocks an SM: <= 64 registers
constexpr float kCubicA = -0.75f;

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  const unsigned short u = __ldg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<uint32_t>(u) << 16);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// 16 bytes of V values: a vector store and a vector load.
__device__ __forceinline__ void st16(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void st16(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 u;
  __nv_bfloat162 h[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  u.x = *reinterpret_cast<uint32_t*>(&h[0]);
  u.y = *reinterpret_cast<uint32_t*>(&h[1]);
  u.z = *reinterpret_cast<uint32_t*>(&h[2]);
  u.w = *reinterpret_cast<uint32_t*>(&h[3]);
  *reinterpret_cast<uint4*>(p) = u;
}
__device__ __forceinline__ void ld16(const float* p, float (&v)[4]) {
  const float4 f = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
}
__device__ __forceinline__ void ld16(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// The arithmetic below is spelled out in rounding intrinsics, so that no
// contraction choice of the compiler can part it from F.interpolate's
// kernels: each FMA stands where nvcc contracted PyTorch's expression
// (found on the H100 against torch 2.11's kernels; a product and an add
// rounded apart instead move results by up to 10^6 ulps where a
// bicubic sum cancels).

// area_pixel_compute_source_index (UpSample.cuh): scale * d, or
// scale * (d + 0.5) - 0.5 as one FMA, clamped at 0 for bilinear.
__device__ __forceinline__ float source_index(float scale, int d, bool ac,
                                              bool cubic) {
  if (ac) return __fmul_rn(scale, static_cast<float>(d));
  const float s =
      __fmaf_rn(scale, __fadd_rn(static_cast<float>(d), 0.5f), -0.5f);
  return (!cubic && s < 0.f) ? 0.f : s;
}

// PyTorch's cubic_convolution1 ((A + 2) x - (A + 3)) x x + 1 and
// cubic_convolution2 ((A x - 5 A) x + 8 A) x - 4 A, with A = -0.75.
__device__ __forceinline__ float cubic1(float x) {
  return __fmaf_rn(__fmul_rn(__fmaf_rn(kCubicA + 2, x, -(kCubicA + 3)), x),
                   x, 1.f);
}
__device__ __forceinline__ float cubic2(float x) {
  return __fmaf_rn(
      __fmaf_rn(__fmaf_rn(kCubicA, x, -5 * kCubicA), x, 8 * kCubicA), x,
      -4 * kCubicA);
}

// The TAPS source indices (clamped into [0, n)) and weights of output
// index d along one axis.
template <int TAPS>
struct Taps {
  int i[TAPS];
  float w[TAPS];
};

template <int TAPS>
__device__ __forceinline__ Taps<TAPS> taps(float scale, int d, bool ac,
                                           int n);

// UpSampleBilinear2d.cu: i0 = (int) r, its neighbour if inside, lambdas
// r - i0 and 1 - that.
template <>
__device__ __forceinline__ Taps<2> taps<2>(float scale, int d, bool ac,
                                           int n) {
  const float r = source_index(scale, d, ac, false);
  const int i0 = r;  // r >= 0: truncation is floor
  const int p = (i0 < n - 1) ? 1 : 0;
  const float l1 = __fsub_rn(r, static_cast<float>(i0));
  Taps<2> t;
  t.i[0] = min(i0, n - 1);
  t.i[1] = min(i0 + p, n - 1);
  t.w[0] = __fsub_rn(1.f, l1);
  t.w[1] = l1;
  return t;
}

// get_cubic_upsampling_coefficients at t = r - floor(r), taps clamped.
template <>
__device__ __forceinline__ Taps<4> taps<4>(float scale, int d, bool ac,
                                           int n) {
  const float r = source_index(scale, d, ac, true);
  const int i0 = floorf(r);
  const float x1 = __fsub_rn(r, static_cast<float>(i0));
  const float x2 = __fsub_rn(1.f, x1);
  Taps<4> t;
  t.w[0] = cubic2(__fadd_rn(x1, 1.f));
  t.w[1] = cubic1(x1);
  t.w[2] = cubic1(x2);
  t.w[3] = cubic2(__fadd_rn(x2, 1.f));
#pragma unroll
  for (int k = 0; k < 4; ++k) t.i[k] = max(min(i0 - 1 + k, n - 1), 0);
  return t;
}

// One axis's combination of TAPS values: bilinear w0 a + w1 b, bicubic
// cubic_interp1d's x0 c0 + x1 c1 + x2 c2 + x3 c3; each first sum an FMA
// over the second product, the later ones FMAs in turn.
__device__ __forceinline__ float combine(const float (&v)[2],
                                         const float (&w)[2]) {
  return __fmaf_rn(w[0], v[0], __fmul_rn(w[1], v[1]));
}
__device__ __forceinline__ float combine(const float (&v)[4],
                                         const float (&w)[4]) {
  return __fmaf_rn(v[3], w[3],
                   __fmaf_rn(v[2], w[2],
                             __fmaf_rn(v[0], w[0], __fmul_rn(v[1], w[1]))));
}

// ---------------------------------------------------------------------------
// T = 1: planes
// ---------------------------------------------------------------------------

struct PlaneArgs {
  int L, IH, IW, OH, OW;
  long long sl, sh, sw;  // input strides, elements
  float rh, rw;
  int ac;
  int rows;       // output rows a block takes
  int bands;      // > 0: bands of `rows` within each plane; 0: whole planes
  int h_rows;     // the most source rows a block's band can need
  int contig;     // the input is one contiguous (L, IH, IW) array
};

// n / d and n % d for 0 <= n < 2^22 without an integer division: the
// float quotient, then one step of correction.
__device__ __forceinline__ int divmod(int n, int d, float inv, int& rem) {
  int q = static_cast<int>((static_cast<float>(n) + 0.5f) * inv);
  int r = n - q * d;
  if (r < 0) {
    --q;
    r += d;
  } else if (r >= d) {
    ++q;
    r -= d;
  }
  rem = r;
  return q;
}

// The W-combined rows lie in shared memory one word a value, each row
// padded to a multiple of 32 values, with one word skipped after every 32:
// value (h, c) at h * row_words(OW) + c + c / 32. Pass 2's threads each
// read 16 bytes' worth of adjacent outputs' values, so a warp's reads
// stride by 8 (bf16) or 4 words; the skip spreads them over all 32 banks,
// and the padding keeps c's place among the banks the same in every row.
__host__ __device__ constexpr int row_words(int ow) {
  return (ow + 31) / 32 * 33;
}

__host__ __device__ constexpr int round16(int bytes) {
  return (bytes + 15) / 16 * 16;
}

// Shared memory of a block: the band's row taps, its source rows as they
// are in memory (T, on the 16-byte grid), and their W-combined values
// (f32), each segment on the 16-byte grid.
template <int TAPS>
__host__ __device__ inline int plane_smem(int rows, int h_rows, int IW,
                                          int OW, int esize) {
  return round16(rows * static_cast<int>(sizeof(Taps<TAPS>))) +
         round16((h_rows * IW + 16) * esize) +
         round16(h_rows * row_words(OW) * 4);
}

template <typename T, int TAPS>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    resize_planes(const T* __restrict__ in, T* __restrict__ out,
                  const PlaneArgs a) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  const int IW = a.IW, OW = a.OW;
  Taps<TAPS>* rowtab = reinterpret_cast<Taps<TAPS>*>(smem);
  T* src = reinterpret_cast<T*>(
      smem + round16(a.rows * static_cast<int>(sizeof(Taps<TAPS>))));
  float* hrow = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(src) +
      round16((a.h_rows * IW + 16) * static_cast<int>(sizeof(T))));
  const bool ac = a.ac != 0;

  // the block's output rows [r_a, r_b), flattened over L x OH
  long long r_a, r_b;
  if (a.bands > 0) {
    const int l = blockIdx.x / a.bands;
    const int oy = (blockIdx.x - l * a.bands) * a.rows;
    r_a = static_cast<long long>(l) * a.OH + oy;
    r_b = static_cast<long long>(l) * a.OH + min(oy + a.rows, a.OH);
  } else {
    r_a = static_cast<long long>(blockIdx.x) * a.rows;
    r_b = min(r_a + a.rows, static_cast<long long>(a.L) * a.OH);
  }
  const int nrows = static_cast<int>(r_b - r_a);
  // the source rows they read, g = l * IH + y: from the first row's lowest
  // tap to the last row's highest (taps rise with the output row)
  const int l_a = static_cast<int>(r_a / a.OH);
  const int l_b = static_cast<int>((r_b - 1) / a.OH);
  const int oy_a = static_cast<int>(r_a - static_cast<long long>(l_a) * a.OH);
  const long long g_lo = static_cast<long long>(l_a) * a.IH +
                         taps<TAPS>(a.rh, oy_a, ac, a.IH).i[0];
  const long long g_hi =
      static_cast<long long>(l_b) * a.IH +
      taps<TAPS>(a.rh,
                 static_cast<int>(r_b - 1 - static_cast<long long>(l_b) * a.OH),
                 ac, a.IH).i[TAPS - 1];
  const int nh = static_cast<int>(g_hi - g_lo + 1);
  if (nh > a.h_rows) __trap();  // the host's bound is wrong

  const int rw_words = row_words(OW);
  const int y_lo = static_cast<int>(g_lo - static_cast<long long>(l_a) * a.IH);
  for (int i = threadIdx.x; i < nrows; i += kThreads) {
    const int dl = (oy_a + i) / a.OH;  // planes past the block's first
    Taps<TAPS> t = taps<TAPS>(a.rh, oy_a + i - dl * a.OH, ac, a.IH);
#pragma unroll
    for (int k = 0; k < TAPS; ++k)  // the tap's W-combined row, as an offset
      t.i[k] = (dl * a.IH + t.i[k] - y_lo) * rw_words;
    rowtab[i] = t;
  }

  // stage: the source rows into shared memory. A contiguous input's rows
  // are one run [e_lo, e_hi) of it, copied in 16-byte pieces on its own
  // 16-byte grid (value (h, x) lands at h * IW + x + ph); other strides
  // go value by value (ph = 0).
  int ph = 0;
  if (a.contig) {
    const long long e_lo = g_lo * IW, e_hi = (g_hi + 1) * IW;
    const long long q_lo = e_lo / V, q_hi = (e_hi + V - 1) / V;
    ph = static_cast<int>(e_lo - q_lo * V);
    for (long long q = q_lo + threadIdx.x; q < q_hi; q += kThreads) {
      const long long e0 = q * V;
      T* dst = src + (q - q_lo) * V;
      if (e0 >= e_lo && e0 + V <= e_hi) {
        *reinterpret_cast<uint4*>(dst) =
            __ldg(reinterpret_cast<const uint4*>(in + e0));
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j)
          if (e0 + j >= e_lo && e0 + j < e_hi) dst[j] = in[e0 + j];
      }
    }
  } else {
    for (int f = threadIdx.x; f < nh * IW; f += kThreads) {
      const int h = f / IW, x = f - h * IW;
      const long long g = g_lo + h;
      const long long l = g / a.IH;
      src[f] = in[l * a.sl + (g - l * a.IH) * a.sh + x * a.sw];
    }
  }
  __syncthreads();

  // pass 1: each source row combined along W at every output column.
  // Threads sit on adjacent columns, in `slots` groups that take every
  // slots-th row, so a column's taps are computed once.
  {
    const int cols = min(OW, kThreads);
    const int slots = kThreads / cols;
    const int slot = threadIdx.x / cols;
    if (slot < slots) {
      for (int c = threadIdx.x - slot * cols; c < OW; c += cols) {
        Taps<TAPS> tx = taps<TAPS>(a.rw, c, ac, IW);
#pragma unroll
        for (int m = 0; m < TAPS; ++m) tx.i[m] += ph;
        for (int h = slot; h < nh; h += slots) {
          const T* row = src + h * IW;
          float v[TAPS];
#pragma unroll
          for (int m = 0; m < TAPS; ++m) v[m] = to_f32(row[tx.i[m]]);
          hrow[h * rw_words + c + (c >> 5)] = combine(v, tx.w);
        }
      }
    }
  }
  __syncthreads();

  // pass 2: the band's outputs [f_a, f_b) combined along H, V adjacent
  // values a thread, stored as 16 bytes on the output's 16-byte grid
  const float inv_ow = 1.f / OW;
  const long long f_a = r_a * OW, f_b = r_b * OW;
  const long long v_a = f_a / V, v_b = (f_b + V - 1) / V;
  for (long long v = v_a + threadIdx.x; v < v_b; v += kThreads) {
    const long long e0 = v * V;
    const int lo = static_cast<int>(max(e0, f_a) - e0);
    const int hi = static_cast<int>(min(e0 + V, f_b) - e0);
    int c;
    int i = divmod(static_cast<int>(e0 + lo - f_a), OW, inv_ow, c);
    Taps<TAPS> ty = rowtab[i];
    float o[V];
    if (lo == 0 && hi == V && c + V <= OW) {
      // within one row: offsets from one base, one more past the end of
      // c's group of 32 (at the same place in every row)
      const int cw = c + (c >> 5);
      const int next = 32 - (c & 31);
      if (next >= V) {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          float hv[TAPS];
#pragma unroll
          for (int k = 0; k < TAPS; ++k) hv[k] = hrow[ty.i[k] + cw + j];
          o[j] = combine(hv, ty.w);
        }
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const int at = cw + j + (j >= next);
          float hv[TAPS];
#pragma unroll
          for (int k = 0; k < TAPS; ++k) hv[k] = hrow[ty.i[k] + at];
          o[j] = combine(hv, ty.w);
        }
      }
      st16(out + e0, o);
      continue;
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (j >= lo && j < hi) {
        float hv[TAPS];
#pragma unroll
        for (int k = 0; k < TAPS; ++k) hv[k] = hrow[ty.i[k] + c + (c >> 5)];
        o[j] = combine(hv, ty.w);
        if (++c == OW && j + 1 < hi) {
          c = 0;
          ty = rowtab[++i];
        }
      }
    }
    if (lo == 0 && hi == V) {
      st16(out + e0, o);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j)
        if (j >= lo && j < hi) st(out + e0 + j, o[j]);
    }
  }
}

// ---------------------------------------------------------------------------
// T > 1: channels last
// ---------------------------------------------------------------------------

struct ChannelArgs {
  int L, IH, IW, OH, OW, C;
  long long sl, sh, sw, sc;  // input strides, elements
  float rh, rw;
  int ac;
};

template <typename T, int TAPS, int V>
__global__ void __launch_bounds__(kThreads)
    resize_channels(const T* __restrict__ in, T* __restrict__ out,
                    const ChannelArgs a) {
  const bool ac = a.ac != 0;
  const int nc = a.C / V;
  const long long total =
      static_cast<long long>(a.L) * a.OH * a.OW * nc;
  for (long long idx = static_cast<long long>(blockIdx.x) * kThreads +
                       threadIdx.x;
       idx < total; idx += static_cast<long long>(gridDim.x) * kThreads) {
    const int cv = static_cast<int>(idx % nc);
    const long long p = idx / nc;
    const int ox = static_cast<int>(p % a.OW);
    const long long q = p / a.OW;
    const int oy = static_cast<int>(q % a.OH);
    const int l = static_cast<int>(q / a.OH);
    const Taps<TAPS> ty = taps<TAPS>(a.rh, oy, ac, a.IH);
    const Taps<TAPS> tx = taps<TAPS>(a.rw, ox, ac, a.IW);
    const T* base = in + static_cast<long long>(l) * a.sl +
                    static_cast<long long>(cv) * V * a.sc;
    float rows[TAPS][V];
#pragma unroll
    for (int k = 0; k < TAPS; ++k) {
      float v[TAPS][V];
#pragma unroll
      for (int m = 0; m < TAPS; ++m) {
        const T* src = base + static_cast<long long>(ty.i[k]) * a.sh +
                       static_cast<long long>(tx.i[m]) * a.sw;
        if constexpr (V > 1) {
          ld16(src, v[m]);
        } else {
          v[m][0] = ld(src);
        }
      }
#pragma unroll
      for (int c = 0; c < V; ++c) {
        float h[TAPS];
#pragma unroll
        for (int m = 0; m < TAPS; ++m) h[m] = v[m][c];
        rows[k][c] = combine(h, tx.w);
      }
    }
    float o[V];
#pragma unroll
    for (int c = 0; c < V; ++c) {
      float h[TAPS];
#pragma unroll
      for (int k = 0; k < TAPS; ++k) h[k] = rows[k][c];
      o[c] = combine(h, ty.w);
    }
    T* dst = out + p * a.C + static_cast<long long>(cv) * V;
    if constexpr (V > 1) {
      st16(dst, o);
    } else {
      st(dst, o[0]);
    }
  }
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

// The most source rows a band of `rows` output rows within one plane can
// read: the step between adjacent rows' taps is the axis scale, and the
// band adds its taps' reach and one for rounding.
template <int TAPS>
int band_h_rows(int rows, int IH, int OH, int ac) {
  const double s = ac ? (OH > 1 ? static_cast<double>(IH - 1) / (OH - 1) : 0.)
                      : static_cast<double>(IH) / OH;
  const int reach = static_cast<int>(std::ceil((rows - 1) * s * (1 + 1e-6)));
  return std::min(reach + TAPS + 2, IH);
}

// The block plan of a T = 1 call: ~kBlockOutputs outputs a block, whole
// planes where a plane is smaller and there are planes enough to fill the
// card, else bands of rows of one plane; fewer rows where the grid would
// not fill the card or a block would take more than kBlockSmem (a
// downsample's source rows). False where one row outgrows kMaxSmem.
template <typename T, int TAPS>
bool plane_plan(PlaneArgs& a, int* smem_bytes) {
  constexpr int E = sizeof(T);
  const long long plane = static_cast<long long>(a.OH) * a.OW;
  long long blocks;
  if (plane <= kBlockOutputs && a.L >= kTargetBlocks) {
    int k = static_cast<int>(std::min<long long>(
        kBlockOutputs / plane, (a.L + kTargetBlocks - 1) / kTargetBlocks));
    k = std::max(k, 1);
    while (k > 1 &&
           plane_smem<TAPS>(k * a.OH, k * a.IH, a.IW, a.OW, E) > kBlockSmem)
      --k;
    a.rows = k * a.OH;
    a.bands = 0;
    a.h_rows = k * a.IH;
    blocks = (a.L + k - 1) / k;
  } else {
    int rows = static_cast<int>(std::max<long long>(
        1, std::min<long long>(a.OH, kBlockOutputs / a.OW)));
    const long long total_rows = static_cast<long long>(a.L) * a.OH;
    if (total_rows / rows < kTargetBlocks)
      rows = static_cast<int>(
          std::max<long long>(1, total_rows / kTargetBlocks));
    while (rows > 1 &&
           plane_smem<TAPS>(rows, band_h_rows<TAPS>(rows, a.IH, a.OH, a.ac),
                            a.IW, a.OW, E) > kBlockSmem)
      rows = rows * 3 / 4;
    a.rows = rows;
    a.bands = (a.OH + rows - 1) / rows;
    a.h_rows = band_h_rows<TAPS>(rows, a.IH, a.OH, a.ac);
    blocks = static_cast<long long>(a.L) * a.bands;
  }
  a.contig = a.sw == 1 && a.sh == a.IW &&
             (a.L == 1 || a.sl == static_cast<long long>(a.IH) * a.IW);
  *smem_bytes = plane_smem<TAPS>(a.rows, a.h_rows, a.IW, a.OW, E);
  return *smem_bytes <= kMaxSmem && blocks <= 0x7fffffffLL &&
         static_cast<long long>(a.h_rows) * row_words(a.OW) < (1 << 24) &&
         static_cast<long long>(a.h_rows) * a.IW < (1 << 24) &&
         static_cast<long long>(a.rows) * a.OW < (1 << 22);
}

// What a launch asks of the CUDA runtime, kept per device so that a call
// costs no queries: the SM count, and each plane kernel's opt-in to
// kMaxSmem.
constexpr int kCachedDevices = 64;

cudaError_t sm_count(int device, int* sms) {
  static std::atomic<int> cached[kCachedDevices];
  const bool keep = device >= 0 && device < kCachedDevices;
  if (keep && (*sms = cached[device].load()) > 0) return cudaSuccess;
  const cudaError_t err =
      cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess && keep) cached[device].store(*sms);
  return err;
}

template <typename T, int TAPS>
cudaError_t allow_max_smem(int device) {
  static std::atomic<bool> allowed[kCachedDevices];
  const bool keep = device >= 0 && device < kCachedDevices;
  if (keep && allowed[device].load()) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      resize_planes<T, TAPS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmem);
  if (err == cudaSuccess && keep) allowed[device].store(true);
  return err;
}

template <typename T, int TAPS>
cudaError_t launch_planes(const void* in, void* out, PlaneArgs a, int device,
                          cudaStream_t s) {
  int smem = 0;
  if (!plane_plan<T, TAPS>(a, &smem)) return cudaErrorInvalidValue;
  a.contig = a.contig && reinterpret_cast<uintptr_t>(in) % 16 == 0;
  const long long blocks =
      a.bands > 0 ? static_cast<long long>(a.L) * a.bands
                  : (static_cast<long long>(a.L) * a.OH + a.rows - 1) / a.rows;
  if (smem > 48 * 1024) {
    const cudaError_t err = allow_max_smem<T, TAPS>(device);
    if (err != cudaSuccess) return err;
  }
  resize_planes<T, TAPS><<<static_cast<unsigned>(blocks), kThreads, smem,
                           s>>>(static_cast<const T*>(in),
                                static_cast<T*>(out), a);
  return cudaGetLastError();
}

template <typename T, int TAPS>
cudaError_t launch_channels(const void* in, void* out, const ChannelArgs& a,
                            bool vec, int device, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const int v = vec ? V : 1;
  const long long total =
      static_cast<long long>(a.L) * a.OH * a.OW * (a.C / v);
  int sms = 0;
  const cudaError_t err = sm_count(device, &sms);
  if (err != cudaSuccess) return err;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 16LL * sms) blocks = 16LL * sms;
  const T* x = static_cast<const T*>(in);
  T* y = static_cast<T*>(out);
  if (vec)
    resize_channels<T, TAPS, V><<<static_cast<unsigned>(blocks), kThreads, 0,
                                  s>>>(x, y, a);
  else
    resize_channels<T, TAPS, 1><<<static_cast<unsigned>(blocks), kThreads, 0,
                                  s>>>(x, y, a);
  return cudaGetLastError();
}

template <typename T, int TAPS>
cudaError_t launch(const void* in, void* out, int L, int IH, int IW, int OH,
                   int OW, int C, long long sl, long long sh, long long sw,
                   long long sc, float rh, float rw, int ac, int device,
                   cudaStream_t s) {
  if (C == 1) {
    const PlaneArgs a{L, IH, IW, OH, OW, sl, sh, sw, rh, rw, ac, 0, 0, 0, 0};
    return launch_planes<T, TAPS>(in, out, a, device, s);
  }
  constexpr int V = 16 / sizeof(T);
  const bool vec = sc == 1 && C % V == 0 && sl % V == 0 && sh % V == 0 &&
                   sw % V == 0 &&
                   reinterpret_cast<uintptr_t>(in) % 16 == 0;
  const ChannelArgs a{L, IH, IW, OH, OW, C, sl, sh, sw, sc, rh, rw, ac};
  return launch_channels<T, TAPS>(in, out, a, vec, device, s);
}

}  // namespace

// in: (L, IH, IW, C) with strides (sl, sh, sw, sc) in elements; out: a
// contiguous, 16-byte aligned (L, OH, OW, C) of the same dtype. rh, rw:
// PyTorch's area_pixel_compute_scale per axis, from the host. Returns
// cudaErrorInvalidValue, launching nothing, where a C = 1 call's plan finds
// no block that holds one output row's source rows.
extern "C" int pf_resize(const void* in, void* out, int is_bf16, int cubic,
                         int L, int IH, int IW, int OH, int OW, int C,
                         long long sl, long long sh, long long sw,
                         long long sc, float rh, float rw, int align_corners,
                         int device, void* stream) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    err = cubic ? launch<__nv_bfloat16, 4>(in, out, L, IH, IW, OH, OW, C, sl,
                                           sh, sw, sc, rh, rw, align_corners,
                                           device, s)
                : launch<__nv_bfloat16, 2>(in, out, L, IH, IW, OH, OW, C, sl,
                                           sh, sw, sc, rh, rw, align_corners,
                                           device, s);
  } else {
    err = cubic ? launch<float, 4>(in, out, L, IH, IW, OH, OW, C, sl, sh, sw,
                                   sc, rh, rw, align_corners, device, s)
                : launch<float, 2>(in, out, L, IH, IW, OH, OW, C, sl, sh, sw,
                                   sc, rh, rw, align_corners, device, s);
  }
  return static_cast<int>(err);
}
