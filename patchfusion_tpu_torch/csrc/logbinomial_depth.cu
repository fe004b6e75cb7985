// Log-binomial depth expectation of the metric-bins head, for sm_90a.
//
// Replaces: patchfusion_tpu/ops/pallas_head.py::logbinomial_depth (Pallas
// kernel _logbinomial_depth_impl). Per output pixel (b, y, x):
//   cent[k] = bilinear align_corners=True upsample of centers (B,IH,IW,K)
//   pc = clip(p, 1e-4, 1), q = clip(1 - pc, 1e-4, 1)
//   y[k] = (c0[k] + k log pc + (K-1-k) log q) / (t (max-min) + min)
//   depth = sum_k softmax(y)[k] cent[k]
// with c0 the reference's Stirling log-binomial coefficients.
//
// What bounds it on the H100: at the main-path shape (4 x 392 x 518
// pixels from 224 x 296 centers, K = 64) it must move ~43 MB (p, t, out
// and the bf16 centers once), ~0.013 ms at 3.35 TB/s, and take 52 M exps,
// ~0.013 ms on MUFU at 16 a clock per SM; the rest is a few FMAs per
// (pixel, bin). There is no matrix product.
//
// Design (the tiled kernel): persistent blocks of 256 threads walk 8 x 64
// tiles of output pixels, one row per warp, two pixels per lane (x and
// x + 32). Each tile's low-resolution window of the centers (about 6 x 38
// source pixels at the head's 1.75x upsample) comes into shared memory in
// chunks of bins by cp.async, in the input's own layout (x contiguous for
// the model's permuted NCHW view, k for contiguous NHWC), 16-byte
// granules where the strides allow, double-buffered: the chunk after the
// current one, the next tile's first chunk, p and t included, is in
// flight while the current one is computed, and no register holds it.
// Per chunk each warp H-lerps its row's two source rows once per (source
// column, bin) into f32 bin pairs (shared memory, the warp's own), and
// its pixels then read two 8-byte words per two bins: the x corners. The
// per-pixel arithmetic is pf::logbinom_depth's (common.cuh): a bisection
// over the c0 table (staged in shared memory) for the softmax shift, then
// per bin two FMAs, one ex2.approx and three sums, the W lerp once at the
// end. c0 is the wrapper's table, cached per device.
//
// A shape the tiled kernel does not take takes the per-pixel kernel
// instead: one thread per pixel over the same body, the centers read from
// global memory. Those are a downsample of the centers steep enough (~2.5x
// in bf16, less in f32) that a 2-bin chunk of its window outgrows the copy
// slots, strides that need 64-bit offsets within one batch or are not
// 4-byte aligned, and layouts where neither x nor k is contiguous.

#include <algorithm>
#include <atomic>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kTH = 8, kTW = 64;  // output tile
constexpr int kThreads = 256;     // 8 warps: one tile row each
constexpr int kMinBlocks = 3;     // resident blocks per SM (80 registers)
constexpr int kSlots = 4;         // copy granules per thread per chunk
constexpr int kMaxBins = 64;      // bins per chunk, at most
constexpr int kC0Smem = 4096;     // bins whose c0 table is staged

// Two adjacent staged values (two columns, or two bins) as floats.
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const unsigned short* p) {
  const uint32_t v = *reinterpret_cast<const uint32_t*>(p);
  return make_float2(__uint_as_float(v << 16),
                     __uint_as_float(v & 0xffff0000u));
}

// i / d for 0 <= i < 2^16, m = ceil(2^32 / d) from the host.
__device__ __forceinline__ int fast_div(int i, uint64_t m) {
  return static_cast<int>((static_cast<uint64_t>(i) * m) >> 32);
}

// An asynchronous copy of `bytes` (<= size) from global to shared memory,
// the rest of `size` zero-filled; size is 16, 8 or 4.
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int size, int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if (size == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(bytes));
  else if (size == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
                 "l"(src), "r"(bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The tiled kernel's geometry, chosen on the host per shape.
struct Plan {
  int x_inner;       // 1: x is contiguous (NCHW view), 0: k is (NHWC)
  int gsize, gelems;  // copy granule: bytes, elements
  int fy, fx;        // window rows x columns (largest over tiles)
  int fxw;           // x_inner: staged columns per row (aligned, >= fx)
  int kc;            // bins per chunk (even)
  int rs_row, rs_col, rs_k;  // element strides of the staged window
  int granules;      // copy granules per chunk
  int tiles_x, tiles_y, tiles;
  int c0_bytes;      // the c0 table in shared memory (0: read from global)
  int raw_bytes;     // one buffer's window, rounded up to 16 bytes
  int buf_bytes;     // one buffer: its window, then the chunk's c0 and k
  int lstride;       // f32 pairs per column of a warp's H-lerped row (odd)
  int smem;          // bytes: c0, two buffers, the warps' H-lerped rows
  int n_a, items;    // the H-lerp pass: items (a fast, b slow)
  uint64_t m_a;      // fast_div magic of n_a
};

struct Args {
  const float* p;
  const float* t;
  const void* centers;
  const float* c0;
  float* out;
  int OH, OW, IH, IW, K;
  long long sb;
  int sy, sx, sk;  // within one batch the offsets fit 32 bits
  float min_temp, max_temp;
  Plan pl;
};

// A tile's place: batch b, output origin (y0, x0), and the origin of its
// window (iy0, ix0), moved inside the map so that the whole fy x fx window
// is in bounds; the copy starts at column ix0 - xoff (granule-aligned).
struct TileAt {
  int b, y0, x0, iy0, ix0, xoff;
};

__device__ __forceinline__ TileAt tile_at(int tile, const Args& a) {
  TileAt g;
  g.x0 = (tile % a.pl.tiles_x) * kTW;
  tile /= a.pl.tiles_x;
  g.y0 = (tile % a.pl.tiles_y) * kTH;
  g.b = tile / a.pl.tiles_y;
  g.iy0 = min(pf::align_corners_tap(g.y0, a.OH, a.IH).i0, a.IH - a.pl.fy);
  g.ix0 = min(pf::align_corners_tap(g.x0, a.OW, a.IW).i0, a.IW - a.pl.fx);
  g.xoff = a.pl.x_inner ? g.ix0 % a.pl.gelems : 0;
  return g;
}

// Persistent blocks walk the tiles blockIdx.x, + gridDim.x, ...; the
// chunks of all their tiles form one stream, each copied while the one
// before it is computed.
template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
logbinomial_depth_tiled(const Args a) {
  using R = typename std::conditional<std::is_same<T, float>::value, float,
                                      unsigned short>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const Plan& pl = a.pl;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float* c0 = a.c0;
  if (pl.c0_bytes) {
    float* c0s = reinterpret_cast<float*>(smem);
    for (int k = tid; k < a.K; k += kThreads) c0s[k] = __ldg(a.c0 + k);
    c0 = c0s;
  }
  unsigned char* bufs = smem + pl.c0_bytes;
  auto raw = [&](int i) {
    return reinterpret_cast<R*>(bufs + i * pl.buf_bytes);
  };
  auto cw = [&](int i) {
    return reinterpret_cast<float4*>(bufs + i * pl.buf_bytes +
                                      pl.raw_bytes);
  };
  // this warp's H-lerped row of the current chunk: [staged col][bin pair]
  float2* lrow = reinterpret_cast<float2*>(bufs + 2 * pl.buf_bytes) +
                 warp * pl.fxw * pl.lstride;

  // this thread's copy granules, the same for every tile: global offset
  // from the window's origin, shared offset in the buffer, and the
  // granule's first bin (its plane where x is contiguous) and first column
  // (where x is contiguous) as gk << 16 | col
  int goff[kSlots], soff[kSlots], meta[kSlots];
#pragma unroll
  for (int r = 0; r < kSlots; ++r) {
    const int g = tid + r * kThreads;
    soff[r] = -1;
    goff[r] = meta[r] = 0;
    if (g < pl.granules) {
      if (pl.x_inner) {
        const int per_row = pl.fxw / pl.gelems;
        const int col = (g % per_row) * pl.gelems;
        const int row = (g / per_row) % pl.fy;
        const int k = g / per_row / pl.fy;
        goff[r] = k * a.sk + row * a.sy + col;
        soff[r] = k * pl.rs_k + row * pl.rs_row + col;
        meta[r] = k << 16 | col;
      } else {
        const int per_px = pl.kc / pl.gelems;
        const int k = (g % per_px) * pl.gelems;
        const int col = (g / per_px) % pl.fx;
        const int row = g / per_px / pl.fx;
        goff[r] = row * a.sy + col * a.sx + k;
        soff[r] = row * pl.rs_row + col * pl.rs_col + k;
        meta[r] = k << 16;
      }
    }
  }
  constexpr int e = sizeof(R);
  // copies chunk kbase of tile g into buffer i, and that chunk's c0 and k
  auto issue = [&](const TileAt& g, int kbase, int i) {
    const R* src = static_cast<const R*>(a.centers) + g.b * a.sb +
                   static_cast<long long>(g.iy0) * a.sy +
                   static_cast<long long>(g.ix0 - g.xoff) * a.sx +
                   static_cast<long long>(kbase) * a.sk;
    R* dst = raw(i);
#pragma unroll
    for (int r = 0; r < kSlots; ++r) {
      if (soff[r] < 0) continue;
      const int k = kbase + (meta[r] >> 16);
      int bytes;
      if (pl.x_inner) {
        if (k >= a.K) continue;
        bytes = (a.IW - (g.ix0 - g.xoff) - (meta[r] & 0xffff)) * e;
      } else {
        bytes = (a.K - k) * e;
      }
      bytes = max(0, min(bytes, pl.gsize));
      cp_async(dst + soff[r], src + goff[r], pl.gsize, bytes);
    }
    cp_async_commit();
    if (tid < pl.kc / 2) {
      const int k = kbase + 2 * tid;
      cw(i)[tid] = make_float4(k < a.K ? c0[k] : 0.f,
                               k + 1 < a.K ? c0[k + 1] : 0.f,
                               static_cast<float>(k),
                               static_cast<float>(k + 1));
    }
  };
  // the lane's two pixels of tile g (clamped into the output; only live
  // ones store): x0 + lane and x0 + lane + 32 of row y0 + warp
  auto pixel = [&](const TileAt& g, int j) {
    return (static_cast<long long>(g.b) * a.OH +
            min(g.y0 + warp, a.OH - 1)) * a.OW +
           min(g.x0 + lane + 32 * j, a.OW - 1);
  };
  float pn[2], tn[2];  // p and t of the tile to come
  auto load_pt = [&](const TileAt& g) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      pn[j] = __ldg(a.p + pixel(g, j));
      tn[j] = __ldg(a.t + pixel(g, j));
    }
  };

  int tile = blockIdx.x;
  TileAt cur = tile_at(tile, a);
  __syncthreads();  // the c0 table is staged
  issue(cur, 0, 0);
  load_pt(cur);
  cp_async_wait_all();
  __syncthreads();

  const int chunks = (a.K + pl.kc - 1) / pl.kc;
  int step = 0;
  for (;;) {
    const int y = min(cur.y0 + warp, a.OH - 1);
    const pf::Tap ty = pf::align_corners_tap(y, a.OH, a.IH);
    const int ry0 = (ty.i0 - cur.iy0) * pl.rs_row;
    const int ry1 = ry0 + (ty.i1 - ty.i0) * pl.rs_row;
    int x0o[2], x1o[2];  // the two source columns in lrow
    float wx[2];
    pf::LogBinom lb[2];
    pf::DepthSums s[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int x = min(cur.x0 + lane + 32 * j, a.OW - 1);
      const pf::Tap tx = pf::align_corners_tap(x, a.OW, a.IW);
      wx[j] = tx.w;
      x0o[j] = (tx.i0 - cur.ix0 + cur.xoff) * pl.lstride;
      x1o[j] = (tx.i1 - cur.ix0 + cur.xoff) * pl.lstride;
      lb[j] = pf::logbinom_setup(pn[j], tn[j], c0, a.K, a.min_temp,
                                 a.max_temp);
    }
    const int next = tile + gridDim.x;

    for (int c = 0; c < chunks; ++c, ++step) {
      const bool more = c + 1 < chunks || next < pl.tiles;
      if (c + 1 < chunks) {
        issue(cur, (c + 1) * pl.kc, (step + 1) & 1);
      } else if (next < pl.tiles) {
        const TileAt nt = tile_at(next, a);
        issue(nt, 0, (step + 1) & 1);
        load_pt(nt);
      }
      // the H lerp of the warp's two source rows, once per (staged column,
      // bin): where x is contiguous an item is two columns by a bin pair,
      // else one column by a bin pair; lane L takes items L, L + 32, ...
      {
        const R* r0 = raw(step & 1) + ry0;
        const R* r1 = raw(step & 1) + ry1;
#pragma unroll 4
        for (int it = lane; it < pl.items; it += 32) {
          const int ib = fast_div(it, pl.m_a);
          const int ia = it - ib * pl.n_a;
          if (pl.x_inner) {  // columns 2 ia, 2 ia + 1; bins 2 ib, 2 ib + 1
            const int o = 2 * ia + 2 * ib * pl.rs_k;
            const float2 a0 = load2(r0 + o), a1 = load2(r1 + o);
            const float2 b0 = load2(r0 + o + pl.rs_k);
            const float2 b1 = load2(r1 + o + pl.rs_k);
            float2* d = lrow + 2 * ia * pl.lstride + ib;
            d[0] = make_float2(pf::lerp(a0.x, a1.x, ty.w),
                               pf::lerp(b0.x, b1.x, ty.w));
            d[pl.lstride] = make_float2(pf::lerp(a0.y, a1.y, ty.w),
                                        pf::lerp(b0.y, b1.y, ty.w));
          } else {  // column ib; bins 2 ia, 2 ia + 1
            const int o = ib * pl.rs_col + 2 * ia;
            const float2 v0 = load2(r0 + o), v1 = load2(r1 + o);
            lrow[ib * pl.lstride + ia] = make_float2(
                pf::lerp(v0.x, v1.x, ty.w), pf::lerp(v0.y, v1.y, ty.w));
          }
        }
      }
      __syncwarp();
      const float4* w = cw(step & 1);
      const int n = min(pl.kc, a.K - c * pl.kc);
#pragma unroll 4
      for (int q = 0; q < (n >> 1); ++q) {
        const float4 wq = w[q];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float2 v0 = lrow[x0o[j] + q], v1 = lrow[x1o[j] + q];
          s[j].add(lb[j].weight(wq.x, wq.z), v0.x, v1.x);
          s[j].add(lb[j].weight(wq.y, wq.w), v0.y, v1.y);
        }
      }
      if (n & 1) {  // the last bin of an odd K
        const int q = n >> 1;
        const float4 wq = w[q];
#pragma unroll
        for (int j = 0; j < 2; ++j)
          s[j].add(lb[j].weight(wq.x, wq.z), lrow[x0o[j] + q].x,
                   lrow[x1o[j] + q].x);
      }
      if (more) {
        // (the barrier also keeps lrow until every lane has read it)
        cp_async_wait_all();
        __syncthreads();
      }
    }
    if (cur.y0 + warp < a.OH) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
        if (cur.x0 + lane + 32 * j < a.OW)
          a.out[pixel(cur, j)] = s[j].finish(wx[j]);
    }
    if (next >= pl.tiles) break;
    tile = next;
    cur = tile_at(tile, a);
  }
}

// The per-pixel kernel, for shapes the tiled one does not take.
template <typename T>
__global__ void __launch_bounds__(256)
logbinomial_depth_pixel(const float* __restrict__ p,
                        const float* __restrict__ t,
                        const T* __restrict__ centers,
                        const float* __restrict__ c0,
                        float* __restrict__ out, int B, int OH, int OW,
                        int IH, int IW, int K, pf::Strides4 cs,
                        float min_temp, float max_temp) {
  const long long total = static_cast<long long>(B) * OH * OW;
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int x = static_cast<int>(idx % OW);
  const int y = static_cast<int>((idx / OW) % OH);
  const int b = static_cast<int>(idx / (static_cast<long long>(OW) * OH));
  out[idx] = pf::logbinom_depth_pixel<T>(p[idx], t[idx], centers, cs, c0, b,
                                         y, x, OH, OW, IH, IW, K, min_temp,
                                         max_temp);
}

// The footprint of `tile` outputs of an out -> in align_corners resize:
// the span of their first and last taps, plus one (as csrc/clb_tc.cuh).
int max_footprint(int tile, int out, int in) {
  if (out <= 1) return 2;
  const double r = static_cast<double>(in - 1) / (out - 1);
  const int f = static_cast<int>(r * (tile - 1)) + 3;
  return f < in ? f : in;
}

// The tiled kernel's plan for this shape, or false where it does not take
// it (see the note at the top).
bool plan_tiled(int B, int OH, int OW, int IH, int IW, int K, long long sb,
                long long sy, long long sx, long long sk, int e,
                const void* centers, Plan* pl) {
  // the last chunk's granules point up to kMaxBins bins past K - 1
  const long long span =
      (IH - 1) * sy + (IW - 1) * sx + (K + kMaxBins) * sk;
  if (sy < 0 || sx < 0 || sk < 0 || span >= (1ll << 31) - 1) return false;
  if (sx == 1)
    pl->x_inner = 1;
  else if (sk == 1)
    pl->x_inner = 0;
  else
    return false;
  // the largest granule every copy's source and destination align to
  const long long outer[3] = {sb, sy, pl->x_inner ? sk : sx};
  pl->gsize = 0;
  for (int g = 16; g >= 4 && !pl->gsize; g /= 2) {
    bool ok = reinterpret_cast<uintptr_t>(centers) % g == 0 && g >= e;
    for (long long s : outer) ok = ok && (s * e) % g == 0;
    if (ok) pl->gsize = g;
  }
  if (!pl->gsize) return false;
  const int ge = pl->gelems = pl->gsize / e;
  pl->fy = std::min(max_footprint(kTH, OH, IH), IH);
  pl->fx = std::min(max_footprint(kTW, OW, IW), IW);
  // bins per chunk: as many as the copy slots take, even (and whole
  // granules where k is contiguous), then evened out over the chunks
  const int mult = pl->x_inner ? 2 : std::max(2, ge);
  int kmax;
  if (pl->x_inner) {
    // whole granules, and an even count for the H-lerp pass's pairs
    const int gw = std::max(ge, 2);
    pl->fxw = (pl->fx + ge - 1 + gw - 1) / gw * gw;
    kmax = kThreads * kSlots / (pl->fy * (pl->fxw / ge));
  } else {
    pl->fxw = pl->fx;
    kmax = kThreads * kSlots / (pl->fy * pl->fx) * ge;
  }
  kmax = std::min(kmax, kMaxBins) / mult * mult;
  if (kmax < 2) return false;
  const int chunks = (K + kmax - 1) / kmax;
  pl->kc = ((K + chunks - 1) / chunks + mult - 1) / mult * mult;
  if (pl->x_inner) {
    pl->rs_col = 1;
    pl->rs_row = pl->fxw;
    pl->rs_k = pl->fy * pl->fxw;
    pl->granules = pl->kc * pl->fy * (pl->fxw / ge);
  } else {
    pl->rs_k = 1;
    pl->rs_col = pl->kc;
    pl->rs_row = pl->fx * pl->kc;
    pl->granules = pl->fy * pl->fx * (pl->kc / ge);
  }
  pl->c0_bytes = K <= kC0Smem ? (K * 4 + 15) & ~15 : 0;
  pl->raw_bytes = (pl->kc * pl->fy * pl->fxw * e + 15) & ~15;
  pl->buf_bytes = pl->raw_bytes + pl->kc / 2 * 16;
  pl->lstride = (pl->kc / 2) | 1;
  pl->smem = pl->c0_bytes + 2 * pl->buf_bytes +
             kThreads / 32 * pl->fxw * pl->lstride * 8;
  pl->n_a = pl->x_inner ? pl->fxw / 2 : pl->kc / 2;
  pl->items = pl->n_a * (pl->x_inner ? pl->kc / 2 : pl->fx);
  pl->m_a = ((1ull << 32) + pl->n_a - 1) / pl->n_a;
  pl->tiles_x = (OW + kTW - 1) / kTW;
  pl->tiles_y = (OH + kTH - 1) / kTH;
  const long long tiles = static_cast<long long>(B) * pl->tiles_x *
                          pl->tiles_y;
  pl->tiles = static_cast<int>(tiles);
  return tiles < 0x7fffffffLL && pl->smem <= 227 * 1024;
}

// What a launch of the tiled kernel asks of the driver, per device: its
// SM count, the shared memory the kernel was allowed, and the resident
// blocks per SM at the last size asked (kept, so a call costs no queries).
struct DeviceCache {
  std::atomic<int> sms{0}, smem_allowed{48 * 1024}, occ_smem{-1},
      occ_blocks{0};
};
constexpr int kCachedDevices = 64;

template <typename T>
cudaError_t tiled_grid(const Plan& pl, int device, int* blocks) {
  static DeviceCache caches[kCachedDevices];
  DeviceCache scratch;
  DeviceCache& c = device < kCachedDevices ? caches[device] : scratch;
  cudaError_t err = cudaSuccess;
  if (pl.smem > c.smem_allowed.load()) {
    err = cudaFuncSetAttribute(logbinomial_depth_tiled<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               pl.smem);
    if (err != cudaSuccess) return err;
    c.smem_allowed.store(pl.smem);
  }
  if (c.sms.load() == 0) {
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return err;
    c.sms.store(sms);
  }
  if (c.occ_smem.load() != pl.smem) {
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, logbinomial_depth_tiled<T>, kThreads, pl.smem);
    if (err != cudaSuccess) return err;
    c.occ_blocks.store(per_sm);
    c.occ_smem.store(pl.smem);
  }
  if (c.occ_blocks.load() < 1) return cudaErrorInvalidConfiguration;
  *blocks = std::min(pl.tiles, c.sms.load() * c.occ_blocks.load());
  return cudaSuccess;
}

template <typename T>
cudaError_t launch(const void* p, const void* t, const void* centers,
                   const float* c0, void* out, int B, int OH, int OW, int IH,
                   int IW, int K, pf::Strides4 cs, float min_temp,
                   float max_temp, int device, cudaStream_t stream,
                   int* variant) {
  const long long total = static_cast<long long>(B) * OH * OW;
  Plan pl;
  if (plan_tiled(B, OH, OW, IH, IW, K, cs.b, cs.y, cs.x, cs.c, sizeof(T),
                 centers, &pl)) {
    *variant = 1;
    if (total == 0) return cudaSuccess;
    int blocks = 0;
    const cudaError_t err = tiled_grid<T>(pl, device, &blocks);
    if (err != cudaSuccess) return err;
    const Args a{static_cast<const float*>(p), static_cast<const float*>(t),
                 centers, c0, static_cast<float*>(out), OH, OW, IH, IW, K,
                 cs.b, static_cast<int>(cs.y), static_cast<int>(cs.x),
                 static_cast<int>(cs.c), min_temp, max_temp, pl};
    logbinomial_depth_tiled<T><<<blocks, kThreads, pl.smem, stream>>>(a);
    return cudaGetLastError();
  }
  *variant = 2;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  if (blocks == 0) return cudaSuccess;
  logbinomial_depth_pixel<T><<<static_cast<unsigned>(blocks), threads, 0,
                               stream>>>(
      static_cast<const float*>(p), static_cast<const float*>(t),
      static_cast<const T*>(centers), c0, static_cast<float*>(out), B, OH,
      OW, IH, IW, K, cs, min_temp, max_temp);
  return cudaGetLastError();
}

}  // namespace

// C entry point. Pointers are device pointers on `device`; p, t and out are
// contiguous (B, OH, OW) float32; centers is (B, IH, IW, K) with the given
// element strides, float32 (centers_bf16 = 0) or bfloat16 (= 1); c0 is the
// K-entry log-binomial table in float32. Sets *variant to the kernel that
// ran: 1 the tiled kernel, 2 the per-pixel one. Returns the cudaError_t of
// the launch.
extern "C" int pf_logbinomial_depth(const void* p, const void* t,
                                    const void* centers, const void* c0,
                                    void* out, int centers_bf16, int B,
                                    int OH, int OW, int IH, int IW, int K,
                                    long long sb, long long sy, long long sx,
                                    long long sk, float min_temp,
                                    float max_temp, int device, void* stream,
                                    int* variant) {
  *variant = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const pf::Strides4 cs{sb, sy, sx, sk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* c0f = static_cast<const float*>(c0);
  if (centers_bf16)
    err = launch<__nv_bfloat16>(p, t, centers, c0f, out, B, OH, OW, IH, IW,
                                K, cs, min_temp, max_temp, device, s,
                                variant);
  else
    err = launch<float>(p, t, centers, c0f, out, B, OH, OW, IH, IW, K, cs,
                        min_temp, max_temp, device, s, variant);
  return static_cast<int>(err);
}
