// The whole ConditionalLogBinomial stage of the metric-bins head in one
// launch, for sm_90a: the MLP of csrc/clb_pt.cu and the depth expectation
// of csrc/logbinomial_depth.cu, fused.
//
// Replaces: patchfusion_tpu/ops/pallas_head.py::clb_logbinomial_depth
// (Pallas kernel _clb_depth_impl). Per output pixel (b, y, x):
//   (p, t) = the ConditionalLogBinomial MLP (as in csrc/clb_pt.cu)
//   depth  = sum_k softmax(log-binomial(p, t))[k] up(centers)[k]
// writing only the (B, OH, OW) f32 depth: p and t stay on the chip, the
// 80-channel bottleneck and the upsampled condition and centers never
// reach memory.
//
// What bounds it on the H100: bytes. At B = 4, 392x518 from 224x296 it
// must read 33 + (128 + 64) / 3.06 bf16 per output pixel and write 4 bytes
// (~159 MB), 0.047 ms at 3.35 TB/s; its tensor-core products (~10 GFLOP
// with the condition projected at low resolution) take ~0.01 ms and its
// 52 M exps ~0.013 ms on MUFU. What held the first fused kernel (0.51 ms,
// 9% of that bound) was latency in serialised phases: one 8-warp block
// per SM staged each tile's inputs through registers with synchronous
// loads (38% of its time, clock64 stamps), then projected, lerped and ran
// the depth epilogue behind barriers, the tensor cores idle during the
// softmax and MUFU idle during the products.
//
// bf16 design (the main path's inputs; the plan, i.e. tile height, the
// footprint's rows and columns, which maps TMA copies and the bin chunk,
// comes from the wrapper, ops/fused_head.clb_depth_plan, and is checked
// here before the launch):
//   * persistent blocks, one per SM, walk output tiles of TH x 32 pixels
//     (TH = 8, or 4 where a steep footprint would not fit), with two warp
//     roles on one copy of the weights (W1 as bf16 hi + lo, W2, the c0
//     table), staged once per block.
//   * 8 MLP warps: the tile's condition footprint (128 channels) projected
//     through W1[Cin:] on the tensor cores (mma.sync, A by ldmatrix.trans
//     from 8-pixel chunks of the staged rows) into a compact f32
//     (footprint row, column, 80) array; the tile's last_cat through
//     W1[:Cin]; per pixel the four corners of the projection lerped, b1,
//     bf16 rounding, tanh-GELU, rounding, W2 as one more mma, softplus:
//     csrc/clb_tc.cuh's arithmetic, so p and t are clb_pt's to the bit.
//     They hand p and t to the depth warps through a two-slot ring in
//     shared memory (named barriers full / empty per slot).
//   * 4 depth warps: per tile row the two source rows of the centers are
//     H-lerped once per (footprint column, bin) into f32 bin pairs, then
//     each pixel (a lane per column) runs logbinomial_depth's body (c0
//     bisection shift, ex2.approx, the W lerp at the end): the same
//     operations in the same order as csrc/logbinomial_depth.cu, so the
//     depth is the two-kernel route's to the bit. The depth of tile i runs
//     on MUFU and the FMA pipes while the MLP warps multiply tile i + 1 on
//     the tensor cores.
//   * every copy is TMA into its own buffer, one box per staged row: a
//     permuted NCHW map seen as (H W pixels, C, B, 1), a box of w pixels
//     by all its channels from the 8-pixel boundary at or before the
//     row's first wanted pixel (the H100 faults on a box whose start is
//     off the 16-byte grid; a staged row so holds up to 7 columns before
//     the footprint, row_shift), issued by one thread as soon as the
//     buffer is free, completing on an mbarrier: the next tile's condition
//     footprint as soon as the projection has read the current one, its
//     last_cat as soon as the input term has, its centers as soon as the
//     depth warps have H-lerped the current ones. Each copy has most of a
//     tile's compute to land in, and no phase waits on a load it could
//     have issued a tile earlier. (Per-thread cp.async instead issues
//     ~11 k copies of 4 or 8 bytes per tile, whose issue held the MLP
//     warps in this kernel's first form.) Where a row's shift keeps 16
//     pixels off the 16-byte grid (last_cat's A fragments, the centers'
//     H lerp) the reads are 2-byte loads. A map TMA cannot take (x not
//     contiguous, strides not multiples of 16 bytes) is staged by
//     synchronous element loads into the same layout, unshifted.
// For f32 inputs (not on the main path): clb_pt's first design (one
// thread per pixel, grid-stride loop, the f32 weights in shared memory)
// with pf::logbinom_depth_pixel's epilogue. All three maps are read
// through their strides (NCHW tensors as permuted views).

#include <cuda.h>

#include <algorithm>
#include <cmath>
#include <cstring>

#include "clb_tc.cuh"
#include "common.cuh"

namespace {

namespace tc = pf::tc;
using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// phase timing (a timing build: -DPF_PHASE_TIMING; chip_smoke.py and
// tools/clb_depth_split.py build one beside the kernel library). Each warp
// sums clock64() deltas per phase in registers and adds them to
// g_phase_cycles when it ends.
// ---------------------------------------------------------------------------

#ifdef PF_PHASE_TIMING
constexpr int kPhases = 13;
__device__ unsigned long long g_phase_cycles[kPhases];
#define PF_PHASES() \
  long long pf_t0_ = clock64();  \
  long long pf_ph_[kPhases] = {};
#define PF_PHASE(i)                         \
  do {                                      \
    __syncwarp();                           \
    const long long pf_t_ = clock64();      \
    pf_ph_[i] += pf_t_ - pf_t0_;            \
    pf_t0_ = pf_t_;                         \
  } while (0)
#define PF_PHASES_FLUSH()                                              \
  do {                                                                 \
    if ((threadIdx.x & 31) == 0)                                       \
      for (int pf_i_ = 0; pf_i_ < kPhases; ++pf_i_)                    \
        atomicAdd(g_phase_cycles + pf_i_,                              \
                  static_cast<unsigned long long>(pf_ph_[pf_i_]));     \
  } while (0)
#else
#define PF_PHASES()
#define PF_PHASE(i) \
  do {              \
  } while (0)
#define PF_PHASES_FLUSH() \
  do {                    \
  } while (0)
#endif

// ---------------------------------------------------------------------------
// f32 inputs: one thread per pixel
// ---------------------------------------------------------------------------

constexpr int kF32Threads = 128;

__global__ void __launch_bounds__(kF32Threads)
clb_depth_f32_kernel(const float* __restrict__ last,
                     const float* __restrict__ cond,
                     const float* __restrict__ centers,
                     const float* __restrict__ w1,
                     const float* __restrict__ b1,
                     const float* __restrict__ w2,
                     const float* __restrict__ b2, float* __restrict__ out,
                     int B, int OH, int OW, int IH, int IW, int Cin, int Cc,
                     int K, pf::Strides4 ls, pf::Strides4 cs,
                     pf::Strides4 zs, float p_eps, float min_temp,
                     float max_temp) {
  extern __shared__ float smem_f32[];
  const pf::ClbWeights w =
      pf::clb_stage_weights(smem_f32, w1, b1, w2, b2, Cin + Cc);
  float* c0 = smem_f32 + pf::clb_smem_floats(Cin + Cc);
  pf::fill_log_binom_c0(c0, K);

  const long long total = static_cast<long long>(B) * OH * OW;
  for (long long idx =
           static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       idx < total; idx += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int x = static_cast<int>(idx % OW);
    const int y = static_cast<int>((idx / OW) % OH);
    const int b = static_cast<int>(idx / (static_cast<long long>(OW) * OH));
    const float2 pt = pf::clb_pixel(last, cond, ls, cs, w, b, y, x, OH, OW,
                                    IH, IW, Cin, Cc, p_eps);
    out[idx] = pf::logbinom_depth_pixel<float>(pt.x, pt.y, centers, zs, c0,
                                               b, y, x, OH, OW, IH, IW, K,
                                               min_temp, max_temp);
  }
}

cudaError_t launch_f32(const void* last, const void* cond,
                       const void* centers, const void* w1, const void* b1,
                       const void* w2, const void* b2, void* out, int B,
                       int OH, int OW, int IH, int IW, int Cin, int Cc, int K,
                       pf::Strides4 ls, pf::Strides4 cs, pf::Strides4 zs,
                       float p_eps, float min_temp, float max_temp,
                       int device, cudaStream_t stream) {
  const size_t smem =
      (static_cast<size_t>(pf::clb_smem_floats(Cin + Cc)) + K) *
      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      clb_depth_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, clb_depth_f32_kernel, kF32Threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long total = static_cast<long long>(B) * OH * OW;
  if (total == 0) return cudaSuccess;
  long long blocks = (total + kF32Threads - 1) / kF32Threads;
  const long long resident = static_cast<long long>(sms) * per_sm;
  if (blocks > resident) blocks = resident;
  clb_depth_f32_kernel
      <<<static_cast<unsigned>(blocks), kF32Threads, smem, stream>>>(
          static_cast<const float*>(last), static_cast<const float*>(cond),
          static_cast<const float*>(centers), static_cast<const float*>(w1),
          static_cast<const float*>(b1), static_cast<const float*>(w2),
          static_cast<const float*>(b2), static_cast<float*>(out), B, OH, OW,
          IH, IW, Cin, Cc, K, ls, cs, zs, p_eps, min_temp, max_temp);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: the warp-specialised tiled kernel
// ---------------------------------------------------------------------------

constexpr int kMlpWarps = 8;
constexpr int kDepthWarps = 4;
constexpr int kMlpThreads = 32 * kMlpWarps;
constexpr int kDepthThreads = 32 * kDepthWarps;
constexpr int kThreads = kMlpThreads + kDepthThreads;
constexpr int kTW = 32;  // tile columns: one per lane of a depth warp
constexpr int kLW = kTW + 8;  // staged last_cat columns (a box's shift)
constexpr int kProjStride = tc::kHid + 8;  // f32 per projected pixel
// named barriers (0 is __syncthreads): each role's own, and per p / t slot
// "full" (the MLP warps arrive, the depth warps wait) and "empty" (the
// other way round)
constexpr int kBarMlp = 1, kBarDepth = 2, kBarFull = 3, kBarEmpty = 5;
// Plan::tma bits: the maps copied by TMA boxes (else by element loads)
constexpr int kTmaCond = 1, kTmaCent = 2, kTmaLast = 4;

// The wrapper's plan (ops/fused_head.clb_depth_plan; field for field).
struct Plan {
  int th;    // tile rows: 8 or 4
  int fy;    // footprint rows of a tile, at most
  int fx;    // footprint columns of a tile, at most
  int ws;    // staged footprint columns: fx + 7 rounded up to 8
  int tma;   // kTma* bits
  int kc;    // bins per H-lerp chunk (even)
  int smem;  // bytes of shared memory
};
static_assert(sizeof(Plan) == 7 * sizeof(int), "the wrapper's 7 ints");

// Byte offsets of the shared-memory buffers from a 128-byte aligned base,
// and the staged maps' strides in elements. The staged maps are row-major
// over footprint (or tile) rows, one TMA box per row: last_cat
// [row][c][kLW], cond_lo [row][c][ws], centers [row][k][ws]; a row starts
// at the 8-pixel boundary at or before its first pixel (row_shift); the
// projection is kept compact, [row][fx][kProjStride].
struct Layout {
  int w_lo, w2, b1, b2, c0, c0w, bars, last, cond, proj, pt, cent, lrow;
  int last_row;  // bf16 per staged last_cat row
  int cond_row;  // bf16 per staged cond_lo row (128 ws)
  int cent_row;  // bf16 per staged centers row
  int hstride;   // float2 per column of a depth warp's H-lerped row (odd)
  int total;     // bytes, with the 128 of the base's alignment
};

__host__ __device__ inline int align128(int n) { return (n + 127) & ~127; }

__host__ __device__ inline Layout layout(const Plan& p, int Cin, int K) {
  Layout l;
  const int k2 = K + (K & 1);  // the c0 pairs
  l.w_lo = tc::kHid * tc::kWStride * 2;
  int o = 2 * l.w_lo;  // W1 hi, then lo
  l.w2 = o;
  o += 8 * tc::kW2Stride * 2;
  l.b1 = o;
  o += tc::kHid * 4;
  l.b2 = o;
  o += 16;
  l.c0 = o;
  o += (K * 4 + 15) & ~15;
  l.c0w = o;
  o += k2 / 2 * 16;
  l.bars = o;  // the three mbarriers
  o += 32;
  o = align128(o);
  l.last_row = align128(Cin * kLW * 2) / 2;
  l.last = o;
  o += p.th * l.last_row * 2;
  l.cond_row = tc::kCc * p.ws;
  l.cond = o;
  o += p.fy * l.cond_row * 2;
  l.proj = o;
  o += p.fy * p.fx * kProjStride * 4;
  l.pt = o;
  o += 2 * 2 * kTW * p.th * 4;
  o = align128(o);
  l.cent_row = align128(K * p.ws * 2) / 2;
  l.cent = o;
  o += p.fy * l.cent_row * 2;
  l.hstride = (p.kc / 2) | 1;
  l.lrow = o;
  o += kDepthWarps * p.fx * l.hstride * 8;
  l.total = o + 128;
  return l;
}

struct Args {
  const bf16* last;
  const bf16* cond;
  const bf16* cent;
  const float *w1, *b1, *w2, *b2, *c0;
  float* out;
  int OH, OW, IH, IW, Cin, K;
  pf::Strides4 ls, cs, zs;
  float p_eps, min_temp, max_temp;
  Plan pl;
  Layout ly;
  int tiles_x, tiles_y, tiles;
};

// A tile's place and its footprint: rows iy_lo .. iy_lo + fy - 1 and
// columns ix_lo .. ix_lo + fx - 1.
struct Geo {
  int b, y0, x0, iy_lo, fy, ix_lo, fx;
};

__device__ __forceinline__ Geo tile_geo(int tile, const Args& a, int TH) {
  Geo q;
  q.x0 = (tile % a.tiles_x) * kTW;
  q.y0 = ((tile / a.tiles_x) % a.tiles_y) * TH;
  q.b = tile / (a.tiles_x * a.tiles_y);
  const int y1 = min(q.y0 + TH, a.OH) - 1, x1 = min(q.x0 + kTW, a.OW) - 1;
  q.iy_lo = pf::align_corners_tap(q.y0, a.OH, a.IH).i0;
  q.ix_lo = pf::align_corners_tap(q.x0, a.OW, a.IW).i0;
  q.fy = pf::align_corners_tap(y1, a.OH, a.IH).i1 - q.iy_lo + 1;
  q.fx = pf::align_corners_tap(x1, a.OW, a.IW).i1 - q.ix_lo + 1;
  return q;
}

// The columns a staged row of a (., W) map holds before its first wanted
// pixel (y, x): a TMA box starts at the 8-pixel (16-byte) boundary at or
// before it (the H100 faults on a box that starts off one); element loads
// start at the pixel itself.
__device__ __forceinline__ int row_shift(bool tma, int y, int W, int x) {
  return tma ? (y * W + x) & 7 : 0;
}

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar));
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
// Waits until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// One box of a tensor map over (pixel, channel, batch, 1) into shared
// memory, from pixel px (a multiple of 8); completes on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint32_t bar, int px, int b) {
  const int zero = 0;
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %4}], [%2];\n" ::"r"(
          tc::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(px), "r"(zero),
      "r"(b)
      : "memory");
}

// Stages rows y_lo .. y_lo + n_rows - 1 (those below H) of one batch's
// (H, W, C) map, channels 0 .. n_c - 1, row-major into dst: row r, channel
// c, staged column j at dst[r row + c w + j], holding map column x_lo - s
// + j with s = row_shift. TMA (map non-null): one box of w pixels by n_c
// channels per row from the map's flattened pixel (y, x_lo) - s (a box
// running past the row's end reads the next row's first pixels, past the
// map's end zeros), issued by the calling thread, which arrives on bar
// expecting their bytes. Else element loads (s = 0) by thread tid of
// n_threads (columns past W read as zeros), done on return.
__device__ __forceinline__ void stage(
    bf16* dst, int row, const CUtensorMap* map, uint32_t bar, int b,
    const bf16* src, const pf::Strides4& s, int y_lo, int n_rows, int H,
    int x_lo, int w, int W, int n_c, int tid, int n_threads) {
  n_rows = min(n_rows, H - y_lo);
  if (map) {
    mbar_expect_tx(bar, static_cast<uint32_t>(n_rows * n_c * w * 2));
    for (int r = 0; r < n_rows; ++r)
      tma_load(dst + r * row, map, bar, ((y_lo + r) * W + x_lo) & ~7, b);
    return;
  }
  const int per_row = n_c * w;
  for (int i = tid; i < n_rows * per_row; i += n_threads) {
    // the channel fastest: contiguous reads where the map is NHWC
    const int c = i % n_c, px = i / n_c;
    const int r = px / w, col = px - r * w;
    const int x = x_lo + col;
    dst[r * row + c * w + col] =
        x < W ? src[b * s.b + static_cast<long long>(y_lo + r) * s.y +
                    x * s.x + c * s.c]
              : __float2bfloat16(0.f);
  }
}

// The projection works on 8-pixel chunks of the staged condition rows
// (chunk i: row i / nch, staged columns 8 (i % nch) ..), nch per row, two
// to an m-tile. This lane's element offset of the chunk it addresses in
// m-tile mt (the last chunk again past n_chunks).
__device__ __forceinline__ int cond_chunk(int mt, int nch, int n_chunks,
                                          int row) {
  const int i = min(2 * mt + ((threadIdx.x >> 3) & 1), n_chunks - 1);
  const int r = i / nch;
  return r * row + 8 * (i - r * nch);
}

// The A fragment (the m-tile of cond_chunk's offset `chunk` x 16 channels
// k0 ..) of the staged condition [row][channel][ws]: four 8x8 matrices
// through ldmatrix.trans.
__device__ __forceinline__ void load_a_cond(uint32_t (&a)[4],
                                            const bf16* base, int chunk,
                                            int ws, int k0) {
  const int lane = threadIdx.x & 31;
  const int mat = lane >> 3, r = lane & 7;
  const bf16* p = base + chunk + (k0 + r + 8 * (mat >> 1)) * ws;
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(tc::smem_u32(p)));
}

// The A fragment (16 pixels x 16 channels k0 ..) of the staged last_cat
// row `base` ([channel][kLW]) from staged column col0 (a row's shift keeps
// it off the 16-byte grid that ldmatrix needs): the mma layout assembled
// from 2-byte loads, channels >= cin as zeros.
__device__ __forceinline__ void load_a_last(uint32_t (&a)[4],
                                            const bf16* base, int col0,
                                            int k0, int cin) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const unsigned short* p =
      reinterpret_cast<const unsigned short*>(base) + col0 + g;
  auto v = [&](int k, int dx) -> uint32_t {
    return k < cin ? p[k * kLW + dx] : 0u;
  };
  const int k = k0 + 2 * t;
  a[0] = v(k, 0) | v(k + 1, 0) << 16;
  a[1] = v(k, 8) | v(k + 1, 8) << 16;
  a[2] = v(k + 8, 0) | v(k + 9, 0) << 16;
  a[3] = v(k + 8, 8) | v(k + 9, 8) << 16;
}

// The B fragments of one hidden n-tile n0 (16 input channels k0 ..) from a
// staged (hidden, k) weight: one ldmatrix.x2.
__device__ __forceinline__ void load_b_one(uint32_t (&b)[2], const bf16* w,
                                           int n0, int k0) {
  const int lane = threadIdx.x & 31;
  const int mat = (lane >> 3) & 1, r = lane & 7;
  const bf16* p = w + (n0 + r) * tc::kWStride + k0 + 8 * mat;
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(b[0]), "=r"(b[1])
      : "r"(tc::smem_u32(p)));
}

// acc[j] += a . W1[k0 .. k0 + 15, n-tile 5 h + j] for j < 5 (hidden
// columns 40 h .. 40 h + 39), hi then lo as tc::mma_w1 orders them.
__device__ __forceinline__ void mma_w1_half(float (&acc)[5][4],
                                            const uint32_t (&a)[4],
                                            const bf16* w_hi,
                                            const bf16* w_lo, int k0,
                                            int h) {
  const int n0 = 40 * h;
#pragma unroll
  for (int np = 0; np < 2; ++np)
#pragma unroll
    for (int part = 0; part < 2; ++part) {
      uint32_t b[4];
      tc::load_b_pair(b, part ? w_lo : w_hi, n0 + 16 * np, k0);
      tc::mma_16816(acc[2 * np], a, b[0], b[1]);
      tc::mma_16816(acc[2 * np + 1], a, b[2], b[3]);
    }
#pragma unroll
  for (int part = 0; part < 2; ++part) {
    uint32_t b[2];
    load_b_one(b, part ? w_lo : w_hi, n0 + 32, k0);
    tc::mma_16816(acc[4], a, b[0], b[1]);
  }
}

struct Smem {
  bf16 *w_hi, *w_lo, *w2;
  float *b1, *b2, *c0;
  float4* c0w;
  bf16 *last, *cond;
  float *proj, *pt;
  bf16* cent;
  float2* lrow;
  uint32_t bar_cond, bar_last, bar_cent;  // mbarriers of the TMA copies
};

// The three TMA tensor maps (unused where Plan::tma leaves a map to
// element loads): on the host, and in the kernel as pointers to its
// __grid_constant__ parameters.
struct Maps {
  CUtensorMap last, cond, cent;
};
struct MapPtrs {
  const CUtensorMap *last, *cond, *cent;
};

template <int TH>
__device__ __forceinline__ void mlp_warps(const Args& a, const Smem& sm,
                                          const MapPtrs& maps) {
  constexpr int kM = TH / 4;  // m-tiles of 16 pixels per warp
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const Layout& ly = a.ly;
  const int ws = a.pl.ws, fxp = a.pl.fx;
  const bool tma_c = a.pl.tma & kTmaCond, tma_l = a.pl.tma & kTmaLast;
  PF_PHASES()
  // the next tile's cond_lo footprint and last_cat tile: by TMA from
  // thread 0, or by the element loads of every MLP thread
  auto issue_cond = [&](const Geo& q) {
    if (!tma_c || tid == 0)
      stage(sm.cond, ly.cond_row, tma_c ? maps.cond : nullptr, sm.bar_cond,
            q.b, a.cond, a.cs, q.iy_lo, q.fy, a.IH, q.ix_lo, ws, a.IW,
            tc::kCc, tid, kMlpThreads);
  };
  auto issue_last = [&](const Geo& q) {
    if (!tma_l || tid == 0)
      stage(sm.last, ly.last_row, tma_l ? maps.last : nullptr, sm.bar_last,
            q.b, a.last, a.ls, q.y0, TH, a.OH, q.x0, kLW, a.OW, a.Cin, tid,
            kMlpThreads);
  };

  int tile = blockIdx.x;
  Geo cur = tile_geo(tile, a, TH);
  issue_cond(cur);
  issue_last(cur);
  for (int j = 0;; ++j) {
    const int next = tile + gridDim.x;
    const bool more = next < a.tiles;
    const uint32_t parity = j & 1;
    PF_PHASE(12);
    if (tma_c) mbar_wait(sm.bar_cond, parity);
    // the tile's footprint is staged; the last tile's lerp is done with
    // proj
    bar_sync(kBarMlp, kMlpThreads);
    PF_PHASE(0);

    // ---- project the footprint: proj (fy, fx, 80) = cond . W1[Cin:] in
    // f32, over the staged chunks that hold footprint columns, kept compact
    // (no shifts), in units of (m-tile, half of the hidden columns)
    int nch = 1;
    for (int r = 0; r < cur.fy; ++r)
      nch = max(nch, (row_shift(tma_c, cur.iy_lo + r, a.IW, cur.ix_lo) +
                      cur.fx + 7) >> 3);
    const int n_chunks = cur.fy * nch, mtiles = (n_chunks + 1) >> 1;
    for (int u = warp; u < 2 * mtiles; u += kMlpWarps) {
      const int mt = u >> 1, h = u & 1;
      const int chunk = cond_chunk(mt, nch, n_chunks, ly.cond_row);
      float acc[5][4] = {};
#pragma unroll
      for (int ks = 0; ks < tc::kCc / 16; ++ks) {
        uint32_t af[4];
        load_a_cond(af, sm.cond, chunk, ws, 16 * ks);
        mma_w1_half(acc, af, sm.w_hi, sm.w_lo, tc::kCinPad + 16 * ks, h);
      }
      // this thread's pixels: column g of chunks 2 mt and 2 mt + 1
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = 2 * mt + r;
        const int row = i / nch;
        const int col = 8 * (i - row * nch) + g -
                        row_shift(tma_c, cur.iy_lo + row, a.IW, cur.ix_lo);
        if (i >= n_chunks || col < 0 || col >= cur.fx) continue;
        float* dst =
            sm.proj + (row * fxp + col) * kProjStride + 40 * h + 2 * t;
#pragma unroll
        for (int n = 0; n < 5; ++n)
          *reinterpret_cast<float2*>(dst + 8 * n) =
              make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
      }
    }
    PF_PHASE(1);
    bar_sync(kBarMlp, kMlpThreads);  // proj is whole; cond is free
    Geo nxt = cur;
    if (more) {
      nxt = tile_geo(next, a, TH);
      issue_cond(nxt);
    }
    if (tma_l) mbar_wait(sm.bar_last, parity);
    PF_PHASE(2);

    // ---- per m-tile warp + 8 m (16 pixels of one tile row): the input
    // term, the lerped condition term, b1, GELU, W2, softplus
    // (csrc/clb_tc.cuh's arithmetic, operation for operation)
    float ptm[kM][2];
#pragma unroll
    for (int mi = 0; mi < kM; ++mi) {
      const int mt = warp + kMlpWarps * mi;
      const int tr = mt / (kTW / 16);  // tile row
      const bf16* lrow_s = sm.last + tr * ly.last_row;
      const int col0 = 16 * (mt % (kTW / 16)) +
                       row_shift(tma_l, cur.y0 + tr, a.OW, cur.x0);
      float acc[1][tc::kNT][4] = {};
#pragma unroll
      for (int ks = 0; ks < tc::kCinPad / 16; ++ks) {
        uint32_t af[1][4];
        load_a_last(af[0], lrow_s, col0, 16 * ks, a.Cin);
        tc::mma_w1<1>(acc, af, sm.w_hi, sm.w_lo, 16 * ks);
      }
      PF_PHASE(3);
      if (mi == kM - 1) {
        bar_sync(kBarMlp, kMlpThreads);  // last_cat is free
        if (more) issue_last(nxt);
        PF_PHASE(4);
      }
      ptm[mi][0] = ptm[mi][1] = 0.5f;
      const int y = cur.y0 + mt / (kTW / 16);
      if (y >= a.OH) continue;
      const int xm = cur.x0 + 16 * (mt % (kTW / 16));
      const pf::Tap ty = pf::align_corners_tap(y, a.OH, a.IH);
      int c00[2], c01[2], c10[2], c11[2];
      float wx[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int x = min(xm + g + 8 * r, a.OW - 1);
        const pf::Tap tx = pf::align_corners_tap(x, a.OW, a.IW);
        wx[r] = tx.w;
        const int col = tx.i0 - cur.ix_lo;
        const int p00 = (ty.i0 - cur.iy_lo) * fxp + col;
        const int p10 = (ty.i1 - cur.iy_lo) * fxp + col;
        const int dx = tx.i1 - tx.i0;
        c00[r] = p00 * kProjStride + 2 * t;
        c01[r] = c00[r] + dx * kProjStride;
        c10[r] = p10 * kProjStride + 2 * t;
        c11[r] = c10[r] + dx * kProjStride;
      }
      // GELU(h) rounded, as the W2 product's A operand: n-tile n, pixel
      // row r, channels (2 t, 2 t + 1) in gelu[n][r]
      uint32_t gelu[tc::kNT][2];
      // h = input term + lerp(condition term) + b1, rounded; GELU, rounded
      // (the roundings two values at a time: the same bits)
      auto round2 = [](float x, float y, float& rx, float& ry) {
        const uint32_t v = tc::pack_bf16x2(x, y);
        rx = __uint_as_float(v << 16);
        ry = __uint_as_float(v & 0xffff0000u);
      };
#pragma unroll
      for (int n = 0; n < tc::kNT; ++n) {
        const float2 bb =
            *reinterpret_cast<const float2*>(sm.b1 + 8 * n + 2 * t);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int o = 8 * n;
          const float2 v00 =
              *reinterpret_cast<const float2*>(sm.proj + c00[r] + o);
          const float2 v10 =
              *reinterpret_cast<const float2*>(sm.proj + c10[r] + o);
          const float2 v01 =
              *reinterpret_cast<const float2*>(sm.proj + c01[r] + o);
          const float2 v11 =
              *reinterpret_cast<const float2*>(sm.proj + c11[r] + o);
          const float a0x = v00.x * (1.f - ty.w) + v10.x * ty.w;
          const float a1x = v01.x * (1.f - ty.w) + v11.x * ty.w;
          const float a0y = v00.y * (1.f - ty.w) + v10.y * ty.w;
          const float a1y = v01.y * (1.f - ty.w) + v11.y * ty.w;
          const float ux = a0x * (1.f - wx[r]) + a1x * wx[r];
          const float uy = a0y * (1.f - wx[r]) + a1y * wx[r];
          float h0, h1;
          round2(acc[0][n][2 * r] + ux + bb.x,
                 acc[0][n][2 * r + 1] + uy + bb.y, h0, h1);
          gelu[n][r] = tc::pack_bf16x2(pf::gelu_tanh<bf16>(h0),
                                       pf::gelu_tanh<bf16>(h1));
        }
      }
      // (p0, p1, t0, t1) = GELU . W2: n-tiles 2 kk and 2 kk + 1 are the A
      // fragment of k-step kk
      float out[4] = {};
#pragma unroll
      for (int kk = 0; kk < tc::kHid / 16; ++kk) {
        const uint32_t af[4] = {gelu[2 * kk][0], gelu[2 * kk][1],
                                gelu[2 * kk + 1][0], gelu[2 * kk + 1][1]};
        const bf16* wr = sm.w2 + g * tc::kW2Stride + 16 * kk + 2 * t;
        tc::mma_16816(out, af, *reinterpret_cast<const uint32_t*>(wr),
                      *reinterpret_cast<const uint32_t*>(wr + 8));
      }
      // thread t = 0 holds (p0, p1), t = 1 holds (t0, t1), of pixels g and
      // g + 8
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int o = 2 * (t & 1);
        const float s0 = pf::softplus(out[2 * r] + sm.b2[o]) + a.p_eps;
        const float s1 = pf::softplus(out[2 * r + 1] + sm.b2[o + 1]) +
                         a.p_eps;
        ptm[mi][r] = s0 / (s0 + s1);
      }
      PF_PHASE(5);
    }

    // ---- p and t to slot j % 2: p at [px], t at [TH 32 + px]
    const int slot = j & 1;
    if (j >= 2) bar_sync(kBarEmpty + slot, kThreads);
    if (t < 2) {
      float* dst = sm.pt + slot * 2 * kTW * TH + t * kTW * TH;
#pragma unroll
      for (int mi = 0; mi < kM; ++mi) {
        const int mt = warp + kMlpWarps * mi;
#pragma unroll
        for (int r = 0; r < 2; ++r)
          dst[mt * 16 + g + 8 * r] = ptm[mi][r];
      }
    }
    bar_arrive(kBarFull + slot, kThreads);
    PF_PHASE(6);
    if (!more) break;
    tile = next;
    cur = nxt;
  }
  PF_PHASES_FLUSH();
}

// The depth warps: per tile row the H lerp of the centers and each
// pixel's softmax-weighted sums (csrc/logbinomial_depth.cu's arithmetic).
template <int TH>
__device__ __forceinline__ void depth_warps(const Args& a, const Smem& sm,
                                            const MapPtrs& maps) {
  constexpr int kRows = TH / 4;  // tile rows per warp
  const int tid = threadIdx.x - kMlpThreads;
  const int warp = tid >> 5, lane = tid & 31;
  const Layout& ly = a.ly;
  const int ws = a.pl.ws;
  const bool tma_z = a.pl.tma & kTmaCent;
  float2* lrow = sm.lrow + warp * a.pl.fx * ly.hstride;
  const unsigned short* raw = reinterpret_cast<const unsigned short*>(sm.cent);
  PF_PHASES()
  auto issue_cent = [&](const Geo& q) {
    if (!tma_z || tid == 0)
      stage(sm.cent, ly.cent_row, tma_z ? maps.cent : nullptr, sm.bar_cent,
            q.b, a.cent, a.zs, q.iy_lo, q.fy, a.IH, q.ix_lo, ws, a.IW, a.K,
            tid, kDepthThreads);
  };
  auto f32 = [](unsigned short v) { return __uint_as_float(v << 16); };

  int tile = blockIdx.x;
  Geo cur = tile_geo(tile, a, TH);
  issue_cent(cur);
  const int mine =
      (a.tiles - 1 - static_cast<int>(blockIdx.x)) / gridDim.x + 1;
  const int chunks = (a.K + a.pl.kc - 1) / a.pl.kc;
  for (int j = 0; j < mine; ++j) {
    const int slot = j & 1;
    PF_PHASE(11);
    if (tma_z)
      mbar_wait(sm.bar_cent, j & 1);
    else
      bar_sync(kBarDepth, kDepthThreads);  // the element loads are done
    PF_PHASE(7);
    bar_sync(kBarFull + slot, kThreads);  // the tile's p and t
    float pv[kRows], tv[kRows];
    const float* src = sm.pt + slot * 2 * kTW * TH;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int px = (warp + kDepthWarps * i) * kTW + lane;
      pv[i] = src[px];
      tv[i] = src[kTW * TH + px];
    }
    if (j + 2 < mine) bar_arrive(kBarEmpty + slot, kThreads);
    PF_PHASE(8);

    const int x = min(cur.x0 + lane, a.OW - 1);
    const pf::Tap tx = pf::align_corners_tap(x, a.OW, a.IW);
    const int x0o = (tx.i0 - cur.ix_lo) * ly.hstride;
    const int x1o = (tx.i1 - cur.ix_lo) * ly.hstride;
    const tc::FastDiv by_x(cur.fx);
    float dep[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int y = min(cur.y0 + warp + kDepthWarps * i, a.OH - 1);
      const pf::Tap ty = pf::align_corners_tap(y, a.OH, a.IH);
      // the two source rows, each from its footprint column 0
      const unsigned short* r0 = raw + (ty.i0 - cur.iy_lo) * ly.cent_row +
                                 row_shift(tma_z, ty.i0, a.IW, cur.ix_lo);
      const unsigned short* r1 = raw + (ty.i1 - cur.iy_lo) * ly.cent_row +
                                 row_shift(tma_z, ty.i1, a.IW, cur.ix_lo);
      const pf::LogBinom lb = pf::logbinom_setup(pv[i], tv[i], sm.c0, a.K,
                                                 a.min_temp, a.max_temp);
      pf::DepthSums s;
      for (int c = 0; c < chunks; ++c) {
        const int kb = c * a.pl.kc;
        const int n = min(a.pl.kc, a.K - kb);
        // the H lerp: item (footprint column ix, bin pair ib), lane L
        // takes items L, L + 32, ... (2-byte loads: the two rows' shifts
        // may differ)
        const int items = cur.fx * ((n + 1) >> 1);
#pragma unroll 4
        for (int it = lane; it < items; it += 32) {
          const int ib = by_x.div(it), ix = it - ib * cur.fx;
          const int o = ix + (kb + 2 * ib) * ws;
          lrow[ix * ly.hstride + ib] =
              make_float2(pf::lerp(f32(r0[o]), f32(r1[o]), ty.w),
                          pf::lerp(f32(r0[o + ws]), f32(r1[o + ws]), ty.w));
        }
        __syncwarp();
        PF_PHASE(9);
        const float4* wq4 = sm.c0w + kb / 2;
#pragma unroll 4
        for (int q = 0; q < (n >> 1); ++q) {
          const float4 wq = wq4[q];
          const float2 v0 = lrow[x0o + q], v1 = lrow[x1o + q];
          s.add(lb.weight(wq.x, wq.z), v0.x, v1.x);
          s.add(lb.weight(wq.y, wq.w), v0.y, v1.y);
        }
        if (n & 1) {  // the last bin of an odd K
          const int q = n >> 1;
          const float4 wq = wq4[q];
          s.add(lb.weight(wq.x, wq.z), lrow[x0o + q].x, lrow[x1o + q].x);
        }
        __syncwarp();  // every lane has read lrow
        PF_PHASE(10);
      }
      dep[i] = s.finish(tx.w);
    }
    // every depth warp is done with the centers: the next tile's copy
    bar_sync(kBarDepth, kDepthThreads);
    const int next = tile + gridDim.x;
    Geo nxt = cur;
    if (j + 1 < mine) {
      nxt = tile_geo(next, a, TH);
      issue_cent(nxt);
    }
    if (cur.x0 + lane < a.OW) {
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int y = cur.y0 + warp + kDepthWarps * i;
        if (y < a.OH)
          a.out[(static_cast<long long>(cur.b) * a.OH + y) * a.OW + cur.x0 +
                lane] = dep[i];
      }
    }
    PF_PHASE(11);
    tile = next;
    cur = nxt;
  }
  PF_PHASES_FLUSH();
}

template <int TH>
__global__ void __launch_bounds__(kThreads, 1)
clb_depth_kernel(const Args a, const __grid_constant__ CUtensorMap last_map,
                 const __grid_constant__ CUtensorMap cond_map,
                 const __grid_constant__ CUtensorMap cent_map) {
  const MapPtrs maps{&last_map, &cond_map, &cent_map};
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((128 - (tc::smem_u32(smem_raw) & 127)) & 127);
  const Layout& l = a.ly;
  Smem sm;
  sm.w_hi = reinterpret_cast<bf16*>(base);
  sm.w_lo = reinterpret_cast<bf16*>(base + l.w_lo);
  sm.w2 = reinterpret_cast<bf16*>(base + l.w2);
  sm.b1 = reinterpret_cast<float*>(base + l.b1);
  sm.b2 = reinterpret_cast<float*>(base + l.b2);
  sm.c0 = reinterpret_cast<float*>(base + l.c0);
  sm.c0w = reinterpret_cast<float4*>(base + l.c0w);
  sm.last = reinterpret_cast<bf16*>(base + l.last);
  sm.cond = reinterpret_cast<bf16*>(base + l.cond);
  sm.proj = reinterpret_cast<float*>(base + l.proj);
  sm.pt = reinterpret_cast<float*>(base + l.pt);
  sm.cent = reinterpret_cast<bf16*>(base + l.cent);
  sm.lrow = reinterpret_cast<float2*>(base + l.lrow);
  sm.bar_cond = tc::smem_u32(base + l.bars);
  sm.bar_last = sm.bar_cond + 8;
  sm.bar_cent = sm.bar_cond + 16;
  if (threadIdx.x == 0) {
    mbar_init(sm.bar_cond);
    mbar_init(sm.bar_last);
    mbar_init(sm.bar_cent);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // ---- once per block: W1 (Cin + Cc, H) f32 -> (H, k) bf16 hi and lo,
  // the input rows padded to 48; W2 (H, 4) -> (8, H) bf16; b1, b2; the
  // c0 table and its (c0[k], c0[k + 1], k, k + 1) pairs
  for (int i = threadIdx.x; i < tc::kHid * tc::kKAll; i += kThreads) {
    const int n = i / tc::kKAll, k = i % tc::kKAll;
    float v = 0.f;
    if (k < tc::kCinPad) {
      if (k < a.Cin) v = a.w1[k * tc::kHid + n];
    } else {
      v = a.w1[(a.Cin + k - tc::kCinPad) * tc::kHid + n];
    }
    const bf16 hi = __float2bfloat16(v);
    sm.w_hi[n * tc::kWStride + k] = hi;
    sm.w_lo[n * tc::kWStride + k] = __float2bfloat16(v - __bfloat162float(hi));
  }
  for (int i = threadIdx.x; i < 8 * tc::kHid; i += kThreads) {
    const int n = i / tc::kHid, k = i % tc::kHid;
    sm.w2[n * tc::kW2Stride + k] =
        __float2bfloat16(n < 4 ? a.w2[k * 4 + n] : 0.f);
  }
  for (int i = threadIdx.x; i < tc::kHid; i += kThreads) sm.b1[i] = a.b1[i];
  if (threadIdx.x < 4) sm.b2[threadIdx.x] = a.b2[threadIdx.x];
  for (int k = threadIdx.x; k < a.K; k += kThreads) sm.c0[k] = a.c0[k];
  for (int q = threadIdx.x; 2 * q < a.K; q += kThreads) {
    const int k = 2 * q;
    sm.c0w[q] = make_float4(a.c0[k], k + 1 < a.K ? a.c0[k + 1] : 0.f,
                            static_cast<float>(k),
                            static_cast<float>(k + 1));
  }
  __syncthreads();
  if (threadIdx.x < kMlpThreads)
    mlp_warps<TH>(a, sm, maps);
  else
    depth_warps<TH>(a, sm, maps);
}

// ---------------------------------------------------------------------------
// the host side: the plan's checks, the tensor maps and the launch
// ---------------------------------------------------------------------------

// The align_corners source taps of output d (pf::align_corners_tap's float
// arithmetic on the host).
inline void host_tap(int d, int out, int in, int* i0, int* i1) {
  float src = 0.f;
  if (out > 1) {
    const float s = static_cast<float>(in - 1) / static_cast<float>(out - 1);
    volatile float prod = static_cast<float>(d) * s;  // one rounding
    src = prod;
  }
  src = std::fmin(std::fmax(src, 0.f), static_cast<float>(in - 1));
  *i0 = std::min(std::max(static_cast<int>(std::floor(src)), 0), in - 1);
  *i1 = std::min(*i0 + 1, in - 1);
}

// Whether the plan covers every tile of this shape (each tile's footprint
// rows within fy and columns within fx, as the device computes them from
// the same taps; staged rows of fx + 7 columns rounded up to 8, room for
// a box's shift) and its bytes are the layout's.
bool plan_ok(const Plan& p, int OH, int OW, int IH, int IW, int Cin, int K,
             const Layout& l) {
  if ((p.th != 8 && p.th != 4) || p.fy < 1 || p.fx < 1 ||
      p.ws != (p.fx + 14) / 8 * 8 || p.kc < 2 || (p.kc & 1) ||
      l.total != p.smem || p.smem > 227 * 1024)
    return false;
  for (int y0 = 0; y0 < OH; y0 += p.th) {
    int lo, hi, unused;
    host_tap(y0, OH, IH, &lo, &unused);
    host_tap(std::min(y0 + p.th, OH) - 1, OH, IH, &unused, &hi);
    if (hi - lo + 1 > p.fy) return false;
  }
  for (int x0 = 0; x0 < OW; x0 += kTW) {
    int lo, hi, unused;
    host_tap(x0, OW, IW, &lo, &unused);
    host_tap(std::min(x0 + kTW, OW) - 1, OW, IW, &unused, &hi);
    if (hi - lo + 1 > p.fx) return false;
  }
  return true;
}

// A tensor map over a (B, H, W, C) bf16 view whose pixels are contiguous
// per channel (a permuted NCHW tensor): dims (H W, C, B, 1), boxes of w
// pixels by C channels. Returns false where TMA cannot take the strides.
bool make_map(CUtensorMap* map, const void* ptr, int B, int H, int W, int C,
              const pf::Strides4& s, int w) {
  if (s.x != 1 || s.y != W || reinterpret_cast<uintptr_t>(ptr) % 16 ||
      (2 * s.c) % 16 || (2 * s.b) % 16 || C > 256 || w > 256)
    return false;
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(H) * W,
                        static_cast<cuuint64_t>(C),
                        static_cast<cuuint64_t>(B), 1};
  cuuint64_t strides[3] = {static_cast<cuuint64_t>(s.c) * 2,
                           static_cast<cuuint64_t>(s.b) * 2,
                           static_cast<cuuint64_t>(s.b) * 2 * B};
  cuuint32_t box[4] = {static_cast<cuuint32_t>(w),
                       static_cast<cuuint32_t>(C), 1, 1};
  cuuint32_t elem[4] = {1, 1, 1, 1};
  return cuTensorMapEncodeTiled(
             map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
             const_cast<void*>(ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int TH>
cudaError_t launch_tiled(const Args& a, const Maps& maps, int device,
                         cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      clb_depth_kernel<TH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      a.pl.smem);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int blocks = std::min(a.tiles, sms);
  clb_depth_kernel<TH><<<blocks, kThreads, a.pl.smem, stream>>>(
      a, maps.last, maps.cond, maps.cent);
  return cudaGetLastError();
}

cudaError_t launch_bf16(Args& a, int B, int device, cudaStream_t stream) {
  if (a.Cin < 1 || a.Cin > tc::kCinPad || a.K < 1 || a.K > 128 ||
      a.IH > a.OH || a.IW > a.OW)
    return cudaErrorInvalidValue;
  a.ly = layout(a.pl, a.Cin, a.K);
  if (!plan_ok(a.pl, a.OH, a.OW, a.IH, a.IW, a.Cin, a.K, a.ly))
    return cudaErrorInvalidValue;
  Maps maps;
  memset(&maps, 0, sizeof(maps));
  if (((a.pl.tma & kTmaCond) &&
       !make_map(&maps.cond, a.cond, B, a.IH, a.IW, tc::kCc, a.cs,
                 a.pl.ws)) ||
      ((a.pl.tma & kTmaCent) &&
       !make_map(&maps.cent, a.cent, B, a.IH, a.IW, a.K, a.zs, a.pl.ws)) ||
      ((a.pl.tma & kTmaLast) &&
       !make_map(&maps.last, a.last, B, a.OH, a.OW, a.Cin, a.ls, kLW)))
    return cudaErrorInvalidValue;
  a.tiles_x = (a.OW + kTW - 1) / kTW;
  a.tiles_y = (a.OH + a.pl.th - 1) / a.pl.th;
  const long long tiles = static_cast<long long>(B) * a.tiles_x * a.tiles_y;
  if (tiles == 0) return cudaSuccess;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  a.tiles = static_cast<int>(tiles);
  return a.pl.th == 8 ? launch_tiled<8>(a, maps, device, stream)
                      : launch_tiled<4>(a, maps, device, stream);
}

}  // namespace

// Shared memory, in bytes, of the bf16 kernel's layout for this plan (the
// plan's ints in Plan's order), Cin input channels and K bins: the
// wrapper's reckoning is checked against it.
extern "C" int pf_clb_depth_smem(const int* plan, int Cin, int K) {
  Plan p;
  memcpy(&p, plan, sizeof(Plan));
  return layout(p, Cin, K).total;
}

// C entry point. last_cat (B, OH, OW, Cin), cond_lo (B, IH, IW, Cc) and
// centers (B, IH, IW, K) are device tensors of one dtype, float32
// (inputs_bf16 = 0) or bfloat16 (= 1), with the given element strides;
// w1 (Cin+Cc, hidden), b1 (hidden,), w2 (hidden, 4) and b2 (4,) are
// contiguous float32; c0 is the K-entry log-binomial table in float32;
// out is contiguous (B, OH, OW) float32. bfloat16 takes the wrapper's plan
// (Plan's ints, checked here: a plan that does not cover the shape, or TMA
// where the strides do not allow it, returns cudaErrorInvalidValue), Cin
// <= 48, Cc = 128, K <= 128 and an upsample. Returns the cudaError_t of
// the launch.
extern "C" int pf_clb_logbinomial_depth(
    const void* last, const void* cond, const void* centers, const void* w1,
    const void* b1, const void* w2, const void* b2, const void* c0,
    void* out, int inputs_bf16, const int* plan, int B, int OH, int OW,
    int IH, int IW, int Cin, int Cc, int K, int hidden, long long lb,
    long long ly, long long lx, long long lc, long long cb, long long cy,
    long long cx, long long cc, long long zb, long long zy, long long zx,
    long long zc, float p_eps, float min_temp, float max_temp, int device,
    void* stream) {
  if (hidden != pf::kClbHidden) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const pf::Strides4 ls{lb, ly, lx, lc};
  const pf::Strides4 cs{cb, cy, cx, cc};
  const pf::Strides4 zs{zb, zy, zx, zc};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (inputs_bf16) {
    if (Cc != tc::kCc) return static_cast<int>(cudaErrorInvalidValue);
    Args a{};
    a.last = static_cast<const bf16*>(last);
    a.cond = static_cast<const bf16*>(cond);
    a.cent = static_cast<const bf16*>(centers);
    a.w1 = static_cast<const float*>(w1);
    a.b1 = static_cast<const float*>(b1);
    a.w2 = static_cast<const float*>(w2);
    a.b2 = static_cast<const float*>(b2);
    a.c0 = static_cast<const float*>(c0);
    a.out = static_cast<float*>(out);
    a.OH = OH;
    a.OW = OW;
    a.IH = IH;
    a.IW = IW;
    a.Cin = Cin;
    a.K = K;
    a.ls = ls;
    a.cs = cs;
    a.zs = zs;
    a.p_eps = p_eps;
    a.min_temp = min_temp;
    a.max_temp = max_temp;
    memcpy(&a.pl, plan, sizeof(Plan));
    err = launch_bf16(a, B, device, s);
  } else {
    err = launch_f32(last, cond, centers, w1, b1, w2, b2, out, B, OH, OW, IH,
                     IW, Cin, Cc, K, ls, cs, zs, p_eps, min_temp, max_temp,
                     device, s);
  }
  return static_cast<int>(err);
}

#ifdef PF_PHASE_TIMING
// The timing build's per-phase cycle sums (over warps) since the last
// reset, and the phases' names ("role: phase"; the roles' warps per block
// are pf_clb_depth_role_warps), in g_phase_cycles' order.
extern "C" int pf_clb_depth_phases(unsigned long long* out, int n,
                                   int reset) {
  if (n > kPhases) n = kPhases;
  cudaError_t err = cudaMemcpyFromSymbol(out, g_phase_cycles,
                                         n * sizeof(unsigned long long));
  if (err == cudaSuccess && reset) {
    const unsigned long long zero[kPhases] = {};
    err = cudaMemcpyToSymbol(g_phase_cycles, zero, sizeof(zero));
  }
  return static_cast<int>(err);
}
extern "C" const char* pf_clb_depth_phase_names() {
  return "mlp: wait for the condition,mlp: projection,"
         "mlp: barrier + issue cond + wait for last_cat,mlp: input term,"
         "mlp: barrier + issue last_cat,mlp: lerp GELU W2 softplus,"
         "mlp: hand p t to the depth warps,depth: wait for the centers,"
         "depth: wait for p t,depth: setup + H lerp,depth: softmax sums,"
         "depth: barrier + issue centers + store,mlp: loop";
}
extern "C" int pf_clb_depth_role_warps(int depth) {
  return depth ? kDepthWarps : kMlpWarps;
}
#endif
