// Self-attention over bf16 ViT tokens, for sm_90a.
//
// Replaces: patchfusion_tpu/ops/pallas_attention.py::vit_attention
// (Pallas kernel _attn_kernel), ::vit_attention_blocked
// (_attn_kernel_blocked) and ::vit_attention_mxsum (_attn_kernel_mxsum).
// The three compute the same function and differ only in TPU tricks; on
// the card they are one kernel:
//   whole (Npad, Npad) score block in VMEM  -> K/V streamed in 128-key tiles
//   pad correction of the normaliser,
//   -1e30 bias row                          -> the ragged last K tile masked
//   block_rows                              -> the 192- or 128-row query tile
//   ones column of v_ext                    -> the same: a box of ones
//                                              beside each V tile
// Per (b, h): o = softmax(q k^T * Dh^-0.5) v with the JAX bf16 contract:
//   * q * scale rounded to bf16 (scale itself given in bf16, as JAX casts
//     the Python float to the array's dtype);
//   * q.k logits accumulate in f32 (wgmma, f32 accumulators);
//   * RL (round_logits): the logits are rounded to bf16 off the accumulator
//     (_attn_kernel's bf16 N^2 stage and the JAX einsum path,
//     models/dinov2.py:90-93);
//   * RD (round_diff): s - m is rounded to bf16 before exp (_attn_kernel,
//     and _attn_kernel_mxsum with bf16_exp, whose logits stay f32);
//   * the probabilities are rounded to bf16 for the P.V product, which
//     accumulates in f32, and the f32 normaliser is the sum of the
//     bf16-rounded probabilities (_attn_kernel_mxsum's MXU row sum);
//   * o = (P.V) / l, rounded to bf16 once.
// An online softmax keeps a running max and sum per row, so it equals the
// whole-row softmax up to where the bf16 rounding of P falls (each P is
// rounded relative to the running max of its tile and rescaled in f32).
//
// What bounds it on the H100: at the vitl fine shape (B = 4, H = 16,
// N = 1037, Dh = 64) it reads q, k, v and writes o, 34 MB, and does
// 4 B H N^2 Dh = 17.6 GFLOP: ~18 us at the bf16 tensor-core peak against
// ~10 us of HBM traffic, so its bound is the tensor cores'. What limits
// this kernel is the softmax beside them: per score one MUFU exp and half
// an f32 -> bf16 conversion (the pack of P), which share MUFU's 16 lanes
// per clock per SM (~12 us for the 69 M scores alone), and the bf16
// roundings of the contract, ~9 instructions per score on the other pipes.
//
// Design (the FlashAttention-3 shape, sized for a short ViT sequence):
//   * persistent blocks, one per SM, walk the (b, h, query tile) items.
//     A block is three consumer warpgroups of 64 query rows each (wgmma's
//     M), 192 rows, for Dh up to 64, or two for wider heads (the wider
//     accumulators need the registers), and one producer warpgroup that
//     gives its registers to the consumers (setmaxnreg). Its first thread
//     issues the TMA loads: Q once per item, each 128-key K and V tile into
//     two-stage rings that run on across items, so the next item's loads
//     overlap this item's last tiles; K and V have rings of their own, with
//     full and empty mbarriers, because they are consumed at different
//     times. 192-row tiles make 384 items at B = 4 (2.9 per SM) and 96 at
//     B = 1 (one partial wave, which measured faster than two waves of
//     64-row tiles).
//   * S = Q K^T is a wgmma with both operands in shared memory (K-major,
//     128-byte swizzle, as TMA lays them down). P stays in registers as
//     the A operand of the P.V wgmma; V is its B operand as it lies,
//     (keys, Dh) row-major, read through wgmma's transpose flag, with a box
//     of ones beside it whose output column is the row sum of P.
//   * overlap: each warpgroup issues the next tile's S product together
//     with the previous tile's P.V product, then runs the softmax of the
//     new S while its own P.V runs; three warpgroups per SM keep MUFU and
//     the tensor cores busy between them. (A ping-pong of two warpgroups
//     on named barriers measured no faster here: the softmax, not the
//     products, is the longer phase.)
//   * the softmax spends one MUFU op per score and rounds on the other
//     pipes: the logits with two integer and two f32 operations, s - m as
//     one bf16x2 subtraction per key pair, the max on bf16x2 pairs; the
//     output is rescaled only when some row's max moved.
//   * TMA reads q, k and v through their strides from the qkv linear's
//     output (views qkv[:, :, i] of a (B, N, 3, H, Dh) tensor), one 4-D
//     tensor map per operand, innermost first (Dh, H, N, B). Rows past N
//     come in as zeros and their scores are masked to -inf.
//   * head widths: a tile row is 64 bf16 (128 bytes, one swizzle span); Dh
//     up to 64 is one such box, Dh up to 128 two boxes side by side. TMA
//     fills the columns past Dh with zeros, which add nothing to Q K^T and
//     give output columns that are not stored, so every multiple of 16 up
//     to 128 runs on the two widths 64 and 128.
//   * Q scaling: a power-of-two scale (Dh = 16, 64) is exact in bf16 and
//     commutes with every rounding, so it is folded into exp's multiplier;
//     otherwise each consumer warpgroup scales its Q rows in place in
//     shared memory (elementwise, so the swizzle does not matter) and
//     fences them to the async proxy that wgmma reads through.
//   * o is written contiguous (B, N, H, Dh) from the accumulators, so the
//     caller's reshape to (B, N, H*Dh) is free.

#include <cuda.h>

#include <cmath>

#include "common.cuh"

namespace {

constexpr int kBN = 128;    // keys per K/V tile
constexpr int kStages = 2;  // K and V ring depth
constexpr int kRow = 128;   // bytes per smem tile row: 64 bf16, one swizzle

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Two floats as one bf16x2 register, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// --- mbarriers, named barriers, TMA --------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
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

__device__ __forceinline__ void bar_sync(uint32_t id, uint32_t threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// One box of a 4-D tensor map into shared memory; completes on bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// --- wgmma ----------------------------------------------------------------

// Shared-memory matrix descriptor of a 128-byte-swizzled operand; addr is
// a shared address inside a 1024-byte aligned swizzle atom group.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of wgmma operands across
// the asynchronous product's issue and wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// d (64 x 128 f32) {=, +=} A (64 x 16, smem) . B (128 x 16, smem)^T, both
// K-major; scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 72 f32) += A (64 x 16 bf16, registers) . B (16 x 72, smem,
// MN-major: the transpose flag reads it as it lies, rows of 72 values).
__device__ __forceinline__ void wgmma_rs_n72(float (&d)[36],
                                              uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %41, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35}, "
      "{%36, %37, %38, %39}, %40, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+r"(a[0]), "+r"(a[1]), "+r"(a[2]), "+r"(a[3])
      : "l"(db), "r"(1));
}

// d (64 x 136 f32) += A (64 x 16 bf16, registers) . B (16 x 136, smem,
// MN-major: the transpose flag reads it as it lies, rows of 136 values).
__device__ __forceinline__ void wgmma_rs_n136(float (&d)[68],
                                              uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %73, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n136k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67}, "
      "{%68, %69, %70, %71}, %72, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+r"(a[0]), "+r"(a[1]), "+r"(a[2]), "+r"(a[3])
      : "l"(db), "r"(1));
}

// The P.V product over kDC 64-column boxes of V and one more box whose
// first column is all ones: its accumulator column 64 kDC is the row sum
// of P, the normaliser, summed in f32 by the tensor cores (the TPU
// kernel's ones column of v_ext).
template <int kDC>
__device__ __forceinline__ void wgmma_pv(float (&d)[32 * kDC + 4],
                                         uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void wgmma_pv<1>(float (&d)[36], uint32_t (&a)[4],
                                            uint64_t db) {
  wgmma_rs_n72(d, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<2>(float (&d)[68], uint32_t (&a)[4],
                                            uint64_t db) {
  wgmma_rs_n136(d, a, db);
}

// --- the online softmax of one 64 x 128 score tile ------------------------
//
// The N^2 work is bound by the SM's narrow pipes, not by the FMA pipes:
// MUFU (exp) and the f32 -> bf16 conversions share 16 lanes per clock per
// SM, the integer pipe has 64. So the kernel spends one MUFU op per score
// and half a conversion (the bf16x2 pack of P, which is the P.V product's
// A fragment), and rounds the logits and s - m to bf16 with two integer and
// two f32 operations each.

// 2^(x mul) as MUFU's ex2 with flush to zero: one multiply and one MUFU op
// (__expf adds three to keep results below 2^-126, which no probability
// that matters reaches). mul is log2(e), times the softmax scale where the
// kernel folds that in here.
__device__ __forceinline__ float exp2_ftz(float x, float mul) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * mul));
  return y;
}

// x rounded to the nearest bf16, ties to even, as a float. c = 1.5 *
// 2^(e + 16) for x's binade e puts x + c in a binade whose f32 ulp is
// 2^(e - 7), bf16's ulp at x, and c is an even multiple of it, so the
// f32 addition's round-to-nearest-even is bf16's; subtracting c is exact.
// Holds for 0 and -inf (c is then tiny) and for |x| < 2^100.
__device__ __forceinline__ float bf16_round_fast(float x) {
  const float c =
      __uint_as_float((__float_as_uint(x) & 0x7f800000u) + 0x08400000u);
  return __fsub_rn(__fadd_rn(x, c), c);
}

// s: this thread's scores (accumulator layout: element i is row g + 8 *
// ((i >> 1) & 1) of the warp's 16, key 8 * (i >> 2) + 2 t + (i & 1)); with
// kMask, keys at or past n_valid are masked. Leaves exp(s - m) in s (still
// f32: pack_p rounds it once the P.V product before it is done with the
// A fragments), updates the running max m and returns in a the factors
// that rescale the output and its row sums.
// The row max over this thread's four partial maxima, then over the four
// threads of the row group, which hold the row's columns; every tile holds
// a valid key, so the new max is finite, and the first tile's factor is
// exp(-inf) = 0.
__device__ __forceinline__ void update_max(float (&mx4)[2][4], float (&m)[2],
                                           float (&a)[2], float exp_mul) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = fmaxf(fmaxf(mx4[r][0], mx4[r][1]), fmaxf(mx4[r][2], mx4[r][3]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float mn = fmaxf(m[r], mx);
    a[r] = exp2_ftz(m[r] - mn, exp_mul);
    m[r] = mn;
  }
}

template <bool RL, bool RD, bool kMask>
__device__ __forceinline__ void softmax_tile(float (&s)[64], float (&m)[2],
                                             float (&a)[2], int t,
                                             int n_valid, float exp_mul) {
  const float neg_inf = __int_as_float(0xff800000);
  auto masked = [&](int i) {
    return kMask && 8 * (i >> 2) + 2 * t + (i & 1) >= n_valid;
  };
  // four partial maxima per row, so the reduction is not one long chain
  float mx4[2][4];
  if constexpr (RL && RD) {
    // bf16 logits, packed in pairs: the max and s - m run on bf16x2, and
    // the subtraction rounds the exact difference once
    uint32_t s2[32];
    __nv_bfloat162 mx2[2][2];
#pragma unroll
    for (int r = 0; r < 2; ++r)
      mx2[r][0] = mx2[r][1] = __float2bfloat162_rn(neg_inf);
#pragma unroll
    for (int i = 0; i < 64; i += 2) {  // keys i, i + 1 of row (i >> 1) & 1
      float x0 = bf16_round_fast(s[i]), x1 = bf16_round_fast(s[i + 1]);
      if (masked(i)) x0 = neg_inf;
      if (masked(i + 1)) x1 = neg_inf;
      s2[i >> 1] = __byte_perm(__float_as_uint(x0), __float_as_uint(x1),
                               0x7632);
      __nv_bfloat162& mq = mx2[(i >> 1) & 1][(i >> 3) & 1];
      mq = __hmax2(mq, *reinterpret_cast<const __nv_bfloat162*>(&s2[i >> 1]));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const uint32_t u = *reinterpret_cast<const uint32_t*>(&mx2[r][q]);
        mx4[r][2 * q] = __uint_as_float(u << 16);
        mx4[r][2 * q + 1] = __uint_as_float(u & 0xffff0000u);
      }
    update_max(mx4, m, a, exp_mul);
    __nv_bfloat162 m2[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) m2[r] = __float2bfloat162_rn(m[r]);
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const __nv_bfloat162 d2 = __hsub2(
          *reinterpret_cast<const __nv_bfloat162*>(&s2[i >> 1]),
          m2[(i >> 1) & 1]);
      const uint32_t d = *reinterpret_cast<const uint32_t*>(&d2);
      s[i] = exp2_ftz(__uint_as_float(d << 16), exp_mul);
      s[i + 1] = exp2_ftz(__uint_as_float(d & 0xffff0000u), exp_mul);
    }
  } else {
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) mx4[r][q] = neg_inf;
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      float x = RL ? bf16_round_fast(s[i]) : s[i];
      if (masked(i)) x = neg_inf;
      s[i] = x;
      float& mq = mx4[(i >> 1) & 1][(i >> 2) & 3];
      mq = fmaxf(mq, x);
    }
    update_max(mx4, m, a, exp_mul);
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      float d = s[i] - m[(i >> 1) & 1];
      if (RD) d = bf16_round_fast(d);
      s[i] = exp2_ftz(d, exp_mul);
    }
  }
}

template <bool RL, bool RD>
__device__ __forceinline__ void softmax_any(float (&s)[64], float (&m)[2],
                                            float (&a)[2], int t, int n_valid,
                                            float exp_mul) {
  if (n_valid < kBN)  // only the last tile is ragged
    softmax_tile<RL, RD, true>(s, m, a, t, n_valid, exp_mul);
  else
    softmax_tile<RL, RD, false>(s, m, a, t, n_valid, exp_mul);
}

// P = bf16(p) as the A fragments of the P.V product: the accumulators of
// keys 16 ks .. 16 ks + 15 are the A fragment of k-step ks, element for
// element, and one bf16x2 conversion rounds and packs two of them.
__device__ __forceinline__ void pack_p(uint32_t (&pa)[8][4],
                                       const float (&s)[64]) {
#pragma unroll
  for (int ks = 0; ks < 8; ++ks)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      pa[ks][e] = pack_bf16x2(s[8 * ks + 2 * e], s[8 * ks + 2 * e + 1]);
}

// o and the row sums times a; skipped, warp-uniformly, where no row's max
// moved (a = 1 exactly), which after the first tiles is the common case.
template <int kDC>
__device__ __forceinline__ void rescale(float (&o)[32 * kDC + 4],
                                        const float (&a)[2]) {
  if (!__any_sync(0xffffffffu, a[0] != 1.f || a[1] != 1.f)) return;
#pragma unroll
  for (int i = 0; i < 32 * kDC + 4; ++i) o[i] *= a[(i >> 1) & 1];
}

// --- the kernel -------------------------------------------------------------

// Shared memory: Q (kM rows), then kStages K tiles, then kStages V tiles,
// each stored as kDC boxes of (rows, 64 bf16), 128-byte swizzled; each V
// tile is followed by its box of ones (see wgmma_pv).
template <int kWG, int kDC>
__host__ __device__ constexpr uint32_t q_bytes() {
  return 64 * kWG * kRow * kDC;
}
template <int kDC>
__host__ __device__ constexpr uint32_t tile_bytes() { return kBN * kRow * kDC; }
template <int kWG, int kDC>
__host__ __device__ constexpr size_t smem_bytes() {
  return q_bytes<kWG, kDC>() + kStages * (2 * kDC + 1) * kBN * kRow + 1024;
}

// Registers per thread after setmaxnreg: the block is launched with the
// launch bound's share of the SM's 64 K (128 with three consumer
// warpgroups, 168 with two); the producer warpgroup drops to 24 and gives
// the rest to the consumers' accumulators.
template <int kWG>
struct RegSplit {
  static constexpr int kProducer = 24;
  static constexpr int kConsumer = kWG == 3 ? 160 : 240;
};

template <int kWG, int kDC, bool RL, bool RD>
__global__ void __launch_bounds__((kWG + 1) * 128, 1)
vit_attention_kernel(const __grid_constant__ CUtensorMap qm,
                     const __grid_constant__ CUtensorMap km,
                     const __grid_constant__ CUtensorMap vm,
                     __nv_bfloat16* __restrict__ o, int N, int H, int Dh,
                     int n_qtiles, int n_items, float scale, int scale_q,
                     float exp_mul) {
  constexpr int kM = 64 * kWG;
  constexpr uint32_t kQBytes = q_bytes<kWG, kDC>();
  constexpr uint32_t kTile = tile_bytes<kDC>();
  constexpr uint32_t kVTile = kTile + kBN * kRow;  // V and its ones box
  extern __shared__ uint8_t smem_raw[];
  // Q full and empty; K full, K empty, V full, V empty per stage
  __shared__ __align__(8) uint64_t bars[2 + 4 * kStages];

  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sQ = (raw + 1023) & ~1023u;  // swizzle atoms: 1024-aligned
  const uint32_t sK = sQ + kQBytes;
  const uint32_t sV = sK + kStages * kTile;
  uint8_t* q_gen = smem_raw + (sQ - raw);
  auto bar = [&](int i) { return smem_u32(&bars[i]); };
  const uint32_t q_full = bar(0), q_empty = bar(1);
  auto k_full = [&](int s) { return bar(2 + s); };
  auto k_empty = [&](int s) { return bar(2 + kStages + s); };
  auto v_full = [&](int s) { return bar(2 + 2 * kStages + s); };
  auto v_empty = [&](int s) { return bar(2 + 3 * kStages + s); };

  const int nt = (N + kBN - 1) / kBN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 4 * kWG);  // one arrival per consumer warp
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), 4 * kWG);
      mbar_init(v_empty(s), 4 * kWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * kWG) {
    // ---- producer warpgroup: its first warp's lane 0 loads, per work item,
    // Q and then K_j and V_j into the rings, which run on across items; the
    // warpgroup gives its registers to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        RegSplit<kWG>::kProducer));
    if (warp == 4 * kWG && lane == 0) {
      int g = 0;  // K/V tiles loaded so far
      for (int item = blockIdx.x, it = 0; item < n_items;
           item += gridDim.x, ++it) {
        const int bh = item / n_qtiles, q0 = (item % n_qtiles) * kM;
        const int b = bh / H, h = bh % H;
        mbar_wait(q_empty, (it & 1) ^ 1);
        mbar_expect_tx(q_full, kQBytes);
        for (int c = 0; c < kDC; ++c)
          tma_load(sQ + c * kM * kRow, &qm, q_full, 64 * c, h, q0, b);
        for (int j = 0; j < nt; ++j, ++g) {
          const int s = g % kStages;
          const uint32_t free_parity = ((g / kStages) & 1) ^ 1;
          mbar_wait(k_empty(s), free_parity);
          mbar_expect_tx(k_full(s), kTile);
          for (int c = 0; c < kDC; ++c)
            tma_load(sK + s * kTile + c * kBN * kRow, &km, k_full(s), 64 * c,
                     h, j * kBN, b);
          mbar_wait(v_empty(s), free_parity);
          mbar_expect_tx(v_full(s), kTile);
          for (int c = 0; c < kDC; ++c)
            tma_load(sV + s * kVTile + c * kBN * kRow, &vm, v_full(s), 64 * c,
                     h, j * kBN, b);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroup wg: query rows q0 + 64 wg .. + 63 of each item
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      RegSplit<kWG>::kConsumer));
  const int wg = warp >> 2;
  const int wtid = threadIdx.x & 127;
  const int g = lane >> 2, t = lane & 3;  // accumulator row group, column

  // the ones boxes: every 16-byte chunk (1, 0, ..., 0), so column 0 of the
  // box is 1 and the rest 0 under any swizzle
  for (int i = threadIdx.x; i < kStages * kBN * kRow / 16; i += 128 * kWG) {
    const int st = i / (kBN * kRow / 16), r = i % (kBN * kRow / 16);
    reinterpret_cast<uint4*>(q_gen + (sV - sQ) + st * kVTile + kTile)[r] =
        make_uint4(0x3f80u, 0u, 0u, 0u);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  bar_sync(1, 128 * kWG);

  // operand descriptors: Q and K K-major (k-step kk: box kk / 4, 32-byte
  // column kk % 4 of the swizzled row), V MN-major (k-step ks: 16 keys
  // further; its 64-column boxes kBN rows apart)
  const uint32_t q_base = sQ + wg * 64 * kRow;
  auto desc_q = [&](int kk) {
    return sw128_desc(q_base + (kk >> 2) * kM * kRow + (kk & 3) * 32, 16,
                      1024);
  };
  auto desc_k = [&](int s, int kk) {
    return sw128_desc(sK + s * kTile + (kk >> 2) * kBN * kRow + (kk & 3) * 32,
                      16, 1024);
  };
  auto desc_v = [&](int s, int ks) {
    return sw128_desc(sV + s * kVTile + ks * 16 * kRow, kBN * kRow, 1024);
  };

  float sacc[64];
  float oacc[32 * kDC + 4];  // o, then the row sums in column 64 kDC
  uint32_t pa[8][4];
  float m[2], a[2];

  auto issue_s = [&](int s) {
#pragma unroll
    for (int kk = 0; kk < 4 * kDC; ++kk)
      wgmma_ss_n128(sacc, desc_q(kk), desc_k(s, kk), kk > 0);
    wgmma_commit();
  };
  auto issue_pv = [&](int s) {
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) wgmma_pv<kDC>(oacc, pa[ks], desc_v(s, ks));
    wgmma_commit();
  };
  auto release = [&](uint32_t empty_bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_bar);
  };

  int gt = 0;  // K/V tiles consumed so far
  for (int item = blockIdx.x, it = 0; item < n_items;
       item += gridDim.x, ++it) {
    const int bh = item / n_qtiles, q0 = (item % n_qtiles) * kM;
    const int b = bh / H, h = bh % H;
    mbar_wait(q_full, it & 1);
    if (scale_q) {
      // Q * scale, rounded to bf16, in place (a power-of-two scale is
      // exact and rides on exp_mul instead)
      for (int c = 0; c < kDC; ++c) {
        uint4* rows = reinterpret_cast<uint4*>(q_gen + c * kM * kRow +
                                               wg * 64 * kRow);
        for (int i = wtid; i < 64 * kRow / 16; i += 128) {
          uint4 v = rows[i];
          uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&w[e]));
            w[e] = pack_bf16x2(f.x * scale, f.y * scale);
          }
          rows[i] = v;
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bar_sync(2 + wg, 128);
    }
    m[0] = m[1] = __int_as_float(0xff800000);
#pragma unroll
    for (int i = 0; i < 32 * kDC + 4; ++i) oacc[i] = 0.f;

    // tile 0: S only
    mbar_wait(k_full(gt % kStages), (gt / kStages) & 1);
    fence_regs(sacc);
    wgmma_fence();
    issue_s(gt % kStages);
    wgmma_wait<0>();
    fence_regs(sacc);
    release(k_empty(gt % kStages));
    if (nt == 1) release(q_empty);
    softmax_any<RL, RD>(sacc, m, a, t, min(N, kBN), exp_mul);
    pack_p(pa, sacc);

    // tile j: S_j and P_{j-1} V_{j-1} issued together, then the softmax of
    // S_j under the P.V product; P_j is packed once that product is done
    for (int j = 1; j < nt; ++j) {
      const int gj = gt + j;
      const int s = gj % kStages, sp = (gj - 1) % kStages;
      rescale<kDC>(oacc, a);
      mbar_wait(k_full(s), (gj / kStages) & 1);
      mbar_wait(v_full(sp), ((gj - 1) / kStages) & 1);
      fence_regs(sacc);
      fence_regs(oacc);
      fence_regs(pa);
      wgmma_fence();
      issue_s(s);
      issue_pv(sp);
      wgmma_wait<1>();
      fence_regs(sacc);
      release(k_empty(s));
      if (j == nt - 1) release(q_empty);  // the item's last Q K^T is done
      softmax_any<RL, RD>(sacc, m, a, t, min(N - j * kBN, kBN), exp_mul);
      wgmma_wait<0>();
      fence_regs(oacc);
      fence_regs(pa);
      release(v_empty(sp));
      pack_p(pa, sacc);
    }

    // the last tile's P.V
    {
      const int gl = gt + nt - 1;
      const int sp = gl % kStages;
      rescale<kDC>(oacc, a);
      mbar_wait(v_full(sp), (gl / kStages) & 1);
      fence_regs(oacc);
      fence_regs(pa);
      wgmma_fence();
      issue_pv(sp);
      wgmma_wait<0>();
      fence_regs(oacc);
      release(v_empty(sp));
    }
    gt += nt;

    // the row sums sit in column 64 kDC, held by the row group's t = 0
    float l[2];
#pragma unroll
    for (int r = 0; r < 2; ++r)
      l[r] = 1.f / __shfl_sync(0xffffffffu, oacc[32 * kDC + 2 * r], lane & ~3);

    // o[b, n, h, :] at ((b N + n) H + h) Dh
    const int row0 = q0 + wg * 64 + (wtid >> 5) * 16 + g;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= N) continue;
      __nv_bfloat16* orow =
          o + ((static_cast<long long>(b) * N + row) * H + h) * Dh + 2 * t;
#pragma unroll
      for (int c = 0; c < 8 * kDC; ++c) {  // 8-column blocks of o
        if (8 * c + 2 * t < Dh)
          *reinterpret_cast<uint32_t*>(orow + 8 * c) =
              pack_bf16x2(oacc[4 * c + 2 * r] * l[r],
                          oacc[4 * c + 2 * r + 1] * l[r]);
      }
    }
  }
}

// A tiled map over one (B, N, H, Dh) operand with the given element
// strides: dims innermost first (Dh, H, N, B), boxes of (64, 1, rows, 1).
CUresult make_map(CUtensorMap* map, const void* ptr, int B, int N, int H,
                  int Dh, long long sb, long long sn, long long sh,
                  int rows) {
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(Dh),
                        static_cast<cuuint64_t>(H),
                        static_cast<cuuint64_t>(N),
                        static_cast<cuuint64_t>(B)};
  cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2,
                           static_cast<cuuint64_t>(sn) * 2,
                           static_cast<cuuint64_t>(sb) * 2};
  cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  cuuint32_t elem[4] = {1, 1, 1, 1};
  return cuTensorMapEncodeTiled(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

struct Args {
  const void *q, *k, *v;
  void* o;
  int B, N, H, Dh, device;
  long long qs[3], ks[3], vs[3];  // (b, n, h) element strides
  float scale;
};

// An error of the tensor-map encoder, told apart from cudaError_t codes.
constexpr int kMapError = 100000;

template <int kWG, int kDC, bool RL, bool RD>
int launch(const Args& x, cudaStream_t stream) {
  constexpr int kM = 64 * kWG;
  CUtensorMap qm, km, vm;
  CUresult r = make_map(&qm, x.q, x.B, x.N, x.H, x.Dh, x.qs[0], x.qs[1],
                        x.qs[2], kM);
  if (r == CUDA_SUCCESS)
    r = make_map(&km, x.k, x.B, x.N, x.H, x.Dh, x.ks[0], x.ks[1], x.ks[2],
                 kBN);
  if (r == CUDA_SUCCESS)
    r = make_map(&vm, x.v, x.B, x.N, x.H, x.Dh, x.vs[0], x.vs[1], x.vs[2],
                 kBN);
  if (r != CUDA_SUCCESS) return kMapError + static_cast<int>(r);
  auto kernel = vit_attention_kernel<kWG, kDC, RL, RD>;
  constexpr size_t smem = smem_bytes<kWG, kDC>();
  // per device, once: the shared-memory opt-in and the SM count
  static int sms_of[64] = {};
  if (x.device < 0 || x.device >= 64)
    return static_cast<int>(cudaErrorInvalidDevice);
  int& sms = sms_of[x.device];
  cudaError_t err = cudaSuccess;
  if (sms == 0) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    int n = 0;
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, x.device);
    if (err != cudaSuccess) return static_cast<int>(err);
    sms = n;
  }
  const int n_qtiles = (x.N + kM - 1) / kM;
  const long long items = static_cast<long long>(x.B) * x.H * n_qtiles;
  if (items > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  // persistent: one block per SM walks the (b, h, query tile) items
  const int blocks = static_cast<int>(items < sms ? items : sms);
  // a power-of-two scale (Dh = 16, 64) leaves q * scale exact in bf16 and
  // commutes with every rounding, so the kernel folds it into exp's
  // multiplier instead of a pass over Q
  int e2 = 0;
  const bool pow2 = std::frexp(x.scale, &e2) == 0.5f;
  const float log2e = 1.4426950408889634f;
  kernel<<<blocks, (kWG + 1) * 128, smem, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(x.o), x.N, x.H, x.Dh, n_qtiles,
      static_cast<int>(items), x.scale, pow2 ? 0 : 1,
      pow2 ? log2e * x.scale : log2e);
  return static_cast<int>(cudaGetLastError());
}

template <int kWG, int kDC>
int launch_rounding(const Args& x, int round_logits, int round_diff,
                    cudaStream_t s) {
  if (round_logits && round_diff) return launch<kWG, kDC, true, true>(x, s);
  if (!round_logits && !round_diff)
    return launch<kWG, kDC, false, false>(x, s);
  if (!round_logits && round_diff) return launch<kWG, kDC, false, true>(x, s);
  // bf16 logits with an f32 s - m is no TPU kernel's rounding
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// C entry point. q, k and v are (B, N, H, Dh) bfloat16 device tensors with
// element strides (b, n, h) as given and a contiguous last dimension, every
// stride a multiple of 8 elements and the start 16-byte aligned; o is a
// contiguous (B, N, H, Dh) bfloat16 tensor. Dh is a multiple of 16 up to
// 128. scale is Dh^-0.5 rounded to bf16. round_logits and round_diff
// select the rounding (see the note at the top); round_logits without
// round_diff is refused. Returns the cudaError_t of the launch, or 100000
// plus the CUresult of a tensor map the driver refused.
extern "C" int pf_vit_attention(const void* q, const void* k, const void* v,
                                void* o, int B, int N, int H, int Dh,
                                long long qb, long long qn, long long qh,
                                long long kb, long long kn, long long kh,
                                long long vb, long long vn, long long vh,
                                float scale, int round_logits, int round_diff,
                                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (Dh <= 0 || Dh > 128 || Dh % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || N == 0 || H == 0) return 0;
  const Args x{q, k, v, o, B, N, H, Dh, device, {qb, qn, qh}, {kb, kn, kh},
               {vb, vn, vh}, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 192-row query tiles (three consumer warpgroups) up to Dh = 64, 128-row
  // tiles (two, with the wider accumulators) above
  if (Dh <= 64) return launch_rounding<3, 1>(x, round_logits, round_diff, s);
  return launch_rounding<2, 2>(x, round_logits, round_diff, s);
}
