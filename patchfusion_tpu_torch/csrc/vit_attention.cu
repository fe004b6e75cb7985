// Self-attention over bf16 ViT tokens, for sm_90a.
//
// Replaces: patchfusion_tpu/ops/pallas_attention.py::vit_attention
// (Pallas kernel _attn_kernel), ::vit_attention_blocked
// (_attn_kernel_blocked) and ::vit_attention_mxsum (_attn_kernel_mxsum).
// The three compute the same function and differ only in TPU tricks; on
// the card they are one kernel:
//   whole (Npad, Npad) score block in VMEM  -> K/V streamed in 64-row tiles
//   pad correction of the normaliser,
//   -1e30 bias row                          -> the ragged last K tile masked
//   block_rows                              -> the 64-row query tile
//   ones column of v_ext                    -> the normaliser summed in
//                                              registers
// Per (b, h): o = softmax(q k^T * Dh^-0.5) v with the JAX bf16 contract:
//   * q * scale rounded to bf16 (scale itself given in bf16, as JAX casts
//     the Python float to the array's dtype);
//   * q.k logits accumulate in f32 (mma.sync m16n8k16, f32 accumulators);
//   * bf16_exp = 1: the logits are rounded to bf16 off the accumulator and
//     (s - m) is rounded to bf16 before exp: _attn_kernel's bf16 N^2 stage,
//     which is also the rounding of the JAX einsum path
//     (models/dinov2.py:90-93); bf16_exp = 0: s - m and exp in f32
//     (_attn_kernel_blocked, vit_attention_mxsum(bf16_exp=False));
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
// ~10 us of HBM traffic, so it is bound by tensor-core operations, with
// B H N^2 = 69 M exps on the side. This first kernel uses mma.sync (not
// wgmma) with synchronous tile loads, so it reaches a fraction of that
// peak; wgmma, TMA and warp specialisation are later work.
//
// Design: one block per (b*h, 64 query rows), four warps of 16 query rows
// each. q, k and v are read through their (b, n, h) strides straight from
// the qkv linear's output (views qkv[:, :, i] of a (B, N, 3, H, Dh)
// tensor), so no transpose or pad copy is made; the last dimension must be
// contiguous. Each 64-row K and V tile is staged in shared memory, rows
// padded by 8 bf16 so the fragment loads hit 32 distinct banks; rows past
// N are zero-filled and their scores masked to -inf. S = Q K^T comes from
// 32-bit fragment loads of K; P, kept in registers as the A operand,
// multiplies V through ldmatrix.trans. o is written contiguous
// (B, N, H, Dh), so the caller's reshape to (B, N, H*Dh) is free.

#include "common.cuh"

namespace {

constexpr int kRows = 64;  // query rows per block, and keys per K/V tile
constexpr int kWarps = 4;  // 16 query rows each
constexpr int kThreads = 32 * kWarps;

__device__ __forceinline__ float bf16_round(float x) {
  return pf::round_to<__nv_bfloat16>(x);
}

// Two floats as one bf16x2 register, lo in the low half: the element order
// of the mma fragments.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Two adjacent bf16 of shared memory times scale, rounded back to bf16x2.
__device__ __forceinline__ uint32_t scaled_pair(const __nv_bfloat16* p,
                                                float scale) {
  const float2 f = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(p));
  return pack_bf16x2(f.x * scale, f.y * scale);
}

// d += a (16x16 bf16, row) . b (16x8 bf16, col), f32 accumulate.
__device__ __forceinline__ void mma_16816(float (&d)[4],
                                          const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four transposed 8x8 bf16 matrices of shared memory; lane l gives the row
// address of row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const __nv_bfloat16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// Rows row0 .. row0 + 63 of one (b, h) slice into shared memory, 16 bytes
// per thread and step; rows at or past n are zero-filled.
template <int DH>
__device__ __forceinline__ void load_tile(__nv_bfloat16 (*dst)[DH + 8],
                                          const __nv_bfloat16* src,
                                          long long row_stride, int row0,
                                          int n) {
  constexpr int kChunks = DH / 8;
  for (int c = threadIdx.x; c < kRows * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n)
      v = *reinterpret_cast<const uint4*>(
          src + static_cast<long long>(row0 + r) * row_stride + col);
    *reinterpret_cast<uint4*>(&dst[r][col]) = v;
  }
}

struct TokenStrides {
  long long b, n, h;  // in elements; the Dh stride is 1
};

template <int DH>
__global__ void __launch_bounds__(kThreads)
vit_attention_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, int N, int H,
                     TokenStrides qs, TokenStrides ks, TokenStrides vs,
                     float scale, int bf16_exp) {
  constexpr int kDK = DH / 16;     // k-steps of Q K^T
  constexpr int kDN = DH / 8;      // 8-wide column tiles of O
  constexpr int kKN = kRows / 8;   // 8-key column tiles of S per K tile
  __shared__ __align__(16) __nv_bfloat16 k_s[kRows][DH + 8];
  __shared__ __align__(16) __nv_bfloat16 v_s[kRows][DH + 8];

  const int n_tiles = (N + kRows - 1) / kRows;
  const int bh = blockIdx.x / n_tiles;
  const int q0 = (blockIdx.x % n_tiles) * kRows;
  const int b = bh / H, h = bh % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group, column
  const int wr = warp * 16 + g;           // this thread's rows: wr, wr + 8

  // Q tile through k_s into A fragments, pre-scaled and rounded to bf16
  load_tile<DH>(k_s, q + b * qs.b + h * qs.h, qs.n, q0, N);
  __syncthreads();
  uint32_t qf[kDK][4];
#pragma unroll
  for (int kd = 0; kd < kDK; ++kd) {
    const int c = kd * 16 + 2 * t;
    qf[kd][0] = scaled_pair(&k_s[wr][c], scale);
    qf[kd][1] = scaled_pair(&k_s[wr + 8][c], scale);
    qf[kd][2] = scaled_pair(&k_s[wr][c + 8], scale);
    qf[kd][3] = scaled_pair(&k_s[wr + 8][c + 8], scale);
  }
  __syncthreads();

  const float neg_inf = __int_as_float(0xff800000);
  float m0 = neg_inf, m1 = neg_inf;  // running max of rows wr, wr + 8
  float l0 = 0.f, l1 = 0.f;          // this thread's share of their sums
  float acc[kDN][4];
#pragma unroll
  for (int j = 0; j < kDN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  const __nv_bfloat16* kb = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + h * vs.h;
  for (int k0 = 0; k0 < N; k0 += kRows) {
    load_tile<DH>(k_s, kb, ks.n, k0, N);
    load_tile<DH>(v_s, vb, vs.n, k0, N);
    __syncthreads();

    // S = (Q * scale) K^T for this warp's 16 rows and the tile's 64 keys
    float s[kKN][4];
#pragma unroll
    for (int j = 0; j < kKN; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kd = 0; kd < kDK; ++kd) {
        const __nv_bfloat16* kr = &k_s[8 * j + g][kd * 16 + 2 * t];
        mma_16816(s[j], qf[kd], *reinterpret_cast<const uint32_t*>(kr),
                  *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }

    // mask the ragged tile, round, and take the tile's row max
    float mx0 = neg_inf, mx1 = neg_inf;
#pragma unroll
    for (int j = 0; j < kKN; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = bf16_exp ? bf16_round(s[j][e]) : s[j][e];
        if (k0 + 8 * j + 2 * t + (e & 1) >= N) x = neg_inf;
        s[j][e] = x;
        if (e < 2)
          mx0 = fmaxf(mx0, x);
        else
          mx1 = fmaxf(mx1, x);
      }
    }
    // the four threads of a row group hold the row's columns
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // every tile holds a valid key, so the new max is finite; the first
    // tile's rescale is exp(-inf) = 0
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = __expf(m0 - mn0), a1 = __expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int j = 0; j < kDN; ++j) {
      acc[j][0] *= a0;
      acc[j][1] *= a0;
      acc[j][2] *= a1;
      acc[j][3] *= a1;
    }

    // P = exp(S - m) in bf16, as A fragments of the P V product: the
    // accumulators of key tiles 2 kb and 2 kb + 1 are the A fragment of
    // k-step kb
    uint32_t pa[kKN / 2][4];
#pragma unroll
    for (int j = 0; j < kKN; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float d = s[j][e] - (e < 2 ? m0 : m1);
        if (bf16_exp) d = bf16_round(d);
        p[e] = bf16_round(__expf(d));
      }
      l0 += p[0] + p[1];
      l1 += p[2] + p[3];
      pa[j / 2][(j & 1) * 2 + 0] = pack_bf16x2(p[0], p[1]);
      pa[j / 2][(j & 1) * 2 + 1] = pack_bf16x2(p[2], p[3]);
    }

    // O += P V: ldmatrix.trans gives the B fragments of two column tiles
#pragma unroll
    for (int kk = 0; kk < kKN / 2; ++kk) {
#pragma unroll
      for (int jd = 0; jd < kDN; jd += 2) {
        uint32_t r[4];
        ldmatrix_x4_trans(
            r, &v_s[kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8]
                   [jd * 8 + (lane >> 4) * 8]);
        mma_16816(acc[jd], pa[kk], r[0], r[1]);
        mma_16816(acc[jd + 1], pa[kk], r[2], r[3]);
      }
    }
    __syncthreads();  // the next tile overwrites k_s and v_s
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);

  // o[b, n, h, :] at ((b N + n) H + h) Dh
  const long long row_stride = static_cast<long long>(H) * DH;
  __nv_bfloat16* ob =
      o + (static_cast<long long>(b) * N * H + h) * DH + 2 * t;
  const int r0 = q0 + wr, r1 = r0 + 8;
#pragma unroll
  for (int j = 0; j < kDN; ++j) {
    if (r0 < N)
      *reinterpret_cast<uint32_t*>(ob + r0 * row_stride + j * 8) =
          pack_bf16x2(acc[j][0] / l0, acc[j][1] / l0);
    if (r1 < N)
      *reinterpret_cast<uint32_t*>(ob + r1 * row_stride + j * 8) =
          pack_bf16x2(acc[j][2] / l1, acc[j][3] / l1);
  }
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int N, int H, TokenStrides qs, TokenStrides ks,
                   TokenStrides vs, float scale, int bf16_exp,
                   cudaStream_t stream) {
  const long long blocks = static_cast<long long>(B) * H *
                           ((N + kRows - 1) / kRows);
  if (blocks == 0) return cudaSuccess;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  vit_attention_kernel<DH>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
          static_cast<const __nv_bfloat16*>(q),
          static_cast<const __nv_bfloat16*>(k),
          static_cast<const __nv_bfloat16*>(v),
          static_cast<__nv_bfloat16*>(o), N, H, qs, ks, vs, scale, bf16_exp);
  return cudaGetLastError();
}

}  // namespace

// C entry point. q, k and v are (B, N, H, Dh) bfloat16 device tensors with
// element strides (b, n, h) as given and a contiguous last dimension, every
// row 16-byte aligned; o is a contiguous (B, N, H, Dh) bfloat16 tensor.
// Dh is a multiple of 16 up to 128. scale is Dh^-0.5 rounded to bf16.
// Returns the cudaError_t of the launch.
extern "C" int pf_vit_attention(const void* q, const void* k, const void* v,
                                void* o, int B, int N, int H, int Dh,
                                long long qb, long long qn, long long qh,
                                long long kb, long long kn, long long kh,
                                long long vb, long long vn, long long vh,
                                float scale, int bf16_exp, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const TokenStrides qs{qb, qn, qh}, ks{kb, kn, kh}, vs{vb, vn, vh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (Dh) {
#define PF_ATTN_CASE(D)                                                     \
  case D:                                                                   \
    err = launch<D>(q, k, v, o, B, N, H, qs, ks, vs, scale, bf16_exp, s);   \
    break;
    PF_ATTN_CASE(16)
    PF_ATTN_CASE(32)
    PF_ATTN_CASE(48)
    PF_ATTN_CASE(64)
    PF_ATTN_CASE(80)
    PF_ATTN_CASE(96)
    PF_ATTN_CASE(112)
    PF_ATTN_CASE(128)
#undef PF_ATTN_CASE
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
