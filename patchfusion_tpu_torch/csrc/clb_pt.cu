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

// Shared memory the bf16 kernels need for these sizes and K bins (0 for
// clb_pt), in bytes; the wrappers check it against the card's 227 KB.
extern "C" long long pf_clb_tc_smem(int OH, int OW, int IH, int IW, int K) {
  return static_cast<long long>(pf::tc::smem_bytes(OH, OW, IH, IW, K));
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
    err = pf::tc::launch<false>(static_cast<const __nv_bfloat16*>(last),
                                static_cast<const __nv_bfloat16*>(cond), w1f,
                                b1f, w2f, b2f, po, to, B, OH, OW, IH, IW, Cin,
                                Cc, ls, cs, p_eps, pf::tc::DepthArgs{}, device,
                                s);
  else
    err = launch_f32(static_cast<const float*>(last),
                     static_cast<const float*>(cond), w1f, b1f, w2f, b2f, po,
                     to, B, OH, OW, IH, IW, Cin, Cc, ls, cs, p_eps, device, s);
  return static_cast<int>(err);
}
