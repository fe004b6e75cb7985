// The whole ConditionalLogBinomial stage of the metric-bins head in one
// launch, for sm_90a: the MLP of csrc/clb_pt.cu and the depth expectation
// of csrc/logbinomial_depth.cu, fused.
//
// Replaces: patchfusion_tpu/ops/pallas_head.py::clb_logbinomial_depth
// (Pallas kernel _clb_depth_impl). Per output pixel (b, y, x):
//   (p, t) = the ConditionalLogBinomial MLP (as in csrc/clb_pt.cu)
//   depth  = sum_k softmax(log-binomial(p, t))[k] up(centers)[k]
//            (pf::logbinom_depth_pixel)
// writing only the (B, OH, OW) f32 depth: p and t stay in registers, the
// 80-channel bottleneck and the upsampled condition and centers never
// reach memory.
//
// What bounds it on the H100: per pixel it reads Cin = 33 inputs, four
// corner rows of Cc = 128 condition channels and of K = 64 centers (mostly
// shared with neighbouring pixels through L1) and writes 4 B, while it does
// ~13 k FMAs of the MLP and K exps of the softmax. As with clb_pt that is
// above the fp32 FMA ridge and below the tensor-core ridge: it is bound by
// FMA issue and shared-memory weight reads, not by HBM. Fusing saves the
// 8 B per pixel of p and t written and read back, and one launch.
//
// Design: for bf16 inputs (the main path's dtype) the tensor-core body of
// the bf16 clb_pt kernel (csrc/clb_tc.cuh: the condition projected at low
// resolution, W1 as bf16 hi + lo), so depth_fused computes clb_pt then
// logbinomial_depth's per-pixel body (the tiled logbinomial_depth kernel
// runs the same arithmetic from its own staging; the two routes agree to
// float rounding, ~1e-7 of max depth). Its epilogue: the K-entry c0
// table beside the buffers in shared memory, each tile's footprint of the
// centers (K <= 128 channels) staged where the condition's was once the
// projection is done with it, and one output pixel per lane running
// pf::logbinom_depth over the staged corners. For f32 inputs, clb_pt's
// first design (one thread per
// pixel, grid-stride loop over a grid that fills the SMs once, the 52 KB of
// f32 weights staged in shared memory once per block, 80 accumulators in
// registers) with the same epilogue. All three maps are read through their
// strides (NCHW tensors as permuted views).

#include "clb_tc.cuh"
#include "common.cuh"

namespace {

constexpr int kThreads = 128;

// f32 inputs: one thread per pixel.
__global__ void __launch_bounds__(kThreads)
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
  extern __shared__ float smem[];
  const pf::ClbWeights w =
      pf::clb_stage_weights(smem, w1, b1, w2, b2, Cin + Cc);
  float* c0 = smem + pf::clb_smem_floats(Cin + Cc);
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
      &per_sm, clb_depth_f32_kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long total = static_cast<long long>(B) * OH * OW;
  if (total == 0) return cudaSuccess;
  long long blocks = (total + kThreads - 1) / kThreads;
  const long long resident = static_cast<long long>(sms) * per_sm;
  if (blocks > resident) blocks = resident;
  clb_depth_f32_kernel
      <<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
          static_cast<const float*>(last), static_cast<const float*>(cond),
          static_cast<const float*>(centers), static_cast<const float*>(w1),
          static_cast<const float*>(b1), static_cast<const float*>(w2),
          static_cast<const float*>(b2), static_cast<float*>(out), B, OH, OW,
          IH, IW, Cin, Cc, K, ls, cs, zs, p_eps, min_temp, max_temp);
  return cudaGetLastError();
}

}  // namespace

// C entry point. last_cat (B, OH, OW, Cin), cond_lo (B, IH, IW, Cc) and
// centers (B, IH, IW, K) are device tensors of one dtype, float32
// (inputs_bf16 = 0) or bfloat16 (= 1, with K <= 128 and what clb_pt's bf16
// kernel takes), with the given element strides;
// w1 (Cin+Cc, hidden), b1 (hidden,), w2 (hidden, 4) and b2 (4,) are
// contiguous float32; out is contiguous (B, OH, OW) float32. Returns the
// cudaError_t of the launch.
extern "C" int pf_clb_logbinomial_depth(
    const void* last, const void* cond, const void* centers, const void* w1,
    const void* b1, const void* w2, const void* b2, void* out,
    int inputs_bf16, int B, int OH, int OW, int IH, int IW, int Cin, int Cc,
    int K, int hidden, long long lb, long long ly, long long lx,
    long long lc, long long cb, long long cy, long long cx, long long cc,
    long long zb, long long zy, long long zx, long long zc, float p_eps,
    float min_temp, float max_temp, int device, void* stream) {
  if (hidden != pf::kClbHidden) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const pf::Strides4 ls{lb, ly, lx, lc};
  const pf::Strides4 cs{cb, cy, cx, cc};
  const pf::Strides4 zs{zb, zy, zx, zc};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (inputs_bf16)
    err = pf::tc::launch<true>(
        static_cast<const __nv_bfloat16*>(last),
        static_cast<const __nv_bfloat16*>(cond),
        static_cast<const float*>(w1), static_cast<const float*>(b1),
        static_cast<const float*>(w2), static_cast<const float*>(b2), nullptr,
        nullptr, B, OH, OW, IH, IW, Cin, Cc, ls, cs, p_eps,
        pf::tc::DepthArgs{static_cast<const __nv_bfloat16*>(centers), zs, K,
                          min_temp, max_temp, static_cast<float*>(out)},
        device, s);
  else
    err = launch_f32(last, cond, centers, w1, b1, w2, b2, out, B, OH, OW, IH,
                     IW, Cin, Cc, K, ls, cs, zs, p_eps, min_temp, max_temp,
                     device, s);
  return static_cast<int>(err);
}
