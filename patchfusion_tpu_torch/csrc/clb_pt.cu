// ConditionalLogBinomial MLP of the metric-bins head, for sm_90a.
//
// Replaces: patchfusion_tpu/ops/pallas_head.py::clb_pt (Pallas kernel
// _clb_pt_impl). Per output pixel (b, y, x):
//   cu  = bilinear align_corners=True upsample of cond_lo (B,IH,IW,Cc)
//   h   = last_cat[b,y,x,:] . W1[:Cin] + cu . W1[Cin:] + b1     (H = 80)
//   g   = tanh-GELU(h) at the input dtype
//   s   = softplus(g . W2 + b2)                                 (4 values)
//   p   = (s0+eps) / (s0+s1+2eps),  t = (s2+eps) / (s2+s3+2eps)
// writing only p and t; the full-resolution 80-channel bottleneck never
// reaches memory.
//
// Order of the condition term: this kernel upsamples cond_lo first and then
// projects it through W1[Cin:], all inside the kernel (the TPU kernel
// projects at low resolution and then upsamples; the two are equal up to
// float reassociation because both maps are linear). One pass, one launch,
// no scratch tensor.
//
// What bounds it on the H100: per pixel it reads Cin = 33 inputs (66 B in
// bf16), four corner rows of Cc = 128 condition channels (mostly shared
// with neighbouring pixels through L1) and writes 8 B, while it does
// (33 + 128) x 80 + 80 x 4 ~ 13 k FMAs. That is ~100 FLOP per byte of
// unique traffic: below the tensor-core ridge (~295 FLOP/B), but above the
// ~20 FLOP/B ridge of the plain fp32 FMA pipes this simple kernel uses, so
// it is bound by FMA issue and shared-memory weight reads. Moving the
// products onto tensor cores (mma/wgmma over pixel tiles) is the later
// optimisation.
//
// Design: one thread per output pixel in a grid-stride loop over a grid
// sized to fill the SMs once, so each block stages the 52 KB of f32
// weights into shared memory once. Each thread keeps its 80 accumulators
// in registers; every weight read is the same address across the warp (a
// shared-memory broadcast). Inputs are read through their strides, so the
// model passes its NCHW tensors as permuted views: for each channel,
// neighbouring threads (neighbouring x) read neighbouring addresses.
// For bf16 inputs h and GELU(h) are rounded to bf16 and W2 is used in bf16
// with f32 accumulation, as the TPU kernel does at the input dtype. The
// per-pixel body is pf::clb_pixel (common.cuh), shared with
// csrc/clb_depth.cu.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
clb_pt_kernel(const T* __restrict__ last, const T* __restrict__ cond,
              const float* __restrict__ w1, const float* __restrict__ b1,
              const float* __restrict__ w2, const float* __restrict__ b2,
              float* __restrict__ p_out, float* __restrict__ t_out, int B,
              int OH, int OW, int IH, int IW, int Cin, int Cc,
              pf::Strides4 ls, pf::Strides4 cs, float p_eps) {
  extern __shared__ float smem[];
  const pf::ClbWeights w =
      pf::clb_stage_weights<T>(smem, w1, b1, w2, b2, Cin + Cc);

  const long long total = static_cast<long long>(B) * OH * OW;
  for (long long idx =
           static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       idx < total; idx += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int x = static_cast<int>(idx % OW);
    const int y = static_cast<int>((idx / OW) % OH);
    const int b = static_cast<int>(idx / (static_cast<long long>(OW) * OH));
    const float2 pt = pf::clb_pixel<T>(last, cond, ls, cs, w, b, y, x, OH,
                                       OW, IH, IW, Cin, Cc, p_eps);
    p_out[idx] = pt.x;
    t_out[idx] = pt.y;
  }
}

template <typename T>
cudaError_t launch(const void* last, const void* cond, const void* w1,
                   const void* b1, const void* w2, const void* b2,
                   void* p_out, void* t_out, int B, int OH, int OW, int IH,
                   int IW, int Cin, int Cc, pf::Strides4 ls,
                   pf::Strides4 cs, float p_eps, int device,
                   cudaStream_t stream) {
  const size_t smem = pf::clb_smem_floats(Cin + Cc) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      clb_pt_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, clb_pt_kernel<T>, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long total = static_cast<long long>(B) * OH * OW;
  if (total == 0) return cudaSuccess;
  long long blocks = (total + kThreads - 1) / kThreads;
  const long long resident = static_cast<long long>(sms) * per_sm;
  if (blocks > resident) blocks = resident;
  clb_pt_kernel<T><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const T*>(last), static_cast<const T*>(cond),
      static_cast<const float*>(w1), static_cast<const float*>(b1),
      static_cast<const float*>(w2), static_cast<const float*>(b2),
      static_cast<float*>(p_out), static_cast<float*>(t_out), B, OH, OW, IH,
      IW, Cin, Cc, ls, cs, p_eps);
  return cudaGetLastError();
}

}  // namespace

// C entry point. last_cat (B, OH, OW, Cin) and cond_lo (B, IH, IW, Cc) are
// device tensors of one dtype, float32 (inputs_bf16 = 0) or bfloat16 (= 1),
// with the given element strides; w1 (Cin+Cc, hidden), b1 (hidden,),
// w2 (hidden, 4) and b2 (4,) are contiguous float32; p_out and t_out are
// contiguous (B, OH, OW) float32. Returns the cudaError_t of the launch.
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
  if (inputs_bf16)
    err = launch<__nv_bfloat16>(last, cond, w1, b1, w2, b2, p_out, t_out, B,
                                OH, OW, IH, IW, Cin, Cc, ls, cs, p_eps,
                                device, s);
  else
    err = launch<float>(last, cond, w1, b1, w2, b2, p_out, t_out, B, OH, OW,
                        IH, IW, Cin, Cc, ls, cs, p_eps, device, s);
  return static_cast<int>(err);
}
