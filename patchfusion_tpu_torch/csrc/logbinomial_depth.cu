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
// What bounds it on the H100: per pixel it reads p and t (8 B), four corner
// rows of K bin centers (4 x 64 x 2 B in bf16, mostly shared with the
// neighbouring pixels through L1: the upsample is ~1.75x per axis) and
// writes 4 B; it does ~2 logs and K exps plus ~10 K FLOPs. At the main-path
// shape (4 x 392 x 518 pixels, K = 64) that is ~40 MB of unique traffic and
// ~0.6 GFLOP with 52 M exps, so it is bound by the SFU (exp) and issue rate,
// not by HBM: well below the tensor-core ridge, and there is no matmul.
//
// Design: one thread per output pixel; the K-entry c0 table is computed
// once per block into shared memory (in double, as the host does); the
// softmax takes two passes over K (max, then exp-sum and the weighted sum)
// so nothing K-sized lives in registers, and the upsampled centers are
// never written to memory. The per-pixel body is pf::logbinom_depth_pixel
// (common.cuh), shared with csrc/clb_depth.cu. The TPU kernel's banded W matrix, DMA'd row
// spans and lane padding have no counterpart: the bilinear taps are
// computed per pixel. centers are read through their strides, so the
// model passes its NCHW tensor as a permuted view; neighbouring threads
// (neighbouring x) then read neighbouring addresses for each k.

#include "common.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(256)
logbinomial_depth_kernel(const float* __restrict__ p,
                         const float* __restrict__ t,
                         const T* __restrict__ centers,
                         float* __restrict__ out, int B, int OH, int OW,
                         int IH, int IW, int K, pf::Strides4 cs,
                         float min_temp, float max_temp) {
  extern __shared__ float c0[];  // K entries
  pf::fill_log_binom_c0(c0, K);

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

template <typename T>
cudaError_t launch(const void* p, const void* t, const void* centers,
                   void* out, int B, int OH, int OW, int IH, int IW, int K,
                   pf::Strides4 cs, float min_temp, float max_temp,
                   cudaStream_t stream) {
  const long long total = static_cast<long long>(B) * OH * OW;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  if (blocks == 0) return cudaSuccess;
  logbinomial_depth_kernel<T>
      <<<static_cast<unsigned>(blocks), threads, K * sizeof(float), stream>>>(
          static_cast<const float*>(p), static_cast<const float*>(t),
          static_cast<const T*>(centers), static_cast<float*>(out), B, OH,
          OW, IH, IW, K, cs, min_temp, max_temp);
  return cudaGetLastError();
}

}  // namespace

// C entry point. Pointers are device pointers on `device`; p, t and out are
// contiguous (B, OH, OW) float32; centers is (B, IH, IW, K) with the given
// element strides, float32 (centers_bf16 = 0) or bfloat16 (= 1). Returns
// the cudaError_t of the launch.
extern "C" int pf_logbinomial_depth(const void* p, const void* t,
                                    const void* centers, void* out,
                                    int centers_bf16, int B, int OH, int OW,
                                    int IH, int IW, int K, long long sb,
                                    long long sy, long long sx, long long sk,
                                    float min_temp, float max_temp,
                                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const pf::Strides4 cs{sb, sy, sx, sk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (centers_bf16)
    err = launch<__nv_bfloat16>(p, t, centers, out, B, OH, OW, IH, IW, K, cs,
                                min_temp, max_temp, s);
  else
    err = launch<float>(p, t, centers, out, B, OH, OW, IH, IW, K, cs,
                        min_temp, max_temp, s);
  return static_cast<int>(err);
}
