// The CHM head's direct 4D convolution on Hopper (sm_90a): hough4d_kernel
// (hough4d.cuh, with its own note) behind a plain C interface for ctypes.
// It replaces no TPU kernel: the JAX package's CHM6d and CHM4d are XLA
// convolutions. Instances: (Ci, Co) = (1, 1) for CHM4d and (9, 9) for
// CHM6d, 5^4 kernels.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr size_t DEFAULT_SMEM = 48 * 1024;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async8(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// every group but the newest N complete
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

#define FSS_SHARED(name) extern __shared__ float name[]
#include "hough4d.cuh"

template <int CI, int CO>
H4Layout plan_layout(int hs, int ws) {
  return h4_layout(CI, CO, H4Tile<CI, CO>::TH, H4Tile<CI, CO>::TW, H4Tile<CI, CO>::C0, hs, ws);
}

template <int CI, int CO, int V>
cudaError_t launch_v(const float* x, const float* wt, const float* bias, float* y, int batch,
                     int h, int w, int hs, int ws, long long sb, long long sh, long long sw,
                     long long sc, int bias_stride, cudaStream_t stream) {
  const H4Layout L = plan_layout<CI, CO>(hs, ws);
  const size_t smem = sizeof(float) * (size_t)L.floats;
  if (smem > (size_t)H4_MAX_SMEM || L.threads > H4_THREADS) return cudaErrorInvalidValue;
  if (smem > DEFAULT_SMEM) {
    const cudaError_t err = cudaFuncSetAttribute(
        hough4d_kernel<CI, CO, V>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const long long blocks = (long long)batch * L.bands * h * w;
  if (blocks < 1) return cudaSuccess;  // an empty batch
  hough4d_kernel<CI, CO, V><<<(unsigned)blocks, L.threads, smem, stream>>>(
      x, wt, bias, y, h, w, hs, ws, sb, sh, sw, sc, bias_stride);
  return cudaGetLastError();
}

template <int CI, int CO>
cudaError_t launch(const float* x, const float* wt, const float* bias, float* y, int batch,
                   int h, int w, int hs, int ws, long long sb, long long sh, long long sw,
                   long long sc, int bias_stride, cudaStream_t stream) {
  // the widest copies for which every staged row starts aligned
  auto aligned = [&](int v) {
    return ws % v == 0 && (uintptr_t)x % (4 * v) == 0 && sb % v == 0 && sh % v == 0 &&
           sw % v == 0 && (CI == 1 || sc % v == 0);
  };
  if (H4Tile<CI, CO>::C0 == 4 && aligned(4))
    return launch_v<CI, CO, 4>(x, wt, bias, y, batch, h, w, hs, ws, sb, sh, sw, sc,
                               bias_stride, stream);
  if (aligned(2))
    return launch_v<CI, CO, 2>(x, wt, bias, y, batch, h, w, hs, ws, sb, sh, sw, sc,
                               bias_stride, stream);
  return launch_v<CI, CO, 1>(x, wt, bias, y, batch, h, w, hs, ws, sb, sh, sw, sc, bias_stride,
                             stream);
}

}  // namespace

extern "C" {

// The launch plan of (ci, co) at a support plane (hs, ws) into out[4]:
// threads a CTA, support rows a CTA, CTAs a query position, shared bytes a
// CTA. Returns 0, or -1 for a (ci, co) the kernel is not instantiated for.
int fss_hough4d_plan(int ci, int co, int hs, int ws, long long* out) {
  H4Layout L;
  if (ci == 1 && co == 1)
    L = plan_layout<1, 1>(hs, ws);
  else if (ci == 9 && co == 9)
    L = plan_layout<9, 9>(hs, ws);
  else
    return -1;
  out[0] = L.threads;
  out[1] = L.band;
  out[2] = L.bands;
  out[3] = (long long)sizeof(float) * L.floats;
  return 0;
}

// y (B, co, h, w, hs, ws) from x (strides sb, sh, sw, sc in floats; the
// support plane contiguous) and wt (25, ci, co, 28); bias null, or co values
// at stride bias_stride (0: one value for every channel). Returns the
// cudaError_t.
int fss_hough4d(const float* x, const float* wt, const float* bias, float* y, int batch, int h,
                int w, int hs, int ws, int ci, int co, long long sb, long long sh, long long sw,
                long long sc, int bias_stride, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (ci == 1 && co == 1)
    return (int)launch<1, 1>(x, wt, bias, y, batch, h, w, hs, ws, sb, sh, sw, sc, bias_stride,
                             s);
  if (ci == 9 && co == 9)
    return (int)launch<9, 9>(x, wt, bias, y, batch, h, w, hs, ws, sb, sh, sw, sc, bias_stride,
                             s);
  return (int)cudaErrorInvalidValue;
}

const char* fss_hough4d_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
