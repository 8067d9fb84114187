// RMSNorm over the last axis: y = x * rsqrt(mean(x^2) + eps) * scale.
//
// Replaces the TPU kernel repro/kernels/rmsnorm.py::_rmsnorm_kernel, which
// walks a grid of 256-row blocks held in VMEM.  Here one thread block owns one
// row: the row is read from device memory once, kept in shared memory as f32
// while the block reduces the sum of squares (warp shuffles, then one value a
// warp through shared memory), and written once.  The work is bound by bytes
// (one read and one write of x), so the only aim is 16-byte loads and stores
// on neighbouring addresses; rows whose length or address does not allow them
// take the scalar loop of the same kernel.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale, T* __restrict__ y,
               int d, float eps, int vec) {
  extern __shared__ __align__(16) float row[];  // d floats
  __shared__ float red[kThreads / 32];
  constexpr int V = Vec16<T>::N;
  const int tid = threadIdx.x;
  const int64_t base = (int64_t)blockIdx.x * d;
  const T* xr = x + base;
  T* yr = y + base;

  float ss = 0.0f;
  if (vec) {
    for (int c = tid * V; c < d; c += kThreads * V) {
      float buf[V];
      Vec16<T>::load(xr + c, buf);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        row[c + i] = buf[i];
        ss += buf[i] * buf[i];
      }
    }
  } else {
    for (int c = tid; c < d; c += kThreads) {
      const float v = to_f32(xr[c]);
      row[c] = v;
      ss += v * v;
    }
  }

  ss = warp_sum(ss);
  if ((tid & 31) == 0) red[tid >> 5] = ss;
  __syncthreads();
  if (tid < 32) {
    float v = tid < kThreads / 32 ? red[tid] : 0.0f;
    v = warp_sum(v);
    if (tid == 0) red[0] = v;
  }
  __syncthreads();
  const float inv = rsqrtf(red[0] / (float)d + eps);

  // each thread rereads only what it wrote itself
  if (vec) {
    for (int c = tid * V; c < d; c += kThreads * V) {
      float buf[V];
#pragma unroll
      for (int i = 0; i < V; ++i) buf[i] = row[c + i] * inv * scale[c + i];
      Vec16<T>::store(yr + c, buf);
    }
  } else {
    for (int c = tid; c < d; c += kThreads) yr[c] = from_f32<T>(row[c] * inv * scale[c]);
  }
}

template <typename T>
int launch(const void* x, const void* scale, void* y, int64_t n, int d, float eps, int vec,
           cudaStream_t stream) {
  const size_t smem = (size_t)d * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(rmsnorm_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  rmsnorm_kernel<T><<<(unsigned)n, kThreads, smem, stream>>>(
      (const T*)x, (const float*)scale, (T*)y, d, eps, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y: (n, d) contiguous in `dtype`; scale: (d,) f32.  vec != 0 promises that
// d is a multiple of 16 bytes' worth of elements and that x, y and scale are
// 16-byte aligned.  Returns cudaGetLastError() of the launch, -1 for a bad dtype.
extern "C" int rmsnorm_launch(const void* x, const void* scale, void* y, int64_t n, int d,
                              float eps, int dtype, int vec, void* stream) {
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == DT_F32) return launch<float>(x, scale, y, n, d, eps, vec, s);
  if (dtype == DT_BF16) return launch<__nv_bfloat16>(x, scale, y, n, d, eps, vec, s);
  return -1;
}
