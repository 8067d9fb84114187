// RMSNorm over the last axis: y = x * rsqrt(mean(x^2) + eps) * scale.
//
// Replaces the TPU kernel repro/kernels/rmsnorm.py::_rmsnorm_kernel, which
// walks a grid of 256-row blocks held in VMEM.  The work is bound by bytes
// (one read and one write of x), so the aims are 16-byte loads and stores on
// neighbouring addresses, enough of them in flight to cover the memory's
// latency, and no traffic besides x.  The C entry point picks one of two
// kernels:
//
// - rmsnorm_reg_kernel<T, NT> (the served path: rows of up to kElems * NT
//   elements that split into 16-byte chunks, x, y and scale 16-byte aligned;
//   d_model 4096 in bf16 is 128 threads of 32 elements).  A row lives in
//   registers: each thread holds its chunks (chunk c = tid + i * NT, so a warp
//   reads 512 neighbouring bytes at each i) as raw 16-byte words, and issues
//   all of its loads before any arithmetic.  The grid is one wave of as many
//   blocks as the SMs hold; a block walks the rows blockIdx.x, + gridDim.x, ...
//   and loads the next row's words while it reduces and writes the current
//   one.  The f32 scale is read once a block, into registers, and serves every
//   row the block owns.  The sum of squares goes through warp shuffles and
//   one float a warp in shared memory (two slots, alternating by row, so one
//   barrier a row suffices).
// - rmsnorm_kernel<T> (any other row: d that is not a whole number of 16-byte
//   chunks, an unaligned pointer, or a row longer than the register tile).  One
//   block owns one row, kept in shared memory as f32 while the block reduces,
//   with the scalar loop where 16-byte accesses are not allowed.
//
// Both keep the reference's order: f32 sum of squares, rsqrt(mean + eps),
// x times that, times the f32 scale, rounded once to x's type.
//
// The backward, rmsnorm_bwd_kernel<T> + rmsnorm_bwd_reduce_kernel: with
// g = dy * scale and r = rsqrt(mean(x^2) + eps), dx = r g - x r^3 mean(g x)
// and dscale = sum over rows of dy x r.  It is the port's counterpart of what
// XLA derives for the reference's jnp rmsnorm; the TPU kernel has no backward.
// Bound by bytes: x and dy read once, dx written once.  r is recomputed from
// x in the same pass (the backward reads x anyway), so the forward saves
// nothing.  A one-wave grid of blocks walks the rows (row = blockIdx.x, +
// gridDim.x, ...); a block keeps its row of x and dy as f32 in shared memory
// while it reduces sum(x^2) and sum(g x) together, and adds dy x r into its
// own f32 dscale partial, one column a thread, in shared memory.  The second
// kernel sums the blocks' partials column by column in a fixed order: no
// float atomics, so every run gives the same bits.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // rmsnorm_kernel
constexpr int kElems = 32;     // rmsnorm_reg_kernel: elements of a row a thread holds, at most

template <typename T, int NT>
__global__ void __launch_bounds__(NT)
rmsnorm_reg_kernel(const T* __restrict__ x, const float* __restrict__ scale, T* __restrict__ y,
                   int64_t n, int d, float eps) {
  constexpr int V = Vec16<T>::N;
  constexpr int NV = kElems / V;  // 16-byte chunks a thread
  constexpr int NW = NT / 32;
  __shared__ float red[2][NW];
  const int tid = threadIdx.x;
  const int chunks = d / V;

  float sc[NV][V];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = tid + i * NT;
#pragma unroll
    for (int j = 0; j < V; j += 4) {
      const float4 s4 = c < chunks ? *reinterpret_cast<const float4*>(scale + c * V + j)
                                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      sc[i][j] = s4.x; sc[i][j + 1] = s4.y; sc[i][j + 2] = s4.z; sc[i][j + 3] = s4.w;
    }
  }

  uint4 cur[NV], nxt[NV];
  auto fetch = [&](int64_t row, uint4* buf) {
    const uint4* src = reinterpret_cast<const uint4*>(x + row * d);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = tid + i * NT;
      buf[i] = c < chunks ? src[c] : make_uint4(0u, 0u, 0u, 0u);  // zeros add nothing to the sum
    }
  };

  int64_t row = blockIdx.x;
  if (row < n) fetch(row, cur);
  for (int it = 0; row < n; row += gridDim.x, ++it) {
    const int64_t next = row + gridDim.x;
    if (next < n) fetch(next, nxt);  // in flight while this row is reduced and written

    float ss = 0.0f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      float v[V];
      Vec16<T>::unpack(cur[i], v);
#pragma unroll
      for (int j = 0; j < V; ++j) ss += v[j] * v[j];
    }
    ss = warp_sum(ss);
    if ((tid & 31) == 0) red[it & 1][tid >> 5] = ss;
    __syncthreads();
    float total = 0.0f;
#pragma unroll
    for (int w = 0; w < NW; ++w) total += red[it & 1][w];
    const float inv = rsqrtf(total / (float)d + eps);

    uint4* dst = reinterpret_cast<uint4*>(y + row * d);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = tid + i * NT;
      if (c < chunks) {
        float v[V];
        Vec16<T>::unpack(cur[i], v);
#pragma unroll
        for (int j = 0; j < V; ++j) v[j] = v[j] * inv * sc[i][j];
        dst[c] = Vec16<T>::pack(v);
      }
    }
#pragma unroll
    for (int i = 0; i < NV; ++i) cur[i] = nxt[i];
  }
}

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

// VEC: d is a whole number of 16-byte chunks and every pointer 16-byte
// aligned; a thread then owns chunks of W = Vec16<T>::N columns, else single
// columns.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ scale, const T* __restrict__ dy,
                   T* __restrict__ dx, float* __restrict__ partial, int64_t n, int d, float eps) {
  extern __shared__ __align__(16) float bwd_smem[];  // x, dy and the dscale partial: 3 d floats
  float* xs = bwd_smem;
  float* gs = xs + d;
  float* acc = gs + d;
  __shared__ float part[kThreads / 32][2];
  __shared__ float total[2];
  constexpr int W = VEC ? Vec16<T>::N : 1;
  const int tid = threadIdx.x;
  // every loop below visits the same columns of a thread, so a thread reads
  // back only what it wrote itself and the rows need no barrier of their own
  const int first = tid * W;
  for (int c = first; c < d; c += kThreads * W)
#pragma unroll
    for (int i = 0; i < W; ++i) acc[c + i] = 0.0f;

  for (int64_t row = blockIdx.x; row < n; row += gridDim.x) {
    const T* xr = x + row * d;
    const T* gr = dy + row * d;
    float ss = 0.0f, gx = 0.0f;
    for (int c = first; c < d; c += kThreads * W) {
      float xb[W], gb[W];
      if constexpr (VEC) {
        Vec16<T>::load(xr + c, xb);
        Vec16<T>::load(gr + c, gb);
      } else {
        xb[0] = to_f32(xr[c]);
        gb[0] = to_f32(gr[c]);
      }
#pragma unroll
      for (int i = 0; i < W; ++i) {
        xs[c + i] = xb[i];
        gs[c + i] = gb[i];
        ss += xb[i] * xb[i];
        gx += gb[i] * scale[c + i] * xb[i];
      }
    }
    ss = warp_sum(ss);
    gx = warp_sum(gx);
    if ((tid & 31) == 0) {
      part[tid >> 5][0] = ss;
      part[tid >> 5][1] = gx;
    }
    __syncthreads();
    if (tid < 32) {
      float a = tid < kThreads / 32 ? part[tid][0] : 0.0f;
      float b = tid < kThreads / 32 ? part[tid][1] : 0.0f;
      a = warp_sum(a);
      b = warp_sum(b);
      if (tid == 0) {
        total[0] = a;
        total[1] = b;
      }
    }
    __syncthreads();
    const float r = rsqrtf(total[0] / (float)d + eps);
    const float coef = r * r * r * (total[1] / (float)d);
    T* out = dx + row * d;
    for (int c = first; c < d; c += kThreads * W) {
      float buf[W];
#pragma unroll
      for (int i = 0; i < W; ++i) {
        const float xv = xs[c + i], gv = gs[c + i];
        buf[i] = r * gv * scale[c + i] - xv * coef;
        acc[c + i] += gv * xv * r;
      }
      if constexpr (VEC) {
        Vec16<T>::store(out + c, buf);
      } else {
        out[c] = from_f32<T>(buf[0]);
      }
    }
  }
  float* mine = partial + (int64_t)blockIdx.x * d;
  for (int c = first; c < d; c += kThreads * W)
#pragma unroll
    for (int i = 0; i < W; ++i) mine[c + i] = acc[c + i];
}

// dscale[c] = the blocks' partials of column c.  A block owns 32 columns; its
// eight warps each sum every eighth partial row of them, in order (a warp
// reads 128 neighbouring bytes a row), and warp 0 adds the eight sums in
// order: a fixed order whatever the timing.
constexpr int kRedCols = 32;
constexpr int kRedRows = kThreads / kRedCols;

__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_reduce_kernel(const float* __restrict__ partial, float* __restrict__ dscale, int blocks,
                          int d) {
  __shared__ float part[kRedRows][kRedCols + 1];
  const int tx = threadIdx.x % kRedCols;
  const int ty = threadIdx.x / kRedCols;
  const int c = blockIdx.x * kRedCols + tx;
  float s = 0.0f;
  if (c < d)
    for (int b = ty; b < blocks; b += kRedRows) s += partial[(int64_t)b * d + c];
  part[ty][tx] = s;
  __syncthreads();
  if (ty == 0 && c < d) {
    float total = 0.0f;
#pragma unroll
    for (int r = 0; r < kRedRows; ++r) total += part[r][tx];
    dscale[c] = total;
  }
}

template <typename T, bool VEC>
cudaError_t launch_bwd_rows(const void* x, const void* scale, const void* dy, void* dx,
                            void* partial, int64_t n, int d, float eps, int blocks,
                            cudaStream_t stream) {
  const size_t smem = (size_t)3 * d * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(rmsnorm_bwd_kernel<T, VEC>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  rmsnorm_bwd_kernel<T, VEC><<<(unsigned)blocks, kThreads, smem, stream>>>(
      (const T*)x, (const float*)scale, (const T*)dy, (T*)dx, (float*)partial, n, d, eps);
  return cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* x, const void* scale, const void* dy, void* dx, void* dscale,
               void* partial, int64_t n, int d, float eps, int vec, int blocks,
               cudaStream_t stream) {
  cudaError_t e = vec ? launch_bwd_rows<T, true>(x, scale, dy, dx, partial, n, d, eps, blocks, stream)
                      : launch_bwd_rows<T, false>(x, scale, dy, dx, partial, n, d, eps, blocks, stream);
  if (e != cudaSuccess) return (int)e;
  rmsnorm_bwd_reduce_kernel<<<(unsigned)((d + kRedCols - 1) / kRedCols), kThreads, 0, stream>>>(
      (const float*)partial, (float*)dscale, blocks, d);
  return (int)cudaGetLastError();
}

// One wave: as many blocks as the card's SMs hold at once, at most one a row.
// The wave's size is asked of the runtime once a device and kept.
template <typename T, int NT>
int launch_reg(const void* x, const void* scale, void* y, int64_t n, int d, float eps,
               cudaStream_t stream) {
  constexpr int kDevices = 64;
  static int64_t wave[kDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kDevices) return -3;
  if (wave[dev] == 0) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rmsnorm_reg_kernel<T, NT>, NT, 0);
    if (e != cudaSuccess) return (int)e;
    wave[dev] = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  }
  rmsnorm_reg_kernel<T, NT><<<(unsigned)(n < wave[dev] ? n : wave[dev]), NT, 0, stream>>>(
      (const T*)x, (const float*)scale, (T*)y, n, d, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* scale, void* y, int64_t n, int d, float eps, int vec,
           cudaStream_t stream) {
  if (vec && d <= 128 * kElems) {
    if (d <= 32 * kElems) return launch_reg<T, 32>(x, scale, y, n, d, eps, stream);
    if (d <= 64 * kElems) return launch_reg<T, 64>(x, scale, y, n, d, eps, stream);
    return launch_reg<T, 128>(x, scale, y, n, d, eps, stream);
  }
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
// 16-byte aligned; such rows of up to 128 * kElems elements take
// rmsnorm_reg_kernel, every other row rmsnorm_kernel.  Returns
// cudaGetLastError() of the launch (or of the occupancy query), -1 for a bad
// dtype, -3 for a device index past the kept table.
extern "C" int rmsnorm_launch(const void* x, const void* scale, void* y, int64_t n, int d,
                              float eps, int dtype, int vec, void* stream) {
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == DT_F32) return launch<float>(x, scale, y, n, d, eps, vec, s);
  if (dtype == DT_BF16) return launch<__nv_bfloat16>(x, scale, y, n, d, eps, vec, s);
  return -1;
}

// The backward.  x, dy, dx: (n, d) contiguous in `dtype`; scale: (d,) f32;
// dscale: (d,) f32; partial: (blocks, d) f32 scratch, one row a block of the
// grid, 1 <= blocks <= n.  vec != 0 promises that d is a multiple of 16 bytes'
// worth of elements and that x, dy, dx and scale are 16-byte aligned.
// Returns cudaGetLastError() of the launches, -1 for a bad dtype, -4 for a bad
// grid.
extern "C" int rmsnorm_bwd_launch(const void* x, const void* scale, const void* dy, void* dx,
                                  void* dscale, void* partial, int64_t n, int d, float eps,
                                  int dtype, int vec, int blocks, void* stream) {
  if (n == 0) return 0;
  if (blocks < 1 || blocks > n) return -4;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == DT_F32)
    return launch_bwd<float>(x, scale, dy, dx, dscale, partial, n, d, eps, vec, blocks, s);
  if (dtype == DT_BF16)
    return launch_bwd<__nv_bfloat16>(x, scale, dy, dx, dscale, partial, n, d, eps, vec, blocks, s);
  return -1;
}
