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
// The backward: with g = dy * scale and r = rsqrt(mean(x^2) + eps),
// dx = r g - x r^3 mean(g x) and dscale = sum over rows of dy x r.  It is the
// port's counterpart of what XLA derives for the reference's jnp rmsnorm; the
// TPU kernel has no backward.  Bound by bytes: x and dy read once, dx written
// once.  r is recomputed from x in the same pass (the backward reads x
// anyway), so the forward saves nothing.  A one-wave grid of blocks walks the
// rows (row = blockIdx.x, + gridDim.x, ...), and each block adds dy x r of its
// rows into its own f32 dscale partial, one partial row a block; a second
// kernel sums the partials in a fixed order: no float atomics, so every run
// gives the same bits.  The first kernel is one of two, chosen by shape:
//
// - rmsnorm_bwd_reg_kernel<T, NT> (rows the forward's register kernel takes:
//   whole 16-byte chunks, up to 4096 elements, x, dy, dx and scale aligned;
//   d_model 4096 in bf16 is 128 threads of 32 elements, in f32 256 threads of
//   16).  Each thread holds kBwdChunks chunks of the current row of x and of
//   dy as raw 16-byte words (chunk c = tid + i * NT, as the forward) and
//   issues the next row's loads before it reduces and writes the current
//   one.  Its columns' scale and dscale partial stay in f32 registers across
//   every row the block owns.  sum(x^2) and sum(g x) go through warp shuffles
//   together, one pair a warp in shared memory, two slots alternating by row:
//   one barrier a row.  The grid is as many blocks as the SMs hold at once
//   (asked of the runtime once a device), evened out so that every block
//   walks the same number of rows but the last.
// - rmsnorm_bwd_kernel<T, VEC> (every other row: d not a whole number of
//   16-byte chunks, an unaligned pointer, a row past 4096 elements): a block
//   keeps its row of x and dy as f32 in shared memory while it reduces, and
//   its partial there too, one column a thread; kBwdBlocksPerSm blocks an SM.
//
// rmsnorm_bwd_reduce_kernel<V4> then gives a block 16 columns: four threads
// across them, 16 bytes each, and 64 row lanes down the partials.  A lane
// issues the loads of kRedBatch partial rows before it adds them, in row
// order; the lanes of a warp meet by shuffles, the warps in order.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // rmsnorm_kernel
constexpr int kElems = 32;     // rmsnorm_reg_kernel: elements of a row a thread holds, at most
constexpr int kRegRow = 128 * kElems;  // the longest row the register kernels take
constexpr int kBwdChunks = 4;  // rmsnorm_bwd_reg_kernel: 16-byte chunks of x (and of dy) a thread holds
constexpr int kBwdBlocksPerSm = 4;  // rmsnorm_bwd_kernel: 48 KB of shared memory a block at d 4096
constexpr int kDevices = 64;   // devices whose wave sizes are kept

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

template <typename T, int NT>
__global__ void __launch_bounds__(NT)
rmsnorm_bwd_reg_kernel(const T* __restrict__ x, const float* __restrict__ scale, const T* __restrict__ dy,
                       T* __restrict__ dx, float* __restrict__ partial, int64_t n, int d, float eps) {
  constexpr int V = Vec16<T>::N;
  constexpr int NV = kBwdChunks;
  constexpr int NW = NT / 32;
  __shared__ float2 red[2][NW];
  const int tid = threadIdx.x;
  const int chunks = d / V;

  float sc[NV][V], acc[NV][V];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = tid + i * NT;
#pragma unroll
    for (int j = 0; j < V; j += 4) {
      const float4 s4 = c < chunks ? *reinterpret_cast<const float4*>(scale + c * V + j)
                                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      sc[i][j] = s4.x; sc[i][j + 1] = s4.y; sc[i][j + 2] = s4.z; sc[i][j + 3] = s4.w;
    }
#pragma unroll
    for (int j = 0; j < V; ++j) acc[i][j] = 0.0f;
  }

  uint4 cx[NV], cg[NV], nx[NV], ng[NV];
  auto fetch = [&](int64_t row, uint4* bx, uint4* bg) {
    const uint4* sx = reinterpret_cast<const uint4*>(x + row * d);
    const uint4* sg = reinterpret_cast<const uint4*>(dy + row * d);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = tid + i * NT;
      const uint4 zero = make_uint4(0u, 0u, 0u, 0u);  // zeros add nothing to the sums
      bx[i] = c < chunks ? sx[c] : zero;
      bg[i] = c < chunks ? sg[c] : zero;
    }
  };

  int64_t row = blockIdx.x;
  if (row < n) fetch(row, cx, cg);
  for (int it = 0; row < n; row += gridDim.x, ++it) {
    const int64_t next = row + gridDim.x;
    if (next < n) fetch(next, nx, ng);  // in flight while this row is reduced and written

    float ss = 0.0f, gx = 0.0f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      float xv[V], gv[V];
      Vec16<T>::unpack(cx[i], xv);
      Vec16<T>::unpack(cg[i], gv);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        ss += xv[j] * xv[j];
        gx += gv[j] * sc[i][j] * xv[j];
      }
    }
    ss = warp_sum(ss);
    gx = warp_sum(gx);
    if ((tid & 31) == 0) red[it & 1][tid >> 5] = make_float2(ss, gx);
    __syncthreads();
    float tss = 0.0f, tgx = 0.0f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      tss += red[it & 1][w].x;
      tgx += red[it & 1][w].y;
    }
    const float r = rsqrtf(tss / (float)d + eps);
    const float coef = r * r * r * (tgx / (float)d);

    uint4* out = reinterpret_cast<uint4*>(dx + row * d);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = tid + i * NT;
      if (c < chunks) {
        float xv[V], gv[V], o[V];
        Vec16<T>::unpack(cx[i], xv);
        Vec16<T>::unpack(cg[i], gv);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          o[j] = r * gv[j] * sc[i][j] - xv[j] * coef;
          acc[i][j] += gv[j] * xv[j] * r;
        }
        out[c] = Vec16<T>::pack(o);
      }
    }
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      cx[i] = nx[i];
      cg[i] = ng[i];
    }
  }
  float* mine = partial + (int64_t)blockIdx.x * d;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = tid + i * NT;
    if (c < chunks)
#pragma unroll
      for (int j = 0; j < V; j += 4)
        *reinterpret_cast<float4*>(mine + c * V + j) =
            make_float4(acc[i][j], acc[i][j + 1], acc[i][j + 2], acc[i][j + 3]);
  }
}

// dscale[c] = the blocks' partials of column c.  A block owns kRedCols
// columns: thread (tx, ty) sums 4 of them (16 bytes a partial row, with V4)
// down the partial rows ty, ty + kRedLanes, ..., in that order, issuing
// kRedBatch rows' loads before it adds them; then the 8 row lanes of a warp
// meet by shuffles and the 8 warps' sums are added in order by the first
// kRedTx threads: a fixed order whatever the timing.
constexpr int kRedTx = 4;
constexpr int kRedCols = 4 * kRedTx;
constexpr int kRedLanes = kThreads / kRedTx;
constexpr int kRedBatch = 8;

template <bool V4>
__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_reduce_kernel(const float* __restrict__ partial, float* __restrict__ dscale, int blocks,
                          int d) {
  __shared__ float4 part[kThreads / 32][kRedTx];
  const int tx = threadIdx.x % kRedTx;
  const int ty = threadIdx.x / kRedTx;
  const int c0 = (blockIdx.x * kRedTx + tx) * 4;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float4 s = zero;
  if (c0 < d) {
    for (int b0 = ty; b0 < blocks; b0 += kRedBatch * kRedLanes) {
      float4 v[kRedBatch];
#pragma unroll
      for (int u = 0; u < kRedBatch; ++u) {
        const int b = b0 + u * kRedLanes;
        const float* p = partial + (int64_t)b * d + c0;
        if (b >= blocks) {
          v[u] = zero;
        } else if constexpr (V4) {
          v[u] = *reinterpret_cast<const float4*>(p);
        } else {
          v[u] = make_float4(p[0], c0 + 1 < d ? p[1] : 0.0f, c0 + 2 < d ? p[2] : 0.0f,
                             c0 + 3 < d ? p[3] : 0.0f);
        }
      }
#pragma unroll
      for (int u = 0; u < kRedBatch; ++u) {
        s.x += v[u].x; s.y += v[u].y; s.z += v[u].z; s.w += v[u].w;
      }
    }
  }
  // lanes tx, tx + kRedTx, ... of a warp hold the same columns
#pragma unroll
  for (int o = kRedTx; o < 32; o <<= 1) {
    s.x += __shfl_xor_sync(0xffffffffu, s.x, o);
    s.y += __shfl_xor_sync(0xffffffffu, s.y, o);
    s.z += __shfl_xor_sync(0xffffffffu, s.z, o);
    s.w += __shfl_xor_sync(0xffffffffu, s.w, o);
  }
  if ((threadIdx.x & 31) < kRedTx) part[threadIdx.x >> 5][tx] = s;
  __syncthreads();
  if (threadIdx.x < kRedTx && c0 < d) {
    float4 t = zero;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) {
      const float4 p = part[w][tx];
      t.x += p.x; t.y += p.y; t.z += p.z; t.w += p.w;
    }
    if constexpr (V4) {
      *reinterpret_cast<float4*>(dscale + c0) = t;
    } else {
      dscale[c0] = t.x;
      if (c0 + 1 < d) dscale[c0 + 1] = t.y;
      if (c0 + 2 < d) dscale[c0 + 2] = t.z;
      if (c0 + 3 < d) dscale[c0 + 3] = t.w;
    }
  }
}

// How many blocks of `kernel` (nt threads, no dynamic shared memory) the card
// holds at once, or, with per_sm > 0, that many an SM: asked of the runtime on
// a device's first call and kept in `kept`, one entry a device.  Returns 0, a
// CUDA error, or -3 for a device index past the table.
int one_wave(const void* kernel, int nt, int per_sm, int64_t* kept, int64_t* wave) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kDevices) return -3;
  if (kept[dev] == 0) {
    int sms = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess && per_sm <= 0)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, nt, 0);
    if (e != cudaSuccess) return (int)e;
    kept[dev] = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  }
  *wave = kept[dev];
  return 0;
}

// Threads a block of rmsnorm_bwd_reg_kernel for rows of d (vec: whole 16-byte
// chunks, aligned pointers), or 0 where the rows take rmsnorm_bwd_kernel.
template <typename T>
int bwd_threads(int d, int vec) {
  if (!vec || d > kRegRow) return 0;
  int nt = 32;
  while (nt * kBwdChunks * Vec16<T>::N < d) nt *= 2;
  return nt;  // bf16: 32, 64 or 128; f32: up to 256
}

template <typename T, int NT>
int reg_bwd_wave(int64_t* wave) {
  static int64_t kept[kDevices] = {};
  return one_wave((const void*)rmsnorm_bwd_reg_kernel<T, NT>, NT, 0, kept, wave);
}

// The backward's grid for n rows of d: one wave of the first kernel, evened
// out (each block walks ceil(n / wave) rows, the last block fewer), so no
// block waits on a row that a smaller grid would not; one partial row a block.
template <typename T>
int bwd_grid(int64_t n, int d, int vec, int* blocks, int* threads) {
  static int64_t kept_smem[kDevices] = {};
  const int nt = bwd_threads<T>(d, vec);
  int64_t wave = 0;
  int e = -4;
  if (nt == 0) e = one_wave((const void*)rmsnorm_bwd_kernel<T, true>, kThreads, kBwdBlocksPerSm, kept_smem, &wave);
  if (nt == 32) e = reg_bwd_wave<T, 32>(&wave);
  if (nt == 64) e = reg_bwd_wave<T, 64>(&wave);
  if (nt == 128) e = reg_bwd_wave<T, 128>(&wave);
  if constexpr (Vec16<T>::N == 4)
    if (nt == 256) e = reg_bwd_wave<T, 256>(&wave);
  if (e != 0) return e;
  const int64_t per = (n + wave - 1) / wave;
  *blocks = (int)((n + per - 1) / per);
  *threads = nt;
  return 0;
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

template <typename T, int NT>
cudaError_t launch_bwd_reg(const void* x, const void* scale, const void* dy, void* dx,
                           void* partial, int64_t n, int d, float eps, int blocks,
                           cudaStream_t stream) {
  rmsnorm_bwd_reg_kernel<T, NT><<<(unsigned)blocks, NT, 0, stream>>>(
      (const T*)x, (const float*)scale, (const T*)dy, (T*)dx, (float*)partial, n, d, eps);
  return cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* x, const void* scale, const void* dy, void* dx, void* dscale,
               void* partial, int64_t n, int d, float eps, int vec, int blocks,
               cudaStream_t stream) {
  const int nt = bwd_threads<T>(d, vec);
  cudaError_t e = cudaErrorInvalidValue;
  if (nt == 0)
    e = vec ? launch_bwd_rows<T, true>(x, scale, dy, dx, partial, n, d, eps, blocks, stream)
            : launch_bwd_rows<T, false>(x, scale, dy, dx, partial, n, d, eps, blocks, stream);
  if (nt == 32) e = launch_bwd_reg<T, 32>(x, scale, dy, dx, partial, n, d, eps, blocks, stream);
  if (nt == 64) e = launch_bwd_reg<T, 64>(x, scale, dy, dx, partial, n, d, eps, blocks, stream);
  if (nt == 128) e = launch_bwd_reg<T, 128>(x, scale, dy, dx, partial, n, d, eps, blocks, stream);
  if constexpr (Vec16<T>::N == 4)
    if (nt == 256) e = launch_bwd_reg<T, 256>(x, scale, dy, dx, partial, n, d, eps, blocks, stream);
  if (e != cudaSuccess) return (int)e;
  const unsigned red_blocks = (unsigned)((d + kRedCols - 1) / kRedCols);
  if (d % 4 == 0)
    rmsnorm_bwd_reduce_kernel<true><<<red_blocks, kThreads, 0, stream>>>((const float*)partial, (float*)dscale, blocks, d);
  else
    rmsnorm_bwd_reduce_kernel<false><<<red_blocks, kThreads, 0, stream>>>((const float*)partial, (float*)dscale, blocks, d);
  return (int)cudaGetLastError();
}

// One wave: as many blocks as the card's SMs hold at once, at most one a row.
template <typename T, int NT>
int launch_reg(const void* x, const void* scale, void* y, int64_t n, int d, float eps,
               cudaStream_t stream) {
  static int64_t kept[kDevices] = {};
  int64_t wave = 0;
  const int e = one_wave((const void*)rmsnorm_reg_kernel<T, NT>, NT, 0, kept, &wave);
  if (e != 0) return e;
  rmsnorm_reg_kernel<T, NT><<<(unsigned)(n < wave ? n : wave), NT, 0, stream>>>(
      (const T*)x, (const float*)scale, (T*)y, n, d, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* scale, void* y, int64_t n, int d, float eps, int vec,
           cudaStream_t stream) {
  if (vec && d <= kRegRow) {
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

// The backward's grid for n >= 1 rows of d: *blocks, the blocks of its first
// kernel and so the rows of the partial scratch that rmsnorm_bwd_launch wants,
// and *threads, a block's threads of rmsnorm_bwd_reg_kernel, or 0 where the
// rows take rmsnorm_bwd_kernel.  vec as for rmsnorm_bwd_launch.  The wave's
// size is asked of the runtime once a device and kept.  Returns 0, a CUDA
// error of the query, -1 for a bad dtype, -3 for a device index past the kept
// table, -4 for n < 1.
extern "C" int rmsnorm_bwd_grid(int64_t n, int d, int dtype, int vec, int* blocks, int* threads) {
  if (n < 1) return -4;
  if (dtype == DT_F32) return bwd_grid<float>(n, d, vec, blocks, threads);
  if (dtype == DT_BF16) return bwd_grid<__nv_bfloat16>(n, d, vec, blocks, threads);
  return -1;
}

// The backward.  x, dy, dx: (n, d) contiguous in `dtype`; scale: (d,) f32;
// dscale: (d,) f32; partial: (blocks, d) f32 scratch, one row a block of the
// grid, 1 <= blocks <= n (rmsnorm_bwd_grid's).  vec != 0 promises that d is a
// multiple of 16 bytes' worth of elements and that x, dy, dx and scale are
// 16-byte aligned; such rows of up to 4096 elements take
// rmsnorm_bwd_reg_kernel, every other row rmsnorm_bwd_kernel.  Returns
// cudaGetLastError() of the launches, -1 for a bad dtype, -4 for a bad grid.
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
