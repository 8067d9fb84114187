// Shared helpers of the Hopper kernels: element types, 16-byte global loads
// into f32, cp.async copies into shared memory, warp reductions, and the
// ldmatrix / mma.sync fragments of bf16 tensor-core products.  Every kernel
// keeps f32 inside and rounds once, on the store, to the tensor's own type.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// Finite on purpose: a row whose every key is masked gets the uniform mean of
// V (exp(0) = 1 for every key), exactly as the plain versions compute it.
#define NEG_INF (-1073741824.0f)  // -2**30

// dtype codes shared with the Python wrappers
#define DT_F32 0
#define DT_BF16 1

template <typename T>
struct Vec16;  // how many T fill 16 bytes, and how to widen them to f32 and narrow them back

template <>
struct Vec16<float> {
  static constexpr int N = 4;
  __device__ static void unpack(const uint4& raw, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(&raw);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
  __device__ static uint4 pack(const float* in) {
    const float4 v = make_float4(in[0], in[1], in[2], in[3]);
    return *reinterpret_cast<const uint4*>(&v);
  }
  __device__ static void load(const float* p, float* out) { unpack(*reinterpret_cast<const uint4*>(p), out); }
  __device__ static void store(float* p, const float* in) { *reinterpret_cast<uint4*>(p) = pack(in); }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void unpack(const uint4& raw, float* out) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ static uint4 pack(const float* in) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
    return raw;
  }
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    unpack(*reinterpret_cast<const uint4*>(p), out);
  }
  __device__ static void store(__nv_bfloat16* p, const float* in) {
    *reinterpret_cast<uint4*>(p) = pack(in);
  }
};

__device__ inline float to_f32(float x) { return x; }
__device__ inline float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ inline T from_f32(float x);
template <>
__device__ inline float from_f32<float>(float x) { return x; }
template <>
__device__ inline __nv_bfloat16 from_f32<__nv_bfloat16>(float x) { return __float2bfloat16_rn(x); }

// Copies `rows` rows of D contiguous elements (row r starts at src + r*stride;
// rows at or past `valid_rows` become zeros) into f32 shared memory with row
// stride LD.  16-byte global loads, neighbouring threads on neighbouring chunks.
template <typename T, int D, int LD>
__device__ inline void load_tile_f32(float* dst, const T* src, int64_t stride, int rows,
                                     int valid_rows, float mul, int tid, int nthreads) {
  constexpr int V = Vec16<T>::N;
  constexpr int CPR = D / V;  // chunks per row
  for (int c = tid; c < rows * CPR; c += nthreads) {
    const int r = c / CPR;
    const int col = (c % CPR) * V;
    float buf[V];
    if (r < valid_rows) {
      Vec16<T>::load(src + (int64_t)r * stride + col, buf);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) buf[i] = 0.0f;
    }
    float* out = dst + r * LD + col;
#pragma unroll
    for (int i = 0; i < V; i += 4) {
      *reinterpret_cast<float4*>(out + i) =
          make_float4(buf[i] * mul, buf[i + 1] * mul, buf[i + 2] * mul, buf[i + 3] * mul);
    }
  }
}

// Asynchronous copies from global to shared memory (cp.async, sm_80 and later).
__device__ inline uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, without passing through registers;
// with `valid` false nothing is read and the 16 bytes become zeros.
__device__ inline void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes from global to shared memory (cp.async.ca: .cg takes 16 only);
// with `valid` false nothing is read and the 4 bytes become zeros.
__device__ inline void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// ROWS rows of D bf16 (row r at src + r*stride) into shared memory with row
// stride LD, NT threads 16 bytes each a chunk; rows at or past `valid` become zeros.
template <int ROWS, int NT, int D, int LD>
__device__ inline void cp_async_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                     int64_t stride, int valid, int tid) {
  constexpr int CPR = D / 8;  // chunks a row
#pragma unroll
  for (int i = 0; i < ROWS * CPR / NT; ++i) {
    const int c = tid + i * NT;
    const int r = c / CPR;
    const int col = (c % CPR) * 8;
    const bool ok = r < valid;
    cp_async16(smem_addr(dst + r * LD + col), src + (ok ? (int64_t)r * stride + col : 0), ok);
  }
}

template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Programmatic dependent launch (sm_90): let the next kernel in the stream,
// launched with programmatic stream serialization, start its blocks; and wait
// until the kernels this one may have overlapped have ended and their writes
// are visible (at once where the launch was an ordinary one).
__device__ inline void launch_dependents() { asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory"); }
__device__ inline void grid_dependency_wait() { asm volatile("griddepcontrol.wait;\n" ::: "memory"); }

__device__ inline float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ inline float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ---------------------------------------------------------------------------
// bf16 tensor-core products (mma.sync m16n8k16, f32 sums)
// ---------------------------------------------------------------------------

// Four 8 x 8 bf16 matrices; lanes 8i..8i+7 give the row addresses of matrix i,
// and register i of lane l gets row l/4, columns 2(l%4) and 2(l%4)+1 of it
// (with .trans: of its transpose).
__device__ inline void ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ inline void ldmatrix_x4_trans(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// c (16 x 8, f32) += a (16 x 16, bf16, row-major) * b (16 x 8, bf16, column-major).
// Lane l = 4g + t holds c at rows g and g+8, columns 2t and 2t+1.
__device__ inline void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ inline uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&p);
}
