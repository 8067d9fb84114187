// Blocked attention forward with an online softmax (prefill, T > 1).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::_flash_kernel,
// whose grid (batch*heads, q blocks, kv blocks) walks the kv axis innermost
// and carries m, l and the accumulator in VMEM from one grid step to the next.
// Blocks of a CUDA grid run in no order, so here the kv axis is a loop inside
// the block: one block owns 64 query rows of one (batch, head) and keeps m, l
// and its share of the 64 x D accumulator in registers.  Q (scaled in f32
// before the product, as the reference does), the K tile and the V tile sit in
// shared memory as f32; the 64 x 64 probabilities reuse the K tile's room, so
// two blocks fit on an SM.  Each thread computes a 4 x 4 patch of the scores
// and 4 x D/16 of the output.  The work is bound by operations (4*T*S*D a
// head, half when causal); this first version multiplies on the CUDA cores in
// f32, for f32 and bf16 inputs alike, and leaves the tensor cores to a later
// change.  It reads (B, T, H, D) through strides, masks its own ragged edge in
// T and S, and when causal stops at the diagonal tile.
#include "common.cuh"

namespace {

constexpr int BM = 64;   // query rows a block
constexpr int BN = 64;   // keys a tile
constexpr int NT = 256;  // threads: 16 x 16, thread (ty, tx) owns rows ty*4+i, columns tx+16*j
constexpr int LDP = BN + 4;

template <int D>
struct Layout {
  static constexpr int LDQ = D + 4;  // 16-byte aligned rows, conflict-free float4 reads
  static constexpr int KP = (BN * LDQ > BM * LDP) ? BN * LDQ : BM * LDP;  // K tile, then P
  static constexpr int FLOATS = BM * LDQ + KP + BN * D;
};

__device__ inline float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ inline float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT, 2)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ o, int Tq, int S, int Hq, int group, float scale, int causal,
             int64_t qsb, int64_t qst, int64_t qsh, int64_t ksb, int64_t kst, int64_t ksh,
             int64_t vsb, int64_t vst, int64_t vsh) {
  using L = Layout<D>;
  constexpr int LDQ = L::LDQ;
  constexpr int DC = D / 16;  // output columns a thread
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sK = sQ + BM * LDQ;
  float* sP = sK;  // the probabilities take the K tile's place once the scores are done
  float* sV = sK + L::KP;

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  // the longest rows of a causal head first
  const int qi = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / group;
  const int q0 = qi * BM;

  load_tile_f32<T, D, LDQ>(sQ, q + b * qsb + (int64_t)q0 * qst + h * qsh, qst, BM, Tq - q0, scale,
                           tid, NT);

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.0f;
  }

  int nkv = (S + BN - 1) / BN;
  if (causal && qi + 1 < nkv) nkv = qi + 1;  // BM == BN: the diagonal tile is tile qi

  for (int kt = 0; kt < nkv; ++kt) {
    const int k0 = kt * BN;
    load_tile_f32<T, D, LDQ>(sK, k + b * ksb + (int64_t)k0 * kst + kvh * ksh, kst, BN, S - k0, 1.0f,
                             tid, NT);
    load_tile_f32<T, D, D>(sV, v + b * vsb + (int64_t)k0 * vst + kvh * vsh, vst, BN, S - k0, 1.0f,
                           tid, NT);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;

#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(sQ + (ty * 4 + i) * LDQ + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(sK + (tx + 16 * j) * LDQ + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    // A key past S is no key at all (-inf: weight exactly 0).  A key the causal
    // mask hides keeps the reference's finite NEG_INF.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        if (col >= S) {
          s[i][j] = -INFINITY;
        } else if (causal && col > row) {
          s[i][j] = NEG_INF;
        }
      }
    }

    // online softmax; the 16 threads that share a row sit in one half warp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
      mx = half_warp_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
      rs = half_warp_sum(rs);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }

    __syncthreads();  // every thread is done with the K tile
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sP[(ty * 4 + i) * LDP + tx + 16 * j] = s[i][j];
    __syncthreads();

#pragma unroll 2
    for (int s4 = 0; s4 < BN; s4 += 4) {
      float p[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 t = *reinterpret_cast<const float4*>(sP + (ty * 4 + i) * LDP + s4);
        p[i][0] = t.x; p[i][1] = t.y; p[i][2] = t.z; p[i][3] = t.w;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const float vv = sV[(s4 + u) * D + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i][u], vv, acc[i][c]);
        }
      }
    }
    __syncthreads();  // before the next tile overwrites K/P and V
  }

  // Every row has seen at least one key at its running maximum, so l >= 1.
  // Stage the tile in Q's room so that the store is 16 bytes a thread.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float inv = 1.0f / l[i];
#pragma unroll
    for (int c = 0; c < DC; ++c) sQ[(ty * 4 + i) * LDQ + tx + 16 * c] = acc[i][c] * inv;
  }
  __syncthreads();
  constexpr int V = Vec16<T>::N;
  constexpr int CPR = D / V;
  T* ob = o + ((int64_t)b * Tq * Hq + h) * D;
  for (int c = tid; c < BM * CPR; c += NT) {
    const int r = c / CPR;
    const int col = (c % CPR) * V;
    if (q0 + r < Tq) {
      float buf[V];
#pragma unroll
      for (int i = 0; i < V; ++i) buf[i] = sQ[r * LDQ + col + i];
      Vec16<T>::store(ob + (int64_t)(q0 + r) * Hq * D + col, buf);
    }
  }
}

struct Args {
  const void *q, *k, *v;
  void* o;
  int B, Tq, S, Hq, Hkv;
  float scale;
  int causal;
  int64_t qs[3], ks[3], vs[3];
  cudaStream_t stream;
};

template <typename T, int D>
int launch(const Args& a) {
  constexpr int smem = Layout<D>::FLOATS * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(flash_kernel<T, D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.Tq + BM - 1) / BM, a.Hq, a.B);
  flash_kernel<T, D><<<grid, NT, smem, a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (T*)a.o, a.Tq, a.S, a.Hq, a.Hq / a.Hkv, a.scale,
      a.causal, a.qs[0], a.qs[1], a.qs[2], a.ks[0], a.ks[1], a.ks[2], a.vs[0], a.vs[1], a.vs[2]);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const Args& a, int D) {
  if (D == 32) return launch<T, 32>(a);
  if (D == 64) return launch<T, 64>(a);
  if (D == 128) return launch<T, 128>(a);
  return -2;
}

}  // namespace

// q (B, T, Hq, D), k and v (B, S, Hkv, D) with element strides (batch, time,
// head) and a unit stride along D; o (B, T, Hq, D) contiguous.  Every row of
// q, k and v must start on a 16-byte boundary.  Returns cudaGetLastError() of
// the launch, -1 for a bad dtype, -2 for a head size without a template.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o, int B,
                                      int Tq, int S, int Hq, int Hkv, int D, float scale,
                                      int causal, int dtype, int64_t qsb, int64_t qst, int64_t qsh,
                                      int64_t ksb, int64_t kst, int64_t ksh, int64_t vsb,
                                      int64_t vst, int64_t vsh, void* stream) {
  if (B == 0 || Tq == 0) return 0;
  const Args a{q, k, v, o, B, Tq, S, Hq, Hkv, scale, causal,
               {qsb, qst, qsh}, {ksb, kst, ksh}, {vsb, vst, vsh}, (cudaStream_t)stream};
  if (dtype == DT_F32) return launch_d<float>(a, D);
  if (dtype == DT_BF16) return launch_d<__nv_bfloat16>(a, D);
  return -1;
}
