// One query a (batch, head) against a ring KV cache (decode, T == 1).
//
// Replaces the TPU kernel repro/kernels/decode_attention.py::_decode_kernel,
// whose grid (batch*heads, kv blocks) streams the cache through VMEM in order
// and carries m, l and the accumulator from one grid step to the next.  The
// work is bound by bytes: K and V are each read once and everything else is
// small.  So that a small batch still fills the card, the ring is cut into
// slices: one block owns (batch, kv head, slice), reads its K and V tiles once
// with 16-byte loads, serves all `group` query heads of that kv head from that
// one read, and writes a partial (m, l, acc) to scratch.  A second kernel
// merges the slices.  A slot is valid by the VALUE in kv_pos (>= 0, <= q_pos,
// inside the window), never by its index, because a ring leaves positions in
// any slot order.  Masked scores are the reference's finite NEG_INF, so no
// slice is skipped for holding no valid slot: a query with no valid key at all
// gets the mean of V over every slot, as the plain version gives it.
#include "common.cuh"

namespace {

constexpr int TN = 64;   // slots a tile
constexpr int NT = 128;  // threads a block
constexpr int GC = 4;    // query heads that share one pass over a V tile

struct Strides {
  int64_t qb, qh;      // q (B, 1, Hq, D)
  int64_t kb, ks, kh;  // k (B, S, Hkv, D)
  int64_t vb, vs, vh;
};

__host__ __device__ inline int padded_heads(int G) { return (G + GC - 1) / GC * GC; }

template <int D>
__host__ __device__ inline int partial_smem_floats(int G) {
  return TN * (D + 4) + 2 * G * D + padded_heads(G) * TN + 3 * G + TN;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const int* __restrict__ q_pos, const int* __restrict__ kv_pos,
                      float* __restrict__ part_acc, float* __restrict__ part_m,
                      float* __restrict__ part_l, int B, int S, int Hq, int G, int window,
                      float scale, int tiles_per_split, Strides st) {
  constexpr int LD = D + 4;
  extern __shared__ __align__(16) float smem[];
  const int Gp = padded_heads(G);
  float* sKV = smem;              // (TN, LD): the K tile, then the V tile
  float* sQ = sKV + TN * LD;      // (G, D), scaled
  float* sAcc = sQ + G * D;       // (G, D)
  float* sS = sAcc + G * D;       // (Gp, TN): scores, then probabilities; rows >= G stay 0
  float* sM = sS + Gp * TN;       // (G,)
  float* sL = sM + G;
  float* sAlpha = sL + G;
  int* sMask = reinterpret_cast<int*>(sAlpha + G);  // (TN,): 0 past S, 1 masked, 2 valid

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int split = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;

  for (int i = tid; i < G * D; i += NT) {
    const int g = i / D;
    const int d = i % D;
    sQ[i] = to_f32(q[b * st.qb + (int64_t)(kvh * G + g) * st.qh + d]) * scale;
    sAcc[i] = 0.0f;
  }
  for (int i = tid; i < Gp * TN; i += NT) sS[i] = 0.0f;
  for (int g = tid; g < G; g += NT) {
    sM[g] = NEG_INF;
    sL[g] = 0.0f;
  }
  const int qp = q_pos[b];

  const int ntiles = (S + TN - 1) / TN;
  const int t0 = split * tiles_per_split;
  const int t1 = min(t0 + tiles_per_split, ntiles);
  for (int t = t0; t < t1; ++t) {
    const int s0 = t * TN;
    __syncthreads();  // the last tile's V is used up (and, the first time, the set-up is visible)
    load_tile_f32<T, D, LD>(sKV, k + b * st.kb + (int64_t)s0 * st.ks + kvh * st.kh, st.ks, TN,
                            S - s0, 1.0f, tid, NT);
    if (tid < TN) {
      const int slot = s0 + tid;
      int code = 0;
      if (slot < S) {
        const int p = kv_pos[(int64_t)b * S + slot];
        const bool ok = p >= 0 && p <= qp && (window <= 0 || p > qp - window);
        code = ok ? 2 : 1;
      }
      sMask[tid] = code;
    }
    __syncthreads();

    // scores: one (slot, head) pair a thread
    for (int i = tid; i < G * TN; i += NT) {
      const int j = i % TN;
      const int g = i / TN;
      const float* kr = sKV + j * LD;
      const float* qr = sQ + g * D;
      float dot = 0.0f;
#pragma unroll 8
      for (int d = 0; d < D; d += 4) {
        const float4 kk = *reinterpret_cast<const float4*>(kr + d);
        const float4 qq = *reinterpret_cast<const float4*>(qr + d);
        dot = fmaf(qq.x, kk.x, dot);
        dot = fmaf(qq.y, kk.y, dot);
        dot = fmaf(qq.z, kk.z, dot);
        dot = fmaf(qq.w, kk.w, dot);
      }
      const int code = sMask[j];
      sS[g * TN + j] = code == 2 ? dot : (code == 1 ? NEG_INF : -INFINITY);
    }
    __syncthreads();  // the K tile is used up

    load_tile_f32<T, D, LD>(sKV, v + b * st.vb + (int64_t)s0 * st.vs + kvh * st.vh, st.vs, TN,
                            S - s0, 1.0f, tid, NT);
    // online softmax over the tile: one warp a head
    for (int g = warp; g < G; g += NT / 32) {
      const float a0 = sS[g * TN + lane];
      const float a1 = sS[g * TN + lane + 32];
      const float m_old = sM[g];
      const float l_old = sL[g];
      const float mx = warp_max(fmaxf(a0, a1));
      const float m_new = fmaxf(m_old, mx);
      const float p0 = expf(a0 - m_new);
      const float p1 = expf(a1 - m_new);
      const float sum = warp_sum(p0 + p1);
      sS[g * TN + lane] = p0;
      sS[g * TN + lane + 32] = p1;
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        sAlpha[g] = alpha;
        sM[g] = m_new;
        sL[g] = l_old * alpha + sum;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V: one (column, group of GC heads) a thread
    const int nchunks = Gp / GC;
    for (int i = tid; i < nchunks * D; i += NT) {
      const int d = i % D;
      const int g0 = (i / D) * GC;
      float a[GC];
#pragma unroll
      for (int u = 0; u < GC; ++u) a[u] = 0.0f;
#pragma unroll 8
      for (int j = 0; j < TN; ++j) {
        const float vv = sKV[j * LD + d];
#pragma unroll
        for (int u = 0; u < GC; ++u) a[u] = fmaf(sS[(g0 + u) * TN + j], vv, a[u]);
      }
#pragma unroll
      for (int u = 0; u < GC; ++u) {
        const int g = g0 + u;
        if (g < G) sAcc[g * D + d] = sAcc[g * D + d] * sAlpha[g] + a[u];
      }
    }
  }
  __syncthreads();

  const int64_t row0 = ((int64_t)split * B + b) * Hq + kvh * G;
  for (int i = tid; i < G * D; i += NT) part_acc[row0 * D + i] = sAcc[i];
  for (int g = tid; g < G; g += NT) {
    part_m[row0 + g] = sM[g];
    part_l[row0 + g] = sL[g];
  }
}

// One block a (batch, head), one thread a column: weighs every slice's partial
// by exp(m_slice - m) and divides by the merged l (>= 1, so never 0).
template <typename T>
__global__ void decode_merge_kernel(const float* __restrict__ part_acc,
                                    const float* __restrict__ part_m,
                                    const float* __restrict__ part_l, T* __restrict__ o,
                                    int nsplit, int64_t BH, int D) {
  const int64_t bh = blockIdx.x;
  const int d = threadIdx.x;
  float m = NEG_INF;
  for (int s = 0; s < nsplit; ++s) m = fmaxf(m, part_m[s * BH + bh]);
  float l = 0.0f, a = 0.0f;
  for (int s = 0; s < nsplit; ++s) {
    const float w = expf(part_m[s * BH + bh] - m);
    l += part_l[s * BH + bh] * w;
    a += part_acc[(s * BH + bh) * D + d] * w;
  }
  o[bh * D + d] = from_f32<T>(a / l);
}

struct Args {
  const void *q, *k, *v, *q_pos, *kv_pos;
  void *o, *part_acc, *part_m, *part_l;
  int B, S, Hq, Hkv, window;
  float scale;
  int nsplit, tiles_per_split;
  Strides st;
  cudaStream_t stream;
};

template <typename T, int D>
int launch(const Args& a) {
  const int G = a.Hq / a.Hkv;
  const int smem = partial_smem_floats<D>(G) * (int)sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(decode_partial_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(a.nsplit, a.Hkv, a.B);
  decode_partial_kernel<T, D><<<grid, NT, smem, a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const int*)a.q_pos, (const int*)a.kv_pos,
      (float*)a.part_acc, (float*)a.part_m, (float*)a.part_l, a.B, a.S, a.Hq, G, a.window, a.scale,
      a.tiles_per_split, a.st);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  decode_merge_kernel<T><<<(unsigned)(a.B * a.Hq), D, 0, a.stream>>>(
      (const float*)a.part_acc, (const float*)a.part_m, (const float*)a.part_l, (T*)a.o, a.nsplit,
      (int64_t)a.B * a.Hq, D);
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

// q (B, 1, Hq, D) with element strides (batch, head); k and v (B, S, Hkv, D)
// with element strides (batch, slot, head); unit stride along D and 16-byte
// aligned rows of k and v; q_pos (B,) and kv_pos (B, S) contiguous int32;
// o (B, 1, Hq, D) contiguous.  Scratch, all f32: part_acc (nsplit, B, Hq, D),
// part_m and part_l (nsplit, B, Hq), where nsplit * tiles_per_split * 64 >= S.
// window <= 0 means no window.  Returns cudaGetLastError() of the launches,
// -1 for a bad dtype, -2 for a head size without a template.
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* q_pos, const void* kv_pos, void* o,
                                       void* part_acc, void* part_m, void* part_l, int B, int S,
                                       int Hq, int Hkv, int D, int window, float scale, int nsplit,
                                       int tiles_per_split, int dtype, int64_t qsb, int64_t qsh,
                                       int64_t ksb, int64_t kss, int64_t ksh, int64_t vsb,
                                       int64_t vss, int64_t vsh, void* stream) {
  if (B == 0) return 0;
  const Args a{q, k, v, q_pos, kv_pos, o, part_acc, part_m, part_l, B, S, Hq, Hkv, window,
               scale, nsplit, tiles_per_split, {qsb, qsh, ksb, kss, ksh, vsb, vss, vsh},
               (cudaStream_t)stream};
  if (dtype == DT_F32) return launch_d<float>(a, D);
  if (dtype == DT_BF16) return launch_d<__nv_bfloat16>(a, D);
  return -1;
}
