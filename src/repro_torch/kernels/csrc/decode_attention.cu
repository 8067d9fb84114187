// One query a (batch, head) against a ring KV cache (decode, T == 1).
//
// Replaces the TPU kernel repro/kernels/decode_attention.py::_decode_kernel,
// whose grid (batch*heads, kv blocks) streams the cache through VMEM in order
// and carries m, l and the accumulator from one grid step to the next.  The
// work is bound by bytes: one query a head against a long cache, K and V read
// once, and the `group` query heads of a kv head served from that one read.
//
// decode_partial_kernel: one block owns (batch, kv head, up to GC of its query
// heads, slice).  The ring is cut into tiles of 64 slots, and a slice takes
// them round robin (slice s reads tiles s, s + nsplit, ...), so that a ring
// that has not wrapped, whose valid slots lie in one prefix, spreads them over
// every slice.  The block first reads the slice's positions (kv_pos, 256 B a
// tile) and marks which slots are valid by VALUE (>= 0, <= q_pos, inside the
// window), never by index, because a ring leaves positions in any slot order.
// A tile with no valid slot is not read at all.  That is exact: once a row has
// one valid slot, its merged maximum m is a real score, and exp(NEG_INF - m)
// is exactly 0 in f32, so an all-masked tile adds nothing whether it is read
// or not.  The valid tiles' K and V come into STAGES shared-memory stages by
// 16-byte cp.async copies, in their own type (rows past S zero-filled), the
// next tile's copies in flight while the block computes this one; values are
// widened to f32 only as they are read out.  Lanes run along D
// (one 16-byte vector each: at D = 128 in bf16, 16 lanes a slot and two slots
// a warp step) and warps along the tile's slots.  A slot takes D / V vectors
// rounded up to a power of two lanes, so that its lanes are an aligned group
// the xor shuffles reduce and a warp step still divides a warp's 16 slots: at
// D = 80, 10 vectors in bf16 take 16 lanes (two slots a step) and 20 in f32
// take 32 (one slot a step); the lanes past D / V hold a zero query, load
// nothing and add 0 to every sum.  Each lane keeps its part of
// the scaled f32 Q of the block's heads in registers (Q is scaled first, then
// multiplied, as the reference does), and a dot product is reduced by
// shuffles.  The tile's softmax statistics are taken over all 64 scores (every
// warp computes the same m and l), and each warp adds P V for its own slots
// into f32 registers, rescaled by alpha a tile; the warps' accumulators are
// summed once, through shared memory, at the end of the slice.  The slice's
// (m, l, acc) goes to scratch; a slice with no valid tile writes the marker
// (m = -inf, l = 0, acc = 0).  Slots past S inside a read tile score -inf and
// weigh exactly 0; masked slots score the reference's finite NEG_INF.
//
// decode_merge_kernel: one block a (batch, query head) weighs each slice by
// exp(m_slice - m) and divides by the merged l.  Where every slice wrote the
// marker, the row has no valid slot at all: the reference's finite NEG_INF
// then gives the uniform mean of V over the S slots, and the merge computes
// that mean from V itself.  The test for -inf comes before any weight, since
// exp(-inf - (-inf)) is NaN.
#include "common.cuh"

namespace {

constexpr int TN = 64;              // slots a tile
constexpr int NT = 128;             // threads a block
constexpr int NW = NT / 32;         // warps a block
constexpr int SLOTS_W = TN / NW;    // slots of a tile a warp owns
constexpr int MAX_TILES = 256;      // tiles a slice at most: the size of the valid-slot table
constexpr int SCAN_U = 4;           // tiles a warp reads the positions of at once
// K and V tiles a block keeps in flight: two stages of 32 KB in bf16 at D = 128,
// so that split_plan's grid, two blocks an SM at most, runs in one wave
constexpr int STAGES = 2;
constexpr unsigned FULL = 0xffffffffu;

struct Strides {
  int64_t qb, qh;      // q (B, 1, Hq, D)
  int64_t kb, ks, kh;  // k (B, S, Hkv, D)
  int64_t vb, vs, vh;
};

template <typename T, int D, int GC>
struct Layout {
  static constexpr int V = 16 / sizeof(T);  // elements of a 16-byte vector
  static constexpr int VPR = D / V;         // 16-byte vectors a row
  // lanes a slot: VPR rounded up to a power of two
  static constexpr int LPR = VPR <= 1 ? 1 : VPR <= 2 ? 2 : VPR <= 4 ? 4 : VPR <= 8 ? 8 : VPR <= 16 ? 16 : 32;
  static constexpr int SPW = 32 / LPR;      // slots a warp step
  static constexpr int TILE = TN * D;       // elements of one K or V tile
  static constexpr int KV_BYTES = STAGES * 2 * TILE * (int)sizeof(T);
  static constexpr int BYTES = KV_BYTES + GC * TN * (int)sizeof(float);
  static_assert(D % V == 0 && VPR <= 32 && SLOTS_W % SPW == 0, "a slot's row must fit in a warp");
  static_assert(TN * VPR % NT == 0, "a tile's 16-byte copies split evenly over the block's threads");
  static_assert(NW * GC * D * (int)sizeof(float) <= KV_BYTES, "the warps' sums reuse the stages");
};

// The lane's 16-byte vector of a row in shared memory, widened to f32; zeros
// on a lane past the row's vectors, which reads nothing.
template <typename T, int V>
__device__ inline void load_or_zero(const T* p, bool on, float (&out)[V]) {
  if (on) {
    Vec16<T>::load(p, out);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) out[e] = 0.0f;
  }
}

// The first tile at or after i that holds a valid slot, or n.
__device__ inline int next_valid(const unsigned long long* valid, int i, int n) {
  while (i < n && valid[i] == 0ull) ++i;
  return i;
}

template <typename T, int D, int GC>
__global__ void __launch_bounds__(NT)
decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const int* __restrict__ q_pos, const int* __restrict__ kv_pos,
                      float* __restrict__ part_acc, float* __restrict__ part_m,
                      float* __restrict__ part_l, int B, int S, int Hq, int G, int window,
                      float scale, int nsplit, Strides st) {
  using L = Layout<T, D, GC>;
  constexpr int V = L::V, VPR = L::VPR, LPR = L::LPR, SPW = L::SPW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sKV = reinterpret_cast<T*>(smem_raw);  // STAGES x (K tile, V tile), (TN, D) each
  float* sS = reinterpret_cast<float*>(smem_raw + L::KV_BYTES);  // (GC, TN) scores
  __shared__ unsigned long long sValid[MAX_TILES];  // bit j: slot j of the slice's i-th tile is valid

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int r = lane / LPR;  // the slot of a warp step this lane works on
  const int c = lane % LPR;  // the 16-byte vector of that slot's row
  const bool on = c < VPR;   // a lane past the row's vectors holds zeros
  const int split = blockIdx.x;
  const int nchunk = (G + GC - 1) / GC;
  const int kvh = blockIdx.y / nchunk;
  const int h0 = kvh * G + (blockIdx.y % nchunk) * GC;  // the block's first query head
  const int heads = min(GC, kvh * G + G - h0);
  const int b = blockIdx.z;
  const int ntiles = (S + TN - 1) / TN;
  const int nlocal = (ntiles - split + nsplit - 1) / nsplit;  // tiles split, split + nsplit, ...

  float qr[GC][V];  // this lane's part of the scaled query of each head
#pragma unroll
  for (int g = 0; g < GC; ++g) {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      qr[g][e] = g < heads && on ? to_f32(q[b * st.qb + (int64_t)(h0 + g) * st.qh + c * V + e]) * scale : 0.0f;
    }
  }

  // The slice's valid slots, by value: a warp reads SCAN_U tiles' positions at once.
  const int qp = q_pos[b];
  const int* pos = kv_pos + (int64_t)b * S;
  for (int i0 = warp; i0 < nlocal; i0 += NW * SCAN_U) {
    int p[SCAN_U][2];
#pragma unroll
    for (int u = 0; u < SCAN_U; ++u) {
      const int i = i0 + u * NW;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int slot = (split + i * nsplit) * TN + hh * 32 + lane;
        p[u][hh] = i < nlocal && slot < S ? pos[slot] : -1;
      }
    }
#pragma unroll
    for (int u = 0; u < SCAN_U; ++u) {
      unsigned bits[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int x = p[u][hh];
        bits[hh] = __ballot_sync(FULL, x >= 0 && x <= qp && (window <= 0 || x > qp - window));
      }
      const int i = i0 + u * NW;
      if (lane == 0 && i < nlocal) sValid[i] = (unsigned long long)bits[1] << 32 | bits[0];
    }
  }
  __syncthreads();

  const int64_t row0 = ((int64_t)split * B + b) * Hq + h0;
  int cur = next_valid(sValid, 0, nlocal);
  if (cur == nlocal) {  // no valid slot in the slice: the marker the merge recognises
    for (int i = tid; i < heads * D; i += NT) part_acc[row0 * D + i] = 0.0f;
    if (tid < heads) {
      part_m[row0 + tid] = -INFINITY;
      part_l[row0 + tid] = 0.0f;
    }
    return;
  }

  const T* kbase = k + b * st.kb + kvh * st.kh;
  const T* vbase = v + b * st.vb + kvh * st.vh;
  // K and V of the slice's i-th tile into `stage`, 16 bytes a copy; rows past S become zeros
  auto fetch = [&](int i, int stage) {
    const int s0 = (split + i * nsplit) * TN;
    T* sK = sKV + stage * 2 * L::TILE;
    T* sV = sK + L::TILE;
#pragma unroll
    for (int u = 0; u < TN * VPR / NT; ++u) {
      const int idx = tid + u * NT;
      const int row = idx / VPR;
      const int col = (idx % VPR) * V;
      const bool ok = s0 + row < S;
      cp_async16(smem_addr(sK + row * D + col), kbase + (ok ? (int64_t)(s0 + row) * st.ks + col : 0), ok);
      cp_async16(smem_addr(sV + row * D + col), vbase + (ok ? (int64_t)(s0 + row) * st.vs + col : 0), ok);
    }
  };

  float m[GC], l[GC], acc[GC][V];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.0f;
#pragma unroll
    for (int e = 0; e < V; ++e) acc[g][e] = 0.0f;
  }

  int ahead = cur;  // the next valid tile to copy
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (ahead < nlocal) {
      fetch(ahead, s);
      ahead = next_valid(sValid, ahead + 1, nlocal);
    }
    cp_async_commit();  // an empty group where the slice has fewer tiles keeps the count
  }

  const int half = warp * SLOTS_W / 32;  // which 32 of the tile's slots this warp's lie in
  for (int n = 0; cur < nlocal; ++n) {
    const int stage = n % STAGES;
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile n has landed for every thread, and every warp is done with tile n - 1
    if (ahead < nlocal) {
      fetch(ahead, (n + STAGES - 1) % STAGES);  // into the stage tile n - 1 left
      ahead = next_valid(sValid, ahead + 1, nlocal);
    }
    cp_async_commit();

    const T* sK = sKV + stage * 2 * L::TILE;
    const T* sV = sK + L::TILE;
    const unsigned long long valid = sValid[cur];
    const int s0 = (split + cur * nsplit) * TN;

    // scores of this warp's slots, SPW slots a step
#pragma unroll
    for (int step = 0; step < SLOTS_W / SPW; ++step) {
      const int j = warp * SLOTS_W + step * SPW + r;
      float kf[V];
      load_or_zero<T, V>(sK + j * D + c * V, on, kf);
      float dot[GC];
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        dot[g] = 0.0f;
#pragma unroll
        for (int e = 0; e < V; ++e) dot[g] = fmaf(qr[g][e], kf[e], dot[g]);
      }
#pragma unroll
      for (int off = LPR / 2; off > 0; off >>= 1) {
#pragma unroll
        for (int g = 0; g < GC; ++g) dot[g] += __shfl_xor_sync(FULL, dot[g], off);
      }
      if (c == 0) {
        const bool ok = (valid >> j) & 1ull;
        const float masked = s0 + j < S ? NEG_INF : -INFINITY;
#pragma unroll
        for (int g = 0; g < GC; ++g) sS[g * TN + j] = ok ? dot[g] : masked;
      }
    }
    __syncthreads();

    // the tile's softmax statistics over all 64 scores, the same in every warp
    float p[GC];  // the probability of slot (32 * half + lane)
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      const float a0 = sS[g * TN + lane];
      const float a1 = sS[g * TN + 32 + lane];
      const float m_new = fmaxf(m[g], warp_max(fmaxf(a0, a1)));  // a real score: the tile has a valid slot
      const float p0 = expf(a0 - m_new);
      const float p1 = expf(a1 - m_new);
      const float alpha = expf(m[g] - m_new);  // 0 on the slice's first tile, where m is -inf
      l[g] = l[g] * alpha + warp_sum(p0 + p1);
      m[g] = m_new;
      p[g] = half ? p1 : p0;
#pragma unroll
      for (int e = 0; e < V; ++e) acc[g][e] *= alpha;
    }

    // acc += P V over this warp's slots
#pragma unroll
    for (int step = 0; step < SLOTS_W / SPW; ++step) {
      const int j = warp * SLOTS_W + step * SPW + r;
      float vf[V];
      load_or_zero<T, V>(sV + j * D + c * V, on, vf);
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        const float pj = __shfl_sync(FULL, p[g], j & 31);
#pragma unroll
        for (int e = 0; e < V; ++e) acc[g][e] = fmaf(pj, vf[e], acc[g][e]);
      }
    }
    cur = next_valid(sValid, cur + 1, nlocal);
  }

  // the warps' accumulators, summed through the stages' room
  cp_async_wait<0>();
  __syncthreads();
  float* sRed = reinterpret_cast<float*>(smem_raw);  // (NW, GC, D)
#pragma unroll
  for (int g = 0; g < GC; ++g) {
#pragma unroll
    for (int e = 0; e < V; ++e) {
#pragma unroll
      for (int off = LPR; off < 32; off <<= 1) acc[g][e] += __shfl_xor_sync(FULL, acc[g][e], off);
      if (r == 0 && on) sRed[(warp * GC + g) * D + c * V + e] = acc[g][e];
    }
  }
  __syncthreads();
  for (int i = tid; i < heads * D; i += NT) {
    const int g = i / D;
    const int d = i % D;
    float sum = 0.0f;
#pragma unroll
    for (int w = 0; w < NW; ++w) sum += sRed[(w * GC + g) * D + d];
    part_acc[row0 * D + i] = sum;
  }
  if (tid == 0) {
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      if (g < heads) {
        part_m[row0 + g] = m[g];
        part_l[row0 + g] = l[g];
      }
    }
  }
}

// One block a (batch, query head), one thread a column.
template <typename T>
__global__ void decode_merge_kernel(const float* __restrict__ part_acc,
                                    const float* __restrict__ part_m,
                                    const float* __restrict__ part_l, const T* __restrict__ v,
                                    T* __restrict__ o, int nsplit, int Hq, int G, int S, int64_t BH,
                                    int64_t vb, int64_t vs, int64_t vh) {
  const int64_t bh = blockIdx.x;
  const int d = threadIdx.x;
  const int D = blockDim.x;
  float m = -INFINITY;
  for (int s = 0; s < nsplit; ++s) m = fmaxf(m, part_m[s * BH + bh]);
  float out;
  if (m == -INFINITY) {  // every slice wrote the marker: no valid slot, the mean of V over S slots
    const int b = (int)(bh / Hq);
    const int kvh = (int)(bh % Hq) / G;
    const T* col = v + b * vb + kvh * vh + d;
    float sum = 0.0f;
#pragma unroll 8
    for (int s = 0; s < S; ++s) sum += to_f32(col[(int64_t)s * vs]);
    out = sum / (float)S;
  } else {
    float l = 0.0f, a = 0.0f;
    for (int s = 0; s < nsplit; ++s) {
      const float w = expf(part_m[s * BH + bh] - m);  // 0 for a marker
      l += part_l[s * BH + bh] * w;
      a += part_acc[(s * BH + bh) * D + d] * w;
    }
    out = a / l;  // l >= 1: the slice that holds m adds exp(0) at least
  }
  o[bh * D + d] = from_f32<T>(out);
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

template <typename T, int D, int GC>
int launch_partial(const Args& a) {
  using L = Layout<T, D, GC>;
  static bool configured[64] = {};  // by device: the kernel's shared memory, set once
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64 || !configured[dev]) {
    e = cudaFuncSetAttribute(decode_partial_kernel<T, D, GC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(decode_partial_kernel<T, D, GC>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) configured[dev] = true;
  }
  const int G = a.Hq / a.Hkv;
  const dim3 grid(a.nsplit, a.Hkv * ((G + GC - 1) / GC), a.B);
  decode_partial_kernel<T, D, GC><<<grid, NT, L::BYTES, a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const int*)a.q_pos, (const int*)a.kv_pos,
      (float*)a.part_acc, (float*)a.part_m, (float*)a.part_l, a.B, a.S, a.Hq, G, a.window, a.scale,
      a.nsplit, a.st);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch(const Args& a) {
  const int ntiles = (a.S + TN - 1) / TN;
  const int per = (ntiles + a.nsplit - 1) / a.nsplit;
  if (a.nsplit < 1 || a.tiles_per_split < per || per > MAX_TILES) return -3;
  // heads of a kv head a block: 1, 2, 4 or 8 in registers; a larger group takes several blocks
  const int G = a.Hq / a.Hkv;
  const int e = G == 1   ? launch_partial<T, D, 1>(a)
                : G == 2 ? launch_partial<T, D, 2>(a)
                : G <= 4 ? launch_partial<T, D, 4>(a)
                         : launch_partial<T, D, 8>(a);
  if (e != 0) return e;
  decode_merge_kernel<T><<<(unsigned)(a.B * a.Hq), D, 0, a.stream>>>(
      (const float*)a.part_acc, (const float*)a.part_m, (const float*)a.part_l, (const T*)a.v,
      (T*)a.o, a.nsplit, a.Hq, G, a.S, (int64_t)a.B * a.Hq, a.st.vb, a.st.vs, a.st.vh);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const Args& a, int D) {
  if (D == 32) return launch<T, 32>(a);
  if (D == 64) return launch<T, 64>(a);
  if (D == 80) return launch<T, 80>(a);
  if (D == 128) return launch<T, 128>(a);
  return -2;
}

}  // namespace

// q (B, 1, Hq, D) with element strides (batch, head); k and v (B, S, Hkv, D)
// with element strides (batch, slot, head); unit stride along D and 16-byte
// aligned rows of k and v; q_pos (B,) and kv_pos (B, S) contiguous int32;
// o (B, 1, Hq, D) contiguous.  Scratch, all f32: part_acc (nsplit, B, Hq, D),
// part_m and part_l (nsplit, B, Hq); slice s takes the 64-slot tiles s,
// s + nsplit, ..., at most tiles_per_split of them.  window <= 0 means no
// window.  Returns cudaGetLastError() of the launches, -1 for a bad dtype, -2
// for a head size without a template, -3 for a plan whose slices hold more
// than tiles_per_split or 256 tiles.
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
