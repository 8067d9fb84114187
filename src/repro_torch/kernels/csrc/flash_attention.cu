// Blocked attention forward with an online softmax (prefill, T > 1).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention_bhsd
// (body _flash_kernel), whose grid (batch*heads, q blocks, kv blocks) walks the
// kv axis innermost and carries m, l and the accumulator in VMEM from one grid
// step to the next.  Blocks of a CUDA grid run in no order, so here the kv axis
// is a loop inside the block: one block owns 64 query rows of one (batch, head)
// and keeps m, l and the 64 x D accumulator in registers.  Both kernels below
// read (B, T, H, D) through strides, mask their own ragged edge in T and S
// (keys past S weigh exactly 0; keys the causal mask hides get the reference's
// finite -2^30), stop at the diagonal tile when causal, and start the blocks
// with the longest causal rows first.  The work is 4*T*S*D operations a head
// (half when causal) on q, k, v read once and o written once: in bf16 on the
// tensor cores the operations bind from about 1200 causal tokens on and the
// bytes below that (GPT-A's 512-token prompts); in f32 on the CUDA cores the
// operations bind from about 160.  The dtype picks the kernel:
//
// - bf16, flash_mma_kernel<D>: the tensor cores, in the FlashAttention-2 form.
//   Four warps own 16 query rows each.  Q, and K and V in two stages, sit in
//   shared memory as bf16, rows padded by 16 bytes so that ldmatrix reads eight
//   rows without a bank conflict; cp.async fetches tile kt+1 (zero-filled past
//   S) while the warps compute on tile kt.  S = Q K^T and O += P V are
//   mma.sync m16n8k16 bf16 products with f32 sums; Q's fragments stay in
//   registers for the whole loop.  The scale multiplies the f32 scores after
//   the product, the online softmax runs on the accumulator fragments (a row
//   lives in a quad of four threads), and P is rounded to bf16 in registers,
//   where the m16n8 accumulator layout of two neighbouring key tiles is the
//   m16k16 A layout, so P never passes through shared memory.  That rounding is
//   the one the f32 path does not make.
// - f32, flash_kernel<D>: the CUDA cores, which it keeps to hold the plain
//   version to 2e-5 (TF32 on the tensor cores keeps about three digits).  Q
//   (scaled in f32 before the product, as the reference does), K and V tiles
//   sit in shared memory as f32 and the 64 x 64 probabilities reuse the K
//   tile's room, so two blocks fit on an SM; each thread computes a 4 x 4 patch
//   of the scores and 4 x D/16 of the output.
//
// Given a non-null `lse`, both also write every query row's log-sum-exp of
// its scaled scores, m + log(l) in the natural-log domain (B, Hq, T) f32,
// which the backward (flash_attention_bwd.cu) reads to recompute P.  Serving
// passes null.
#include "common.cuh"

namespace {

constexpr int BM = 64;  // query rows a block
constexpr int BN = 64;  // keys a tile

// ---------------------------------------------------------------------------
// f32: the CUDA cores
// ---------------------------------------------------------------------------

constexpr int NT = 256;  // threads: 16 x 16, thread (ty, tx) owns rows ty*4+i, columns tx+16*j
constexpr int LDP = BN + 4;

template <int D>
struct Layout {
  static_assert(D % 16 == 0, "a thread owns D / 16 output columns");
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

template <int D>
__global__ void __launch_bounds__(NT, 2)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
             float* __restrict__ o, float* __restrict__ lse, int Tq, int S, int Hq, int group,
             float scale, int causal, int64_t qsb, int64_t qst, int64_t qsh, int64_t ksb, int64_t kst, int64_t ksh,
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

  load_tile_f32<float, D, LDQ>(sQ, q + b * qsb + (int64_t)q0 * qst + h * qsh, qst, BM, Tq - q0,
                               scale, tid, NT);

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
    load_tile_f32<float, D, LDQ>(sK, k + b * ksb + (int64_t)k0 * kst + kvh * ksh, kst, BN, S - k0,
                                 1.0f, tid, NT);
    load_tile_f32<float, D, D>(sV, v + b * vsb + (int64_t)k0 * vst + kvh * vsh, vst, BN, S - k0,
                               1.0f, tid, NT);
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
  if (lse != nullptr && tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      if (row < Tq) lse[((int64_t)b * Hq + h) * Tq + row] = m[i] + logf(l[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float inv = 1.0f / l[i];
#pragma unroll
    for (int c = 0; c < DC; ++c) sQ[(ty * 4 + i) * LDQ + tx + 16 * c] = acc[i][c] * inv;
  }
  __syncthreads();
  constexpr int CPR = D / 4;
  float* ob = o + ((int64_t)b * Tq * Hq + h) * D;
  for (int c = tid; c < BM * CPR; c += NT) {
    const int r = c / CPR;
    const int col = (c % CPR) * 4;
    if (q0 + r < Tq) Vec16<float>::store(ob + (int64_t)(q0 + r) * Hq * D + col, sQ + r * LDQ + col);
  }
}

// ---------------------------------------------------------------------------
// bf16: the tensor cores, through mma.sync
// ---------------------------------------------------------------------------

constexpr int MMA_NT = 128;  // four warps, 16 query rows each
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Every D the entry point takes (32, 64, 80, 128) is a whole number of 16-wide
// k-steps and of pairs of 8-wide output tiles (D 80: 5 k-steps, 5 pairs), and
// 64 rows of D / 8 16-byte chunks are a whole number of the block's 128
// threads (D 80: 640 chunks, 5 a thread); the static_asserts hold the kernels
// to that.  A row of D + 8 bf16 (D 80: 176 bytes, 44 words) stays on 16 bytes,
// and the eight rows an ldmatrix reads start 44 words, 12 banks modulo 32,
// apart, so their 16 bytes each fall on 8 distinct groups of 4 banks, as rows
// of 80, 144 and 272 bytes (D 32, 64, 128) do.
template <int D>
struct MmaLayout {
  static_assert(D % 16 == 0 && (D / 8) % 2 == 0 && (BM * (D / 8)) % MMA_NT == 0, "D: whole k-steps, tile pairs, chunks");
  static constexpr int LD = D + 8;  // bf16 a row: 16 bytes of padding, ldmatrix without conflicts
  static constexpr int TILE = BN * LD;  // BM == BN
  static constexpr int BYTES = 5 * TILE * 2;  // Q, then K and V in two stages each
};

template <int D>
__global__ void __launch_bounds__(MMA_NT, 2)
flash_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                 float* __restrict__ lse, int Tq, int S, int Hq, int group, float scale, int causal,
                 int64_t qsb, int64_t qst,
                 int64_t qsh, int64_t ksb, int64_t kst, int64_t ksh, int64_t vsb, int64_t vst,
                 int64_t vsh) {
  using L = MmaLayout<D>;
  constexpr int LD = L::LD;
  constexpr int KD = D / 16;  // k-steps of Q K^T
  constexpr int NS = BN / 8;  // 8-key column tiles of S
  constexpr int NO = D / 8;   // 8-wide column tiles of O
  extern __shared__ uint4 smem_mma[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_mma);
  __nv_bfloat16* sK = sQ + L::TILE;      // two stages
  __nv_bfloat16* sV = sK + 2 * L::TILE;  // two stages

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // the lane's rows in the warp's 16: g and g + 8
  const int t = lane & 3;   // its columns in an 8-wide tile: 2t and 2t + 1
  const int qi = gridDim.x - 1 - blockIdx.x;  // the longest rows of a causal head first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / group;
  const int q0 = qi * BM;
  const __nv_bfloat16* kb = k + b * ksb + kvh * ksh;
  const __nv_bfloat16* vb = v + b * vsb + kvh * vsh;

  int nkv = (S + BN - 1) / BN;
  if (causal && qi + 1 < nkv) nkv = qi + 1;  // BM == BN: the diagonal tile is tile qi

  auto load_kv = [&](int kt, int stage) {
    const int k0 = kt * BN;
    cp_async_tile<BM, MMA_NT, D, LD>(sK + stage * L::TILE, kb + (int64_t)k0 * kst, kst, S - k0, tid);
    cp_async_tile<BM, MMA_NT, D, LD>(sV + stage * L::TILE, vb + (int64_t)k0 * vst, vst, S - k0, tid);
  };

  cp_async_tile<BM, MMA_NT, D, LD>(sQ, q + b * qsb + (int64_t)q0 * qst + h * qsh, qst, Tq - q0, tid);
  cp_async_commit();
  load_kv(0, 0);
  cp_async_commit();
  cp_async_wait<1>();  // Q has landed
  __syncthreads();

  // the warp's 16 rows of Q as A fragments, for the whole loop
  uint32_t qf[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
    ldmatrix_x4(qf[kk], smem_addr(sQ + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8));

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  // m in the log2 domain; l is this thread's share of its row's sum until the end
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};
  const float scale_log2 = scale * LOG2E;
  const int row0 = q0 + warp * 16 + g;

  for (int kt = 0; kt < nkv; ++kt) {
    const int stage = kt & 1;
    if (kt + 1 < nkv) load_kv(kt + 1, stage ^ 1);
    cp_async_commit();   // an empty group on the last tile keeps the count
    cp_async_wait<1>();  // tile kt has landed
    __syncthreads();
    const __nv_bfloat16* cK = sK + stage * L::TILE;
    const __nv_bfloat16* cV = sV + stage * L::TILE;

    // S = Q K^T: an x4 ldmatrix of K gives the B fragments of two key tiles
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int j = 0; j < NS; j += 2) {
        uint32_t kf[4];
        ldmatrix_x4(kf, smem_addr(cK + (j * 8 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                                  ((lane >> 3) & 1) * 8));
        mma_bf16(s[j], qf[kk], kf[0], kf[1]);
        mma_bf16(s[j + 1], qf[kk], kf[2], kf[3]);
      }
    }

    // Scale the f32 scores; mask only the diagonal tile and the ragged last
    // one.  A key past S is no key (-inf, weight exactly 0); a key the causal
    // mask hides keeps the reference's finite NEG_INF.
    const int k0 = kt * BN;
    const bool edge = k0 + BN > S || (causal && kt == qi);
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (edge) {
          const int col = k0 + j * 8 + 2 * t + (e & 1);
          if (col >= S) {
            x = -INFINITY;
          } else if (causal && col > row0 + (e >> 1) * 8) {
            x = NEG_INF;
          }
        }
        s[j][e] = x;
      }

    // online softmax: a row lives in the quad of lanes 4g..4g+3
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float alpha[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - m[e >> 1]);
        rs[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += P V: P's accumulators of key tiles 2kk and 2kk+1, rounded to bf16,
    // are the A fragment of k-step kk; an x4 ldmatrix.trans of V gives the B
    // fragments of two 8-wide column tiles of O
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, smem_addr(cV + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                        n * 8 + (lane >> 4) * 8));
        mma_bf16(acc[n], pa, vf[0], vf[1]);
        mma_bf16(acc[n + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();  // before the next iteration's loads overwrite this stage
  }

  // The quad's shares make the row's sum; every row has seen at least one key
  // at its running maximum, so l >= 1.  Each warp stages its 16 rows in Q's
  // room, then the block stores 16 bytes a thread.
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.0f / l[r];
  }
  if (lse != nullptr && t == 0) {  // m is in the log2 domain
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + r * 8;
      if (row < Tq) lse[((int64_t)b * Hq + h) * Tq + row] = m[r] * LN2 + logf(l[r]);
    }
  }
  const int rw = warp * 16 + g;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    *reinterpret_cast<__nv_bfloat162*>(sQ + rw * LD + n * 8 + 2 * t) =
        __floats2bfloat162_rn(acc[n][0] * inv[0], acc[n][1] * inv[0]);
    *reinterpret_cast<__nv_bfloat162*>(sQ + (rw + 8) * LD + n * 8 + 2 * t) =
        __floats2bfloat162_rn(acc[n][2] * inv[1], acc[n][3] * inv[1]);
  }
  __syncthreads();
  constexpr int CPR = D / 8;
  __nv_bfloat16* ob = o + ((int64_t)b * Tq * Hq + h) * D;
#pragma unroll
  for (int i = 0; i < BM * CPR / MMA_NT; ++i) {
    const int c = tid + i * MMA_NT;
    const int r = c / CPR;
    const int col = (c % CPR) * 8;
    if (q0 + r < Tq)
      *reinterpret_cast<uint4*>(ob + (int64_t)(q0 + r) * Hq * D + col) =
          *reinterpret_cast<const uint4*>(sQ + r * LD + col);
  }
}

// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v;
  void* o;
  float* lse;
  int B, Tq, S, Hq, Hkv;
  float scale;
  int causal;
  int64_t qs[3], ks[3], vs[3];
  cudaStream_t stream;
};

template <typename T, typename Kernel>
int launch_kernel(Kernel kernel, int threads, int smem, const Args& a) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.Tq + BM - 1) / BM, a.Hq, a.B);
  kernel<<<grid, threads, smem, a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (T*)a.o, a.lse, a.Tq, a.S, a.Hq, a.Hq / a.Hkv, a.scale,
      a.causal, a.qs[0], a.qs[1], a.qs[2], a.ks[0], a.ks[1], a.ks[2], a.vs[0], a.vs[1], a.vs[2]);
  return (int)cudaGetLastError();
}

template <int D>
int launch(const Args& a, int dtype) {
  if (dtype == DT_BF16)
    return launch_kernel<__nv_bfloat16>(flash_mma_kernel<D>, MMA_NT, MmaLayout<D>::BYTES, a);
  return launch_kernel<float>(flash_kernel<D>, NT, Layout<D>::FLOATS * (int)sizeof(float), a);
}

}  // namespace

// q (B, T, Hq, D), k and v (B, S, Hkv, D) with element strides (batch, time,
// head) and a unit stride along D; o (B, T, Hq, D) contiguous; lse null or
// (B, Hq, T) f32 contiguous.  Every row of q, k and v must start on a 16-byte
// boundary.  D is 32, 64, 80 or 128.  bf16 runs flash_mma_kernel on
// the tensor cores, f32 flash_kernel on the CUDA cores.  Returns
// cudaGetLastError() of the launch, -1 for a bad dtype, -2 for a head size
// without a template.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      void* lse, int B, int Tq, int S, int Hq, int Hkv, int D, float scale,
                                      int causal, int dtype, int64_t qsb, int64_t qst, int64_t qsh,
                                      int64_t ksb, int64_t kst, int64_t ksh, int64_t vsb,
                                      int64_t vst, int64_t vsh, void* stream) {
  if (B == 0 || Tq == 0) return 0;
  if (dtype != DT_F32 && dtype != DT_BF16) return -1;
  const Args a{q, k, v, o, (float*)lse, B, Tq, S, Hq, Hkv, scale, causal,
               {qsb, qst, qsh}, {ksb, kst, ksh}, {vsb, vst, vsh}, (cudaStream_t)stream};
  if (D == 32) return launch<32>(a, dtype);
  if (D == 64) return launch<64>(a, dtype);
  if (D == 80) return launch<80>(a, dtype);  // HuBERT-XLarge
  if (D == 128) return launch<128>(a, dtype);
  return -2;
}
