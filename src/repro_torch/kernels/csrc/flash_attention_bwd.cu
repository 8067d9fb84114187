// Blocked attention backward, in the FlashAttention-2 form.
//
// The port's counterpart of what XLA derives for the reference's attention
// when it trains (the TPU kernel repro/kernels/flash_attention.py has no
// backward).  From q, k, v, the forward's o and its log-sum-exp (lse, written
// by flash_attention.cu) and dO:
//
//   P  = exp(scale q k^T - lse)       (recomputed a tile at a time, never stored)
//   D  = rowsum(dO * o)               (flash_bwd_rowsum_kernel)
//   dV = P^T dO,  dS = P * (dO v^T - D),  dK = scale dS^T q
//                                     (flash_bwd_dkdv_kernel)
//   dQ = scale dS k                   (flash_bwd_dq_kernel)
//
// Blocks of a CUDA grid run in no order and nothing carries over between
// them, so each output tile has one owner and the sums it needs run as loops
// inside the block; nothing is added with atomics, and every run gives the
// same bits.  One dK/dV block owns 64 keys of one (batch, kv head) and loops
// over the G query heads of its group and over the query tiles (from the
// diagonal on when causal): GQA's sum over the group happens in its
// registers.  One dQ block owns 64 query rows of one (batch, head) and loops
// over the key tiles (up to the diagonal when causal).  Both read (B, T, H, D)
// through strides, as the forward does, zero the rows past T and S, give keys
// past S and rows past T a weight of exactly 0, and give causally hidden keys
// the forward's finite -2^30 before the exp.
//
// The work is 5 products of 2 T S D a head (half when causal) over q, k, v,
// o, dO read and dq, dk, dv written; at GPT-A's training shapes the bytes
// bound it on the bf16 tensor cores.  The dtype picks the kernels, as in the
// forward:
//
// - bf16, flash_bwd_mma_dkdv_kernel<D> and flash_bwd_mma_dq_kernel<D>: the
//   tensor cores through mma.sync m16n8k16 with f32 sums, four warps of 16
//   rows, bf16 tiles in shared memory filled by cp.async.  Every product is
//   one the forward's flash_mma_kernel makes (rows as the A operand, rows as
//   B through ldmatrix, accumulators rounded to bf16 as the A operand of the
//   next product, rows as B through ldmatrix.trans); P and dS are rounded to
//   bf16 before their products, as the forward rounds P.
// - f32, flash_bwd_dkdv_kernel<D> and flash_bwd_dq_kernel<D>:
//   the CUDA cores (TF32 would not hold 1e-4).  Tiles are f32 in shared memory
//   (q pre-multiplied by the scale, as the f32 forward does, so that the
//   scores are in the lse's domain and dK needs no scale), a thread computes
//   a 4 x 4 patch of the 64 x 64 scores and of dO v^T, and the products into
//   dV, dK and dQ read P and dS back from shared memory.
//
// Outputs are rounded once to the input's type.
#include "common.cuh"

namespace {

constexpr int BT = 64;    // rows of a tile: queries and keys alike
constexpr int NTB = 256;  // threads: 16 x 16, thread (ty, tx) owns rows ty*4+i, columns tx+16*j
constexpr int LDS = BT + 4;

struct BwdArgs {
  const void *q, *k, *v, *o, *dO;
  const float* lse;
  void *dq, *dk, *dv;
  float* rowsum;
  int B, T, S, Hq, Hkv, G;
  float scale;
  int causal;
  int64_t qs[3], ks[3], vs[3], os[3], dos[3];  // element strides (batch, time, head)
};

template <int D>
struct BwdLayout {
  static constexpr int LD = D + 4;  // 16-byte aligned rows, conflict-free float4 reads
  static constexpr int TILE = BT * LD;
  static constexpr int DKDV_FLOATS = 4 * TILE + 2 * BT * LDS + 2 * BT;  // K, V, Q, dO, P, dS, lse, D
  static constexpr int DQ_FLOATS = 4 * TILE + BT * LDS + 2 * BT;        // Q, dO, K, V, dS, lse, D
};

// D = rowsum(dO * o) for every (batch, time, head) row: one warp a row
template <typename T, int D>
__global__ void __launch_bounds__(NTB) flash_bwd_rowsum_kernel(BwdArgs a) {
  const int64_t row = (int64_t)blockIdx.x * (NTB / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= (int64_t)a.B * a.T * a.Hq) return;  // whole warps only
  const int h = (int)(row % a.Hq);
  const int64_t bt = row / a.Hq;
  const int t = (int)(bt % a.T);
  const int b = (int)(bt / a.T);
  const T* o = (const T*)a.o + b * a.os[0] + t * a.os[1] + h * a.os[2];
  const T* g = (const T*)a.dO + b * a.dos[0] + t * a.dos[1] + h * a.dos[2];
  float s = 0.0f;
#pragma unroll
  for (int d = lane; d < D; d += 32) s += to_f32(o[d]) * to_f32(g[d]);
  s = warp_sum(s);
  if (lane == 0) a.rowsum[((int64_t)b * a.Hq + h) * a.T + t] = s;
}

// s[i][j] = sum_d A[ty*4+i][d] B[tx+16j][d] over two f32 tiles of row stride LD
template <int D, int LD>
__device__ inline void tile_dot(float (&s)[4][4], const float* A, const float* B, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = *reinterpret_cast<const float4*>(A + (ty * 4 + i) * LD + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = *reinterpret_cast<const float4*>(B + (tx + 16 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(av[i].x, bv[j].x, s[i][j]);
        s[i][j] = fmaf(av[i].y, bv[j].y, s[i][j]);
        s[i][j] = fmaf(av[i].z, bv[j].z, s[i][j]);
        s[i][j] = fmaf(av[i].w, bv[j].w, s[i][j]);
      }
  }
}

// From the scaled scores s = (scale q) k^T and dp = dO v^T of the tile at
// (q0, k0): s becomes P and dp becomes dS.  Rows past T and keys past S get
// exactly 0; causally hidden keys the forward's finite NEG_INF.
__device__ inline void probs_and_ds(float (&s)[4][4], float (&dp)[4][4], const float* sL,
                                    const float* sDr, int q0, int k0, int T, int S, int causal,
                                    int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const int row = q0 + r;
    const float lse = sL[r], dr = sDr[r];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = k0 + tx + 16 * j;
      float p = 0.0f;
      if (row < T && col < S) p = expf((causal && col > row ? NEG_INF : s[i][j]) - lse);
      s[i][j] = p;
      dp[i][j] = p * (dp[i][j] - dr);
    }
  }
}

// the lse and D of the 64 rows from q0, zeros past T
__device__ inline void load_row_stats(float* sL, float* sDr, const BwdArgs& a, int b, int h, int q0,
                                      int tid) {
  if (tid < BT) {
    const int row = q0 + tid;
    const bool ok = row < a.T;
    const int64_t idx = ((int64_t)b * a.Hq + h) * a.T + row;
    sL[tid] = ok ? a.lse[idx] : 0.0f;
    sDr[tid] = ok ? a.rowsum[idx] : 0.0f;
  }
}

template <int D>
__global__ void __launch_bounds__(NTB) flash_bwd_dkdv_kernel(BwdArgs a) {
  using T = float;
  using L = BwdLayout<D>;
  constexpr int LD = L::LD;
  constexpr int DC = D / 16;  // output columns a thread
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;
  float* sV = sK + L::TILE;
  float* sQ = sV + L::TILE;
  float* sdO = sQ + L::TILE;
  float* sP = sdO + L::TILE;
  float* sdS = sP + BT * LDS;
  float* sL = sdS + BT * LDS;
  float* sDr = sL + BT;

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int kt = blockIdx.x;  // the first key tiles have the most causal work: they start first
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int k0 = kt * BT;

  load_tile_f32<T, D, LD>(sK, (const T*)a.k + b * a.ks[0] + (int64_t)k0 * a.ks[1] + kvh * a.ks[2],
                          a.ks[1], BT, a.S - k0, 1.0f, tid, NTB);
  load_tile_f32<T, D, LD>(sV, (const T*)a.v + b * a.vs[0] + (int64_t)k0 * a.vs[1] + kvh * a.vs[2],
                          a.vs[1], BT, a.S - k0, 1.0f, tid, NTB);

  float dk[4][DC], dv[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk[i][c] = dv[i][c] = 0.0f;

  const int nq = (a.T + BT - 1) / BT;
  for (int g = 0; g < a.G; ++g) {
    const int h = kvh * a.G + g;
    // BM == BN: query tiles before tile kt see none of these keys when causal
    for (int qt = a.causal ? kt : 0; qt < nq; ++qt) {
      const int q0 = qt * BT;
      __syncthreads();  // the previous tile's readers are done with Q, dO, P and dS
      load_tile_f32<T, D, LD>(sQ, (const T*)a.q + b * a.qs[0] + (int64_t)q0 * a.qs[1] + h * a.qs[2],
                              a.qs[1], BT, a.T - q0, a.scale, tid, NTB);
      load_tile_f32<T, D, LD>(sdO, (const T*)a.dO + b * a.dos[0] + (int64_t)q0 * a.dos[1] + h * a.dos[2],
                              a.dos[1], BT, a.T - q0, 1.0f, tid, NTB);
      load_row_stats(sL, sDr, a, b, h, q0, tid);
      __syncthreads();

      float s[4][4], dp[4][4];
      tile_dot<D, LD>(s, sQ, sK, ty, tx);
      tile_dot<D, LD>(dp, sdO, sV, ty, tx);
      probs_and_ds(s, dp, sL, sDr, q0, k0, a.T, a.S, a.causal, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sP[(ty * 4 + i) * LDS + tx + 16 * j] = s[i][j];
          sdS[(ty * 4 + i) * LDS + tx + 16 * j] = dp[i][j];
        }
      __syncthreads();

      // dV[key][d] += sum_r P[r][key] dO[r][d]; dK[key][d] += sum_r dS[r][key] (scale q)[r][d]
      // for this thread's keys ty*4.. and columns tx+16c
#pragma unroll 2
      for (int r = 0; r < BT; ++r) {
        const float4 p4 = *reinterpret_cast<const float4*>(sP + r * LDS + ty * 4);
        const float4 d4 = *reinterpret_cast<const float4*>(sdS + r * LDS + ty * 4);
        const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
        const float dsv[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const float ov = sdO[r * LD + tx + 16 * c];
          const float qv = sQ[r * LD + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dv[i][c] = fmaf(pv[i], ov, dv[i][c]);
            dk[i][c] = fmaf(dsv[i], qv, dk[i][c]);
          }
        }
      }
    }
  }

  T* dK = (T*)a.dk;
  T* dV = (T*)a.dv;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty * 4 + i;
    if (key < a.S) {
      const int64_t base = (((int64_t)b * a.S + key) * a.Hkv + kvh) * D;
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        dK[base + tx + 16 * c] = from_f32<T>(dk[i][c]);
        dV[base + tx + 16 * c] = from_f32<T>(dv[i][c]);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NTB) flash_bwd_dq_kernel(BwdArgs a) {
  using T = float;
  using L = BwdLayout<D>;
  constexpr int LD = L::LD;
  constexpr int DC = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sdO = sQ + L::TILE;
  float* sK = sdO + L::TILE;
  float* sV = sK + L::TILE;
  float* sdS = sV + L::TILE;
  float* sL = sdS + BT * LDS;
  float* sDr = sL + BT;

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int qt = gridDim.x - 1 - blockIdx.x;  // the longest rows of a causal head first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / a.G;
  const int q0 = qt * BT;

  load_tile_f32<T, D, LD>(sQ, (const T*)a.q + b * a.qs[0] + (int64_t)q0 * a.qs[1] + h * a.qs[2],
                          a.qs[1], BT, a.T - q0, a.scale, tid, NTB);
  load_tile_f32<T, D, LD>(sdO, (const T*)a.dO + b * a.dos[0] + (int64_t)q0 * a.dos[1] + h * a.dos[2],
                          a.dos[1], BT, a.T - q0, 1.0f, tid, NTB);
  load_row_stats(sL, sDr, a, b, h, q0, tid);

  float dq[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dq[i][c] = 0.0f;

  int nk = (a.S + BT - 1) / BT;
  if (a.causal && qt + 1 < nk) nk = qt + 1;  // BM == BN: the diagonal tile is tile qt
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BT;
    __syncthreads();  // the previous tile's readers are done with K, V and dS
    load_tile_f32<T, D, LD>(sK, (const T*)a.k + b * a.ks[0] + (int64_t)k0 * a.ks[1] + kvh * a.ks[2],
                            a.ks[1], BT, a.S - k0, 1.0f, tid, NTB);
    load_tile_f32<T, D, LD>(sV, (const T*)a.v + b * a.vs[0] + (int64_t)k0 * a.vs[1] + kvh * a.vs[2],
                            a.vs[1], BT, a.S - k0, 1.0f, tid, NTB);
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_dot<D, LD>(s, sQ, sK, ty, tx);
    tile_dot<D, LD>(dp, sdO, sV, ty, tx);
    probs_and_ds(s, dp, sL, sDr, q0, k0, a.T, a.S, a.causal, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sdS[(ty * 4 + i) * LDS + tx + 16 * j] = dp[i][j];
    __syncthreads();

    // dQ[r][d] += sum_key dS[r][key] K[key][d] for this thread's rows ty*4.. and columns tx+16c
#pragma unroll 2
    for (int c4 = 0; c4 < BT; c4 += 4) {
      float dsv[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 t4 = *reinterpret_cast<const float4*>(sdS + (ty * 4 + i) * LDS + c4);
        dsv[i][0] = t4.x; dsv[i][1] = t4.y; dsv[i][2] = t4.z; dsv[i][3] = t4.w;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const float kv = sK[(c4 + u) * LD + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) dq[i][c] = fmaf(dsv[i][u], kv, dq[i][c]);
        }
    }
  }

  T* dQ = (T*)a.dq;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row < a.T) {
      const int64_t base = (((int64_t)b * a.T + row) * a.Hq + h) * D;
#pragma unroll
      for (int c = 0; c < DC; ++c) dQ[base + tx + 16 * c] = from_f32<T>(dq[i][c] * a.scale);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: the tensor cores, through mma.sync
// ---------------------------------------------------------------------------

constexpr int MMA_NT = 128;  // four warps, 16 rows of the block's tile each

template <int D>
struct MmaBwdLayout {
  static constexpr int LD = D + 8;  // bf16 a row: 16 bytes of padding, ldmatrix without conflicts
  static constexpr int TILE = BT * LD;
  static constexpr int BYTES = 4 * TILE * 2 + 2 * BT * 4;  // four bf16 tiles, lse and D
};

// acc (16 x NC of the warp) += A (16 x D rows of sA from row a0) B^T, B the
// NC rows of sB: the m16n8k16 products of the forward's S = Q K^T.
template <int D, int LD, int NC>
__device__ inline void warp_rows_dot(float (&acc)[NC / 8][4], const __nv_bfloat16* sA, int a0,
                                     const __nv_bfloat16* sB, int lane) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t af[4];
    ldmatrix_x4(af, smem_addr(sA + (a0 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8));
#pragma unroll
    for (int j = 0; j < NC / 8; j += 2) {
      uint32_t bf[4];
      ldmatrix_x4(bf, smem_addr(sB + (j * 8 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                                ((lane >> 3) & 1) * 8));
      mma_bf16(acc[j], af, bf[0], bf[1]);
      mma_bf16(acc[j + 1], af, bf[2], bf[3]);
    }
  }
}

// out (16 x D of the warp) += P (16 x NK, the accumulators of warp_rows_dot,
// rounded to bf16 as the forward rounds P) times the NK rows of sB: the
// forward's O += P V, sB read through ldmatrix.trans.
template <int D, int LD, int NK>
__device__ inline void warp_acc_times_rows(float (&out)[D / 8][4], const float (&p)[NK / 8][4],
                                           const __nv_bfloat16* sB, int lane) {
#pragma unroll
  for (int kk = 0; kk < NK / 16; ++kk) {
    const uint32_t pa[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]), pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                            pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                            pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int n = 0; n < D / 8; n += 2) {
      uint32_t bf[4];
      ldmatrix_x4_trans(bf, smem_addr(sB + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + n * 8 +
                                      (lane >> 4) * 8));
      mma_bf16(out[n], pa, bf[0], bf[1]);
      mma_bf16(out[n + 1], pa, bf[2], bf[3]);
    }
  }
}

// The warp's 16 x D accumulators, times `mul`, rounded to bf16 into rows
// row0 + g and row0 + g + 8 (g = lane / 4) of `out`, whose row r starts at
// out + r * row_stride; rows at or past `rows` are not written.
template <int D>
__device__ inline void store_rows_bf16(__nv_bfloat16* out, int64_t row_stride, int row0, int rows,
                                       const float (&acc)[D / 8][4], float mul, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row0 + g + half * 8;
    if (r >= rows) continue;
    __nv_bfloat16* o = out + (int64_t)r * row_stride + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(o + n * 8) =
          __floats2bfloat162_rn(acc[n][2 * half] * mul, acc[n][2 * half + 1] * mul);
  }
}

// dK and dV of 64 keys of one (batch, kv head); warp w owns keys 16w.. .  Per
// query tile, QC queries at a time: S^T = K Q^T and dP^T = V dO^T (K and V
// rows as the A operand, Q and dO rows as B, as the forward's Q and K), P^T
// and dS^T elementwise in the accumulators, then dV += P^T dO and dK += dS^T
// Q (P^T and dS^T rounded to bf16 as the forward's P, dO and Q through
// ldmatrix.trans as its V).  At D 128 the 16 x D sums of dK and dV take 128
// registers, so the scores go 32 queries at a time (ptxas: 124 bytes of
// spills at 64, 36 at 32); below it all 64 at once spill nothing.
template <int D>
__global__ void __launch_bounds__(MMA_NT) flash_bwd_mma_dkdv_kernel(BwdArgs a) {
  using L = MmaBwdLayout<D>;
  constexpr int LD = L::LD;
  constexpr int QC = D >= 128 ? 32 : BT;
  extern __shared__ uint4 smem_mma[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_mma);
  __nv_bfloat16* sV = sK + L::TILE;
  __nv_bfloat16* sQ = sV + L::TILE;
  __nv_bfloat16* sdO = sQ + L::TILE;
  float* sL = reinterpret_cast<float*>(sdO + L::TILE);
  float* sDr = sL + BT;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int k0 = kt * BT;
  const __nv_bfloat16* q = (const __nv_bfloat16*)a.q;
  const __nv_bfloat16* dO = (const __nv_bfloat16*)a.dO;
  cp_async_tile<BT, MMA_NT, D, LD>(sK, (const __nv_bfloat16*)a.k + b * a.ks[0] + (int64_t)k0 * a.ks[1] + kvh * a.ks[2],
                                   a.ks[1], a.S - k0, tid);
  cp_async_tile<BT, MMA_NT, D, LD>(sV, (const __nv_bfloat16*)a.v + b * a.vs[0] + (int64_t)k0 * a.vs[1] + kvh * a.vs[2],
                                   a.vs[1], a.S - k0, tid);
  cp_async_commit();

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.0f;

  const int nq = (a.T + BT - 1) / BT;
  for (int gi = 0; gi < a.G; ++gi) {
    const int h = kvh * a.G + gi;
    for (int qt = a.causal ? kt : 0; qt < nq; ++qt) {  // BM == BN: earlier query tiles see none of these keys
      const int q0 = qt * BT;
      __syncthreads();  // the previous tile's readers are done with Q, dO, lse and D
      cp_async_tile<BT, MMA_NT, D, LD>(sQ, q + b * a.qs[0] + (int64_t)q0 * a.qs[1] + h * a.qs[2], a.qs[1],
                                       a.T - q0, tid);
      cp_async_tile<BT, MMA_NT, D, LD>(sdO, dO + b * a.dos[0] + (int64_t)q0 * a.dos[1] + h * a.dos[2],
                                       a.dos[1], a.T - q0, tid);
      cp_async_commit();
      load_row_stats(sL, sDr, a, b, h, q0, tid);
      cp_async_wait<0>();
      __syncthreads();

#pragma unroll 1
      for (int qc = 0; qc < BT; qc += QC) {
        float st[QC / 8][4], dpt[QC / 8][4];
#pragma unroll
        for (int j = 0; j < QC / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.0f;
        warp_rows_dot<D, LD, QC>(st, sK, warp * 16, sQ + qc * LD, lane);
        warp_rows_dot<D, LD, QC>(dpt, sV, warp * 16, sdO + qc * LD, lane);

        // rows are keys, columns queries: P^T = exp(scale S^T - lse), dS^T = P^T (dP^T - D)
#pragma unroll
        for (int j = 0; j < QC / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = qc + j * 8 + 2 * t + (e & 1);
            const int query = q0 + c;
            const int key = k0 + warp * 16 + g + (e >> 1) * 8;
            float p = 0.0f;
            if (query < a.T && key < a.S)
              p = expf((a.causal && key > query ? NEG_INF : st[j][e] * a.scale) - sL[c]);
            st[j][e] = p;
            dpt[j][e] = p * (dpt[j][e] - sDr[c]);
          }
        warp_acc_times_rows<D, LD, QC>(dv, st, sdO + qc * LD, lane);
        warp_acc_times_rows<D, LD, QC>(dk, dpt, sQ + qc * LD, lane);
      }
    }
  }
  cp_async_wait<0>();  // a block with no query tile still has K and V in flight

  const int64_t row_stride = (int64_t)a.Hkv * D;
  const int64_t base = ((int64_t)b * a.S * a.Hkv + kvh) * D;
  store_rows_bf16<D>((__nv_bfloat16*)a.dk + base, row_stride, k0 + warp * 16, a.S, dk, a.scale, lane);
  store_rows_bf16<D>((__nv_bfloat16*)a.dv + base, row_stride, k0 + warp * 16, a.S, dv, 1.0f, lane);
}

// dQ of 64 query rows of one (batch, head); warp w owns rows 16w.. .  Per key
// tile: S = Q K^T and dP = dO V^T, P and dS elementwise, dQ += dS K (dS
// rounded to bf16, K through ldmatrix.trans): the forward with dS in P's place.
template <int D>
__global__ void __launch_bounds__(MMA_NT) flash_bwd_mma_dq_kernel(BwdArgs a) {
  using L = MmaBwdLayout<D>;
  constexpr int LD = L::LD;
  extern __shared__ uint4 smem_mma[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_mma);
  __nv_bfloat16* sdO = sQ + L::TILE;
  __nv_bfloat16* sK = sdO + L::TILE;
  __nv_bfloat16* sV = sK + L::TILE;
  float* sL = reinterpret_cast<float*>(sV + L::TILE);
  float* sDr = sL + BT;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qt = gridDim.x - 1 - blockIdx.x;  // the longest rows of a causal head first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / a.G;
  const int q0 = qt * BT;
  const __nv_bfloat16* kb = (const __nv_bfloat16*)a.k + b * a.ks[0] + kvh * a.ks[2];
  const __nv_bfloat16* vb = (const __nv_bfloat16*)a.v + b * a.vs[0] + kvh * a.vs[2];
  cp_async_tile<BT, MMA_NT, D, LD>(sQ, (const __nv_bfloat16*)a.q + b * a.qs[0] + (int64_t)q0 * a.qs[1] + h * a.qs[2],
                                   a.qs[1], a.T - q0, tid);
  cp_async_tile<BT, MMA_NT, D, LD>(sdO, (const __nv_bfloat16*)a.dO + b * a.dos[0] + (int64_t)q0 * a.dos[1] + h * a.dos[2],
                                   a.dos[1], a.T - q0, tid);
  cp_async_commit();
  load_row_stats(sL, sDr, a, b, h, q0, tid);

  float dq[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.0f;

  int nk = (a.S + BT - 1) / BT;
  if (a.causal && qt + 1 < nk) nk = qt + 1;  // BM == BN: the diagonal tile is tile qt
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BT;
    __syncthreads();  // the previous tile's readers are done with K and V
    cp_async_tile<BT, MMA_NT, D, LD>(sK, kb + (int64_t)k0 * a.ks[1], a.ks[1], a.S - k0, tid);
    cp_async_tile<BT, MMA_NT, D, LD>(sV, vb + (int64_t)k0 * a.vs[1], a.vs[1], a.S - k0, tid);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    float s[BT / 8][4], dp[BT / 8][4];
#pragma unroll
    for (int j = 0; j < BT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
    warp_rows_dot<D, LD, BT>(s, sQ, warp * 16, sK, lane);
    warp_rows_dot<D, LD, BT>(dp, sdO, warp * 16, sV, lane);

#pragma unroll
    for (int j = 0; j < BT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = warp * 16 + g + (e >> 1) * 8;
        const int row = q0 + r;
        const int key = k0 + j * 8 + 2 * t + (e & 1);
        float p = 0.0f;
        if (row < a.T && key < a.S)
          p = expf((a.causal && key > row ? NEG_INF : s[j][e] * a.scale) - sL[r]);
        dp[j][e] = p * (dp[j][e] - sDr[r]);
      }
    warp_acc_times_rows<D, LD, BT>(dq, dp, sK, lane);
  }

  store_rows_bf16<D>((__nv_bfloat16*)a.dq + ((int64_t)b * a.T * a.Hq + h) * D, (int64_t)a.Hq * D,
                     q0 + warp * 16, a.T, dq, a.scale, lane);
}

// ---------------------------------------------------------------------------

template <typename Kernel>
cudaError_t launch_tiles(Kernel kernel, dim3 grid, int threads, int smem, const BwdArgs& a,
                         cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, threads, smem, st>>>(a);
  return cudaGetLastError();
}

// bf16 runs the tensor-core kernels, f32 the CUDA-core ones; both after the row sums
template <typename T, int D>
int launch(const BwdArgs& a, cudaStream_t st) {
  const int64_t rows = (int64_t)a.B * a.T * a.Hq;
  flash_bwd_rowsum_kernel<T, D><<<(unsigned)((rows + NTB / 32 - 1) / (NTB / 32)), NTB, 0, st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 kv_grid((a.S + BT - 1) / BT, a.Hkv, a.B), q_grid((a.T + BT - 1) / BT, a.Hq, a.B);
  if constexpr (sizeof(T) == 2) {
    constexpr int smem = MmaBwdLayout<D>::BYTES;
    e = launch_tiles(flash_bwd_mma_dkdv_kernel<D>, kv_grid, MMA_NT, smem, a, st);
    if (e != cudaSuccess) return (int)e;
    return (int)launch_tiles(flash_bwd_mma_dq_kernel<D>, q_grid, MMA_NT, smem, a, st);
  } else {
    using L = BwdLayout<D>;
    e = launch_tiles(flash_bwd_dkdv_kernel<D>, kv_grid, NTB, L::DKDV_FLOATS * (int)sizeof(float), a, st);
    if (e != cudaSuccess) return (int)e;
    return (int)launch_tiles(flash_bwd_dq_kernel<D>, q_grid, NTB, L::DQ_FLOATS * (int)sizeof(float), a, st);
  }
}

template <typename T>
int launch_dtype(const BwdArgs& a, int D, cudaStream_t st) {
  if (D == 32) return launch<T, 32>(a, st);
  if (D == 64) return launch<T, 64>(a, st);
  if (D == 128) return launch<T, 128>(a, st);
  return -2;
}

}  // namespace

// q, o, dO (B, T, Hq, D) and k, v (B, S, Hkv, D) with element strides (batch,
// time, head) and a unit stride along D, every row on a 16-byte boundary; lse
// (B, Hq, T) f32 as the forward wrote it; dq (B, T, Hq, D), dk and dv (B, S,
// Hkv, D) contiguous in the inputs' type; rowsum (B, Hq, T) f32 scratch.
// Launches the three kernels in order on `stream`.  Returns
// cudaGetLastError() of the launches, -1 for a bad dtype, -2 for a head size
// without a template.
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* o, const void* dO, const void* lse, void* dq,
                                          void* dk, void* dv, void* rowsum, int B, int T, int S,
                                          int Hq, int Hkv, int D, float scale, int causal,
                                          int dtype, int64_t qsb, int64_t qst, int64_t qsh,
                                          int64_t ksb, int64_t kst, int64_t ksh, int64_t vsb,
                                          int64_t vst, int64_t vsh, int64_t osb, int64_t ost,
                                          int64_t osh, int64_t dosb, int64_t dost, int64_t dosh,
                                          void* stream) {
  if (B == 0 || T == 0 || S == 0) return 0;
  const BwdArgs a{q, k, v, o, dO, (const float*)lse, dq, dk, dv, (float*)rowsum,
                  B, T, S, Hq, Hkv, Hq / Hkv, scale, causal,
                  {qsb, qst, qsh}, {ksb, kst, ksh}, {vsb, vst, vsh}, {osb, ost, osh}, {dosb, dost, dosh}};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == DT_F32) return launch_dtype<float>(a, D, st);
  if (dtype == DT_BF16) return launch_dtype<__nv_bfloat16>(a, D, st);
  return -1;
}
