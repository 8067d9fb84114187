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
//                                     (the dK/dV kernel)
//   dQ = scale dS k                   (the dQ kernel)
//
// Blocks of a CUDA grid run in no order and nothing carries over between
// them, so each output tile has one owner and the sums it needs run as loops
// inside the block; nothing is added with atomics, and every run gives the
// same bits.  A dK/dV block owns a block of keys of one (batch, kv head) and
// loops over the G query heads of its group and over the query tiles (from
// the diagonal on when causal): GQA's sum over the group happens in its
// registers.  A dQ block owns a block of query rows of one (batch, head) and
// loops over the key tiles (up to the diagonal when causal).  Both read (B, T,
// H, D) through strides, as the forward does, give keys past S and rows past
// T a weight of exactly 0, give causally hidden keys the forward's finite
// -2^30 before the exponential, and start the longest causal work first.
//
// The work is 5 products of 2 T S D a head (half when causal) over q, k, v,
// o, dO read and dq, dk, dv written; the two kernels make 7, S and dP
// recomputed in each, which keeps every output tile with one owner.  At
// GPT-A's training shape (4 x 512 tokens, 32 heads of 128) the bytes bound
// the call (0.040 ms) and 7 products at the bf16 tensor cores' peak are 0.030
// ms; what costs time is latency: loads, the chain product -> exponentials ->
// product inside a step, and each block's first loads and last stores.  The
// dtype picks the kernels, as in the forward:
//
// - bf16, flash_bwd_wg_dkdv_kernel<D> and flash_bwd_wg_dq_kernel<D>: Hopper's
//   warpgroup products (wgmma.mma_async m64nNk16, bf16 in, f32 sums in
//   registers).  A block is two warpgroups of 64 rows (keys, or query rows)
//   whose resident tiles (K and V, or Q and dO) are the A operand of the
//   score products straight from shared memory; the streamed tiles (Q and dO,
//   or K and V) pass through a ring of four stages, thread 0 issuing the copies
//   three tiles ahead.  P (P^T) and dS (dS^T) are computed in the accumulators,
//   rounded to bf16 and moved into A fragments in registers (the accumulator
//   layout of a warp's 16 rows is the m16n8k16 A layout), and the second
//   products take the streamed tile MN-major as B: the same tile read the
//   other way, as wgmma allows for 16-bit types.  exp2 with scale log2(e)
//   folded into the scores and log2(e) into the lse; the mask only on the
//   diagonal and ragged tiles; S and dP as two commit groups, so that P is
//   computed while dP is still being multiplied, and in dK/dV dV's products
//   run while dS is computed.  The tiles are moved by the Tensor Memory
//   Accelerator, not by cp.async: with cp.async (16 bytes a thread, into an
//   unswizzled layout) the copies alone took most of a kernel's time on the
//   card, where one TMA copy moves a 64-row box of up to 128 contiguous bytes
//   a row and completes on an mbarrier; TMA stores write dK, dV and dQ back
//   from shared memory.  The build links no libcuda,
//   so the C entry point fetches cuTensorMapEncodeTiled through
//   cudaGetDriverEntryPoint and passes the maps in the kernels' __grid_constant__
//   argument; the tiles' layout, the widest swizzle a row allows (128, 64 or
//   32 bytes: D 80 has 160-byte rows), is wgmma.cuh's.  The row sums' kernel
//   and the two others are chained by programmatic dependent launch: the dK/dV
//   blocks start loading K and V while the sums finish, and the dQ blocks fill
//   the SMs the dK/dV grid's last blocks leave idle (dQ reads no output of
//   dK/dV).
// - f32, flash_bwd_dkdv_kernel<D> and flash_bwd_dq_kernel<D>:
//   the CUDA cores (TF32 would not hold 1e-4).  Tiles are f32 in shared memory
//   (q pre-multiplied by the scale, as the f32 forward does, so that the
//   scores are in the lse's domain and dK needs no scale), a thread computes
//   a 4 x 4 patch of the 64 x 64 scores and of dO v^T, and the products into
//   dV, dK and dQ read P and dS back from shared memory.
//
// P and dS are rounded to bf16 before their products in bf16, as the
// forward rounds P; outputs are rounded once to the input's type.
#include "common.cuh"
#include "wgmma.cuh"

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
  // bf16: TMA maps of q, dO, k, v and of dq, dk, dv in 64-row tiles (wgmma.cuh); unused in f32
  CUtensorMap tq, tdo, tk, tv, tdq, tdk, tdv;
};

template <int D>
struct BwdLayout {
  static constexpr int LD = D + 4;  // 16-byte aligned rows, conflict-free float4 reads
  static constexpr int TILE = BT * LD;
  static constexpr int DKDV_FLOATS = 4 * TILE + 2 * BT * LDS + 2 * BT;  // K, V, Q, dO, P, dS, lse, D
  static constexpr int DQ_FLOATS = 4 * TILE + BT * LDS + 2 * BT;        // Q, dO, K, V, dS, lse, D
};

// D = rowsum(dO * o) for every (batch, time, head) row: LPR lanes a row (the
// row's 16-byte pieces, rounded up to a power of two), 16-byte loads, the
// lanes' sums met by shuffles
template <typename T, int D>
struct RowsumLanes {
  static constexpr int CPR = D / Vec16<T>::N;
  static_assert(D % Vec16<T>::N == 0 && CPR <= 32, "a row is at most 32 pieces of 16 bytes");
  static constexpr int LPR = CPR <= 4 ? 4 : CPR <= 8 ? 8 : CPR <= 16 ? 16 : 32;
};

template <typename T, int D>
__global__ void __launch_bounds__(NTB) flash_bwd_rowsum_kernel(BwdArgs a) {
  using R = RowsumLanes<T, D>;
  constexpr int V = Vec16<T>::N;
  launch_dependents();  // the dK/dV kernel may start its blocks; it waits for these sums before reading them
  const int64_t row = (int64_t)blockIdx.x * (NTB / R::LPR) + threadIdx.x / R::LPR;
  const int piece = threadIdx.x % R::LPR;
  const bool live = row < (int64_t)a.B * a.T * a.Hq;
  float s = 0.0f;
  int b = 0, t = 0, h = 0;
  if (live) {
    h = (int)(row % a.Hq);
    const int64_t bt = row / a.Hq;
    t = (int)(bt % a.T);
    b = (int)(bt / a.T);
    if (piece < R::CPR) {
      float o[V], g[V];
      Vec16<T>::load((const T*)a.o + b * a.os[0] + t * a.os[1] + h * a.os[2] + piece * V, o);
      Vec16<T>::load((const T*)a.dO + b * a.dos[0] + t * a.dos[1] + h * a.dos[2] + piece * V, g);
#pragma unroll
      for (int i = 0; i < V; ++i) s = fmaf(o[i], g[i], s);
    }
  }
#pragma unroll
  for (int o = R::LPR / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (live && piece == 0) a.rowsum[((int64_t)b * a.Hq + h) * a.T + t] = s;
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
// bf16: the tensor cores, through wgmma
// ---------------------------------------------------------------------------

constexpr int WG_NT = 128;          // a warpgroup: warp w holds rows 16w.. of its 64-row products
constexpr int NWG = 2;              // warpgroups a block, one 64-row tile each
constexpr int BLK = NWG * TILE_ROWS;  // keys of a dK/dV block, query rows of a dQ block
constexpr int STAGES = 4;           // the ring of streamed tiles: three in flight while one is used
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory of both kernels: two resident 128-row tiles (K and V, or Q
// and dO: a 64-row tile a warpgroup each), then the ring, a stage of two
// 64-row tiles (Q and dO, or K and V) and, for dK/dV, the step's lse and D.
template <int D>
struct WgLayout {
  static_assert(D % 16 == 0 && D >= 32 && D <= 128, "whole k-steps; wgmma's N is D, a multiple of 8 up to 256");
  static constexpr int TILE = TILE_ROWS * D;   // bf16 of a 64-row tile
  static constexpr int TILE_BYTES = TILE * 2;  // multiples of 1024: every tile starts a swizzle pattern
  static constexpr int STAGE = 2 * TILE_BYTES + 1024;  // two tiles, then lse and D (512 bytes) padded
  static constexpr int BYTES = 2 * NWG * TILE_BYTES + STAGES * STAGE + 1024;  // and room to align the base
  static_assert(BYTES <= 227 * 1024, "one block an SM");
};

// 2^x on the special-function unit (MUFU.EX2); results below 2^-126 become 0
__device__ inline float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The 64 x D accumulators of a warpgroup, times `mul`, rounded to bf16 into
// a tile at `tile` (wgmma.cuh's layout), for a TMA store: a warp's 8 rows x 4
// threads write one 16-byte piece a row, which the swizzle puts on 8 distinct
// groups of banks.
template <int D>
__device__ inline void acc_to_tile(__nv_bfloat16* tile, const float (&acc)[D / 2], float mul, int warp, int lane) {
  const int r = warp * 16 + (lane >> 2), t = lane & 3;
  unsigned char* bytes = reinterpret_cast<unsigned char*>(tile);
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int half = 0; half < 2; ++half)
      *reinterpret_cast<__nv_bfloat162*>(bytes + tile_byte<D>(r + 8 * half, j * 8 + 2 * t)) =
          __floats2bfloat162_rn(acc[4 * j + 2 * half] * mul, acc[4 * j + 2 * half + 1] * mul);
}

// dK and dV of 128 keys of one (batch, kv head): two warpgroups of 64 keys.
// K and V are copied once (TMA) and stay the A operand of S^T = K Q^T and dP^T
// = V dO^T (shared memory, K-major).  The query steps (64 rows) of the G heads
// of the group stream through a ring of four stages shared by both
// warpgroups: thread 0 issues step i + 3's two TMA copies before step i's
// products, and the step's lse and D follow by cp.async.  Each step: S^T and
// dP^T (64 x 64) as two commit groups; P^T = exp2(S^T scale log2(e) - lse
// log2(e)) while dP^T is still being multiplied; P^T rounded to bf16 into A
// fragments in registers and dV += P^T dO issued; dS^T = P^T (dP^T - D) while
// that runs, rounded likewise, then dK += dS^T Q, with dO and Q read MN-major
// from the same tiles.  dK and dV (64 x D each a warpgroup) stay in registers
// for the whole block.  A warpgroup whose keys all follow a causal step's
// queries skips the step.
template <int D>
__global__ void __launch_bounds__(NWG * WG_NT, 1) flash_bwd_wg_dkdv_kernel(const __grid_constant__ BwdArgs a) {
  using L = WgLayout<D>;
  constexpr int QN = TILE_ROWS;  // queries a step
  extern __shared__ __align__(1024) unsigned char smem_wg[];
  __shared__ __align__(8) uint64_t bars[STAGES + 1];  // a barrier a stage, then the resident tiles'
  // tiles start on 1024 bytes, where the swizzle pattern does
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_wg + ((1024 - (smem_addr(smem_wg) & 1023)) & 1023));
  __nv_bfloat16* sV = sK + NWG * L::TILE;
  unsigned char* ring = reinterpret_cast<unsigned char*>(sV + NWG * L::TILE);
  auto sQ = [&](int st) { return reinterpret_cast<__nv_bfloat16*>(ring + st * L::STAGE); };
  auto sdO = [&](int st) { return sQ(st) + L::TILE; };
  auto sL = [&](int st) { return reinterpret_cast<float*>(sQ(st) + 2 * L::TILE); };
  auto sDr = [&](int st) { return sL(st) + QN; };
  auto bar = [&](int i) { return smem_addr(bars + i); };

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kvh = blockIdx.x % a.Hkv, b = blockIdx.x / a.Hkv;
  const int k0 = blockIdx.y * BLK;  // every head's first keys, the longest causal work, start first
  const int kw0 = k0 + wg * TILE_ROWS;  // the warpgroup's 64 keys
  // the query steps of each head: from the first that sees these keys (causal) to the last
  const int first = a.causal ? k0 / QN : 0;
  const int per_head = max((a.T + QN - 1) / QN - first, 0);
  const int steps = a.G * per_head;

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i <= STAGES; ++i) mbar_init(bar(i), 1);
    mbar_init_fence();
  }
  __syncthreads();
  auto load_step = [&](int i, int st) {  // thread 0 the tiles, threads below QN the row statistics
    const int h = kvh * a.G + i / per_head;
    const int q0 = (first + i % per_head) * QN;
    if (tid == 0) {
      mbar_expect(bar(st), 2 * L::TILE_BYTES);
      tma_tile<D>(sQ(st), &a.tq, bar(st), q0, h, b);
      tma_tile<D>(sdO(st), &a.tdo, bar(st), q0, h, b);
    }
    if (tid < QN) {  // lse and D of the step's rows, zeros past T
      const bool ok = q0 + tid < a.T;
      const int64_t idx = ok ? ((int64_t)b * a.Hq + h) * a.T + q0 + tid : 0;
      cp_async4(smem_addr(sL(st) + tid), a.lse + idx, ok);
      cp_async4(smem_addr(sDr(st) + tid), a.rowsum + idx, ok);
    }
  };
  if (tid == 0) {
    mbar_expect(bar(STAGES), 2 * NWG * L::TILE_BYTES);
#pragma unroll
    for (int w = 0; w < NWG; ++w) {
      tma_tile<D>(sK + w * L::TILE, &a.tk, bar(STAGES), k0 + w * TILE_ROWS, kvh, b);
      tma_tile<D>(sV + w * L::TILE, &a.tv, bar(STAGES), k0 + w * TILE_ROWS, kvh, b);
    }
  }
  // the row sums come from the kernel before: wait for it (K and V are already on their way), then
  // let the dQ kernel, which reads them too, start its blocks as this grid's last ones start
  grid_dependency_wait();
  launch_dependents();
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {  // one cp.async group a step, empty ones past the last
    if (i < steps) load_step(i, i);
    cp_async_commit();
  }

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.0f;
  const float scale_log2 = a.scale * LOG2E;
  const __nv_bfloat16* wK = sK + wg * L::TILE;  // the warpgroup's tiles
  const __nv_bfloat16* wV = sV + wg * L::TILE;
  const int key_lo = kw0 + warp * 16 + g;  // the thread's keys: key_lo and key_lo + 8
  if (steps > 0) mbar_wait(bar(STAGES), 0);

  for (int i = 0; i < steps; ++i) {
    const int st = i % STAGES;
    cp_async_wait<STAGES - 2>();            // this thread's share of step i's lse and D
    mbar_wait(bar(st), (i / STAGES) & 1);   // step i's tiles
    __syncthreads();  // ... for every thread, and step i - 1 is done with its stage
    if (i + STAGES - 1 < steps) load_step(i + STAGES - 1, (i + STAGES - 1) % STAGES);
    cp_async_commit();
    const int q0 = (first + i % per_head) * QN;
    if ((a.causal && q0 + QN <= kw0) || kw0 >= a.S) continue;  // no key of this warpgroup is seen

    float s[QN / 2], dp[QN / 2];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Wg<QN>::ss(s, kdesc<D>(wK, kk), kdesc<D>(sQ(st), kk), kk);
    wg_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Wg<QN>::ss(dp, kdesc<D>(wV, kk), kdesc<D>(sdO(st), kk), kk);
    wg_commit();

    // rows are keys, columns queries; only a diagonal or ragged step masks
    const bool edge = (a.causal && q0 < kw0 + TILE_ROWS) || q0 + QN > a.T || kw0 + TILE_ROWS > a.S;
    const float* lse = sL(st);
    const float* dr = sDr(st);
    wg_wait<1>();  // S^T has landed; dP^T may still be in flight
    keep(s);
#pragma unroll
    for (int j = 0; j < QN / 8; ++j) {
      const int c = j * 8 + 2 * t;
      const float2 l2 = *reinterpret_cast<const float2*>(lse + c);
      const float lq[2] = {l2.x * LOG2E, l2.y * LOG2E};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = fmaf(s[4 * j + e], scale_log2, -lq[e & 1]);
        float p;
        if (edge) {
          const int query = q0 + c + (e & 1), key = key_lo + (e >> 1) * 8;
          if (a.causal && key > query) x = NEG_INF - lq[e & 1];
          p = (query < a.T && key < a.S) ? ex2(x) : 0.0f;
        } else {
          p = ex2(x);
        }
        s[4 * j + e] = p;
      }
    }
    uint32_t pa[QN / 16][4], da[QN / 16][4];
#pragma unroll
    for (int kk = 0; kk < QN / 16; ++kk) acc_to_a(pa[kk], s + 8 * kk);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < QN / 16; ++kk)
      Wg<D>::rs(dv, pa[kk], ndesc<D>(sdO(st), kk), 1);
    wg_commit();

    wg_wait<1>();  // dP^T has landed; dV's products may still be in flight
    keep(dp);
#pragma unroll
    for (int j = 0; j < QN / 8; ++j) {
      const float2 d2 = *reinterpret_cast<const float2*>(dr + j * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[4 * j + e] = s[4 * j + e] * (dp[4 * j + e] - ((e & 1) ? d2.y : d2.x));
    }
#pragma unroll
    for (int kk = 0; kk < QN / 16; ++kk) acc_to_a(da[kk], dp + 8 * kk);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < QN / 16; ++kk)
      Wg<D>::rs(dk, da[kk], ndesc<D>(sQ(st), kk), 1);
    wg_commit();
    wg_wait<0>();
    keep(dv);
    keep(dk);
    keep(pa);
    keep(da);
  }
  cp_async_wait<0>();  // a block with fewer steps than stages still has (empty) groups open
  // copies issued are copies waited for: with no step, the resident tiles' barrier is waited here
  if (steps == 0) mbar_wait(bar(STAGES), 0);

  // dK and dV through the ring's memory, now free, and out by TMA (rows past S are not written)
  __syncthreads();
  __nv_bfloat16* out = reinterpret_cast<__nv_bfloat16*>(ring) + wg * 2 * L::TILE;
  acc_to_tile<D>(out, dk, a.scale, warp, lane);
  acc_to_tile<D>(out + L::TILE, dv, 1.0f, warp, lane);
  fence_proxy_async();
  __syncthreads();
  if (tid == 0) {
#pragma unroll
    for (int w = 0; w < NWG; ++w) {
      const __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(ring) + w * 2 * L::TILE;
      tma_store_tile<D>(&a.tdk, tile, k0 + w * TILE_ROWS, kvh, b);
      tma_store_tile<D>(&a.tdv, tile + L::TILE, k0 + w * TILE_ROWS, kvh, b);
    }
    tma_store_commit();
    tma_store_wait_read();
  }
}

// dQ of 128 query rows of one (batch, head): two warpgroups of 64 rows.  Q
// and dO are copied once (TMA) and stay the A operand of S = Q K^T and dP =
// dO V^T; the key tiles (64 keys of K and V, up to the diagonal when causal)
// stream through a ring of four stages shared by both warpgroups, thread 0
// issuing tile kt + 3's copies as tile kt begins.  Each tile: S and dP (64 x
// 64) as two commit groups, P while dP is still being multiplied, dS = P (dP
// - D) rounded to bf16 into A fragments, then dQ += dS K with K read MN-major
// from the same tile.  A thread's rows are two, so their lse and D sit in
// registers for the whole block.  A warpgroup whose rows all precede a causal
// tile's keys skips the tile.
template <int D>
__global__ void __launch_bounds__(NWG * WG_NT, 1) flash_bwd_wg_dq_kernel(const __grid_constant__ BwdArgs a) {
  using L = WgLayout<D>;
  constexpr int KN = TILE_ROWS;  // keys a tile
  extern __shared__ __align__(1024) unsigned char smem_wg[];
  __shared__ __align__(8) uint64_t bars[STAGES + 1];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_wg + ((1024 - (smem_addr(smem_wg) & 1023)) & 1023));
  __nv_bfloat16* sdO = sQ + NWG * L::TILE;
  unsigned char* ring = reinterpret_cast<unsigned char*>(sdO + NWG * L::TILE);
  auto sK = [&](int st) { return reinterpret_cast<__nv_bfloat16*>(ring + st * L::STAGE); };
  auto sV = [&](int st) { return sK(st) + L::TILE; };
  auto bar = [&](int i) { return smem_addr(bars + i); };

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.x % a.Hq, b = blockIdx.x / a.Hq;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BLK;  // every head's longest causal rows start first
  const int qw0 = q0 + wg * TILE_ROWS;                 // the warpgroup's 64 rows
  const int kvh = h / a.G;
  int nk = (a.S + KN - 1) / KN;
  if (a.causal) nk = min(nk, (q0 + BLK - 1) / KN + 1);  // up to the tile of the block's last row

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i <= STAGES; ++i) mbar_init(bar(i), 1);
    mbar_init_fence();
  }
  __syncthreads();
  auto load_kv = [&](int kt, int st) {
    mbar_expect(bar(st), 2 * L::TILE_BYTES);
    tma_tile<D>(sK(st), &a.tk, bar(st), kt * KN, kvh, b);
    tma_tile<D>(sV(st), &a.tv, bar(st), kt * KN, kvh, b);
  };
  if (tid == 0) {
    mbar_expect(bar(STAGES), 2 * NWG * L::TILE_BYTES);
#pragma unroll
    for (int w = 0; w < NWG; ++w) {
      tma_tile<D>(sQ + w * L::TILE, &a.tq, bar(STAGES), q0 + w * TILE_ROWS, h, b);
      tma_tile<D>(sdO + w * L::TILE, &a.tdo, bar(STAGES), q0 + w * TILE_ROWS, h, b);
    }
#pragma unroll
    for (int i = 0; i < STAGES - 1; ++i)
      if (i < nk) load_kv(i, i);
  }

  const int row_lo = qw0 + warp * 16 + g;  // the thread's rows: row_lo and row_lo + 8
  float lq[2], dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_lo + 8 * r;
    const int64_t idx = ((int64_t)b * a.Hq + h) * a.T + row;
    lq[r] = row < a.T ? a.lse[idx] * LOG2E : 0.0f;
    dr[r] = row < a.T ? a.rowsum[idx] : 0.0f;
  }
  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.0f;
  const float scale_log2 = a.scale * LOG2E;
  const __nv_bfloat16* wQ = sQ + wg * L::TILE;  // the warpgroup's tiles
  const __nv_bfloat16* wdO = sdO + wg * L::TILE;
  mbar_wait(bar(STAGES), 0);

  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt % STAGES;
    mbar_wait(bar(st), (kt / STAGES) & 1);  // tile kt
    __syncthreads();  // ... and tile kt - 1 is done with its stage, for every thread
    if (tid == 0 && kt + STAGES - 1 < nk) load_kv(kt + STAGES - 1, (kt + STAGES - 1) % STAGES);
    const int k0 = kt * KN;
    if ((a.causal && k0 > qw0 + TILE_ROWS - 1) || qw0 >= a.T) continue;  // no key of the tile is seen

    float s[KN / 2], dp[KN / 2];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Wg<KN>::ss(s, kdesc<D>(wQ, kk), kdesc<D>(sK(st), kk), kk);
    wg_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Wg<KN>::ss(dp, kdesc<D>(wdO, kk), kdesc<D>(sV(st), kk), kk);
    wg_commit();

    const bool edge = (a.causal && k0 + KN - 1 > qw0) || k0 + KN > a.S || qw0 + TILE_ROWS > a.T;
    wg_wait<1>();  // S has landed; dP may still be in flight
    keep(s);
#pragma unroll
    for (int j = 0; j < KN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = fmaf(s[4 * j + e], scale_log2, -lq[e >> 1]);
        float p;
        if (edge) {
          const int row = row_lo + (e >> 1) * 8, key = k0 + j * 8 + 2 * t + (e & 1);
          if (a.causal && key > row) x = NEG_INF - lq[e >> 1];
          p = (row < a.T && key < a.S) ? ex2(x) : 0.0f;
        } else {
          p = ex2(x);
        }
        s[4 * j + e] = p;
      }
    wg_wait<0>();
    keep(dp);
    uint32_t da[KN / 16][4];
#pragma unroll
    for (int j = 0; j < KN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[4 * j + e] = s[4 * j + e] * (dp[4 * j + e] - dr[e >> 1]);
#pragma unroll
    for (int kk = 0; kk < KN / 16; ++kk) acc_to_a(da[kk], dp + 8 * kk);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KN / 16; ++kk)
      Wg<D>::rs(dq, da[kk], ndesc<D>(sK(st), kk), 1);
    wg_commit();
    wg_wait<0>();
    keep(dq);
    keep(da);
  }

  // dQ through the ring's memory, now free, and out by TMA (rows past T are not written)
  __syncthreads();
  acc_to_tile<D>(reinterpret_cast<__nv_bfloat16*>(ring) + wg * L::TILE, dq, a.scale, warp, lane);
  fence_proxy_async();
  __syncthreads();
  if (tid == 0) {
#pragma unroll
    for (int w = 0; w < NWG; ++w)
      tma_store_tile<D>(&a.tdq, reinterpret_cast<__nv_bfloat16*>(ring) + w * L::TILE, q0 + w * TILE_ROWS, h, b);
    tma_store_commit();
    tma_store_wait_read();
  }
  // this grid may have started before the dK/dV kernel ended; it ends after it, so that what follows
  // in the stream finds dK and dV written
  grid_dependency_wait();
}

// ---------------------------------------------------------------------------

// With `early`, a programmatic dependent launch: the kernel's blocks may start
// once every block of the kernel before it has passed griddepcontrol's
// launch_dependents, and wait (griddepcontrol.wait) where they need its results.
template <typename Kernel>
cudaError_t launch_tiles(Kernel kernel, dim3 grid, int threads, int smem, const BwdArgs& a, cudaStream_t st,
                         bool early = false) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = early ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, kernel, a);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// bf16 runs the tensor-core kernels, f32 the CUDA-core ones; both after the row sums
template <typename T, int D>
int launch(const BwdArgs& a, cudaStream_t st) {
  const int64_t rows = (int64_t)a.B * a.T * a.Hq;
  constexpr int rows_a_block = NTB / RowsumLanes<T, D>::LPR;
  flash_bwd_rowsum_kernel<T, D><<<(unsigned)((rows + rows_a_block - 1) / rows_a_block), NTB, 0, st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if constexpr (sizeof(T) == 2) {
    const dim3 kv_blocks(a.B * a.Hkv, (a.S + BLK - 1) / BLK), q_blocks(a.B * a.Hq, (a.T + BLK - 1) / BLK);
    e = launch_tiles(flash_bwd_wg_dkdv_kernel<D>, kv_blocks, NWG * WG_NT, WgLayout<D>::BYTES, a, st, true);
    if (e != cudaSuccess) return (int)e;
    return (int)launch_tiles(flash_bwd_wg_dq_kernel<D>, q_blocks, NWG * WG_NT, WgLayout<D>::BYTES, a, st, true);
  } else {
    using L = BwdLayout<D>;
    const dim3 kv_grid((a.S + BT - 1) / BT, a.Hkv, a.B), q_grid((a.T + BT - 1) / BT, a.Hq, a.B);
    e = launch_tiles(flash_bwd_dkdv_kernel<D>, kv_grid, NTB, L::DKDV_FLOATS * (int)sizeof(float), a, st);
    if (e != cudaSuccess) return (int)e;
    return (int)launch_tiles(flash_bwd_dq_kernel<D>, q_grid, NTB, L::DQ_FLOATS * (int)sizeof(float), a, st);
  }
}

template <typename T>
int launch_dtype(const BwdArgs& a, int D, cudaStream_t st) {
  if (D == 32) return launch<T, 32>(a, st);
  if (D == 64) return launch<T, 64>(a, st);
  if (D == 80) return launch<T, 80>(a, st);
  if (D == 128) return launch<T, 128>(a, st);
  return -2;
}

// cuTensorMapEncodeTiled, from the driver through the runtime: the build links no libcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The TMA map of a bf16 (batch, rows, heads, D) tensor with element strides
// (sb, sr, sh) in 64-row tiles of wgmma.cuh's layout: four dimensions,
// innermost first (D, rows, heads, batch), a box of (CB, 64, 1, 1) with the
// SW-byte swizzle.  A dimension of extent 1 gets a stride of 16 bytes, which
// no coordinate multiplies.
template <int D>
bool tile_map(CUtensorMap* map, const void* base, int batch, int rows, int heads, int64_t sb, int64_t sr, int64_t sh) {
  using F = TileFmt<D>;
  EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const auto stride = [](int n, int64_t s) { return (cuuint64_t)(n > 1 ? s * 2 : 16); };
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)rows, (cuuint64_t)heads, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {stride(rows, sr), stride(heads, sh), stride(batch, sb)};
  const cuuint32_t box[4] = {(cuuint32_t)F::CB, (cuuint32_t)TILE_ROWS, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = F::SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : F::SW == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                   : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the seven maps of the bf16 kernels: q, dO, k, v read, dq, dk, dv written
template <int D>
bool all_maps(BwdArgs& a) {
  const int64_t T = a.T, S = a.S, Hq = a.Hq, Hkv = a.Hkv;
  return tile_map<D>(&a.tq, a.q, a.B, a.T, a.Hq, a.qs[0], a.qs[1], a.qs[2]) &&
         tile_map<D>(&a.tdo, a.dO, a.B, a.T, a.Hq, a.dos[0], a.dos[1], a.dos[2]) &&
         tile_map<D>(&a.tk, a.k, a.B, a.S, a.Hkv, a.ks[0], a.ks[1], a.ks[2]) &&
         tile_map<D>(&a.tv, a.v, a.B, a.S, a.Hkv, a.vs[0], a.vs[1], a.vs[2]) &&
         tile_map<D>(&a.tdq, a.dq, a.B, a.T, a.Hq, T * Hq * D, Hq * D, D) &&
         tile_map<D>(&a.tdk, a.dk, a.B, a.S, a.Hkv, S * Hkv * D, Hkv * D, D) &&
         tile_map<D>(&a.tdv, a.dv, a.B, a.S, a.Hkv, S * Hkv * D, Hkv * D, D);
}

}  // namespace

// q, o, dO (B, T, Hq, D) and k, v (B, S, Hkv, D) with element strides (batch,
// time, head) and a unit stride along D, every row on a 16-byte boundary; lse
// (B, Hq, T) f32 as the forward wrote it; dq (B, T, Hq, D), dk and dv (B, S,
// Hkv, D) contiguous in the inputs' type; rowsum (B, Hq, T) f32 scratch.
// Launches the three kernels in order on `stream`.  Returns
// cudaGetLastError() of the launches, -1 for a bad dtype, -2 for a head size
// without a template, -3 where a TMA map of a bf16 input cannot be made.
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
  BwdArgs a{q, k, v, o, dO, (const float*)lse, dq, dk, dv, (float*)rowsum,
            B, T, S, Hq, Hkv, Hq / Hkv, scale, causal,
            {qsb, qst, qsh}, {ksb, kst, ksh}, {vsb, vst, vsh}, {osb, ost, osh}, {dosb, dost, dosh},
            {}, {}, {}, {}, {}, {}, {}};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == DT_F32) return launch_dtype<float>(a, D, st);
  if (dtype != DT_BF16) return -1;
  const bool maps = D == 32 ? all_maps<32>(a) : D == 64 ? all_maps<64>(a) : D == 80 ? all_maps<80>(a)
                  : D == 128 ? all_maps<128>(a) : true;
  if (!maps) return -3;
  return launch_dtype<__nv_bfloat16>(a, D, st);
}
