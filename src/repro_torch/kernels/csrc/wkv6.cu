// RWKV-6 WKV recurrence, one (batch, head) a block:
//
//   y_t[e]    = sum_d r_t[d] * (S[d][e] + u[d] * k_t[d] * v_t[e])
//   S[d][e]  <- S[d][e] * w_t[d] + k_t[d] * v_t[e]         w_t = exp(logw_t)
//
// Replaces the TPU kernel repro/kernels/wkv6.py::wkv6_bhtd (body _wkv6_kernel),
// whose grid walks the chunks of one (batch, head) row in order with the D x D
// state in VMEM scratch, from a zero state, and returns no final state.  Here
// the state comes in (S0, or zeros when the pointer is null) and the final
// state is written back over it: the update in place is safe because one block
// alone reads and writes its (b, h) slice.  The C entry point picks one of two
// kernels: wkv6_chunk_kernel (below) for a bf16 prefill at D = 64, wkv6_kernel
// for everything else (f32, D = 32, a decode step).
//
// wkv6_kernel, the exact sequential recurrence on the CUDA cores.  What bounds
// it: over a prefill's length the f32 arithmetic, 5 operations a state element
// a step; for a decode step (T = 1) the bytes, the 16 KB state read once and
// written once.  The design:
//   * the TPU's sequential chunk axis becomes a loop over t inside the block;
//     there is no exp(-lcum) factor that can overflow, any T works with no
//     padding, and T = 1 is one iteration;
//   * kQ * D threads a block: thread (q, e) holds rows [q*R, q*R + R) of
//     column e of the state in registers (R = D / kQ), so a block has 8 warps
//     at D = 64 and two blocks share an SM.  A warp is 32 columns of one q, so
//     the r, k and w it reads from shared memory at each step are one address
//     for the whole warp, a broadcast: with q in the low lanes instead, each
//     128-bit load served four addresses and shared memory set the pace
//     (0.515 ms on an H100 at the prefill shape against 0.041 ms of bound,
//     0.174 ms with the broadcast);
//   * the kQ partial sums of y_t[e] go to shared memory and are added once for
//     the whole tile, with the bonus v_t[e] * sum_d r u k, when the tile's
//     outputs leave as whole rows: no barrier inside the step loop;
//   * inputs come in tiles of kTT steps, converted to f32 with w = exp(logw)
//     taken and the bonus reduced once for the tile; the next tile's loads are
//     issued into registers before the current tile's steps run, so their
//     latency hides behind the arithmetic.
#include "common.cuh"

namespace {

constexpr int kQ = 4;    // threads a value column
constexpr int kTT = 16;  // time steps a tile

// The body of wkv6_kernel and of the backward's third pass,
// wkv6_bwd_dv_kernel.  REV runs the recurrence from the last step to the
// first: step p of the loop is time T - 1 - p.
template <typename T, int D, bool REV>
__device__ __forceinline__ void
wkv6_sequential(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                const float* __restrict__ logw, const float* __restrict__ u, float* state,
                T* __restrict__ y, int T_len, int H,
                int64_t r_sb, int64_t r_st, int64_t r_sh, int64_t k_sb, int64_t k_st, int64_t k_sh,
                int64_t v_sb, int64_t v_st, int64_t v_sh, int64_t w_sb, int64_t w_st, int64_t w_sh) {
  constexpr int NT = kQ * D;
  constexpr int R = D / kQ;     // state rows a thread holds
  constexpr int NW = D / 32;    // warps across one row of D: partial sums of the bonus
  constexpr int PER = kTT / kQ; // steps of a tile a thread loads, one element of each input a step
  __shared__ __align__(16) float r_s[kTT][D];
  __shared__ __align__(16) float k_s[kTT][D];
  __shared__ __align__(16) float w_s[kTT][D];
  __shared__ float v_s[kTT][D];
  __shared__ float part_s[kQ][kTT][D];
  __shared__ float bonus_s[kTT][NW];

  const int tid = threadIdx.x;
  const int q = tid / D;  // which R rows of the key axis; one q a warp
  const int e = tid % D;  // value column, and the column this thread loads
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const T* rb = r + b * r_sb + h * r_sh + e;
  const T* kb = k + b * k_sb + h * k_sh + e;
  const T* vb = v + b * v_sb + h * v_sh + e;
  const float* wb = logw + b * w_sb + h * w_sh + e;
  T* yb = y + ((int64_t)b * T_len * H + h) * D;  // y is (B, T, H, D) contiguous
  const int64_t y_st = (int64_t)H * D;
  float* st = state == nullptr ? nullptr : state + (int64_t)blockIdx.x * D * D;
  const float ue = u[h * D + e];

  float S[R];
#pragma unroll
  for (int i = 0; i < R; ++i) S[i] = st == nullptr ? 0.0f : st[(q * R + i) * D + e];

  // thread (q, e) loads column e of steps q, q + kQ, q + 2 kQ, ... of a tile;
  // steps past T read as r = k = v = 0, logw = 0
  float pr[PER], pk[PER], pv[PER], pw[PER];
  auto fetch = [&](int t0) {
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int64_t p = t0 + q + j * kQ;
      const bool in = p < T_len;
      const int64_t t = REV ? T_len - 1 - p : p;
      pr[j] = in ? to_f32(rb[t * r_st]) : 0.0f;
      pk[j] = in ? to_f32(kb[t * k_st]) : 0.0f;
      pv[j] = in ? to_f32(vb[t * v_st]) : 0.0f;
      pw[j] = in ? wb[t * w_st] : 0.0f;
    }
  };
  fetch(0);

  for (int t0 = 0; t0 < T_len; t0 += kTT) {
    const int n = min(kTT, T_len - t0);
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int s = q + j * kQ;
      r_s[s][e] = pr[j];
      k_s[s][e] = pk[j];
      v_s[s][e] = pv[j];
      w_s[s][e] = expf(pw[j]);
      const float p = warp_sum(pr[j] * ue * pk[j]);  // a warp is 32 columns of one step
      if ((tid & 31) == 0) bonus_s[s][e / 32] = p;
    }
    __syncthreads();
    if (t0 + kTT < T_len) fetch(t0 + kTT);  // in flight while this tile's steps run

    for (int s = 0; s < n; ++s) {
      const float ve = v_s[s][e];
      const float4* r4 = reinterpret_cast<const float4*>(&r_s[s][q * R]);
      const float4* k4 = reinterpret_cast<const float4*>(&k_s[s][q * R]);
      const float4* w4 = reinterpret_cast<const float4*>(&w_s[s][q * R]);
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < R / 4; ++j) {
        const float4 rr = r4[j], kk = k4[j], ww = w4[j];
        // y reads the state before this step's update
        acc = fmaf(rr.x, S[4 * j + 0], acc);
        acc = fmaf(rr.y, S[4 * j + 1], acc);
        acc = fmaf(rr.z, S[4 * j + 2], acc);
        acc = fmaf(rr.w, S[4 * j + 3], acc);
        S[4 * j + 0] = fmaf(S[4 * j + 0], ww.x, kk.x * ve);
        S[4 * j + 1] = fmaf(S[4 * j + 1], ww.y, kk.y * ve);
        S[4 * j + 2] = fmaf(S[4 * j + 2], ww.z, kk.z * ve);
        S[4 * j + 3] = fmaf(S[4 * j + 3], ww.w, kk.w * ve);
      }
      part_s[q][s][e] = acc;
    }
    __syncthreads();

    for (int idx = tid; idx < n * D; idx += NT) {
      const int s = idx / D;
      const int d = idx % D;
      float bonus = 0.0f;
#pragma unroll
      for (int j = 0; j < NW; ++j) bonus += bonus_s[s][j];
      float yv = v_s[s][d] * bonus;
#pragma unroll
      for (int qq = 0; qq < kQ; ++qq) yv += part_s[qq][s][d];
      const int64_t t = REV ? T_len - 1 - (t0 + s) : t0 + s;
      yb[t * y_st + d] = from_f32<T>(yv);
    }
    __syncthreads();  // the next tile overwrites the shared arrays
  }

  if (st != nullptr) {
#pragma unroll
    for (int i = 0; i < R; ++i) st[(q * R + i) * D + e] = S[i];
  }
}

// the parameters of wkv6_sequential, which its two kernels pass on
#define WKV6_SEQ_PARAMS                                                                                    \
  const T *__restrict__ r, const T *__restrict__ k, const T *__restrict__ v, const float *__restrict__ logw, \
      const float *__restrict__ u, float *state, T *__restrict__ y, int T_len, int H, int64_t r_sb,          \
      int64_t r_st, int64_t r_sh, int64_t k_sb, int64_t k_st, int64_t k_sh, int64_t v_sb, int64_t v_st,       \
      int64_t v_sh, int64_t w_sb, int64_t w_st, int64_t w_sh
#define WKV6_SEQ_ARGS \
  r, k, v, logw, u, state, y, T_len, H, r_sb, r_st, r_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, w_sb, w_st, w_sh

template <typename T, int D>
__global__ void __launch_bounds__(kQ * D) wkv6_kernel(WKV6_SEQ_PARAMS) {
  wkv6_sequential<T, D, false>(WKV6_SEQ_ARGS);
}

// The backward's pass C (wkv6_bwd_launch): the same recurrence backward in
// time, under a name of its own so that a profile counts it with the backward.
template <typename T, int D>
__global__ void __launch_bounds__(kQ * D) wkv6_bwd_dv_kernel(WKV6_SEQ_PARAMS) {
  wkv6_sequential<T, D, true>(WKV6_SEQ_ARGS);
}
#undef WKV6_SEQ_PARAMS
#undef WKV6_SEQ_ARGS

// ---------------------------------------------------------------------------
// bf16, head size 64, T >= t_min: chunks of 64 steps on the tensor cores
// ---------------------------------------------------------------------------

constexpr int CK = 64;       // steps a chunk; also the head size this kernel takes
constexpr int CK_NT = 128;   // four warps
constexpr int LDB = CK + 8;  // bf16 a row of r, k, v and the state's operand: ldmatrix without conflicts
constexpr int LDL = CK + 4;  // f32 a row of logw, then of its cumulative sum
constexpr float kLog2e = 1.4426950408889634f;

struct ChunkLayout {
  static constexpr int BF = CK * LDB;  // elements of a bf16 tile
  static constexpr int LF = CK * LDL;  // floats of an f32 tile
  // r, k, v in two stages, the state's high and low parts (bf16); logw in two stages (f32)
  static constexpr int BYTES = (3 * 2 + 2) * BF * 2 + 2 * LF * 4;
};

// 2^x for x <= 0, which every caller guarantees: a result below 2^-126 is 0
__device__ inline float exp2_nonpos(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// (a, b) = hi + lo, each a bf16 pair: the split keeps about 16 bits of each
__device__ inline void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 f = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - f.x, b - f.y);
}

__device__ inline float2 bf2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// wkv6_chunk_kernel: the chunked form, on the tensor cores.  Per chunk of 64
// steps, with L the inclusive cumulative log2 decay along the chunk (in place
// of logw), Lx the exclusive one (L of the row before), Lt the chunk's total:
//
//   y = A V + (r exp(Lx)) S_prev          S <- exp(Lt) S + (k exp(Lt - L))^T V
//   A[i][j] = sum_d r_i k_j exp(Lx_i - L_j) for j < i, sum_d r_i u k_i at j = i
//
// Bound by bytes (r, k, v, logw read once, y written once, the state): its
// mma.sync operations take a quarter of the byte time at the tensor cores'
// peak.  Four warps; warp w owns rows 16w.. of the chunk (y, A) and of the
// state (its key channels d, all 64 value columns in m16n8 accumulators).
//   * A in 16-row sub-chunks.  Against earlier sub-chunks (j < bd = 16w) the
//     decay factors through the boundary: exp(Lx_i - Lx_bd) exp(Lx_bd - L_j),
//     both <= 1, scale r and k into the operands of one product.  In the
//     16 x 16 diagonal block, rows 8.. against columns ..7 the same with the
//     boundary bd + 8; the two 8 x 8 blocks on the diagonal directly, one exp
//     of Lx_i - L_j (<= 0) per (i, j, d) in f32 on the CUDA cores, 56 entries
//     over the 32 lanes; the bonus on the diagonal.  No exponent anywhere is
//     > 0, so no factor overflows where the chunked plain form's exp(-L) does.
//   * Every operand that is not a bf16 input is split into a bf16 high and
//     low part, and a product is three mma.sync (hi hi, lo hi, hi lo) or two
//     against V: rounded once, the operands part y from the recurrence by 0.8
//     to 1.0 of the bf16 tolerance (tests/test_torch_wkv6_chunk.py), and the
//     f32 state by more than its 2e-4.
//   * r, k, v and logw of the next chunk come in by cp.async into a second
//     stage while the current one is computed; y leaves from the accumulators.
template <int D>  // D == CK: the head size, named like the other kernels' template sizes
__global__ void __launch_bounds__(CK_NT, 2)
wkv6_chunk_kernel(const __nv_bfloat16* __restrict__ r, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, const float* __restrict__ logw,
                  const float* __restrict__ u, float* state, __nv_bfloat16* __restrict__ y,
                  int T_len, int H, int64_t r_sb, int64_t r_st, int64_t r_sh, int64_t k_sb,
                  int64_t k_st, int64_t k_sh, int64_t v_sb, int64_t v_st, int64_t v_sh,
                  int64_t w_sb, int64_t w_st, int64_t w_sh) {
  static_assert(D == CK, "the chunked kernel is written for head size 64");
  using L = ChunkLayout;
  extern __shared__ uint4 smem_chunk[];
  __nv_bfloat16* sR = reinterpret_cast<__nv_bfloat16*>(smem_chunk);  // [2][CK][LDB]
  __nv_bfloat16* sK = sR + 2 * L::BF;
  __nv_bfloat16* sV = sK + 2 * L::BF;
  __nv_bfloat16* sS = sV + 2 * L::BF;  // the state before the chunk, [d][e]: high part, then low part
  float* sW = reinterpret_cast<float*>(sS + 2 * L::BF);  // [2][CK][LDL]: logw, then L in log2 units
  __shared__ float sU[CK];
  __shared__ float sE[4 * 2 * 64];  // (2b): each warp's two 8 x 8 diagonal blocks

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // fragment rows g and g + 8
  const int t = lane & 3;   // fragment columns 2t, 2t + 1 (and + 8)
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const __nv_bfloat16* rb = r + b * r_sb + h * r_sh;
  const __nv_bfloat16* kb = k + b * k_sb + h * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + h * v_sh;
  const float* wb = logw + b * w_sb + h * w_sh;
  __nv_bfloat16* yb = y + ((int64_t)b * T_len * H + h) * CK;  // y is (B, T, H, D) contiguous
  const int64_t y_st = (int64_t)H * CK;
  float* st = state == nullptr ? nullptr : state + (int64_t)blockIdx.x * CK * CK;
  if (tid < CK) sU[tid] = u[h * CK + tid];

  // the state in mma accumulators: rows d0 and d0 + 8, columns 8n + 2t and + 1
  const int d0 = warp * 16 + g;
  float sacc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float2 s2 = st == nullptr ? make_float2(0.0f, 0.0f)
                                      : *reinterpret_cast<const float2*>(st + (d0 + 8 * hf) * CK + 8 * n + 2 * t);
      sacc[n][2 * hf] = s2.x;
      sacc[n][2 * hf + 1] = s2.y;
    }

  // rows of a chunk past T read as r = k = v = 0 and logw = 0: they add nothing and decay nothing
  auto load_chunk = [&](int c, int stage) {
    const int t0 = c * CK;
    const int valid = T_len - t0;
#pragma unroll
    for (int i = 0; i < CK * CK / 8 / CK_NT; ++i) {
      const int idx = tid + i * CK_NT;
      const int row = idx >> 3;
      const int col = (idx & 7) * 8;
      const bool ok = row < valid;
      const int64_t tt = t0 + (ok ? row : 0);
      const int off = stage * L::BF + row * LDB + col;
      cp_async16(smem_addr(sR + off), rb + tt * r_st + col, ok);
      cp_async16(smem_addr(sK + off), kb + tt * k_st + col, ok);
      cp_async16(smem_addr(sV + off), vb + tt * v_st + col, ok);
    }
#pragma unroll
    for (int i = 0; i < CK * CK / 4 / CK_NT; ++i) {
      const int idx = tid + i * CK_NT;
      const int row = idx >> 4;
      const int col = (idx & 15) * 4;
      const bool ok = row < valid;
      cp_async16(smem_addr(sW + stage * L::LF + row * LDL + col), wb + (t0 + (ok ? row : 0)) * w_st + col, ok);
    }
  };

  const int nchunks = (T_len + CK - 1) / CK;
  load_chunk(0, 0);
  cp_async_commit();
  for (int c = 0; c < nchunks; ++c) {
    const int stage = c & 1;
    if (c + 1 < nchunks) load_chunk(c + 1, stage ^ 1);
    cp_async_commit();   // an empty group on the last chunk keeps the count
    cp_async_wait<1>();  // chunk c has landed
    __syncthreads();
    const __nv_bfloat16* cR = sR + stage * L::BF;
    const __nv_bfloat16* cK = sK + stage * L::BF;
    const __nv_bfloat16* cV = sV + stage * L::BF;
    float* cL = sW + stage * L::LF;

    // L = the inclusive cumulative sum of logw * log2(e) along the chunk, in
    // place: thread (d, half) sums its 32 rows, then the second half adds the
    // first half's total.  Each partial sum only falls, so L_i <= L_j for i >= j
    // holds exactly, and every exponent below is <= 0.
    {
      const int d = tid & (CK - 1);
      const int r0 = (tid >> 6) * (CK / 2);
      float acc = 0.0f;
#pragma unroll 8
      for (int i = 0; i < CK / 2; ++i) {
        acc = fmaf(cL[(r0 + i) * LDL + d], kLog2e, acc);
        cL[(r0 + i) * LDL + d] = acc;
      }
    }
    // the state before this chunk, as the B operand of y's product: high and low parts
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        uint32_t hi, lo;
        split_bf16(sacc[n][2 * hf], sacc[n][2 * hf + 1], hi, lo);
        const int off = (d0 + 8 * hf) * LDB + 8 * n + 2 * t;
        *reinterpret_cast<uint32_t*>(sS + off) = hi;
        *reinterpret_cast<uint32_t*>(sS + L::BF + off) = lo;
      }
    __syncthreads();
    if (tid >= CK) {
      const int d = tid - CK;
      const float base = cL[(CK / 2 - 1) * LDL + d];
#pragma unroll 8
      for (int i = CK / 2; i < CK; ++i) cL[i * LDL + d] += base;
    }
    __syncthreads();

    // L of row i at columns dc, dc + 1; Lx (exclusive) of row i is L of row i - 1, 0 for row 0
    auto L2 = [&](int i, int dc) { return *reinterpret_cast<const float2*>(cL + i * LDL + dc); };
    auto Lx2 = [&](int i, int dc) { return i > 0 ? L2(i - 1, dc) : make_float2(0.0f, 0.0f); };
    const int i0 = warp * 16 + g;  // this lane's rows of the chunk: i0 and i0 + 8
    const int i1 = i0 + 8;

    // (1) A against the earlier sub-chunks (j < bd = 16 warp): with the
    // boundary bd, exp(Lx_i - L_j) = exp(Lx_i - Lx_bd) * exp(Lx_bd - L_j), both
    // factors <= 1, scaling r and k into bf16 operands (high and low parts)
    const int bd = warp * 16;
    float A[6][4];
#pragma unroll
    for (int jt = 0; jt < 6; ++jt)
#pragma unroll
      for (int e = 0; e < 4; ++e) A[jt][e] = 0.0f;
    if (warp > 0) {
      uint32_t rh[4][4], rl[4][4];
      float2 lb[4][2];  // Lx of the boundary row at the lane's columns
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int q = 0; q < 2; ++q) lb[ks][q] = Lx2(bd, ks * 16 + 2 * t + q * 8);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int row = (q & 1) ? i1 : i0;
          const int dc = ks * 16 + 2 * t + (q >> 1) * 8;
          const float2 rr = bf2(cR + row * LDB + dc);
          const float2 lx = Lx2(row, dc), lbq = lb[ks][q >> 1];
          split_bf16(rr.x * exp2_nonpos(lx.x - lbq.x), rr.y * exp2_nonpos(lx.y - lbq.y), rh[ks][q], rl[ks][q]);
        }
#pragma unroll
      for (int jt = 0; jt < 6; ++jt) {
        if (jt >= 2 * warp) break;
        const int j = jt * 8 + g;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          uint32_t bh[2], bl[2];
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int dc = ks * 16 + 2 * t + q * 8;
            const float2 kk = bf2(cK + j * LDB + dc);
            const float2 lj = L2(j, dc), lbq = lb[ks][q];
            split_bf16(kk.x * exp2_nonpos(lbq.x - lj.x), kk.y * exp2_nonpos(lbq.y - lj.y), bh[q], bl[q]);
          }
          mma_bf16(A[jt], rh[ks], bh[0], bh[1]);
          mma_bf16(A[jt], rl[ks], bh[0], bh[1]);
          mma_bf16(A[jt], rh[ks], bl[0], bl[1]);
        }
      }
    }

    // (2) A within the sub-chunk, whose rows and columns are bd .. bd + 15.
    // (2a) Rows bd + 8.. against columns bd.. bd + 7 on the tensor cores, as in
    // (1) with the boundary m = bd + 8: A's rows bd.. bd + 7 are zeros, so only
    // the accumulators of rows i1 (E[2], E[3] below) are kept.
    float A8[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    {
      const int m = bd + 8;
      const int j = bd + g;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        uint32_t ah[4] = {0u, 0u, 0u, 0u}, al[4] = {0u, 0u, 0u, 0u}, bh[2], bl[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int dc = ks * 16 + 2 * t + q * 8;
          const float2 rr = bf2(cR + i1 * LDB + dc);
          const float2 lx = Lx2(i1, dc), lm = Lx2(m, dc), lj = L2(j, dc);
          split_bf16(rr.x * exp2_nonpos(lx.x - lm.x), rr.y * exp2_nonpos(lx.y - lm.y), ah[1 + 2 * q], al[1 + 2 * q]);
          const float2 kk = bf2(cK + j * LDB + dc);
          split_bf16(kk.x * exp2_nonpos(lm.x - lj.x), kk.y * exp2_nonpos(lm.y - lj.y), bh[q], bl[q]);
        }
        mma_bf16(A8, ah, bh[0], bh[1]);
        mma_bf16(A8, al, bh[0], bh[1]);
        mma_bf16(A8, ah, bl[0], bl[1]);
      }
    }
    // (2b) The two 8 x 8 blocks on the diagonal, on the CUDA cores in f32: of
    // each, the 28 entries with j < i, exp(Lx_i - L_j) straight from the
    // difference.  56 entries over 32 lanes, two a lane, then through shared
    // memory to the lanes that hold them in the accumulator layout.
    float* sEw = sE + warp * 2 * 64;  // [block][i][j] of this warp
#pragma unroll
    for (int s2 = 0; s2 < 2; ++s2) {
      int p = lane + 32 * s2;
      if (p < 56) {
        const int blk = p / 28;
        p -= blk * 28;
        int i = 1;
        while (p >= i) {  // the p-th entry below the diagonal, by rows: (1, 0), (2, 0), (2, 1), ...
          p -= i;
          ++i;
        }
        const int row = bd + 8 * blk + i;  // >= 1, so Lx of row is L of row - 1
        const int col = bd + 8 * blk + p;
        float acc = 0.0f;
#pragma unroll 4
        for (int dq = 0; dq < CK; dq += 4) {
          const float2 r01 = bf2(cR + row * LDB + dq), r23 = bf2(cR + row * LDB + dq + 2);
          const float2 k01 = bf2(cK + col * LDB + dq), k23 = bf2(cK + col * LDB + dq + 2);
          const float4 x4 = *reinterpret_cast<const float4*>(cL + (row - 1) * LDL + dq);
          const float4 l4 = *reinterpret_cast<const float4*>(cL + col * LDL + dq);
          acc += r01.x * k01.x * exp2_nonpos(x4.x - l4.x);
          acc += r01.y * k01.y * exp2_nonpos(x4.y - l4.y);
          acc += r23.x * k23.x * exp2_nonpos(x4.z - l4.z);
          acc += r23.y * k23.y * exp2_nonpos(x4.w - l4.w);
        }
        sEw[blk * 64 + i * 8 + p] = acc;
      }
    }
    __syncwarp();
    float bonus[2] = {0.0f, 0.0f};
    // the bonus of rows i0 and i1: lane t takes d in [16t, 16t + 16), the quad adds
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int row = a ? i1 : i0;
#pragma unroll
      for (int dd = 0; dd < 16; dd += 2) {
        const int dc = 16 * t + dd;
        const float2 rr = bf2(cR + row * LDB + dc), kk = bf2(cK + row * LDB + dc);
        bonus[a] += rr.x * sU[dc] * kk.x + rr.y * sU[dc + 1] * kk.y;
      }
      bonus[a] += __shfl_xor_sync(0xffffffffu, bonus[a], 1);
      bonus[a] += __shfl_xor_sync(0xffffffffu, bonus[a], 2);
    }
    // the lane's entries of the 16 x 16 block in the accumulator layout: rows
    // g (E[0], E[1]) and g + 8 (E[2]..E[5]) of the sub-chunk, columns 2t + {0, 1}
    // (E[0]..E[3]) and 8 + 2t + {0, 1} (E[4], E[5]); rows g against columns
    // 8.. lie above the diagonal.  Below it: (2b), or (2a) for E[2], E[3]; on
    // it: the bonus.
    float E[6];
    E[2] = A8[2];
    E[3] = A8[3];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int j = 2 * t + q;
      E[q] = j < g ? sEw[g * 8 + j] : (j == g ? bonus[0] : 0.0f);
      E[4 + q] = j < g ? sEw[64 + g * 8 + j] : (j == g ? bonus[1] : 0.0f);
    }

    // (3) y = A V + (r exp(Lx)) S_prev: A's 16 x 16 blocks as A fragments
    // (high and low parts), V and S_prev through ldmatrix.trans
    float yacc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) yacc[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk > warp) break;
      uint32_t ah[4], al[4];
      if (kk < 3 && kk < warp) {  // kk < 3 keeps A's index in bounds where the loop is unrolled
        split_bf16(A[2 * kk][0], A[2 * kk][1], ah[0], al[0]);
        split_bf16(A[2 * kk][2], A[2 * kk][3], ah[1], al[1]);
        split_bf16(A[2 * kk + 1][0], A[2 * kk + 1][1], ah[2], al[2]);
        split_bf16(A[2 * kk + 1][2], A[2 * kk + 1][3], ah[3], al[3]);
      } else {
        split_bf16(E[0], E[1], ah[0], al[0]);
        split_bf16(E[2], E[3], ah[1], al[1]);
        ah[2] = 0u;
        al[2] = 0u;
        split_bf16(E[4], E[5], ah[3], al[3]);
      }
#pragma unroll
      for (int n = 0; n < 8; n += 2) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, smem_addr(cV + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDB + n * 8 +
                                        (lane >> 4) * 8));
        mma_bf16(yacc[n], ah, vf[0], vf[1]);
        mma_bf16(yacc[n], al, vf[0], vf[1]);
        mma_bf16(yacc[n + 1], ah, vf[2], vf[3]);
        mma_bf16(yacc[n + 1], al, vf[2], vf[3]);
      }
    }
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t qh[4], ql[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = (q & 1) ? i1 : i0;
        const int dc = ks * 16 + 2 * t + (q >> 1) * 8;
        const float2 rr = bf2(cR + row * LDB + dc);
        const float2 lx = Lx2(row, dc);
        split_bf16(rr.x * exp2_nonpos(lx.x), rr.y * exp2_nonpos(lx.y), qh[q], ql[q]);
      }
#pragma unroll
      for (int n = 0; n < 8; n += 2) {
        const int off = (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDB + n * 8 + (lane >> 4) * 8;
        uint32_t sh[4], sl[4];
        ldmatrix_x4_trans(sh, smem_addr(sS + off));
        ldmatrix_x4_trans(sl, smem_addr(sS + L::BF + off));
        mma_bf16(yacc[n], qh, sh[0], sh[1]);
        mma_bf16(yacc[n], ql, sh[0], sh[1]);
        mma_bf16(yacc[n], qh, sl[0], sl[1]);
        mma_bf16(yacc[n + 1], qh, sh[2], sh[3]);
        mma_bf16(yacc[n + 1], ql, sh[2], sh[3]);
        mma_bf16(yacc[n + 1], qh, sl[2], sl[3]);
      }
    }
    const int t0 = c * CK;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      if (t0 + i0 < T_len)
        *reinterpret_cast<__nv_bfloat162*>(yb + (t0 + i0) * y_st + 8 * n + 2 * t) =
            __floats2bfloat162_rn(yacc[n][0], yacc[n][1]);
      if (t0 + i1 < T_len)
        *reinterpret_cast<__nv_bfloat162*>(yb + (t0 + i1) * y_st + 8 * n + 2 * t) =
            __floats2bfloat162_rn(yacc[n][2], yacc[n][3]);
    }

    // (4) S <- diag(exp(Lt)) S + (k exp(Lt - L))^T V, Lt = L of the chunk's last
    // row (pad rows add 0); the left factor in high and low parts
    const float lt[2] = {cL[(CK - 1) * LDL + d0], cL[(CK - 1) * LDL + d0 + 8]};
    const float dec[2] = {exp2_nonpos(lt[0]), exp2_nonpos(lt[1])};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[n][e] *= dec[e >> 1];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t kh[4], kl[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int d = d0 + (q & 1) * 8;
        const int j = ks * 16 + 2 * t + (q >> 1) * 8;
        const float f0 = exp2_nonpos(lt[q & 1] - cL[j * LDL + d]);
        const float f1 = exp2_nonpos(lt[q & 1] - cL[(j + 1) * LDL + d]);
        split_bf16(__bfloat162float(cK[j * LDB + d]) * f0, __bfloat162float(cK[(j + 1) * LDB + d]) * f1,
                   kh[q], kl[q]);
      }
#pragma unroll
      for (int n = 0; n < 8; n += 2) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, smem_addr(cV + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDB + n * 8 +
                                        (lane >> 4) * 8));
        mma_bf16(sacc[n], kh, vf[0], vf[1]);
        mma_bf16(sacc[n], kl, vf[0], vf[1]);
        mma_bf16(sacc[n + 1], kh, vf[2], vf[3]);
        mma_bf16(sacc[n + 1], kl, vf[2], vf[3]);
      }
    }
    __syncthreads();  // before the next chunk rewrites S_prev and this stage is loaded again
  }

  if (st != nullptr) {
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        *reinterpret_cast<float2*>(st + (d0 + 8 * hf) * CK + 8 * n + 2 * t) =
            make_float2(sacc[n][2 * hf], sacc[n][2 * hf + 1]);
  }
}

// ---------------------------------------------------------------------------
// The backward, from a zero initial state and with no final state
// ---------------------------------------------------------------------------
//
// What XLA derives for the reference's _wkv_chunked when it trains; the TPU
// kernel has no backward.  With drI_t = S_{t-1} dy_t and dkI_t = dS_t v_t the
// parts of dr and dk that come through the state (dS_t the gradient of the
// state after step t, dS = 0 after the last step):
//
//   dr_t = drI_t + u k_t (v_t.dy_t)       S_t     = diag(w_t) S_{t-1} + k_t^T v_t
//   dk_t = dkI_t + u r_t (v_t.dy_t)       dS_{t-1} = diag(w_t) dS_t + r_t^T dy_t
//   dv_t = dS_t^T k_t + (r_t.u.k_t) dy_t
//   du   = sum over b and t of r_t k_t (v_t.dy_t)
//   dlogw_s = sum_{t>s} r_t drI_t - sum_{t>=s} k_t dkI_t
//
// The last line needs no state and no exp: y reads logw only through the
// decay between two steps, and each pair's term adds to r_t drI_t and to
// k_s dkI_s alike.  Three passes over the recurrence, each one block a
// (batch, head), f32 throughout, no atomics (a run is bit-reproducible):
//   A  wkv6_bwd_kernel<T, D, false>, forward in time: S by rows; writes dr and
//      r_t drI_t (f32 scratch), and du's partial of the (b, h);
//   B  wkv6_bwd_kernel<T, D, true>, backward in time: dS by rows; writes dk
//      and dlogw, reading A's scratch;
//   C  wkv6_bwd_dv_kernel<T, D>, wkv6_kernel's body backward in time:
//      dv_t = sum_i k_t[i] dS_t[i][.] + (k.u.r) dy_t
//      is the forward recurrence run backward in time with k for r, r for k
//      and dy for v (a pair's decay leaves out both its ends, so it reads the
//      same either way), the column layout its reduction over i needs;
// then wkv6_du_kernel sums du's partials over the batch in order.  A and B are
// one kernel: B is A run backward in time with (x, y, kk, z) = (v, dy, r, k)
// for A's (dy, v, k, r),
//
//   part_t = M x_t          M <- diag(w_t) M + kk_t^T y_t
//   out_t  = part_t + u kk_t (x_t.y_t)
//
// with M = S in A, dS in B.  Bound by f32 operations, 5 a state element a
// step in each of the three passes (a dot product's FMA, then a multiply and
// an FMA for the update): 15, where the gradients need 12, since C carries dS
// a second time instead of reading it off B.  The layout is wkv6_kernel's
// transposed: thread (q, i) holds columns [q R, q R + R) of row i of M in
// registers, so x_t and y_t are one shared-memory address for a whole warp (a
// broadcast) and kk_t, w_t one address a lane; the kQ partial sums of part_t
// meet in shared memory once a tile.  B's running sum for dlogw goes along time, so after each tile
// one thread a row walks the tile's steps in order.
template <typename T, int D, bool REV>
__global__ void __launch_bounds__(kQ * D)
wkv6_bwd_kernel(const T* __restrict__ x, const T* __restrict__ y, const T* __restrict__ kk,
                const T* __restrict__ z, const float* __restrict__ logw, const float* __restrict__ u,
                T* __restrict__ out, float* __restrict__ scratch, float* __restrict__ dlogw,
                float* __restrict__ du_part, int T_len, int H,
                int64_t x_sb, int64_t x_st, int64_t x_sh, int64_t y_sb, int64_t y_st, int64_t y_sh,
                int64_t k_sb, int64_t k_st, int64_t k_sh, int64_t z_sb, int64_t z_st, int64_t z_sh,
                int64_t w_sb, int64_t w_st, int64_t w_sh) {
  constexpr int R = D / kQ;
  constexpr int NW = D / 32;
  constexpr int PER = kTT / kQ;
  __shared__ __align__(16) float x_s[kTT][D];
  __shared__ __align__(16) float y_s[kTT][D];
  __shared__ float k_s[kTT][D];
  __shared__ float z_s[kTT][D];
  __shared__ float w_s[kTT][D];
  __shared__ float a_s[kTT][D];  // B: A's r_t drI_t of the tile
  __shared__ float part_s[kQ][kTT][D];
  __shared__ float xy_s[kTT][NW];

  const int tid = threadIdx.x;
  const int q = tid / D;  // which R columns of M; one q a warp
  const int i = tid % D;  // row of M, and the element this thread loads
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const T* xb = x + b * x_sb + h * x_sh + i;
  const T* yb = y + b * y_sb + h * y_sh + i;
  const T* kb = kk + b * k_sb + h * k_sh + i;
  const T* zb = z + b * z_sb + h * z_sh + i;
  const float* wb = logw + b * w_sb + h * w_sh + i;
  const int64_t o_st = (int64_t)H * D;  // out and dlogw are (B, T, H, D) contiguous
  const int64_t o_base = ((int64_t)b * T_len * H + h) * D;
  float* sc = scratch + (int64_t)blockIdx.x * T_len * D;  // (B H, T, D)
  const float ui = u[h * D + i];

  float M[R];
#pragma unroll
  for (int j = 0; j < R; ++j) M[j] = 0.0f;
  float du_acc = 0.0f;    // A: this thread's steps of sum_t kk z (x.y)
  // B, the threads of q = 0: sum_{t'>t} r drI - sum_{t'>=t} k dkI, one running
  // sum, which stays the size of dlogw; the two sums apart grow along T and
  // their difference loses their rounding (4x the error at 4 x 512 tokens)
  float run = 0.0f;

  // thread (q, i) loads element i of loop steps q, q + kQ, ...; past T all zeros
  float px[PER], py[PER], pk[PER], pz[PER], pw[PER], pa[PER];
  auto fetch = [&](int p0) {
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int64_t p = p0 + q + j * kQ;
      const bool in = p < T_len;
      const int64_t t = REV ? T_len - 1 - p : p;
      px[j] = in ? to_f32(xb[t * x_st]) : 0.0f;
      py[j] = in ? to_f32(yb[t * y_st]) : 0.0f;
      pk[j] = in ? to_f32(kb[t * k_st]) : 0.0f;
      pz[j] = in ? to_f32(zb[t * z_st]) : 0.0f;
      pw[j] = in ? wb[t * w_st] : 0.0f;
      pa[j] = REV && in ? sc[t * D + i] : 0.0f;
    }
  };
  fetch(0);

  for (int p0 = 0; p0 < T_len; p0 += kTT) {
    const int n = min(kTT, T_len - p0);
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int s = q + j * kQ;
      x_s[s][i] = px[j];
      y_s[s][i] = py[j];
      k_s[s][i] = pk[j];
      z_s[s][i] = pz[j];
      w_s[s][i] = expf(pw[j]);
      a_s[s][i] = pa[j];
      const float p = warp_sum(px[j] * py[j]);  // a warp is 32 rows of one step
      if ((tid & 31) == 0) xy_s[s][i / 32] = p;
    }
    __syncthreads();
    if (p0 + kTT < T_len) fetch(p0 + kTT);  // in flight while this tile's steps run

    for (int s = 0; s < n; ++s) {
      const float kv = k_s[s][i], wv = w_s[s][i];
      const float4* x4 = reinterpret_cast<const float4*>(&x_s[s][q * R]);
      const float4* y4 = reinterpret_cast<const float4*>(&y_s[s][q * R]);
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < R / 4; ++j) {
        const float4 xx = x4[j], yy = y4[j];
        // part reads M before this step's update
        acc = fmaf(M[4 * j + 0], xx.x, acc);
        acc = fmaf(M[4 * j + 1], xx.y, acc);
        acc = fmaf(M[4 * j + 2], xx.z, acc);
        acc = fmaf(M[4 * j + 3], xx.w, acc);
        M[4 * j + 0] = fmaf(M[4 * j + 0], wv, kv * yy.x);
        M[4 * j + 1] = fmaf(M[4 * j + 1], wv, kv * yy.y);
        M[4 * j + 2] = fmaf(M[4 * j + 2], wv, kv * yy.z);
        M[4 * j + 3] = fmaf(M[4 * j + 3], wv, kv * yy.w);
      }
      part_s[q][s][i] = acc;
    }
    __syncthreads();

    // thread (q, i) finishes row i of steps q, q + kQ, ... of the tile
    for (int s = q; s < n; s += kQ) {
      float xy = 0.0f;
#pragma unroll
      for (int j = 0; j < NW; ++j) xy += xy_s[s][j];
      float part = 0.0f;
#pragma unroll
      for (int qq = 0; qq < kQ; ++qq) part += part_s[qq][s][i];
      const int64_t t = REV ? T_len - 1 - (p0 + s) : p0 + s;
      out[o_base + t * o_st + i] = from_f32<T>(part + ui * k_s[s][i] * xy);
      if (REV) {
        part_s[0][s][i] = z_s[s][i] * part;  // k_t dkI_t, for the walk below
      } else {
        sc[t * D + i] = z_s[s][i] * part;    // r_t drI_t
        du_acc = fmaf(k_s[s][i] * z_s[s][i], xy, du_acc);
      }
    }
    if (REV) {
      __syncthreads();
      if (q == 0) {
        for (int s = 0; s < n; ++s) {
          run -= part_s[0][s][i];
          const int64_t t = T_len - 1 - (p0 + s);
          dlogw[o_base + t * o_st + i] = run;
          run += a_s[s][i];
        }
      }
    }
    __syncthreads();  // the next tile overwrites the shared arrays
  }

  if (!REV) {
    part_s[q][0][i] = du_acc;
    __syncthreads();
    if (q == 0) {
      float sum = 0.0f;
#pragma unroll
      for (int qq = 0; qq < kQ; ++qq) sum += part_s[qq][0][i];
      du_part[(int64_t)blockIdx.x * D + i] = sum;
    }
  }
}

// du[h][i] = sum over b of du_part[b][h][i], b in order
__global__ void wkv6_du_kernel(const float* __restrict__ du_part, float* __restrict__ du, int B, int HD) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= HD) return;
  float sum = 0.0f;
  for (int b = 0; b < B; ++b) sum += du_part[(int64_t)b * HD + idx];
  du[idx] = sum;
}

// ---------------------------------------------------------------------------
// The backward, bf16 at head size 64, T >= t_min: chunks of 64 steps on the tensor cores
// ---------------------------------------------------------------------------
//
// Replaces the same function as the passes above, what XLA derives for the
// reference's _wkv_chunked (there is no TPU kernel), for the bf16 inputs of
// training at head size 64.  What bounds it on an H100: the bytes, r, k, v,
// dy and logw read and dr, dk, dv and dlogw written once, 0.055 ms at 4 x 512
// tokens of 64 heads, and the S_prev workspace written and read once (another
// 0.020 ms); its tensor-core operations, counted from the code, take 0.026 ms.
// Per chunk of 64 steps, with L the inclusive cumulative log2 decay (in place
// of logw), Lx the exclusive one, Lt the chunk's total, dA_ij = dy_i . v_j,
// S_prev the state before the chunk and dS the gradient of the state after it:
//
//   drI_i = sum_{j<i} dA_ij (k_j 2^(Lx_i - L_j)) + 2^(Lx_i) (S_prev dy_i)
//   dkI_j = sum_{i>j} dA_ij (r_i 2^(Lx_i - L_j)) + 2^(Lt - L_j) (dS v_j)
//   dv_j  = sum_{i>=j} A_ij dy_i + (k_j 2^(Lt - L_j)) dS
//   dS   <- 2^(Lt) dS + (r 2^(Lx))^T dy,  dlogw as the passes above have it.
//
// Two launches and the du sum, where the passes above walk the recurrence
// three times step by step on the CUDA cores:
//   * wkv6_bwd_state_kernel: one block a (batch, head) walks the chunks
//     forward with wkv6_chunk_kernel's step (4) alone and writes S before each
//     chunk to an f32 workspace (B H, nc, 64, 64), 16 KB a chunk.
//   * wkv6_bwd_chunk_kernel: one block a (batch, head), four warps, walks the
//     chunks backward with dS in shared memory (f32) and computes every
//     gradient of a chunk in one pass.  Warp w owns rows [b, B) = [16w, 16w +
//     16) of the chunk for drI, dkI, dv and dlogw, and rows 16w.. of dS.  The
//     decay factors through the sub-chunk boundaries, so that no exponent is
//     > 0: drI = 2^(Lx_i - Lx_b) (2^(Lx_b) dy S_prev^T + dA k'), k' = k_j
//     2^(Lx_b - L_j) for j < b; dkI = 2^(Lx_B - L_j) (2^(Lt - Lx_B) v dS^T +
//     dA^T r'), r' = r_i 2^(Lx_i - Lx_B) for i >= B; A^T against the later
//     sub-chunks = (k_j 2^(Lx_B - L_j)) . r'_i.  The 16 x 16 block on the
//     diagonal as the forward's (2a) and (2b): its rows 8.. against its
//     columns ..7 on the tensor cores through the boundary b + 8, its two 8 x 8
//     blocks in f32 on the CUDA cores, exp2(Lx_i - L_j) straight from the
//     difference, for drI, dkI and A at once.  dlogw = sum_{t>s} r drI -
//     sum_{t>=s} k dkI: suffix sums over the warp's rows by shuffles, the later
//     warps' sums and one running sum of the later chunks, all of differences.
//   * Every product is mma.sync (m16n8k16, m16n8k8 for the 8-row blocks) with
//     f32 sums.  An operand that is not a bf16 input is split into bf16 parts,
//     each the rounding of what the parts before leave: dlogw is f32 and held
//     at f32's 2e-4, so the operands on its path (S_prev, dS, dA, the decayed r
//     and k, the state walk's k) take three parts, about 24 bits
//     (tests/test_torch_wkv6_bwd_chunk.py: two parts leave dlogw at 1.8 times
//     that at T = 512), and dv's (A^T, k 2^(Lt - L) against dS) two, as the
//     forward's y.
//   * The loops over k-steps, sub-chunks and the rows of the diagonal block
//     stay loops (only the loops over an accumulator's tiles are unrolled):
//     unrolled, a chunk's body is some 20,000 instructions, which the
//     instruction cache cannot hold: on an H100 the kernel then ran at 0.69 ms.
//   * No atomics: du's partials go to du_part, summed in order by wkv6_du_kernel.
// The inputs of a chunk come in by cp.async in one stage (the shared memory
// holds two blocks an SM); the chunk before is loaded while dlogw is summed.
// On an H100 it runs at 0.32 ms at 4 x 512 x 64 heads, 0.28 of it the gradient
// walk: the SM issues about two-thirds of an instruction a cycle a scheduler,
// and eight warps of 128 registers (the columns split between warp pairs)
// were slower, 0.33 ms, for the work they repeat (PERF.md).

constexpr int LDF = CK + 8;  // f32 a row of L, S_prev and dS here: float2 fragment loads without conflicts

struct StateLayout {
  static constexpr int BF = CK * LDB;
  static constexpr int LF = CK * LDL;
  // k, v in two stages (bf16); logw in two stages (f32)
  static constexpr int BYTES = 2 * 2 * BF * 2 + 2 * LF * 4;
};

struct BwdLayout {
  static constexpr int BF = CK * LDB;
  static constexpr int FF = CK * LDF;
  // r, k, v, dy (bf16); L, S_prev, dS (f32)
  static constexpr int BYTES = 4 * BF * 2 + 3 * FF * 4;
};

// (a, b) as three bf16 pairs, each the rounding of what the pairs before leave
__device__ inline void split3_bf16(float a, float b, uint32_t& hi, uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 fh = __bfloat1622float2(h);
  const float ra = a - fh.x, rb = b - fh.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(ra, rb);
  const float2 fm = __bfloat1622float2(m);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  mid = *reinterpret_cast<const uint32_t*>(&m);
  lo = pack_bf16(ra - fm.x, rb - fm.y);
}

// L in place in a [64][ld] f32 tile of logw: the inclusive cumulative sum of
// logw * log2(e) down each column, as wkv6_chunk_kernel's.  128 threads: thread
// (d, half) takes its column's 32 rows into registers and sums them there,
// then the second half adds the first half's total.  Each partial sum only
// falls, so L_i <= L_j for i >= j holds exactly.  Every thread of the block
// calls it; it ends on a barrier.
__device__ inline void cumsum_log2_tile(float* L, int ld, int tid) {
  const int d = tid & (CK - 1);
  const int r0 = (tid >> 6) * (CK / 2);
  float col[CK / 2];
#pragma unroll
  for (int i = 0; i < CK / 2; ++i) col[i] = L[(r0 + i) * ld + d];
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < CK / 2; ++i) {
    acc = fmaf(col[i], kLog2e, acc);
    col[i] = acc;
  }
  if (r0 == 0) {
#pragma unroll
    for (int i = 0; i < CK / 2; ++i) L[i * ld + d] = col[i];
  }
  __syncthreads();  // the first half's total is read below
  if (r0 > 0) {
    const float base = L[(CK / 2 - 1) * ld + d];
#pragma unroll
    for (int i = 0; i < CK / 2; ++i) L[(r0 + i) * ld + d] = col[i] + base;
  }
  __syncthreads();
}

struct Frag3A {  // an A fragment in three parts
  uint32_t h[4], m[4], l[4];
};
struct Frag3B {  // a B fragment in three parts
  uint32_t h[2], m[2], l[2];
};

// c += a b: a in three parts, b a bf16 input; the small parts first
__device__ inline void mma_a3(float* c, const Frag3A& a, uint32_t b0, uint32_t b1) {
  mma_bf16(c, a.l, b0, b1);
  mma_bf16(c, a.m, b0, b1);
  mma_bf16(c, a.h, b0, b1);
}

// c += a b: a a bf16 input, b in three parts
__device__ inline void mma_b3(float* c, const uint32_t* a, const Frag3B& b) {
  mma_bf16(c, a, b.l[0], b.l[1]);
  mma_bf16(c, a, b.m[0], b.m[1]);
  mma_bf16(c, a, b.h[0], b.h[1]);
}

// c += a b, both in three parts: the six products whose parts' orders sum to less than three
__device__ inline void mma_a3b3(float* c, const Frag3A& a, const Frag3B& b) {
  mma_bf16(c, a.l, b.h[0], b.h[1]);
  mma_bf16(c, a.h, b.l[0], b.l[1]);
  mma_bf16(c, a.m, b.m[0], b.m[1]);
  mma_bf16(c, a.m, b.h[0], b.h[1]);
  mma_bf16(c, a.h, b.m[0], b.m[1]);
  mma_bf16(c, a.h, b.h[0], b.h[1]);
}

// c += a b, both in two parts (hi hi + lo hi + hi lo), as the forward's products
__device__ inline void mma_a2b2(float* c, const uint32_t* ah, const uint32_t* al, const uint32_t* bh,
                                const uint32_t* bl) {
  mma_bf16(c, al, bh[0], bh[1]);
  mma_bf16(c, ah, bl[0], bl[1]);
  mma_bf16(c, ah, bh[0], bh[1]);
}

// c (16 x 8, f32) += a (16 x 8, bf16, row-major: rows g, g + 8, columns 2t, 2t + 1) * b (8 x 8, bf16,
// column-major: rows 2t, 2t + 1, column g): half an m16n8k16 product, for the blocks of 8 rows
__device__ inline void mma_bf16_k8(float* c, uint32_t a0, uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// c += a b on m16n8k8, a (two registers) and b (one) in three parts each, as mma_a3b3
__device__ inline void mma_k8_a3b3(float* c, const uint32_t (&ah)[2], const uint32_t (&am)[2],
                                   const uint32_t (&al)[2], uint32_t bh, uint32_t bm, uint32_t bl) {
  mma_bf16_k8(c, al[0], al[1], bh);
  mma_bf16_k8(c, ah[0], ah[1], bl);
  mma_bf16_k8(c, am[0], am[1], bm);
  mma_bf16_k8(c, am[0], am[1], bh);
  mma_bf16_k8(c, ah[0], ah[1], bm);
  mma_bf16_k8(c, ah[0], ah[1], bh);
}

// an A fragment in three parts from two adjacent m16n8 accumulator tiles (k = their 16 columns)
__device__ inline Frag3A frag3_from_acc(const float (&c0)[4], const float (&c1)[4]) {
  Frag3A a;
  split3_bf16(c0[0], c0[1], a.h[0], a.m[0], a.l[0]);
  split3_bf16(c0[2], c0[3], a.h[1], a.m[1], a.l[1]);
  split3_bf16(c1[0], c1[1], a.h[2], a.m[2], a.l[2]);
  split3_bf16(c1[2], c1[3], a.h[3], a.m[3], a.l[3]);
  return a;
}

// The chunked backward's state walk: S before each chunk c into ws[c] ([d][e],
// f32), from S0 = 0.  wkv6_chunk_kernel's loads and step (4), with k 2^(Lt - L)
// in three parts against V; the state after the last chunk is not written.
template <int D>  // D == CK
__global__ void __launch_bounds__(CK_NT, 2)
wkv6_bwd_state_kernel(const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
                      const float* __restrict__ logw, float* __restrict__ ws, int T_len, int H, int64_t k_sb,
                      int64_t k_st, int64_t k_sh, int64_t v_sb, int64_t v_st, int64_t v_sh, int64_t w_sb,
                      int64_t w_st, int64_t w_sh) {
  static_assert(D == CK, "the chunked backward is written for head size 64");
  using SL = StateLayout;
  extern __shared__ uint4 smem_state[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_state);  // [2][CK][LDB]
  __nv_bfloat16* sV = sK + 2 * SL::BF;
  float* sW = reinterpret_cast<float*>(sV + 2 * SL::BF);  // [2][CK][LDL]: logw, then L in log2 units

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const __nv_bfloat16* kb = k + b * k_sb + h * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + h * v_sh;
  const float* wb = logw + b * w_sb + h * w_sh;
  const int nchunks = (T_len + CK - 1) / CK;
  float* wsb = ws + (int64_t)blockIdx.x * nchunks * CK * CK;
  const int d0 = warp * 16 + g;

  float sacc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) sacc[n][e] = 0.0f;

  auto load_chunk = [&](int c, int stage) {
    const int t0 = c * CK;
    const int valid = T_len - t0;
#pragma unroll
    for (int i = 0; i < CK * CK / 8 / CK_NT; ++i) {
      const int idx = tid + i * CK_NT;
      const int row = idx >> 3;
      const int col = (idx & 7) * 8;
      const bool ok = row < valid;
      const int64_t tt = t0 + (ok ? row : 0);
      const int off = stage * SL::BF + row * LDB + col;
      cp_async16(smem_addr(sK + off), kb + tt * k_st + col, ok);
      cp_async16(smem_addr(sV + off), vb + tt * v_st + col, ok);
    }
#pragma unroll
    for (int i = 0; i < CK * CK / 4 / CK_NT; ++i) {
      const int idx = tid + i * CK_NT;
      const int row = idx >> 4;
      const int col = (idx & 15) * 4;
      const bool ok = row < valid;
      cp_async16(smem_addr(sW + stage * SL::LF + row * LDL + col), wb + (t0 + (ok ? row : 0)) * w_st + col, ok);
    }
  };
  auto store_state = [&](int c) {
    float* sp = wsb + (int64_t)c * CK * CK;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        *reinterpret_cast<float2*>(sp + (d0 + 8 * hf) * CK + 8 * n + 2 * t) =
            make_float2(sacc[n][2 * hf], sacc[n][2 * hf + 1]);
  };

  // the updates run for chunks 0 .. nchunks - 2: the last chunk's S_prev is the last one needed
  if (nchunks > 1) load_chunk(0, 0);
  cp_async_commit();
  for (int c = 0; c + 1 < nchunks; ++c) {
    store_state(c);
    const int stage = c & 1;
    if (c + 2 < nchunks) load_chunk(c + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* cK = sK + stage * SL::BF;
    const __nv_bfloat16* cV = sV + stage * SL::BF;
    float* cL = sW + stage * SL::LF;
    cumsum_log2_tile(cL, LDL, tid);
    // S <- diag(2^Lt) S + (k 2^(Lt - L))^T V
    const float lt[2] = {cL[(CK - 1) * LDL + d0], cL[(CK - 1) * LDL + d0 + 8]};
    const float dec[2] = {exp2_nonpos(lt[0]), exp2_nonpos(lt[1])};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[n][e] *= dec[e >> 1];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      Frag3A a;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int d = d0 + (q & 1) * 8;
        const int j = ks * 16 + 2 * t + (q >> 1) * 8;
        const float f0 = exp2_nonpos(lt[q & 1] - cL[j * LDL + d]);
        const float f1 = exp2_nonpos(lt[q & 1] - cL[(j + 1) * LDL + d]);
        split3_bf16(__bfloat162float(cK[j * LDB + d]) * f0, __bfloat162float(cK[(j + 1) * LDB + d]) * f1, a.h[q],
                    a.m[q], a.l[q]);
      }
#pragma unroll
      for (int n = 0; n < 8; n += 2) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, smem_addr(cV + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDB + n * 8 +
                                        (lane >> 4) * 8));
        mma_a3(sacc[n], a, vf[0], vf[1]);
        mma_a3(sacc[n + 1], a, vf[2], vf[3]);
      }
    }
    __syncthreads();  // before this stage is loaded again
  }
  store_state(nchunks - 1);
}

// The chunked backward's gradient walk (see the note above): one block a
// (batch, head), four warps, the chunks from the last to the first.
template <int D>  // D == CK
__global__ void __launch_bounds__(CK_NT, 2)
wkv6_bwd_chunk_kernel(const __nv_bfloat16* __restrict__ r, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dy,
                      const float* __restrict__ logw, const float* __restrict__ u, const float* __restrict__ ws,
                      __nv_bfloat16* __restrict__ dr, __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                      float* __restrict__ dlogw, float* __restrict__ du_part, int T_len, int H, int64_t r_sb,
                      int64_t r_st, int64_t r_sh, int64_t k_sb, int64_t k_st, int64_t k_sh, int64_t v_sb,
                      int64_t v_st, int64_t v_sh, int64_t w_sb, int64_t w_st, int64_t w_sh, int64_t g_sb,
                      int64_t g_st, int64_t g_sh) {
  static_assert(D == CK, "the chunked backward is written for head size 64");
  using BL = BwdLayout;
  extern __shared__ uint4 smem_bwd[];
  __nv_bfloat16* sR = reinterpret_cast<__nv_bfloat16*>(smem_bwd);  // [CK][LDB] each
  __nv_bfloat16* sK = sR + BL::BF;
  __nv_bfloat16* sV = sK + BL::BF;
  __nv_bfloat16* sG = sV + BL::BF;  // dy
  float* sL = reinterpret_cast<float*>(sG + BL::BF);  // [CK][LDF]: logw, then L in log2 units
  float* sS = sL + BL::FF;  // S_prev [d][e]
  float* sD = sS + BL::FF;  // dS after the chunk [d][e]
  __shared__ float sU[CK];
  __shared__ float sDA[4][16][17];  // each warp's diagonal block of dA, [i][j]
  __shared__ float sAT[4][16][17];  // each warp's diagonal block of A^T, [j][i]: A_ij below, the bonus on it
  __shared__ float sPn[4][CK];      // r drI of each warp's first row
  __shared__ float sTot[4][CK];     // each warp's sum of dlogw's differences
  __shared__ float sCarry[CK];      // dlogw's running sum over the later chunks
  __shared__ float sDu[4][CK];      // du of each warp's rows over the chunks so far

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const __nv_bfloat16* rb = r + b * r_sb + h * r_sh;
  const __nv_bfloat16* kb = k + b * k_sb + h * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + h * v_sh;
  const __nv_bfloat16* gb = dy + b * g_sb + h * g_sh;
  const float* wb = logw + b * w_sb + h * w_sh;
  const int64_t o_st = (int64_t)H * CK;  // dr, dk, dv, dlogw are (B, T, H, D) contiguous
  const int64_t o_base = ((int64_t)b * T_len * H + h) * CK;
  const int nchunks = (T_len + CK - 1) / CK;
  const float* wsb = ws + (int64_t)blockIdx.x * nchunks * CK * CK;
  if (tid < CK) sU[tid] = u[h * CK + tid];

  const int d0 = warp * 16 + g;  // the lane's rows of dS
  const int bnd = warp * 16;     // the warp's rows of the chunk, [bnd, bnd + 16)
  const int i0 = bnd + g;        // the lane's rows of the chunk: i0 and i0 + 8
  const int i1 = i0 + 8;
  const int Bnd = bnd + 16;
  // dS lives in sD between chunks (f32, [d][e]), zero after the last chunk;
  // dlogw's carry and du's sums in shared memory: no register is held across chunks
  for (int i = tid; i < CK * LDF; i += CK_NT) sD[i] = 0.0f;
  if (tid < CK) {
    sCarry[tid] = 0.0f;
#pragma unroll
    for (int w2 = 0; w2 < 4; ++w2) sDu[w2][tid] = 0.0f;
  }

  // rows of a chunk past T read as r = k = v = dy = 0 and logw = 0
  auto load_chunk = [&](int c) {
    const int t0 = c * CK;
    const int valid = T_len - t0;
#pragma unroll
    for (int i = 0; i < CK * CK / 8 / CK_NT; ++i) {
      const int idx = tid + i * CK_NT;
      const int row = idx >> 3;
      const int col = (idx & 7) * 8;
      const bool ok = row < valid;
      const int64_t tt = t0 + (ok ? row : 0);
      const int off = row * LDB + col;
      cp_async16(smem_addr(sR + off), rb + tt * r_st + col, ok);
      cp_async16(smem_addr(sK + off), kb + tt * k_st + col, ok);
      cp_async16(smem_addr(sV + off), vb + tt * v_st + col, ok);
      cp_async16(smem_addr(sG + off), gb + tt * g_st + col, ok);
    }
    const float* sp = wsb + (int64_t)c * CK * CK;
#pragma unroll
    for (int i = 0; i < CK * CK / 4 / CK_NT; ++i) {
      const int idx = tid + i * CK_NT;
      const int row = idx >> 4;
      const int col = (idx & 15) * 4;
      const bool ok = row < valid;
      cp_async16(smem_addr(sL + row * LDF + col), wb + (t0 + (ok ? row : 0)) * w_st + col, ok);
      cp_async16(smem_addr(sS + row * LDF + col), sp + row * CK + col, true);
    }
  };

  auto L1 = [&](int i, int d) { return sL[i * LDF + d]; };
  auto Lx1 = [&](int i, int d) { return i > 0 ? sL[(i - 1) * LDF + d] : 0.0f; };
  auto L2 = [&](int i, int dc) { return *reinterpret_cast<const float2*>(sL + i * LDF + dc); };
  auto Lx2 = [&](int i, int dc) { return i > 0 ? L2(i - 1, dc) : make_float2(0.0f, 0.0f); };
  auto bfv = [&](const __nv_bfloat16* tile, int i, int d) { return __bfloat162float(tile[i * LDB + d]); };

  load_chunk(nchunks - 1);
  cp_async_commit();
  for (int c = nchunks - 1; c >= 0; --c) {
    const int t0 = c * CK;
    cp_async_wait<0>();
    __syncthreads();
    if (c + 1 < nchunks && tid < CK)  // the chunk after: its differences and r drI of its first row
      sCarry[tid] += sTot[0][tid] + sTot[1][tid] + sTot[2][tid] + sTot[3][tid] + sPn[0][tid];
    cumsum_log2_tile(sL, LDF, tid);

    // (1) drI of the warp's rows: the state's part, scaled by 2^(Lx_b) by column,
    // plus dA of the earlier sub-chunks against k' = k 2^(Lx_b - L_j), then
    // scaled by 2^(Lx_i - Lx_b); the diagonal block's dA into sDA.  The loops
    // over k-steps and sub-chunks stay loops: unrolled, the body of a chunk
    // outgrows the instruction cache (tens of thousands of instructions).
    float drI[8][4];
    {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) drI[n][e] = 0.0f;
#pragma unroll 1
      for (int ks = 0; ks < 4; ++ks) {
        uint32_t ga[4];  // dy of the warp's rows, k = e
        ldmatrix_x4(ga, smem_addr(sG + (bnd + (lane & 15)) * LDB + ks * 16 + (lane >> 4) * 8));
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const float* sp = sS + (8 * n + g) * LDF + ks * 16 + 2 * t;
          const float2 s0 = *reinterpret_cast<const float2*>(sp);
          const float2 s1 = *reinterpret_cast<const float2*>(sp + 8);
          Frag3B sb;
          split3_bf16(s0.x, s0.y, sb.h[0], sb.m[0], sb.l[0]);
          split3_bf16(s1.x, s1.y, sb.h[1], sb.m[1], sb.l[1]);
          mma_b3(drI[n], ga, sb);
        }
      }
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float2 lb = Lx2(bnd, 8 * n + 2 * t);
        const float e0 = exp2_nonpos(lb.x), e1 = exp2_nonpos(lb.y);
        drI[n][0] *= e0;
        drI[n][1] *= e1;
        drI[n][2] *= e0;
        drI[n][3] *= e1;
      }
#pragma unroll 1
      for (int J = 0; J <= warp; ++J) {
        float da[2][4];  // dA = dy v^T: the warp's rows i against rows j of sub-chunk J
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int e = 0; e < 4; ++e) da[m][e] = 0.0f;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          uint32_t ga[4], vf[4];
          ldmatrix_x4(ga, smem_addr(sG + (bnd + (lane & 15)) * LDB + ks * 16 + (lane >> 4) * 8));
          ldmatrix_x4(vf, smem_addr(sV + (J * 16 + (lane & 7) + (lane >> 4) * 8) * LDB + ks * 16 +
                                    ((lane >> 3) & 1) * 8));
          mma_bf16(da[0], ga, vf[0], vf[1]);
          mma_bf16(da[1], ga, vf[2], vf[3]);
        }
        if (J == warp) {  // the diagonal block, for (3)
          float* e = &sDA[warp][0][0];
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            e[g * 17 + 8 * m + 2 * t] = da[m][0];
            e[g * 17 + 8 * m + 2 * t + 1] = da[m][1];
            e[(g + 8) * 17 + 8 * m + 2 * t] = da[m][2];
            e[(g + 8) * 17 + 8 * m + 2 * t + 1] = da[m][3];
          }
          break;
        }
        const Frag3A a = frag3_from_acc(da[0], da[1]);
#pragma unroll
        for (int n = 0; n < 8; ++n) {  // B = k' (k = j, n = d), three parts
          const int dcol = 8 * n + g;
          const float lb = Lx1(bnd, dcol);
          Frag3B kf;
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int j = J * 16 + 2 * t + q * 8;
            split3_bf16(bfv(sK, j, dcol) * exp2_nonpos(lb - L1(j, dcol)),
                        bfv(sK, j + 1, dcol) * exp2_nonpos(lb - L1(j + 1, dcol)), kf.h[q], kf.m[q], kf.l[q]);
          }
          mma_a3b3(drI[n], a, kf);
        }
      }
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int dc = 8 * n + 2 * t;
        const float2 lb = Lx2(bnd, dc), x0 = Lx2(i0, dc), x1 = L2(i1 - 1, dc);
        drI[n][0] *= exp2_nonpos(x0.x - lb.x);
        drI[n][1] *= exp2_nonpos(x0.y - lb.y);
        drI[n][2] *= exp2_nonpos(x1.x - lb.x);
        drI[n][3] *= exp2_nonpos(x1.y - lb.y);
      }
    }

    // (2) dkI of the warp's rows: the state's part, scaled by 2^(Lt - Lx_B) by
    // column, plus dA^T of the later sub-chunks against r' = r 2^(Lx_i - Lx_B),
    // then scaled by 2^(Lx_B - L_j)
    float dkI[8][4];
    {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dkI[n][e] = 0.0f;
#pragma unroll 1
      for (int ks = 0; ks < 4; ++ks) {
        uint32_t va[4];  // v of the warp's rows, k = e
        ldmatrix_x4(va, smem_addr(sV + (bnd + (lane & 15)) * LDB + ks * 16 + (lane >> 4) * 8));
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const float* sp = sD + (8 * n + g) * LDF + ks * 16 + 2 * t;
          const float2 s0 = *reinterpret_cast<const float2*>(sp);
          const float2 s1 = *reinterpret_cast<const float2*>(sp + 8);
          Frag3B sb;
          split3_bf16(s0.x, s0.y, sb.h[0], sb.m[0], sb.l[0]);
          split3_bf16(s1.x, s1.y, sb.h[1], sb.m[1], sb.l[1]);
          mma_b3(dkI[n], va, sb);
        }
      }
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float2 lt = L2(CK - 1, 8 * n + 2 * t), lB = L2(Bnd - 1, 8 * n + 2 * t);
        const float e0 = exp2_nonpos(lt.x - lB.x), e1 = exp2_nonpos(lt.y - lB.y);
        dkI[n][0] *= e0;
        dkI[n][1] *= e1;
        dkI[n][2] *= e0;
        dkI[n][3] *= e1;
      }
#pragma unroll 1
      for (int I = warp + 1; I < 4; ++I) {
        float da[2][4];  // dA^T: the warp's rows j against rows i of sub-chunk I
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int e = 0; e < 4; ++e) da[m][e] = 0.0f;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          uint32_t va[4], gf[4];
          ldmatrix_x4(va, smem_addr(sV + (bnd + (lane & 15)) * LDB + ks * 16 + (lane >> 4) * 8));
          ldmatrix_x4(gf, smem_addr(sG + (I * 16 + (lane & 7) + (lane >> 4) * 8) * LDB + ks * 16 +
                                    ((lane >> 3) & 1) * 8));
          mma_bf16(da[0], va, gf[0], gf[1]);
          mma_bf16(da[1], va, gf[2], gf[3]);
        }
        const Frag3A a = frag3_from_acc(da[0], da[1]);
#pragma unroll
        for (int n = 0; n < 8; ++n) {  // B = r' (k = i, n = d), three parts
          const int dcol = 8 * n + g;
          const float lB = L1(Bnd - 1, dcol);
          Frag3B rf;
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int i = I * 16 + 2 * t + q * 8;  // >= 16: Lx of row i is L of row i - 1
            split3_bf16(bfv(sR, i, dcol) * exp2_nonpos(L1(i - 1, dcol) - lB),
                        bfv(sR, i + 1, dcol) * exp2_nonpos(L1(i, dcol) - lB), rf.h[q], rf.m[q], rf.l[q]);
          }
          mma_a3b3(dkI[n], a, rf);
        }
      }
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int dc = 8 * n + 2 * t;
        const float2 lB = L2(Bnd - 1, dc), l0 = L2(i0, dc), l1 = L2(i1, dc);
        dkI[n][0] *= exp2_nonpos(lB.x - l0.x);
        dkI[n][1] *= exp2_nonpos(lB.y - l0.y);
        dkI[n][2] *= exp2_nonpos(lB.x - l1.x);
        dkI[n][3] *= exp2_nonpos(lB.y - l1.y);
      }
    }

    // (3) The sub-chunk's 16 x 16 diagonal block, as wkv6_chunk_kernel's (2a) and
    // (2b): (3a) its rows 8.. against its columns ..7 on the tensor cores
    // through the boundary m = b + 8, (3b) its two 8 x 8 blocks on the diagonal
    // in f32 on the CUDA cores.
    {
      const float* eA = &sDA[warp][0][0];
      float* eT = &sAT[warp][0][0];
      const int m8 = bnd + 8;
      __syncwarp();
      // (3a) drI of rows i1 += 2^(Lx_i - Lx_m) sum_{j in [b, m)} dA_ij k_j 2^(Lx_m - L_j);
      // dkI of rows i0 += 2^(Lx_m - L_j) sum_{i in [m, m + 8)} dA_ij r_i 2^(Lx_i - Lx_m):
      // m16n8k8 products, A's rows g (drI) or g + 8 (dkI) zero, three parts each
      {
        uint32_t rh[2] = {0u, 0u}, rm[2] = {0u, 0u}, rl3[2] = {0u, 0u};  // dA[8 + g][2t..]: rows i1, k = j
        uint32_t ch[2] = {0u, 0u}, cm[2] = {0u, 0u}, cl[2] = {0u, 0u};   // dA[8 + 2t..][g]: rows i0, k = i
        split3_bf16(eA[(8 + g) * 17 + 2 * t], eA[(8 + g) * 17 + 2 * t + 1], rh[1], rm[1], rl3[1]);
        split3_bf16(eA[(8 + 2 * t) * 17 + g], eA[(9 + 2 * t) * 17 + g], ch[0], cm[0], cl[0]);
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int dcol = 8 * n + g;
          const float lm = L1(m8 - 1, dcol);  // Lx of row m
          const int j = bnd + 2 * t, i = m8 + 2 * t;
          uint32_t kh, km, kl, xh, xm, xl;
          split3_bf16(bfv(sK, j, dcol) * exp2_nonpos(lm - L1(j, dcol)),
                      bfv(sK, j + 1, dcol) * exp2_nonpos(lm - L1(j + 1, dcol)), kh, km, kl);
          split3_bf16(bfv(sR, i, dcol) * exp2_nonpos(L1(i - 1, dcol) - lm),
                      bfv(sR, i + 1, dcol) * exp2_nonpos(L1(i, dcol) - lm), xh, xm, xl);
          float cr[4] = {0.0f, 0.0f, 0.0f, 0.0f}, ck[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          mma_k8_a3b3(cr, rh, rm, rl3, kh, km, kl);
          mma_k8_a3b3(ck, ch, cm, cl, xh, xm, xl);
          const int dc = 8 * n + 2 * t;
          const float2 lm2 = L2(m8 - 1, dc), x1 = L2(i1 - 1, dc), l0 = L2(i0, dc);
          drI[n][2] += exp2_nonpos(x1.x - lm2.x) * cr[2];
          drI[n][3] += exp2_nonpos(x1.y - lm2.y) * cr[3];
          dkI[n][0] += exp2_nonpos(lm2.x - l0.x) * ck[0];
          dkI[n][1] += exp2_nonpos(lm2.y - l0.y) * ck[1];
        }
        // A^T[j][i] for j in [b, m), i in [m, m + 8): (k_j 2^(Lx_m - L_j)) . (r_i 2^(Lx_i - Lx_m)),
        // A's rows g + 8 zero, two parts each
        float at[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          uint32_t ah[4] = {0u, 0u, 0u, 0u}, al[4] = {0u, 0u, 0u, 0u}, bh[2], bl[2];
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int dc = ks * 16 + 2 * t + q * 8;
            const float2 lm2 = L2(m8 - 1, dc);
            const float2 kk = bf2(sK + i0 * LDB + dc), lj = L2(i0, dc);
            split_bf16(kk.x * exp2_nonpos(lm2.x - lj.x), kk.y * exp2_nonpos(lm2.y - lj.y), ah[2 * q], al[2 * q]);
            const float2 rr = bf2(sR + (m8 + g) * LDB + dc), lx = L2(m8 + g - 1, dc);
            split_bf16(rr.x * exp2_nonpos(lx.x - lm2.x), rr.y * exp2_nonpos(lx.y - lm2.y), bh[q], bl[q]);
          }
          mma_a2b2(at, ah, al, bh, bl);
        }
        eT[g * 17 + 8 + 2 * t] = at[0];
        eT[g * 17 + 9 + 2 * t] = at[1];
      }
      // (3b) the two 8 x 8 blocks on the diagonal: the lane's rows rl = g and
      // g + 8 against the rows x of their own block, its columns 8n + 2t and + 1.
      // x < rl: drI_rl += dA[rl][x] k_x E and A[rl][x] += r_rl k_x E with E =
      // exp2(Lx_rl - L_x); x > rl: dkI_rl += dA[x][rl] r_x E, E = exp2(Lx_x - L_rl).
      // A (quad sums) and the bonus r u k on the diagonal into sAT.
      float2 Lr[2][8], Lxr[2][8], rr[2][8];  // the lane's rows and columns
      float bonus[2] = {0.0f, 0.0f};
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = bnd + 8 * half + g;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int dc = 8 * n + 2 * t;
          Lr[half][n] = L2(row, dc);
          Lxr[half][n] = Lx2(row, dc);
          rr[half][n] = bf2(sR + row * LDB + dc);
          const float2 kr = bf2(sK + row * LDB + dc);
          bonus[half] += rr[half][n].x * sU[dc] * kr.x + rr[half][n].y * sU[dc + 1] * kr.y;
        }
      }
#pragma unroll 1
      for (int xb = 0; xb < 8; ++xb) {
        // x < rl: a term of drI and A (cR, aR), x > rl: of dkI (cK); the other coefficients 0
        bool sel[2];
        float cR[2], cK[2], aR[2], apart[2] = {0.0f, 0.0f};
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int x = 8 * half + xb, rl = 8 * half + g;
          sel[half] = x < rl;
          cR[half] = x < rl ? eA[rl * 17 + x] : 0.0f;
          cK[half] = x > rl ? eA[x * 17 + rl] : 0.0f;
          aR[half] = x < rl ? 1.0f : 0.0f;
        }
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int dc = 8 * n + 2 * t;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int xr = bnd + 8 * half + xb;
            const float2 Lxx = L2(xr, dc), Lxxm = Lx2(xr, dc);
            const float2 kx = bf2(sK + xr * LDB + dc), rx = bf2(sR + xr * LDB + dc);
            const bool sl = sel[half];
            // at x = rl the exponent is clamped to 0 and both coefficients are 0
            const float ex = exp2_nonpos(fminf(sl ? Lxr[half][n].x - Lxx.x : Lxxm.x - Lr[half][n].x, 0.0f));
            const float ey = exp2_nonpos(fminf(sl ? Lxr[half][n].y - Lxx.y : Lxxm.y - Lr[half][n].y, 0.0f));
            const float kex = kx.x * ex, key = kx.y * ey;
            drI[n][2 * half] = fmaf(kex, cR[half], drI[n][2 * half]);
            drI[n][2 * half + 1] = fmaf(key, cR[half], drI[n][2 * half + 1]);
            dkI[n][2 * half] = fmaf(rx.x * ex, cK[half], dkI[n][2 * half]);
            dkI[n][2 * half + 1] = fmaf(rx.y * ey, cK[half], dkI[n][2 * half + 1]);
            apart[half] = fmaf(fmaf(rr[half][n].x, kex, rr[half][n].y * key), aR[half], apart[half]);
          }
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          apart[half] += __shfl_xor_sync(0xffffffffu, apart[half], 1);
          apart[half] += __shfl_xor_sync(0xffffffffu, apart[half], 2);
          // every lane of the quad holds the sum; where x >= rl it is 0, at an entry
          // that (5) masks or that the bonus overwrites below
          eT[(8 * half + xb) * 17 + 8 * half + g] = apart[half];
        }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        bonus[half] += __shfl_xor_sync(0xffffffffu, bonus[half], 1);
        bonus[half] += __shfl_xor_sync(0xffffffffu, bonus[half], 2);
        eT[(8 * half + g) * 17 + 8 * half + g] = bonus[half];
      }
      __syncwarp();
    }

    // (4) dr and dk out, du's terms, and dlogw's differences z_t = r_{t+1}
    // drI_{t+1} - k_t dkI_t in place of dkI (row 15 of the warp after the barrier)
    {
      float vdy[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = bnd + 8 * half + g;
        float s = 0.0f;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const float2 vv = bf2(sV + row * LDB + 8 * n + 2 * t), gg = bf2(sG + row * LDB + 8 * n + 2 * t);
          s += vv.x * gg.x + vv.y * gg.y;
        }
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        vdy[half] = s;
      }
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int dc = 8 * n + 2 * t;
        const float ux = sU[dc], uy = sU[dc + 1];
        float du2[2] = {0.0f, 0.0f};  // du of the lane's two rows, then of the warp's 16
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = bnd + 8 * half + g;
          const float2 rr = bf2(sR + row * LDB + dc), kr = bf2(sK + row * LDB + dc);
          const float w = vdy[half];
          if (t0 + row < T_len) {
            const int64_t o = o_base + (t0 + row) * o_st + dc;
            *reinterpret_cast<__nv_bfloat162*>(dr + o) =
                __floats2bfloat162_rn(drI[n][2 * half] + ux * kr.x * w, drI[n][2 * half + 1] + uy * kr.y * w);
            *reinterpret_cast<__nv_bfloat162*>(dk + o) =
                __floats2bfloat162_rn(dkI[n][2 * half] + ux * rr.x * w, dkI[n][2 * half + 1] + uy * rr.y * w);
          }
          du2[0] = fmaf(rr.x * kr.x, w, du2[0]);
          du2[1] = fmaf(rr.y * kr.y, w, du2[1]);
          drI[n][2 * half] *= rr.x;  // p = r drI
          drI[n][2 * half + 1] *= rr.y;
          dkI[n][2 * half] *= kr.x;  // q = k dkI
          dkI[n][2 * half + 1] *= kr.y;
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          du2[e] += __shfl_xor_sync(0xffffffffu, du2[e], 4);
          du2[e] += __shfl_xor_sync(0xffffffffu, du2[e], 8);
          du2[e] += __shfl_xor_sync(0xffffffffu, du2[e], 16);
        }
        // the 8 lanes of a column hold the same sum: each writes it (one warp: no race)
        sDu[warp][dc] += du2[0];
        sDu[warp][dc + 1] += du2[1];
      }
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          // p of row g + 1 from lane + 4; row 8 (for g = 7) from lane t; row g + 9 from lane + 4
          const float p_lo = __shfl_down_sync(0xffffffffu, drI[n][e], 4);
          const float p_hi = __shfl_down_sync(0xffffffffu, drI[n][2 + e], 4);
          const float p_8 = __shfl_sync(0xffffffffu, drI[n][2 + e], t);
          dkI[n][e] = (g < 7 ? p_lo : p_8) - dkI[n][e];
          dkI[n][2 + e] = (g < 7 ? p_hi : 0.0f) - dkI[n][2 + e];
        }
      if (g == 0) {
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          sPn[warp][8 * n + 2 * t] = drI[n][0];
          sPn[warp][8 * n + 2 * t + 1] = drI[n][1];
        }
      }
    }
    float (&z)[8][4] = dkI;

    // (5) dv of the warp's rows: (k 2^(Lt - L)) dS, then A^T dy over the
    // sub-chunks from the warp's own on (A^T of the later ones on the tensor
    // cores, one sub-chunk at a time; the diagonal block from sAT); two parts each
    {
      float dva[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dva[n][e] = 0.0f;
#pragma unroll 1
      for (int ks = 0; ks < 4; ++ks) {
        uint32_t ah[4], al[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int row = (q & 1) ? i1 : i0;
          const int dc = ks * 16 + 2 * t + (q >> 1) * 8;
          const float2 kk = bf2(sK + row * LDB + dc), l = L2(row, dc), lt = L2(CK - 1, dc);
          split_bf16(kk.x * exp2_nonpos(lt.x - l.x), kk.y * exp2_nonpos(lt.y - l.y), ah[q], al[q]);
        }
#pragma unroll
        for (int n = 0; n < 8; ++n) {  // B = dS (k = d, n = e)
          uint32_t bh[2], bl[2];
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int d = ks * 16 + 2 * t + q * 8;
            split_bf16(sD[d * LDF + 8 * n + g], sD[(d + 1) * LDF + 8 * n + g], bh[q], bl[q]);
          }
          mma_a2b2(dva[n], ah, al, bh, bl);
        }
      }
#pragma unroll 1
      for (int I = warp; I < 4; ++I) {
        uint32_t ah[4], al[4];
        if (I == warp) {  // A^T[j][i] for i >= j, 0 above
          const float* eT = &sAT[warp][0][0];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int j = g + (q & 1) * 8;
            const int i = 2 * t + (q >> 1) * 8;
            split_bf16(i >= j ? eT[j * 17 + i] : 0.0f, i + 1 >= j ? eT[j * 17 + i + 1] : 0.0f, ah[q], al[q]);
          }
        } else {  // (k 2^(Lx_B - L_j)) . (r 2^(Lx_i - Lx_B)), k = d; two n-tiles of 8 rows i
          float at[2][4];
#pragma unroll
          for (int m = 0; m < 2; ++m)
#pragma unroll
            for (int e = 0; e < 4; ++e) at[m][e] = 0.0f;
#pragma unroll
          for (int ks = 0; ks < 4; ++ks) {
            uint32_t kh[4], kl[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int row = (q & 1) ? i1 : i0;
              const int dc = ks * 16 + 2 * t + (q >> 1) * 8;
              const float2 kk = bf2(sK + row * LDB + dc), l = L2(row, dc), lB = L2(Bnd - 1, dc);
              split_bf16(kk.x * exp2_nonpos(lB.x - l.x), kk.y * exp2_nonpos(lB.y - l.y), kh[q], kl[q]);
            }
#pragma unroll
            for (int m = 0; m < 2; ++m) {
              const int i = I * 16 + 8 * m + g;
              uint32_t bh[2], bl[2];
#pragma unroll
              for (int q = 0; q < 2; ++q) {
                const int dc = ks * 16 + 2 * t + q * 8;
                const float2 rr = bf2(sR + i * LDB + dc), lx = L2(i - 1, dc), lB = L2(Bnd - 1, dc);
                split_bf16(rr.x * exp2_nonpos(lx.x - lB.x), rr.y * exp2_nonpos(lx.y - lB.y), bh[q], bl[q]);
              }
              mma_a2b2(at[m], kh, kl, bh, bl);
            }
          }
          split_bf16(at[0][0], at[0][1], ah[0], al[0]);
          split_bf16(at[0][2], at[0][3], ah[1], al[1]);
          split_bf16(at[1][0], at[1][1], ah[2], al[2]);
          split_bf16(at[1][2], at[1][3], ah[3], al[3]);
        }
#pragma unroll
        for (int n = 0; n < 8; n += 2) {  // B = dy (k = i, n = e)
          uint32_t gf[4];
          ldmatrix_x4_trans(gf, smem_addr(sG + (I * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDB + n * 8 +
                                          (lane >> 4) * 8));
          mma_bf16(dva[n], al, gf[0], gf[1]);
          mma_bf16(dva[n], ah, gf[0], gf[1]);
          mma_bf16(dva[n + 1], al, gf[2], gf[3]);
          mma_bf16(dva[n + 1], ah, gf[2], gf[3]);
        }
      }
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int dc = 8 * n + 2 * t;
        if (t0 + i0 < T_len)
          *reinterpret_cast<__nv_bfloat162*>(dv + o_base + (t0 + i0) * o_st + dc) =
              __floats2bfloat162_rn(dva[n][0], dva[n][1]);
        if (t0 + i1 < T_len)
          *reinterpret_cast<__nv_bfloat162*>(dv + o_base + (t0 + i1) * o_st + dc) =
              __floats2bfloat162_rn(dva[n][2], dva[n][3]);
      }
    }

    // (6) dS <- diag(2^Lt) dS + (r 2^(Lx))^T dy, the left factor in three parts;
    // back into sD once every warp has read it
    float sacc[8][4];  // dS, rows d0 and d0 + 8
    {
      const float dec[2] = {exp2_nonpos(L1(CK - 1, d0)), exp2_nonpos(L1(CK - 1, d0 + 8))};
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const float2 s2 = *reinterpret_cast<const float2*>(sD + (d0 + 8 * hf) * LDF + 8 * n + 2 * t);
          sacc[n][2 * hf] = s2.x * dec[hf];
          sacc[n][2 * hf + 1] = s2.y * dec[hf];
        }
#pragma unroll 1
      for (int ks = 0; ks < 4; ++ks) {
        Frag3A a;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int d = d0 + (q & 1) * 8;
          const int i = ks * 16 + 2 * t + (q >> 1) * 8;
          split3_bf16(bfv(sR, i, d) * exp2_nonpos(Lx1(i, d)), bfv(sR, i + 1, d) * exp2_nonpos(L1(i, d)), a.h[q],
                      a.m[q], a.l[q]);
        }
#pragma unroll
        for (int n = 0; n < 8; n += 2) {
          uint32_t gf[4];
          ldmatrix_x4_trans(gf, smem_addr(sG + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDB + n * 8 +
                                          (lane >> 4) * 8));
          mma_a3(sacc[n], a, gf[0], gf[1]);
          mma_a3(sacc[n + 1], a, gf[2], gf[3]);
        }
      }
    }
    __syncthreads();  // every read of this chunk's tiles and of sD is done; sPn is written
    if (c > 0) load_chunk(c - 1);  // lands while dlogw is summed
    cp_async_commit();
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        *reinterpret_cast<float2*>(sD + (d0 + 8 * hf) * LDF + 8 * n + 2 * t) =
            make_float2(sacc[n][2 * hf], sacc[n][2 * hf + 1]);

    // (7) dlogw: row 15 of the warp takes p of the next warp's first row (past the
    // chunk the chunk before carries it); suffix sums over the warp's rows (rows
    // g + 8 among themselves, then rows g beside them), the later warps' sums and
    // the later chunks' running sum
    {
      const bool last = g == 7 && warp < 3;
      const float* pn = &sPn[warp < 3 ? warp + 1 : 0][0];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        z[n][2] += last ? pn[8 * n + 2 * t] : 0.0f;
        z[n][3] += last ? pn[8 * n + 2 * t + 1] : 0.0f;
      }
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float lo = z[n][e], hi = z[n][2 + e];
#pragma unroll
        for (int off = 1; off < 8; off *= 2) {
          const float ylo = __shfl_down_sync(0xffffffffu, lo, 4 * off);
          const float yhi = __shfl_down_sync(0xffffffffu, hi, 4 * off);
          if (g + off < 8) {
            lo += ylo;
            hi += yhi;
          }
        }
        z[n][e] = lo + __shfl_sync(0xffffffffu, hi, t);  // rows 8..15 of the warp, from row 8's lane
        z[n][2 + e] = hi;
      }
    if (g == 0) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        sTot[warp][8 * n + 2 * t] = z[n][0];
        sTot[warp][8 * n + 2 * t + 1] = z[n][1];
      }
    }
    __syncthreads();
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int dc = 8 * n + 2 * t;
      float off[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        off[e] = sCarry[dc + e];
#pragma unroll
        for (int w2 = 1; w2 < 4; ++w2) off[e] += w2 > warp ? sTot[w2][dc + e] : 0.0f;
      }
      if (t0 + i0 < T_len)
        *reinterpret_cast<float2*>(dlogw + o_base + (t0 + i0) * o_st + dc) =
            make_float2(z[n][0] + off[0], z[n][1] + off[1]);
      if (t0 + i1 < T_len)
        *reinterpret_cast<float2*>(dlogw + o_base + (t0 + i1) * o_st + dc) =
            make_float2(z[n][2] + off[0], z[n][3] + off[1]);
    }
  }

  // du's partial of this (batch, head): the warps' sums in order
  __syncthreads();
  if (tid < CK) du_part[(int64_t)blockIdx.x * CK + tid] = sDu[0][tid] + sDu[1][tid] + sDu[2][tid] + sDu[3][tid];
}

template <typename T, int D>
int launch_bwd(const void* r, const void* k, const void* v, const void* logw, const void* u, const void* dy,
               void* dr, void* dk, void* dv, void* dlogw, void* du, void* scratch, void* du_part, int B,
               int T_len, int H, const int64_t* s, cudaStream_t stream) {
  // s: the (b, t, h) strides of r, k, v, logw, dy
  const int64_t *sr = s, *sk = s + 3, *sv = s + 6, *sw = s + 9, *sg = s + 12;
  const unsigned grid = (unsigned)(B * H);
  wkv6_bwd_kernel<T, D, false><<<grid, kQ * D, 0, stream>>>(
      (const T*)dy, (const T*)v, (const T*)k, (const T*)r, (const float*)logw, (const float*)u, (T*)dr,
      (float*)scratch, nullptr, (float*)du_part, T_len, H, sg[0], sg[1], sg[2], sv[0], sv[1], sv[2], sk[0], sk[1],
      sk[2], sr[0], sr[1], sr[2], sw[0], sw[1], sw[2]);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  wkv6_bwd_kernel<T, D, true><<<grid, kQ * D, 0, stream>>>(
      (const T*)v, (const T*)dy, (const T*)r, (const T*)k, (const float*)logw, (const float*)u, (T*)dk,
      (float*)scratch, (float*)dlogw, nullptr, T_len, H, sv[0], sv[1], sv[2], sg[0], sg[1], sg[2], sr[0], sr[1],
      sr[2], sk[0], sk[1], sk[2], sw[0], sw[1], sw[2]);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  wkv6_bwd_dv_kernel<T, D><<<grid, kQ * D, 0, stream>>>(
      (const T*)k, (const T*)r, (const T*)dy, (const float*)logw, (const float*)u, nullptr, (T*)dv, T_len, H,
      sk[0], sk[1], sk[2], sr[0], sr[1], sr[2], sg[0], sg[1], sg[2], sw[0], sw[1], sw[2]);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int HD = H * D;
  wkv6_du_kernel<<<(HD + 255) / 256, 256, 0, stream>>>((const float*)du_part, (float*)du, B, HD);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd_d(const void* r, const void* k, const void* v, const void* logw, const void* u, const void* dy,
                 void* dr, void* dk, void* dv, void* dlogw, void* du, void* scratch, void* du_part, int B,
                 int T_len, int H, int D, const int64_t* s, cudaStream_t stream) {
  if (D == 32)
    return launch_bwd<T, 32>(r, k, v, logw, u, dy, dr, dk, dv, dlogw, du, scratch, du_part, B, T_len, H, s, stream);
  if (D == 64)
    return launch_bwd<T, 64>(r, k, v, logw, u, dy, dr, dk, dv, dlogw, du, scratch, du_part, B, T_len, H, s, stream);
  return -2;
}

// the chunked backward: the state walk, the gradient walk, the du sum
int launch_bwd_chunk(const void* r, const void* k, const void* v, const void* logw, const void* u, const void* dy,
                     void* dr, void* dk, void* dv, void* dlogw, void* du, void* ws, void* du_part, int B, int T_len,
                     int H, const int64_t* s, cudaStream_t stream) {
  const int64_t *sr = s, *sk = s + 3, *sv = s + 6, *sw = s + 9, *sg = s + 12;
  cudaError_t e = cudaFuncSetAttribute(wkv6_bwd_state_kernel<CK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       StateLayout::BYTES);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(wkv6_bwd_chunk_kernel<CK>, cudaFuncAttributeMaxDynamicSharedMemorySize, BwdLayout::BYTES);
  if (e != cudaSuccess) return (int)e;
  const unsigned grid = (unsigned)(B * H);
  wkv6_bwd_state_kernel<CK><<<grid, CK_NT, StateLayout::BYTES, stream>>>(
      (const __nv_bfloat16*)k, (const __nv_bfloat16*)v, (const float*)logw, (float*)ws, T_len, H, sk[0], sk[1],
      sk[2], sv[0], sv[1], sv[2], sw[0], sw[1], sw[2]);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  wkv6_bwd_chunk_kernel<CK><<<grid, CK_NT, BwdLayout::BYTES, stream>>>(
      (const __nv_bfloat16*)r, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v, (const __nv_bfloat16*)dy,
      (const float*)logw, (const float*)u, (const float*)ws, (__nv_bfloat16*)dr, (__nv_bfloat16*)dk,
      (__nv_bfloat16*)dv, (float*)dlogw, (float*)du_part, T_len, H, sr[0], sr[1], sr[2], sk[0], sk[1], sk[2], sv[0],
      sv[1], sv[2], sw[0], sw[1], sw[2], sg[0], sg[1], sg[2]);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int HD = H * CK;
  wkv6_du_kernel<<<(HD + 255) / 256, 256, 0, stream>>>((const float*)du_part, (float*)du, B, HD);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch(const void* r, const void* k, const void* v, const void* logw, const void* u, void* state,
           void* y, int B, int T_len, int H, const int64_t* s, cudaStream_t stream) {
  wkv6_kernel<T, D><<<(unsigned)(B * H), kQ * D, 0, stream>>>(
      (const T*)r, (const T*)k, (const T*)v, (const float*)logw, (const float*)u, (float*)state,
      (T*)y, T_len, H, s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10], s[11]);
  return (int)cudaGetLastError();
}

int launch_chunk(const void* r, const void* k, const void* v, const void* logw, const void* u, void* state,
                 void* y, int B, int T_len, int H, const int64_t* s, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(wkv6_chunk_kernel<CK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       ChunkLayout::BYTES);
  if (e != cudaSuccess) return (int)e;
  wkv6_chunk_kernel<CK><<<(unsigned)(B * H), CK_NT, ChunkLayout::BYTES, stream>>>(
      (const __nv_bfloat16*)r, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v, (const float*)logw,
      (const float*)u, (float*)state, (__nv_bfloat16*)y, T_len, H, s[0], s[1], s[2], s[3], s[4], s[5], s[6],
      s[7], s[8], s[9], s[10], s[11]);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* r, const void* k, const void* v, const void* logw, const void* u, void* state,
             void* y, int B, int T_len, int H, int D, const int64_t* s, cudaStream_t stream) {
  if (D == 32) return launch<T, 32>(r, k, v, logw, u, state, y, B, T_len, H, s, stream);
  if (D == 64) return launch<T, 64>(r, k, v, logw, u, state, y, B, T_len, H, s, stream);
  return -2;
}

}  // namespace

// r, k, v: (B, T, H, D) in `dtype`, logw: (B, T, H, D) f32, each with a unit
// stride along D and the element strides given for its b, t and h axes;
// u: (H, D) f32 contiguous; state: (B, H, D, D) f32 contiguous or null (then
// S0 = 0 and the final state is not written); y: (B, T, H, D) contiguous in
// `dtype`.  bf16 at D = 64 with T >= t_min runs wkv6_chunk_kernel, which also
// needs `aligned` (every row of r, k, v and logw starts on 16 bytes);
// everything else wkv6_kernel.  Returns cudaGetLastError() of the launch, -1
// for a bad dtype, -2 for a head size the kernel is not instantiated for.
extern "C" int wkv6_launch(const void* r, const void* k, const void* v, const void* logw,
                           const void* u, void* state, void* y, int B, int T_len, int H, int D,
                           int dtype, int aligned, int t_min, int64_t r_sb, int64_t r_st, int64_t r_sh,
                           int64_t k_sb, int64_t k_st, int64_t k_sh, int64_t v_sb, int64_t v_st,
                           int64_t v_sh, int64_t w_sb, int64_t w_st, int64_t w_sh, void* stream) {
  if (B == 0 || T_len == 0 || H == 0) return 0;
  const int64_t s[12] = {r_sb, r_st, r_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, w_sb, w_st, w_sh};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == DT_BF16 && D == CK && aligned && T_len >= t_min)
    return launch_chunk(r, k, v, logw, u, state, y, B, T_len, H, s, st);
  if (dtype == DT_F32) return launch_d<float>(r, k, v, logw, u, state, y, B, T_len, H, D, s, st);
  if (dtype == DT_BF16) return launch_d<__nv_bfloat16>(r, k, v, logw, u, state, y, B, T_len, H, D, s, st);
  return -1;
}

// The backward of wkv6_launch from a zero state with no final state: r, k, v,
// dy (B, T, H, D) in `dtype` and logw (B, T, H, D) f32, each with a unit stride
// along D and the element strides given for its b, t and h axes; u (H, D) f32
// contiguous.  Writes dr, dk, dv (B, T, H, D) contiguous in `dtype`, dlogw
// (B, T, H, D) and du (H, D) contiguous f32.  bf16 at D = 64 with T >= t_min
// and `aligned` (every row of r, k, v, dy and logw starts on 16 bytes) runs the
// chunked backward: wkv6_bwd_state_kernel, wkv6_bwd_chunk_kernel and
// wkv6_du_kernel, with ws (B H, ceil(T / 64), 64, 64) and du_part (B, H, D) f32
// workspace.  Everything else runs the passes A, B and C and wkv6_du_kernel,
// with scratch (B H, T, D) and du_part f32 workspace.  Returns
// cudaGetLastError() of the first launch that failed, -1 for a bad dtype, -2
// for a head size it is not instantiated for, -4 for a missing workspace.
extern "C" int wkv6_bwd_launch(const void* r, const void* k, const void* v, const void* logw, const void* u,
                               const void* dy, void* dr, void* dk, void* dv, void* dlogw, void* du, void* scratch,
                               void* ws, void* du_part, int B, int T_len, int H, int D, int dtype, int aligned,
                               int t_min, int64_t r_sb, int64_t r_st, int64_t r_sh, int64_t k_sb, int64_t k_st,
                               int64_t k_sh, int64_t v_sb, int64_t v_st, int64_t v_sh, int64_t w_sb, int64_t w_st,
                               int64_t w_sh, int64_t g_sb, int64_t g_st, int64_t g_sh, void* stream) {
  if (B == 0 || T_len == 0 || H == 0) return 0;
  const int64_t s[15] = {r_sb, r_st, r_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, w_sb, w_st, w_sh, g_sb, g_st, g_sh};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == DT_BF16 && D == CK && aligned && T_len >= t_min) {
    if (ws == nullptr) return -4;
    return launch_bwd_chunk(r, k, v, logw, u, dy, dr, dk, dv, dlogw, du, ws, du_part, B, T_len, H, s, st);
  }
  if (scratch == nullptr) return -4;
  if (dtype == DT_F32)
    return launch_bwd_d<float>(r, k, v, logw, u, dy, dr, dk, dv, dlogw, du, scratch, du_part, B, T_len, H, D, s, st);
  if (dtype == DT_BF16)
    return launch_bwd_d<__nv_bfloat16>(r, k, v, logw, u, dy, dr, dk, dv, dlogw, du, scratch, du_part, B, T_len, H,
                                       D, s, st);
  return -1;
}
