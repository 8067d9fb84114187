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
// (B, T, H, D) and du (H, D) contiguous f32; scratch (B H, T, D) and du_part
// (B, H, D) are f32 workspace.  Four launches on `stream`: the passes A, B and
// C above and wkv6_du_kernel.  Returns cudaGetLastError() of the first launch
// that failed, -1 for a bad dtype, -2 for a head size it is not instantiated for.
extern "C" int wkv6_bwd_launch(const void* r, const void* k, const void* v, const void* logw, const void* u,
                               const void* dy, void* dr, void* dk, void* dv, void* dlogw, void* du, void* scratch,
                               void* du_part, int B, int T_len, int H, int D, int dtype, int64_t r_sb,
                               int64_t r_st, int64_t r_sh, int64_t k_sb, int64_t k_st, int64_t k_sh, int64_t v_sb,
                               int64_t v_st, int64_t v_sh, int64_t w_sb, int64_t w_st, int64_t w_sh,
                               int64_t g_sb, int64_t g_st, int64_t g_sh, void* stream) {
  if (B == 0 || T_len == 0 || H == 0) return 0;
  const int64_t s[15] = {r_sb, r_st, r_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, w_sb, w_st, w_sh, g_sb, g_st, g_sh};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == DT_F32)
    return launch_bwd_d<float>(r, k, v, logw, u, dy, dr, dk, dv, dlogw, du, scratch, du_part, B, T_len, H, D, s, st);
  if (dtype == DT_BF16)
    return launch_bwd_d<__nv_bfloat16>(r, k, v, logw, u, dy, dr, dk, dv, dlogw, du, scratch, du_part, B, T_len, H,
                                       D, s, st);
  return -1;
}
