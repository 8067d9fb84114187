// RWKV-6 WKV recurrence, one (batch, head) a block, state carried in registers:
//
//   y_t[e]    = sum_d r_t[d] * (S[d][e] + u[d] * k_t[d] * v_t[e])
//   S[d][e]  <- S[d][e] * w_t[d] + k_t[d] * v_t[e]         w_t = exp(logw_t)
//
// Replaces the TPU kernel repro/kernels/wkv6.py::wkv6_bhtd (body _wkv6_kernel),
// whose grid walks the chunks of one (batch, head) row in order with the D x D
// state in VMEM scratch, from a zero state, and returns no final state.  Here
// the state comes in (S0, or zeros when the pointer is null) and the final
// state is written back over it: the update in place is safe because one block
// alone reads and writes its (b, h) slice.
//
// What bounds it on an H100: over a prefill's length the f32 arithmetic of
// the recurrence, 5 operations a state element a step on the CUDA cores; for
// a decode step (T = 1) the bytes, the 16 KB state read once and written once.
// The design:
//   * the TPU's sequential chunk axis becomes a loop over t inside the block;
//     the recurrence is the exact sequential one, so there is no exp(-lcum)
//     factor that can overflow, any T works with no padding, and T = 1 is one
//     iteration;
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
// The products are not on the tensor cores; the chunked form (C x C products
// with wgmma, the state in shared memory) is the way to the operations bound.
#include "common.cuh"

namespace {

constexpr int kQ = 4;    // threads a value column
constexpr int kTT = 16;  // time steps a tile

template <typename T, int D>
__global__ void __launch_bounds__(kQ * D)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
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
      const int64_t t = t0 + q + j * kQ;
      const bool in = t < T_len;
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
      yb[(int64_t)(t0 + s) * y_st + d] = from_f32<T>(yv);
    }
    __syncthreads();  // the next tile overwrites the shared arrays
  }

  if (st != nullptr) {
#pragma unroll
    for (int i = 0; i < R; ++i) st[(q * R + i) * D + e] = S[i];
  }
}

template <typename T, int D>
int launch(const void* r, const void* k, const void* v, const void* logw, const void* u, void* state,
           void* y, int B, int T_len, int H, const int64_t* s, cudaStream_t stream) {
  wkv6_kernel<T, D><<<(unsigned)(B * H), kQ * D, 0, stream>>>(
      (const T*)r, (const T*)k, (const T*)v, (const float*)logw, (const float*)u, (float*)state,
      (T*)y, T_len, H, s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10], s[11]);
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
// `dtype`.  Returns cudaGetLastError() of the launch, -1 for a bad dtype,
// -2 for a head size the kernel is not instantiated for.
extern "C" int wkv6_launch(const void* r, const void* k, const void* v, const void* logw,
                           const void* u, void* state, void* y, int B, int T_len, int H, int D,
                           int dtype, int64_t r_sb, int64_t r_st, int64_t r_sh, int64_t k_sb,
                           int64_t k_st, int64_t k_sh, int64_t v_sb, int64_t v_st, int64_t v_sh,
                           int64_t w_sb, int64_t w_st, int64_t w_sh, void* stream) {
  if (B == 0 || T_len == 0 || H == 0) return 0;
  const int64_t s[12] = {r_sb, r_st, r_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, w_sb, w_st, w_sh};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == DT_F32) return launch_d<float>(r, k, v, logw, u, state, y, B, T_len, H, D, s, st);
  if (dtype == DT_BF16) return launch_d<__nv_bfloat16>(r, k, v, logw, u, state, y, B, T_len, H, D, s, st);
  return -1;
}
