// Hopper's warpgroup products (wgmma.mma_async m64nNk16, bf16 in, f32
// sums in registers), the shared-memory layout they read, and the Tensor
// Memory Accelerator copies (cp.async.bulk.tensor, completed on an mbarrier)
// that fill and drain it, for the backward kernels of flash_attention_bwd.cu.
//
// A tile is 64 rows x D bf16, in column blocks of CB = SW / 2 columns: block
// c holds columns c CB.. of every row, row r at r SW bytes, and its 16-byte
// pieces swizzled within each group of 8 rows as TMA's SW-byte swizzle
// writes them (piece p of row r lands at p ^ ((r SW / 128) % (SW / 16))).
// SW is the widest swizzle whose span divides a row: 128 bytes for D 64 and
// 128, 64 for D 32, 32 for D 80 (160 bytes a row).  One TMA box (CB columns
// x 64 rows) fills a block, so a copy moves SW contiguous bytes a row, not 16.
// A block starts on 1024 bytes, where the swizzle pattern starts over.  wgmma
// reads the same tile both ways:
//
// - K-major (rows are M or N, the 16 columns of a k-step are K; K and Q as the
//   operands of S^T = K Q^T): the stride offset is 8 SW bytes (8 rows); a
//   k-step starts at its columns' byte in the row of its column block (32 kk
//   bytes into the block, the swizzle applied by the hardware); the leading
//   offset is unused.
// - MN-major (rows are K, columns N; dO, Q or K as B of P^T dO, dS^T Q, dS K):
//   the leading offset is a column block (64 SW bytes) along N, the stride
//   offset 8 rows (8 SW bytes) along K; k-step kk starts at row 16 kk.
#pragma once

#include <cuda.h>  // CUtensorMap: the type only, the encoder is fetched at run time

#include "common.cuh"

constexpr int TILE_ROWS = 64;  // rows of a tile: one warpgroup's M

template <int D>
struct TileFmt {
  static constexpr int SW = D % 64 == 0 ? 128 : D % 32 == 0 ? 64 : 32;  // swizzle span, bytes
  static constexpr int CB = SW / 2;                                      // bf16 columns of a block
  static constexpr int NB = D / CB;                                      // blocks, TMA boxes a tile
  static constexpr int BLOCK_BYTES = TILE_ROWS * SW;
  static constexpr uint64_t MODE = SW == 128 ? 1 : SW == 64 ? 2 : 3;      // the descriptor's layout type
  static_assert(D % 16 == 0 && D % CB == 0, "whole k-steps, whole column blocks");
  static_assert((TILE_ROWS * D * 2) % 1024 == 0, "a tile ends where the next can start its swizzle pattern");
};

// The 64-bit matrix descriptor at shared address `addr`: offsets in bytes
// (multiples of 16), the layout type in bits 62-63, base offset 0 (blocks
// start where the swizzle pattern does).
__device__ inline uint64_t wg_desc(uint32_t addr, uint32_t leading, uint32_t stride, uint64_t mode) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(leading >> 4) << 16) | ((uint64_t)(stride >> 4) << 32) |
         (mode << 62);
}

// k-step kk of a tile read K-major, and read MN-major
template <int D>
__device__ inline uint64_t kdesc(const __nv_bfloat16* tile, int kk) {
  using F = TileFmt<D>;
  const int col = 16 * kk;
  return wg_desc(smem_addr(tile) + (col / F::CB) * F::BLOCK_BYTES + (col % F::CB) * 2, 16, 8 * F::SW, F::MODE);
}
template <int D>
__device__ inline uint64_t ndesc(const __nv_bfloat16* tile, int kk) {
  using F = TileFmt<D>;
  return wg_desc(smem_addr(tile) + 16 * kk * F::SW, F::BLOCK_BYTES, 8 * F::SW, F::MODE);
}

// the byte of element (r, c) in a tile, as TMA's swizzle places it
template <int D>
__device__ inline int tile_byte(int r, int c) {
  using F = TileFmt<D>;
  const int piece = ((c % F::CB) * 2) >> 4;
  return (c / F::CB) * F::BLOCK_BYTES + r * F::SW + ((piece ^ ((r * F::SW >> 7) & (F::SW / 16 - 1))) << 4) +
         ((c * 2) & 15);
}

// mbarriers in shared memory, by their shared-space address
__device__ inline void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// makes the initialised barriers visible to the TMA unit; then a __syncthreads
__device__ inline void mbar_init_fence() { asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory"); }
// one arrival that also expects `bytes` from copies completing on the barrier
__device__ inline void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}
// Waits for the barrier's phase of this parity to complete.  A copy that
// never lands (a bad tensor map) traps after a few seconds instead of hanging.
__device__ inline void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (n > (1u << 22)) __trap();
  }
}

// Tile (rows row.., head, batch) of `map` into shared memory at dst, one box
// a column block, completing on the barrier at `bar` (TileFmt<D>::NB * 64 *
// SW = 128 D bytes in all; rows past the tensor's end land as zeros).
template <int D>
__device__ inline void tma_tile(__nv_bfloat16* dst, const CUtensorMap* map, uint32_t bar, int row, int head,
                                int batch) {
  using F = TileFmt<D>;
#pragma unroll
  for (int c = 0; c < F::NB; ++c)
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], "
        "[%6];\n" ::"r"(smem_addr(dst) + c * F::BLOCK_BYTES),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(c * F::CB), "r"(row), "r"(head), "r"(batch), "r"(bar)
        : "memory");
}

// The tile at src into `map` at (rows row.., head, batch), one box a column
// block, as a bulk group; rows past the tensor's end are not written.
template <int D>
__device__ inline void tma_store_tile(const CUtensorMap* map, const __nv_bfloat16* src, int row, int head, int batch) {
  using F = TileFmt<D>;
#pragma unroll
  for (int c = 0; c < F::NB; ++c)
    asm volatile("cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%1, %2, %3, %4}], [%5];\n" ::"l"(
                     reinterpret_cast<uint64_t>(map)),
                 "r"(c * F::CB), "r"(row), "r"(head), "r"(batch), "r"(smem_addr(src) + c * F::BLOCK_BYTES)
                 : "memory");
}
__device__ inline void tma_store_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }
// the bulk groups have read their shared memory (the block may then exit or reuse it)
__device__ inline void tma_store_wait_read() { asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory"); }

// Writes of the generic proxy (st.shared) made visible to the async proxy
// (a TMA store reading them); each writing thread, before the barrier.
__device__ inline void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

__device__ inline void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ inline void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ inline void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Ties registers to this point of the program, so that the compiler neither
// reads an accumulator before wg_wait nor reuses an A fragment's registers
// while a product still reads them.
template <int N>
__device__ inline void keep(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ inline void keep(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// The accumulator of a 64 x N product: warp w of the warpgroup holds rows 16w
// + g and 16w + g + 8 (g = lane / 4), register 4j + e column 8j + 2(lane % 4)
// + (e & 1) of row 16w + g + 8(e >> 1): the mma.sync m16n8 layout, N / 8 times.
// The A operand from registers (64 x 16, K-major) is the m16n8k16 A fragment
// of the warp's 16 rows, so the accumulators of columns 16kk..16kk+15 rounded
// to bf16 pairs are the A fragment of k-step kk of the next product.
__device__ inline void acc_to_a(uint32_t (&a)[4], const float* d) {
  a[0] = pack_bf16(d[0], d[1]);
  a[1] = pack_bf16(d[2], d[3]);
  a[2] = pack_bf16(d[4], d[5]);
  a[3] = pack_bf16(d[6], d[7]);
}

// d (64 x N, f32) [+]= A B, the sum kept where `accumulate` is not 0: ss
// takes A and B from shared memory, B K-major (the score products, N 64);
// rs takes A from registers and B MN-major (the products into dV, dK and dQ,
// N the head size).
template <int N>
struct Wg;

template <>
struct Wg<32> {
  // d (64 x 32) = [d +] A B, A from registers, B (MN-major) from shared memory
  __device__ static void rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
  }
};

template <>
struct Wg<64> {
  // d (64 x 64) = [d +] A B, A and B (K-major) from shared memory
  __device__ static void ss(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(accumulate));
  }
  // d (64 x 64) = [d +] A B, A from registers, B (MN-major) from shared memory
  __device__ static void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
  }
};

template <>
struct Wg<80> {
  // d (64 x 80) = [d +] A B, A from registers, B (MN-major) from shared memory
  __device__ static void rs(float (&d)[40], const uint32_t (&a)[4], uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39"
        "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
  }
};

template <>
struct Wg<128> {
  // d (64 x 128) = [d +] A B, A from registers, B (MN-major) from shared memory
  __device__ static void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
  }
};

