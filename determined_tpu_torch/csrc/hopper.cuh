// Hopper (sm_90a) building blocks shared by the port's attention kernels:
// mbarriers, TMA tile copies with 128-byte swizzle, wgmma descriptors and
// instructions, register rebalancing between warpgroups, the tile shape,
// prologue and epilogue of the warp-specialised q-tile kernels, and the
// host-side tensor-map encoder.  Each kernel source stays its own nvcc unit and
// includes this header (ops/_build.py hashes it into the library's name).
//
// Shared-memory tiles are what a TMA load with CU_TENSOR_MAP_SWIZZLE_128B
// leaves behind: rows of 64 bf16 (128 bytes), the 16-byte chunks of row r
// XOR-ed with r % 8, each tile 1024-byte aligned.  A D = 128 row is two such
// 64-column sub-tiles, one after the other.  The wgmma descriptors below
// read that layout in two ways:
//   K-major (the reduction dimension runs along the row, e.g. Q and K in
//     Q.K^T): 8-row groups 1024 bytes apart (SBO); a 16-wide k step moves
//     the start address 32 bytes along the row, the next 64 columns start
//     at the next sub-tile.
//   MN-major (the reduction dimension runs down the rows, e.g. V in P.V,
//     with the transpose bit): a k step of 16 rows moves the start address
//     2048 bytes; SBO is the 1024 bytes between 8-row groups and LBO the
//     distance between 64-column sub-tiles.
// Accumulators of m64nNk16 (f32): in warp w of the warpgroup, lane 4g + t
// holds, for every 8-column block n, (row 16w + g, cols 8n + 2t, 8n + 2t + 1)
// in d[4n], d[4n + 1] and (row 16w + g + 8, same cols) in d[4n + 2], d[4n + 3].
// A register operand of m64k16 (bf16 pairs) is laid out the same way, so the
// accumulator blocks 2j and 2j + 1 of a score tile are the A operand of
// k step j of the next product.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace hopper {

constexpr float NEG_INF = -1e30f;  // the TPU kernels' finite mask value

// ---------------------------------------------------------------------------
// device side
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&t);
}

// --- mbarriers -------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// makes the initialised barriers visible to the async proxy (TMA) and to
// the other threads; follow with __syncthreads()
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// one arrival, and `bytes` more of asynchronous copies to wait for
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// `bytes` more of asynchronous copies to wait for, without an arrival
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed.  A ring slot used
// for the i-th time (i = 0, 1, ...) is full once phase i % 2 completes; its
// producer waits for the slot to be empty with parity (i % 2) ^ 1, which the
// barrier treats as already complete the first time.  The poll never
// suspends (test_wait), so a wait of 2^34 clock cycles (about ten seconds),
// which only a broken pipeline can take, is seen: it traps, and the launch
// fails with an error instead of hanging the card.  (No printf here: a call
// would make ptxas serialise every wgmma of the kernel.)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  long long start = -1;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    const long long now = clock64();
    if (start < 0) {
      start = now;
    } else if (now - start > (1ll << 34)) {
      __trap();
    }
  }
}

// --- TMA -------------------------------------------------------------------

// Copy the box at element coordinates (c0, c1, c2) of a 3-D tensor map into
// shared memory; completion is counted in bytes on `bar`.  Coordinates past
// the tensor's extent are zero-filled (CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE).
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Store a box from shared memory; the parts past the tensor's extent are
// dropped, so a ragged tile never writes into the next head.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wait until the stores issued so far have read their shared memory
__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// orders this thread's generic-proxy shared-memory writes before later
// async-proxy (TMA, wgmma) reads of them
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// byte offset of element (row, col) in a swizzled bf16 tile of 64-column
// sub-tiles of `sub_bytes` each: what TMA's 128-byte swizzle does
__device__ __forceinline__ uint32_t sw128_offset(int row, int col, int sub_bytes) {
  const int c = col & 63;
  return (col >> 6) * sub_bytes + row * 128 + ((((c >> 3) ^ (row & 7)) << 4) | ((c & 7) << 1));
}

// --- grid order ------------------------------------------------------------------

// Heads whose tiles the grid interleaves: K and V (or Q and dO) of 16 heads
// of 1024 x 128 bf16 are 8 MB, at home in the 50 MB L2.
constexpr int HEAD_GROUP = 16;

// Map a flat CTA index over heads x tiles to (head, rank): heads go in
// groups of HEAD_GROUP; within a group every head's rank-0 tile comes
// first, then every rank-1 tile, and so on.  A kernel gives rank 0 to its
// heaviest tile, so the heavy tiles of a group start together, the light
// ones fill the tail, and a group's inputs are read from device memory about
// once (one group at the serving shape: all heads, heaviest first).
__device__ __forceinline__ void group_order(int block, int heads, int tiles, int& head, int& rank) {
  const int group = block / (HEAD_GROUP * tiles);
  const int in_group = block - group * HEAD_GROUP * tiles;
  const int width = min(HEAD_GROUP, heads - group * HEAD_GROUP);
  rank = in_group / width;
  head = group * HEAD_GROUP + in_group % width;
}

// --- named barriers, register rebalancing ------------------------------------

// barrier `id` (1..15; 0 is __syncthreads) among `threads` threads
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// All four warps of a warpgroup run these together (a lone warp in a
// warpgroup of its own hangs or faults), in a branch that never rejoins the
// other roles (else ptxas ignores them).  `inc` draws only on the registers
// that this CTA's own warps gave back with `dec` (a per-CTA pool), and waits
// until they are there: the counts must balance, or the consumers wait
// forever (see reg_pool_ok).
template <int R>
__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// --- wgmma -------------------------------------------------------------------

// shared-memory matrix descriptor for a 128-byte-swizzled operand
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo_bytes,
                                               uint32_t sbo_bytes) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo_bytes >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// descriptor advanced by `bytes` (a multiple of 16) of start address
__device__ __forceinline__ uint64_t desc_add(uint64_t desc, uint32_t bytes) { return desc + (bytes >> 4); }

// K-major operand: rows of the tile are its M (or N) rows
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr) { return desc_sw128(addr, 16, 1024); }

// MN-major operand whose 64-column sub-tiles lie `sub_bytes` apart
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t addr, uint32_t sub_bytes) {
  return desc_sw128(addr, sub_bytes, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins registers that an in-flight wgmma reads or writes: place after
// wgmma_wait so that no access to them moves above the wait.
template <int R>
__device__ __forceinline__ void fence_regs(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int J>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[J][4]) {
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[j][i])::"memory");
}

// d[64 x N] += A[64 x 16] . B[16 x N], bf16 in, f32 accumulate.  `ss`: A
// and B from shared memory (A K-major); `rs`: A from registers.  TB = 1
// reads B MN-major (transposed).  The `_zero` forms overwrite d and do not
// read it.

template <int TB>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, %34;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, %66;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %37;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %69;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_ss_n64_zero(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, %34;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "l"(da), "l"(db), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_ss_n128_zero(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, %66;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
        "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]), "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
        "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]), "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]),
        "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]), "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),
        "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]), "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
      : "l"(da), "l"(db), "n"(TB));
}

// k step 0 overwrites d (its old values are dead: the "=f" outputs let ptxas
// reuse their registers between tiles); later k steps accumulate
template <int N, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int kstep) {
  static_assert(N == 64 || N == 128, "wgmma width");
  if constexpr (N == 64) {
    if (kstep == 0) wgmma_ss_n64_zero<TB>(d, da, db);
    else wgmma_ss_n64<TB>(d, da, db);
  } else {
    if (kstep == 0) wgmma_ss_n128_zero<TB>(d, da, db);
    else wgmma_ss_n128<TB>(d, da, db);
  }
}

template <int N, int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db) {
  static_assert(N == 64 || N == 128, "wgmma width");
  if constexpr (N == 64) wgmma_rs_n64<TB>(d, a, db);
  else wgmma_rs_n128<TB>(d, a, db);
}

// the accumulator blocks 2j, 2j + 1 of `s` as the bf16 A operand of k step j
template <int N>
__device__ __forceinline__ void acc_to_a(const float (&s)[N / 2], uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int j = 0; j < N / 16; ++j) {
    a[j][0] = pack_bf16(s[8 * j + 0], s[8 * j + 1]);
    a[j][1] = pack_bf16(s[8 * j + 2], s[8 * j + 3]);
    a[j][2] = pack_bf16(s[8 * j + 4], s[8 * j + 5]);
    a[j][3] = pack_bf16(s[8 * j + 6], s[8 * j + 7]);
  }
}

// Write this thread's accumulator elements of a 64 x N tile, cast to bf16,
// into a swizzled tile at `tile` (generic pointer to its 64-row slab of
// 64-column sub-tiles `sub_bytes` apart); `warp` is the warp in the
// warpgroup.  Each store of a warp lands on 32 distinct banks.
template <int N>
__device__ __forceinline__ void stage_acc_bf16(unsigned char* tile, int sub_bytes,
                                               const float (&d)[N / 2], int warp, int g, int t) {
#pragma unroll
  for (int n = 0; n < N / 8; ++n) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = warp * 16 + g + 8 * r;
      *reinterpret_cast<uint32_t*>(tile + sw128_offset(row, 8 * n + 2 * t, sub_bytes)) =
          pack_bf16(d[4 * n + 2 * r], d[4 * n + 2 * r + 1]);
    }
  }
}

// --- warp-specialised kernels ----------------------------------------------------

// Dynamic shared memory from its first 1024-byte boundary, which 128-byte-
// swizzled tiles need (a kernel asks for 1 KB more than it uses): the
// shared-space address and a generic pointer to the same byte.
struct SmemBase {
  uint32_t addr;
  unsigned char* ptr;
};
__device__ __forceinline__ SmemBase align_smem_1024(unsigned char* raw) {
  const uint32_t r = smem_u32(raw);
  const uint32_t a = (r + 1023) & ~1023u;
  return {a, raw + (a - r)};
}

// Shape of a CTA that owns BM = 64 * NWG q rows of one (batch, head) and
// streams BN-key K and V tiles of its kv head through a ring
// (flash_fwd_wgmma, flash_bwd_dq_wgmma): NWG consumer warpgroups of 64 rows,
// then a producer, one of whose threads issues every copy.  With two
// consumer warpgroups the producer is a warpgroup that gives its registers
// to them: setmaxnreg moves registers only within the CTA and a whole
// warpgroup at a time, and 4 x 144 released registers a thread buy the
// consumers 240.  With one, the producer is a lone warp, nothing moves, and
// two CTAs share an SM (168 registers a thread at most: 10 warps on the
// SM's four 16,384-register quarters).
template <int D, int NWG, int BN_>
struct QTileCfg {
  static constexpr int BM = 64 * NWG;
  static constexpr int BN = BN_;
  static constexpr bool REBALANCE = NWG == 2;
  static constexpr int PRODUCERS = REBALANCE ? 128 : 32;
  static constexpr int THREADS = 128 * NWG + PRODUCERS;
  static constexpr int REG_PRODUCER = 24;
  static constexpr int REG_CONSUMER = 240;
  static constexpr int MIN_BLOCKS = REBALANCE ? 1 : 2;  // CTAs an SM
  static constexpr int Q_SUB = BM * 128;                // bytes of one 64-column sub-tile
  static constexpr int KV_SUB = BN * 128;
  static constexpr int Q_BYTES = (D / 64) * Q_SUB;    // one tile of the CTA's rows
  static constexpr int KV_BYTES = (D / 64) * KV_SUB;  // one K (or V) stage
};

// The q tile of this CTA and the key tiles it walks.  Heaviest first: rank
// 0 of group_order is the last q tile, which walks the most key tiles.
// Causal, the walk ends at the key tile of the last real row's diagonal.
struct QTileWalk {
  int bh;    // (batch, head) of the q rows
  int bhk;   // (batch, kv head): head h reads kv head h / (H / Hkv)
  int q0;    // first q row
  int n_kt;  // key tiles walked
};
template <int BM, int BN>
__device__ __forceinline__ QTileWalk q_tile_walk(int BH, int H, int Hkv, int Sq, int Sk,
                                                 int causal) {
  const int n_qt = (Sq + BM - 1) / BM;
  QTileWalk w;
  int rank;
  group_order(blockIdx.x, BH, n_qt, w.bh, rank);
  w.bhk = (w.bh / H) * Hkv + (w.bh % H) / (H / Hkv);
  w.q0 = (n_qt - 1 - rank) * BM;
  w.n_kt = (Sk + BN - 1) / BN;
  if (causal) w.n_kt = min(w.n_kt, (min(w.q0 + BM, Sq) - 1) / BN + 1);
  return w;
}

// Thread 0 sets up a q-tile kernel's mbarriers, 8 bytes apart from `bar`:
// the one the Q-side loads complete, LOADS x STAGES that the ring's TMA
// loads complete (one arrival each, the producer's expect_tx), then STAGES
// "empty" barriers that `consumer_warps` warps release; then the CTA syncs.
template <int LOADS, int STAGES>
__device__ __forceinline__ void init_ring_barriers(uint32_t bar, int consumer_warps) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < 1 + LOADS * STAGES; ++i) mbar_init(bar + 8 * i, 1);
    for (int s = 0; s < STAGES; ++s) mbar_init(bar + 8 * (1 + LOADS * STAGES + s), consumer_warps);
    fence_barrier_init();
  }
  __syncthreads();
}

// A consumer warpgroup's epilogue: its 64 x D accumulator, cast to bf16,
// into the swizzled tile at shared address `tile` (64-column sub-tiles
// `sub_bytes` apart; `smem` points at shared address `base`), then a TMA
// store of it to rows row0 .. row0 + 63 of head `head`.  Call it once every
// thread of the warpgroup is done with the tile; `bar` is a named barrier
// for the warpgroup's 128 threads.
template <int D>
__device__ __forceinline__ void store_acc_tma(const CUtensorMap* map, unsigned char* smem,
                                              uint32_t base, uint32_t tile, int sub_bytes,
                                              const float (&acc)[D / 2], int bar, int row0,
                                              int head) {
  const int lane = threadIdx.x % 32;
  stage_acc_bf16<D>(smem + (tile - base), sub_bytes, acc, (threadIdx.x / 32) % 4, lane / 4,
                    lane % 4);
  fence_proxy_async();
  bar_sync(bar, 128);
  if (threadIdx.x % 128 == 0) {
    for (int c = 0; c < D / 64; ++c) tma_store_3d(map, tile + c * sub_bytes, 64 * c, row0, head);
    tma_store_wait();
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver function; the runtime hands out its
// address, so the library needs no -lcuda
static EncodeTiledFn encode_tiled_fn() {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  const cudaError_t err =
      cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
  const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
  if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
  return reinterpret_cast<EncodeTiledFn>(fn);
}

// Tensor map of a contiguous bf16 tensor [heads, rows, D] seen as 3-D, with
// a box of 64 columns x `box_rows` rows of one head and 128-byte swizzle.
// Rows past `rows` read as zero and are never written: a ragged tile stays
// inside its head.  Built on every launch, since the pointers change.
static cudaError_t make_tmap(CUtensorMap* map, const void* base, int heads, int rows, int D,
                             int box_rows) {
  static const EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows, (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)D * 2 * rows};  // bytes
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Raise a kernel's dynamic shared-memory limit once per device, not on
// every launch.  `done` is the caller's per-kernel bit set of devices.
static cudaError_t smem_limit_once(const void* kernel, int bytes, std::atomic<unsigned long long>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

// Whether a warp-specialised kernel's setmaxnreg counts fit the registers
// it is launched with: `producers` threads go down to `reg_producer`,
// `consumers` up to `reg_consumer`, and the consumers can only take what the
// producers gave back.  Checked once per kernel (the launch refuses a kernel
// that would wait forever).
static bool reg_pool_ok(const void* kernel, int producers, int reg_producer, int consumers,
                        int reg_consumer, std::atomic<int>& checked) {
  int state = checked.load(std::memory_order_acquire);
  if (state == 0) {
    cudaFuncAttributes attr;
    state = 2;
    if (cudaFuncGetAttributes(&attr, kernel) == cudaSuccess &&
        (long)attr.numRegs * (producers + consumers) >=
            (long)reg_producer * producers + (long)reg_consumer * consumers &&
        attr.numRegs <= reg_consumer)
      state = 1;
    checked.store(state, std::memory_order_release);
  }
  return state == 1;
}

// streaming multiprocessors of the current device
static int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 132;
  return n;
}

}  // namespace hopper
