// Flash attention backward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: determined_tpu/ops/flash_attention.py `_flash_bwd_call`, its two
// Pallas kernels `_dq_kernel` (dtt_flash_bwd_dq) and `_dkv_kernel`
// (dtt_flash_bwd_dkv).  Same function: the probabilities are rebuilt from
// the forward's base-2 lse with the forward's exact math (q.k scaled by
// scale*log2(e), the finite -1e30 mask where q_pos < k_pos with no offset,
// exp2), then
//   p  = exp2(s2 - lse)            dp = do . v^T
//   ds = p * (dp - delta) * scale  cast to the input dtype before the products
//   dq = sum_k ds . k              dv = sum_q p_in^T . do     dk = sum_q ds^T . q
// with p_in = p cast to the input dtype and delta = rowsum(do * out) in f32,
// computed outside the kernels as the JAX wrapper computes it.  Every sum
// accumulates in f32 and is cast once at the end.
//
// Layouts: q, do, dq [B, H, Sq, D]; k, v, dk, dv [B, Hkv, Sk, D] (GQA: kv head
// h / (H / Hkv)); lse, delta [B, H, 1, Sq] f32; all contiguous.
//
// What bounds them on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s HBM).
// At the training shape [8, 16, 1024, 128] bf16 causal (524,800 (q, k) pairs
// per head, 2 * D operations per pair and product):
//   dq:  3 products (s, dp, dq) = 5.2e10 FLOP -> 52 us; ~168 MB -> 50 us
//   dkv: 4 products (s, dp, dv, dk) = 6.9e10 FLOP -> 70 us; ~201 MB -> 60 us
// so both are bound by operations, barely.  The serving path runs no
// backward.
//
// What the designs do about it.  Neither kernel writes a [Sq, Sk] tensor:
// p, dp and ds live in registers in the tensor cores' accumulator layout.
// - dq (dtt_flash_bwd_dq): one CTA of four warps owns a 64-row q tile of one
//   (batch, head) and walks 64-key tiles of K and V up to the causal
//   diagonal; each warp owns 16 q rows and keeps its dq rows in f32
//   registers.  bf16 runs mma.sync m16n8k16, f32 plain FMAs.  Tiles are
//   loaded synchronously and B fragments read as 16-bit scalars: this kernel
//   has not been redesigned for Hopper yet.
// - dkv (dtt_flash_bwd_dkv): one CTA owns a key tile of one (batch, KV head)
//   and walks the H / Hkv q heads of its group and, in each, the q tiles
//   from the diagonal on.  It computes the transposed products
//   s^T = K.Q^T and dp^T = V.dO^T, so that p^T and ds^T come out as
//   accumulators whose rows are its keys; those turn straight into the A
//   operand of dv += p^T.dO and dk += ds^T.Q.  The GQA group sum happens in
//   the f32 accumulators: dk and dv are written once, in the kv-head layout,
//   with no atomics and no repeated K/V.  (The JAX package casts each head's
//   dk to the input dtype and then sums over the group; summing in f32 first
//   differs from it by bf16 rounding only.)
//   bf16 (flash_bwd_dkv_wgmma), 64 keys a CTA, two consumer warpgroups and
//   a producer warpgroup of which one warp loads:
//   * key tiles run heaviest first: key tile 0 walks every q tile, so the
//     grid starts the key tile 0 of 16 (batch, KV head)s, then their tile
//     1, and so on (hopper::group_order); those heads' Q and dO stay in L2;
//   * loads overlap compute: the producer loads K and V once by TMA, then
//     streams the 64-row Q and dO tiles (TMA) and their lse and delta rows
//     (plain loads, zero past Sq, issued before the slot frees) into a
//     two-stage ring on mbarriers; the consumers release each slot through
//     an "empty" mbarrier.  3-D tensor maps ([B*H, Sq, D], [B*Hkv, Sk, D])
//     keep a ragged tile in its head.
//   * s^T and dp^T are wgmma with both operands K-major in 128-byte-swizzled
//     shared memory; dv and dk take p^T and ds^T (cast to bf16, as the JAX
//     kernel casts p and ds) as register A operands and dO and Q from shared
//     memory with the transpose bit: no operand is rebuilt from 16-bit
//     scalar loads.
//   * every product is a wgmma, split between the two consumer warpgroups
//     over the same keys: warpgroup 0 runs s^T = K.Q^T, p and
//     dv += p^T.dO; warpgroup 1 runs dp^T = V.dO^T, ds = p (dp - delta)
//     scale with the f32 p that warpgroup 0 hands over in shared memory (an
//     mbarrier a ring stage), and dk += ds^T.Q.  Each holds one D-wide f32
//     accumulator (64 registers a thread at D = 128) beside one score tile
//     (32): holding dk and dv in one warpgroup needed more than the 240
//     registers a thread that the producers' setmaxnreg release buys, and
//     ptxas spilled and serialised every wgmma (PERF.md, Findings).
//   * dk and dv leave through K's and V's shared memory and TMA stores.
//   f32 (flash_bwd_dkv_kernel) keeps the FMA kernel: 64 keys a CTA, four
//   warps, 32-row q tiles loaded synchronously (wgmma in tf32 would not hold
//   the f32 tolerance).

#include "hopper.cuh"

namespace {

using hopper::NEG_INF;
using hopper::pack_bf16;

constexpr int WARPS = 4;  // each warp owns 16 rows of the CTA's 64-row tile
constexpr int THREADS = WARPS * 32;
constexpr int BLOCK_M = 64;   // rows a CTA owns: q rows (dq), k rows (dkv)
constexpr int BLOCK_KN = 64;  // key tile the dq kernel walks
constexpr int BLOCK_QN = 32;  // q tile the dkv kernel walks

// shared-memory row stride in elements: 16 bytes of padding per row keeps the
// 32-bit fragment loads of a warp on distinct banks
template <typename T, int D>
struct Row {
  static constexpr int STRIDE = D + 16 / (int)sizeof(T);
};

__device__ __forceinline__ uint32_t ld32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copy rows [row0, row0 + ROWS) of a [rows, D] matrix into a padded smem tile
// with 16-byte vectors; rows at or past `rows` are zero-filled so that masked
// rows multiply zeros, never stale memory.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int row0, int rows) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PER_ROW = D / VEC;
  constexpr int STRIDE = Row<T, D>::STRIDE;
  for (int i = threadIdx.x; i < ROWS * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW;
    const int c = (i % PER_ROW) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < rows) {
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + c);
    }
    *reinterpret_cast<uint4*>(dst + r * STRIDE + c) = val;
  }
}

// Thread layout shared by both element types (the mma.sync m16n8k16
// accumulator layout): in a warp, lane = 4 * g + t holds, for every 8-column
// tile n, the elements (row g, cols 8n + 2t, 8n + 2t + 1) in slots 0, 1 and
// (row g + 8, same cols) in slots 2, 3 of the warp's 16-row slab.

// acc[16 x 8NT] += A[16 x D] . B[8NT x D]^T, with A the warp's 16 rows and B
// 8NT rows of D-wide smem tiles (both row-major, padded stride).
template <typename T, int D, int NT>
__device__ __forceinline__ void warp_abt(float acc[NT][4], const T* A, const T* B,
                                         int g, int t) {
  constexpr int STRIDE = Row<T, D>::STRIDE;
  if constexpr (sizeof(T) == 2) {
    const T* a0 = A + g * STRIDE + 2 * t;
    const T* a1 = a0 + 8 * STRIDE;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t af[4];
      af[0] = ld32(a0 + kk * 16);
      af[1] = ld32(a1 + kk * 16);
      af[2] = ld32(a0 + kk * 16 + 8);
      af[3] = ld32(a1 + kk * 16 + 8);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const T* br = B + (n * 8 + g) * STRIDE + kk * 16 + 2 * t;
        mma_bf16(acc[n], af, ld32(br), ld32(br + 8));
      }
    }
  } else {
    const float* a0 = reinterpret_cast<const float*>(A) + g * STRIDE;
    const float* a1 = a0 + 8 * STRIDE;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float* b0 = reinterpret_cast<const float*>(B) + (n * 8 + 2 * t) * STRIDE;
      const float* b1 = b0 + STRIDE;
      for (int d = 0; d < D; ++d) {
        const float x0 = a0[d], x1 = a1[d], y0 = b0[d], y1 = b1[d];
        acc[n][0] = fmaf(x0, y0, acc[n][0]);
        acc[n][1] = fmaf(x0, y1, acc[n][1]);
        acc[n][2] = fmaf(x1, y0, acc[n][2]);
        acc[n][3] = fmaf(x1, y1, acc[n][3]);
      }
    }
  }
}

// o[16 x D] += P[16 x KN] . B[KN x D], with P this warp's accumulators (cast
// to T on the way in, as the JAX kernels cast p and ds to the input dtype)
// and B KN rows of a D-wide smem tile.  The f32 path stages P in the warp's
// `pw` scratch (16 x KN floats) and runs FMAs.
template <typename T, int D, int KN>
__device__ __forceinline__ void warp_pb(float o[D / 8][4], float p[KN / 8][4],
                                        const T* B, float* pw, int g, int t) {
  constexpr int STRIDE = Row<T, D>::STRIDE;
  if constexpr (sizeof(T) == 2) {
    const uint16_t* Bh = reinterpret_cast<const uint16_t*>(B);
#pragma unroll
    for (int j = 0; j < KN / 16; ++j) {
      // the accumulators of column tiles 2j and 2j+1 are exactly the A
      // fragment of k indices [16j, 16j + 16)
      uint32_t pa[4];
      pa[0] = pack_bf16(p[2 * j][0], p[2 * j][1]);
      pa[1] = pack_bf16(p[2 * j][2], p[2 * j][3]);
      pa[2] = pack_bf16(p[2 * j + 1][0], p[2 * j + 1][1]);
      pa[3] = pack_bf16(p[2 * j + 1][2], p[2 * j + 1][3]);
      const int kr = 16 * j + 2 * t;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const int col = n * 8 + g;
        const uint32_t b0 = (uint32_t)Bh[kr * STRIDE + col] |
                            ((uint32_t)Bh[(kr + 1) * STRIDE + col] << 16);
        const uint32_t b1 = (uint32_t)Bh[(kr + 8) * STRIDE + col] |
                            ((uint32_t)Bh[(kr + 9) * STRIDE + col] << 16);
        mma_bf16(o[n], pa, b0, b1);
      }
    }
  } else {
#pragma unroll
    for (int n = 0; n < KN / 8; ++n) {
      const int c = n * 8 + 2 * t;
      pw[g * KN + c] = p[n][0];
      pw[g * KN + c + 1] = p[n][1];
      pw[(g + 8) * KN + c] = p[n][2];
      pw[(g + 8) * KN + c + 1] = p[n][3];
    }
    __syncwarp();
    const float* Bf = reinterpret_cast<const float*>(B);
    for (int kk = 0; kk < KN; ++kk) {
      const float p0 = pw[g * KN + kk];
      const float p1 = pw[(g + 8) * KN + kk];
      const float* br = Bf + kk * STRIDE + 2 * t;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const float y0 = br[n * 8], y1 = br[n * 8 + 1];
        o[n][0] = fmaf(p0, y0, o[n][0]);
        o[n][1] = fmaf(p0, y1, o[n][1]);
        o[n][2] = fmaf(p1, y0, o[n][2]);
        o[n][3] = fmaf(p1, y1, o[n][3]);
      }
    }
    __syncwarp();  // reads of pw done before the next product rewrites it
  }
}

template <int N>
__device__ __forceinline__ void zero(float a[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n) a[n][0] = a[n][1] = a[n][2] = a[n][3] = 0.f;
}

// Write this warp's 16 accumulator rows (row0 + g, row0 + g + 8) of a
// [rows, D] output, cast to T; rows past `rows` are dropped.
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* out, float acc[D / 8][4],
                                           int row0, int rows, int g, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= rows) continue;
    T* orow = out + (size_t)row * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const float x0 = acc[n][2 * r], x1 = acc[n][2 * r + 1];
      if constexpr (sizeof(T) == 2) {
        *reinterpret_cast<uint32_t*>(orow + n * 8) = pack_bf16(x0, x1);
      } else {
        *reinterpret_cast<float2*>(orow + n * 8) = make_float2(x0, x1);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// dq
// ---------------------------------------------------------------------------

template <typename T, int D>
struct DqSmem {
  static constexpr int TILE = BLOCK_M * Row<T, D>::STRIDE;  // 64 rows
  // Q, dO, K, V tiles, then (f32 only) the warp-private ds rows
  static constexpr int P_FLOATS = sizeof(T) == 4 ? WARPS * 16 * BLOCK_KN : 0;
  static constexpr size_t BYTES = 4 * TILE * sizeof(T) + P_FLOATS * sizeof(float);
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int H, int Hkv, int Sq, int Sk,
                    float scale_log2, float scale, int causal) {
  using S = DqSmem<T, D>;
  constexpr int STRIDE = Row<T, D>::STRIDE;
  constexpr int NT_S = BLOCK_KN / 8;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* dOs = Qs + S::TILE;
  T* Ks = dOs + S::TILE;
  T* Vs = Ks + S::TILE;
  float* Ps = reinterpret_cast<float*>(Vs + S::TILE);  // f32 path only

  const int q0 = blockIdx.x * BLOCK_M;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;

  const size_t qoff = ((size_t)b * H + h) * Sq;
  const T* kh = k + ((size_t)b * Hkv + hk) * Sk * D;
  const T* vh = v + ((size_t)b * Hkv + hk) * Sk * D;

  load_tile<T, D, BLOCK_M>(Qs, q + qoff * D, q0, Sq);
  load_tile<T, D, BLOCK_M>(dOs, dout + qoff * D, q0, Sq);

  const int qpos[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = qpos[r] < Sq;  // rows past Sq are computed, never stored
    lse_r[r] = in ? lse[qoff + qpos[r]] : 0.f;
    delta_r[r] = in ? delta[qoff + qpos[r]] : 0.f;
  }
  const T* Qw = Qs + warp * 16 * STRIDE;
  const T* dOw = dOs + warp * 16 * STRIDE;
  float* pw = Ps + warp * 16 * BLOCK_KN;

  float acc[D / 8][4];
  zero<D / 8>(acc);

  int n_kt = (Sk + BLOCK_KN - 1) / BLOCK_KN;
  if (causal) {
    // key tiles touching or below the diagonal of this q tile's last real row
    const int last_q = min(q0 + BLOCK_M, Sq) - 1;
    n_kt = min(n_kt, last_q / BLOCK_KN + 1);
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BLOCK_KN;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<T, D, BLOCK_KN>(Ks, kh, k0, Sk);
    load_tile<T, D, BLOCK_KN>(Vs, vh, k0, Sk);
    __syncthreads();

    float s[NT_S][4], dp[NT_S][4];
    zero<NT_S>(s);
    zero<NT_S>(dp);
    warp_abt<T, D, NT_S>(s, Qw, Ks, g, t);
    warp_abt<T, D, NT_S>(dp, dOw, Vs, g, t);

    // p = exp2(s2 - lse) under the forward's mask; ds overwrites s
#pragma unroll
    for (int n = 0; n < NT_S; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + n * 8 + 2 * t + (e & 1);
        const int r = e >> 1;
        float x = s[n][e] * scale_log2;
        if (key >= Sk || (causal && key > qpos[r])) x = NEG_INF;
        const float p = exp2f(x - lse_r[r]);
        s[n][e] = p * (dp[n][e] - delta_r[r]) * scale;
      }
    }
    warp_pb<T, D, BLOCK_KN>(acc, s, Ks, pw, g, t);  // dq += ds . K
  }
  store_rows<T, D>(dq + qoff * D, acc, q0 + warp * 16, Sq, g, t);
}

// ---------------------------------------------------------------------------
// dk, dv
// ---------------------------------------------------------------------------

template <typename T, int D>
struct DkvSmem {
  static constexpr int KTILE = BLOCK_M * Row<T, D>::STRIDE;   // 64 key rows
  static constexpr int QTILE = BLOCK_QN * Row<T, D>::STRIDE;  // 32 q rows
  // K, V, Q, dO tiles, lse and delta of the q tile, then (f32 only) the
  // warp-private p^T / ds^T rows
  static constexpr int P_FLOATS = sizeof(T) == 4 ? WARPS * 16 * BLOCK_QN : 0;
  static constexpr size_t BYTES =
      (2 * KTILE + 2 * QTILE) * sizeof(T) + (2 * BLOCK_QN + P_FLOATS) * sizeof(float);
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, int H, int Hkv, int Sq,
                     int Sk, float scale_log2, float scale, int causal) {
  using S = DkvSmem<T, D>;
  constexpr int STRIDE = Row<T, D>::STRIDE;
  constexpr int NT_S = BLOCK_QN / 8;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + S::KTILE;
  T* Qs = Vs + S::KTILE;
  T* dOs = Qs + S::QTILE;
  float* lse_s = reinterpret_cast<float*>(dOs + S::QTILE);
  float* delta_s = lse_s + BLOCK_QN;
  float* Ps = delta_s + BLOCK_QN;  // f32 path only

  const int k0 = blockIdx.x * BLOCK_M;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int n_rep = H / Hkv;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;

  const size_t koff = ((size_t)b * Hkv + hk) * Sk;
  load_tile<T, D, BLOCK_M>(Ks, k + koff * D, k0, Sk);
  load_tile<T, D, BLOCK_M>(Vs, v + koff * D, k0, Sk);

  const int kpos[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  const T* Kw = Ks + warp * 16 * STRIDE;
  const T* Vw = Vs + warp * 16 * STRIDE;
  float* pw = Ps + warp * 16 * BLOCK_QN;

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
  zero<D / 8>(dk_acc);
  zero<D / 8>(dv_acc);

  // causal: q rows before this k tile see none of its keys; the first q tile
  // walked starts at or before the diagonal and its rows above it are masked
  const int q_begin = causal ? (k0 / BLOCK_QN) * BLOCK_QN : 0;

  for (int h = hk * n_rep; h < (hk + 1) * n_rep; ++h) {
    const size_t qoff = ((size_t)b * H + h) * Sq;
    for (int q0 = q_begin; q0 < Sq; q0 += BLOCK_QN) {
      __syncthreads();  // every warp is done with the previous q tile
      load_tile<T, D, BLOCK_QN>(Qs, q + qoff * D, q0, Sq);
      load_tile<T, D, BLOCK_QN>(dOs, dout + qoff * D, q0, Sq);
      if (threadIdx.x < BLOCK_QN) {
        const int qi = q0 + threadIdx.x;
        lse_s[threadIdx.x] = qi < Sq ? lse[qoff + qi] : 0.f;
        delta_s[threadIdx.x] = qi < Sq ? delta[qoff + qi] : 0.f;
      }
      __syncthreads();

      // transposed scores: rows are this warp's keys, columns the q tile
      float sT[NT_S][4], dsT[NT_S][4];
      zero<NT_S>(sT);
      zero<NT_S>(dsT);
      warp_abt<T, D, NT_S>(sT, Kw, Qs, g, t);
      warp_abt<T, D, NT_S>(dsT, Vw, dOs, g, t);
#pragma unroll
      for (int n = 0; n < NT_S; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = n * 8 + 2 * t + (e & 1);
          const int query = q0 + c;
          const int key = kpos[e >> 1];
          float x = sT[n][e] * scale_log2;
          if (query >= Sq || key >= Sk || (causal && key > query)) x = NEG_INF;
          const float p = exp2f(x - lse_s[c]);
          sT[n][e] = p;
          dsT[n][e] = p * (dsT[n][e] - delta_s[c]) * scale;
        }
      }
      warp_pb<T, D, BLOCK_QN>(dv_acc, sT, dOs, pw, g, t);   // dv += p^T . dO
      warp_pb<T, D, BLOCK_QN>(dk_acc, dsT, Qs, pw, g, t);   // dk += ds^T . Q
    }
  }
  store_rows<T, D>(dk + koff * D, dk_acc, k0 + warp * 16, Sk, g, t);
  store_rows<T, D>(dv + koff * D, dv_acc, k0 + warp * 16, Sk, g, t);
}

// ---------------------------------------------------------------------------
// dk, dv in bf16: TMA + wgmma, warp-specialised
// ---------------------------------------------------------------------------

constexpr int STAGES = 2;

template <int D>
struct DkvCfg {
  static constexpr int BK = 64;  // keys of the CTA, shared by both consumer warpgroups
  static constexpr int BQ = 64;  // q rows of one ring stage: two per producer lane
  // two consumer warpgroups, then a producer warpgroup whose first warp
  // loads: setmaxnreg moves registers only within the CTA, and the
  // producers' 4 x 144 released registers a thread buy the consumers 240
  static constexpr int THREADS = 3 * 128;
  static constexpr int REG_PRODUCER = 24;
  static constexpr int REG_CONSUMER = 240;
  static constexpr int K_SUB = BK * 128;  // bytes of one 64-column sub-tile
  static constexpr int Q_SUB = BQ * 128;
  static constexpr int KV_BYTES = (D / 64) * K_SUB;  // all of K (or V)
  static constexpr int QS_BYTES = (D / 64) * Q_SUB;  // one Q (or dO) stage
  static constexpr int P_BYTES = BK * BQ * 4;        // one stage of f32 p
  static_assert(K_SUB == Q_SUB, "the score products step A and B alike");
  // shared memory: K | V | Q[STAGES] | dO[STAGES] | p[STAGES] |
  //                lse, delta [STAGES][BQ] | mbarriers
  static constexpr int OFF_V = KV_BYTES;
  static constexpr int OFF_Q = 2 * KV_BYTES;
  static constexpr int OFF_DO = OFF_Q + STAGES * QS_BYTES;
  static constexpr int OFF_P = OFF_DO + STAGES * QS_BYTES;
  static constexpr int OFF_ROWS = OFF_P + STAGES * P_BYTES;
  static constexpr int OFF_BAR = OFF_ROWS + STAGES * 2 * BQ * 4;
  static constexpr int SMEM = OFF_BAR + 64 + 1024;  // + 1 KB to align the base to 1024 bytes
};

template <int D>
__global__ void __launch_bounds__(DkvCfg<D>::THREADS, 1)
flash_bwd_dkv_wgmma(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                    const __grid_constant__ CUtensorMap tm_dk, const __grid_constant__ CUtensorMap tm_dv,
                    const float* __restrict__ lse, const float* __restrict__ delta, int BHkv, int H,
                    int Hkv, int Sq, int Sk, float scale_log2, float scale, int causal) {
  using C = DkvCfg<D>;
  constexpr int BQ = C::BQ;
  using namespace hopper;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);  // generic pointer to `base`
  const uint32_t sK = base, sV = base + C::OFF_V, sQ = base + C::OFF_Q, sDO = base + C::OFF_DO;
  float* p_buf = reinterpret_cast<float*>(smem + C::OFF_P);     // [stage][32 / 4][128][4]
  float* rows = reinterpret_cast<float*>(smem + C::OFF_ROWS);  // [stage][lse BQ | delta BQ]
  const uint32_t kv_full = base + C::OFF_BAR;
  auto full = [&](int s) { return kv_full + 8 * (1 + s); };
  auto empty = [&](int s) { return kv_full + 8 * (1 + STAGES + s); };
  auto p_full = [&](int s) { return kv_full + 8 * (1 + 2 * STAGES + s); };

  // heaviest first: rank 0 is key tile 0, which walks every q tile
  int bhk, kt;
  group_order(blockIdx.x, BHkv, (Sk + C::BK - 1) / C::BK, bhk, kt);
  const int b = bhk / Hkv;
  const int n_rep = H / Hkv;
  const int h_first = (bhk % Hkv) * n_rep;
  const int k0 = kt * C::BK;
  // causal: q rows before this key tile see none of its keys, and the first
  // q tile walked (q0 = k0) holds the diagonal
  const int q_begin = causal ? k0 : 0;
  const int n_qt = q_begin < Sq ? (Sq - q_begin + BQ - 1) / BQ : 0;  // q tiles per head

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 32);     // every producer lane after its lse/delta stores, + TMA bytes
      mbar_init(empty(s), 8);     // lane 0 of every consumer warp
      mbar_init(p_full(s), 128);  // every thread of the p warpgroup after its p stores
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= 8) {
    // ---- producer: its first warp loads, the other three only give registers ------
    regs_dealloc<C::REG_PRODUCER>();
    if (warp > 8) return;
    if (lane == 0) {
      mbar_arrive_expect_tx(kv_full, 2 * C::KV_BYTES);
      for (int c = 0; c < D / 64; ++c) {
        tma_load_3d(sK + c * C::K_SUB, &tm_k, kv_full, 64 * c, k0, bhk);
        tma_load_3d(sV + c * C::K_SUB, &tm_v, kv_full, 64 * c, k0, bhk);
      }
    }
    int it = 0;
    for (int hh = 0; hh < n_rep; ++hh) {
      const int bh = b * H + h_first + hh;
      for (int i = 0; i < n_qt; ++i, ++it) {
        const int q0 = q_begin + i * BQ;
        const int s = it % STAGES;
        // this tile's lse and delta rows (zero past Sq: those rows are
        // computed, never stored), loaded while the slot is still in use
        float l2[2], d2[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int row = q0 + 32 * j + lane;
          l2[j] = row < Sq ? lse[(size_t)bh * Sq + row] : 0.f;
          d2[j] = row < Sq ? delta[(size_t)bh * Sq + row] : 0.f;
        }
        mbar_wait(empty(s), ((it / STAGES) & 1) ^ 1);
        if (lane == 0) {
          mbar_expect_tx(full(s), 2 * C::QS_BYTES);
          for (int c = 0; c < D / 64; ++c) {
            tma_load_3d(sQ + s * C::QS_BYTES + c * C::Q_SUB, &tm_q, full(s), 64 * c, q0, bh);
            tma_load_3d(sDO + s * C::QS_BYTES + c * C::Q_SUB, &tm_do, full(s), 64 * c, q0, bh);
          }
        }
        float* lse_s = rows + s * 2 * BQ;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          lse_s[32 * j + lane] = l2[j];
          lse_s[BQ + 32 * j + lane] = d2[j];
        }
        mbar_arrive(full(s));
      }
    }
  } else {
    // ---- consumers: both warpgroups on the CTA's 64 keys.  Warpgroup 0 computes
    // s^T = K Q^T, p and dv += p^T dO; warpgroup 1 computes dp^T = V dO^T,
    // ds = p (dp - delta) scale (p from warpgroup 0, in f32, through shared
    // memory) and dk += ds^T Q.  Each holds one D-wide accumulator.
    regs_alloc<C::REG_CONSUMER>();
    const int wg = warp / 4;
    const int wl = warp % 4;  // warp in the warpgroup: keys 16 wl .. 16 wl + 15
    const int g = lane / 4;
    const int t = lane % 4;
    const int tid = threadIdx.x % 128;
    const int kpos[2] = {k0 + 16 * wl + g, k0 + 16 * wl + g + 8};
    // A operand of this warpgroup's score product: K (s^T) or V (dp^T)
    const uint64_t da = desc_kmajor(wg == 0 ? sK : sV);

    float acc[D / 2];  // dv (warpgroup 0) or dk (warpgroup 1)
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    mbar_wait(kv_full, 0);
    int it = 0;
    for (int hh = 0; hh < n_rep; ++hh) {
      for (int i = 0; i < n_qt; ++i, ++it) {
        const int q0 = q_begin + i * BQ;
        const int s = it % STAGES;
        const uint32_t parity = (it / STAGES) & 1;
        mbar_wait(full(s), parity);
        const uint32_t sQs = sQ + s * C::QS_BYTES, sDOs = sDO + s * C::QS_BYTES;
        const float* lse_s = rows + s * 2 * BQ;
        float4* p_s = reinterpret_cast<float4*>(p_buf) + s * (BQ / 8) * 128;

        // ---- s^T (warpgroup 0) or dp^T (warpgroup 1), both K-major ------------------
        float sc[BQ / 2];
        uint32_t pa[BQ / 16][4];
        const uint64_t db = desc_kmajor(wg == 0 ? sQs : sDOs);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t off = (kk / 4) * C::K_SUB + (kk % 4) * 32;  // K_SUB == Q_SUB
          wgmma_ss<BQ, 0>(sc, desc_add(da, off), desc_add(db, off), kk);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);

        if (wg == 0) {
          // ---- p = exp2(s2 - lse) under the forward's mask; f32 p to warpgroup 1 ----
          const bool masked = q0 + BQ > Sq || k0 + 64 > Sk || (causal && k0 + 63 > q0);
#pragma unroll
          for (int n = 0; n < BQ / 8; ++n) {
            const float2 l2 = *reinterpret_cast<const float2*>(lse_s + 8 * n + 2 * t);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float x = sc[4 * n + e] * scale_log2;
              if (masked) {
                const int query = q0 + 8 * n + 2 * t + (e & 1);
                const int key = kpos[e >> 1];
                if (query >= Sq || key >= Sk || (causal && key > query)) x = NEG_INF;
              }
              sc[4 * n + e] = exp2f(x - ((e & 1) ? l2.y : l2.x));
            }
            p_s[n * 128 + tid] = make_float4(sc[4 * n], sc[4 * n + 1], sc[4 * n + 2], sc[4 * n + 3]);
          }
          mbar_arrive(p_full(s));
          acc_to_a<BQ>(sc, pa);  // p^T cast to bf16, as the JAX kernel casts p
        } else {
          // ---- ds = p (dp - delta) scale, p in f32 from warpgroup 0 --------------------
          const float* delta_s = lse_s + BQ;
          mbar_wait(p_full(s), parity);
#pragma unroll
          for (int n = 0; n < BQ / 8; ++n) {
            const float2 d2 = *reinterpret_cast<const float2*>(delta_s + 8 * n + 2 * t);
            const float4 p4 = p_s[n * 128 + tid];
            const float p[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
            for (int e = 0; e < 4; ++e)
              sc[4 * n + e] = p[e] * (sc[4 * n + e] - ((e & 1) ? d2.y : d2.x)) * scale;
          }
          acc_to_a<BQ>(sc, pa);  // ds^T cast to bf16, as the JAX kernel casts ds
        }

        // ---- dv += p^T dO or dk += ds^T Q: A from registers, B MN-major -----------------
        const uint64_t db_t = desc_mnmajor(wg == 0 ? sDOs : sQs, C::Q_SUB);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < BQ / 16; ++j) wgmma_rs<D, 1>(acc, pa[j], desc_add(db_t, j * 16 * 128));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(pa);
        if (lane == 0) mbar_arrive(empty(s));  // this warp is done with the stage
      }
    }

    // ---- epilogue: dv into V's rows, dk into K's, once both warpgroups are done
    // with K and V; then TMA stores
    bar_sync(1, 256);
    const uint32_t tile = wg == 0 ? sV : sK;
    stage_acc_bf16<D>(smem + (tile - base), C::K_SUB, acc, wl, g, t);
    fence_proxy_async();
    bar_sync(2 + wg, 128);
    if (tid == 0) {
      for (int c = 0; c < D / 64; ++c)
        tma_store_3d(wg == 0 ? &tm_dv : &tm_dk, tile + c * C::K_SUB, 64 * c, k0, bhk);
      tma_store_wait();
    }
  }
}

template <int D>
cudaError_t launch_dkv_bf16(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dk, void* dv, int B, int H,
                            int Hkv, int Sq, int Sk, float scale_log2, float scale, int causal,
                            cudaStream_t stream) {
  using C = DkvCfg<D>;
  static std::atomic<unsigned long long> smem_set{0};
  static std::atomic<int> regs_checked{0};
  auto kernel = flash_bwd_dkv_wgmma<D>;
  cudaError_t err = hopper::smem_limit_once((const void*)kernel, C::SMEM, smem_set);
  if (err != cudaSuccess) return err;
  if (!hopper::reg_pool_ok((const void*)kernel, 128, C::REG_PRODUCER, 256, C::REG_CONSUMER,
                           regs_checked))
    return cudaErrorInvalidConfiguration;
  CUtensorMap tm_q, tm_k, tm_v, tm_do, tm_dk, tm_dv;
  if ((err = hopper::make_tmap(&tm_q, q, B * H, Sq, D, C::BQ)) != cudaSuccess ||
      (err = hopper::make_tmap(&tm_do, dout, B * H, Sq, D, C::BQ)) != cudaSuccess ||
      (err = hopper::make_tmap(&tm_k, k, B * Hkv, Sk, D, C::BK)) != cudaSuccess ||
      (err = hopper::make_tmap(&tm_v, v, B * Hkv, Sk, D, C::BK)) != cudaSuccess ||
      (err = hopper::make_tmap(&tm_dk, dk, B * Hkv, Sk, D, 64)) != cudaSuccess ||
      (err = hopper::make_tmap(&tm_dv, dv, B * Hkv, Sk, D, 64)) != cudaSuccess)
    return err;
  const int n_kt = (Sk + C::BK - 1) / C::BK;
  kernel<<<n_kt * B * Hkv, C::THREADS, C::SMEM, stream>>>(
      tm_q, tm_k, tm_v, tm_do, tm_dk, tm_dv, static_cast<const float*>(lse),
      static_cast<const float*>(delta), B * Hkv, H, Hkv, Sq, Sk, scale_log2, scale, causal);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dq, int B, int H,
                      int Hkv, int Sq, int Sk, float scale_log2, float scale,
                      int causal, cudaStream_t stream) {
  static std::atomic<unsigned long long> smem_set{0};
  auto kernel = flash_bwd_dq_kernel<T, D>;
  const size_t smem = DqSmem<T, D>::BYTES;
  cudaError_t err = hopper::smem_limit_once((const void*)kernel, (int)smem, smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BLOCK_M - 1) / BLOCK_M, H, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), H, Hkv, Sq, Sk,
      scale_log2, scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_f32(const void* q, const void* k, const void* v, const void* dout,
                           const void* lse, const void* delta, void* dk, void* dv, int B,
                           int H, int Hkv, int Sq, int Sk, float scale_log2, float scale,
                           int causal, cudaStream_t stream) {
  static std::atomic<unsigned long long> smem_set{0};
  auto kernel = flash_bwd_dkv_kernel<float, D>;
  const size_t smem = DkvSmem<float, D>::BYTES;
  cudaError_t err = hopper::smem_limit_once((const void*)kernel, (int)smem, smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid((Sk + BLOCK_M - 1) / BLOCK_M, Hkv, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dk), static_cast<float*>(dv), H,
      Hkv, Sq, Sk, scale_log2, scale, causal);
  return cudaGetLastError();
}

bool valid_dims(int B, int H, int Hkv, int Sq, int Sk) {
  return B >= 1 && H >= 1 && Hkv >= 1 && H % Hkv == 0 && Sq >= 1 && Sk >= 1;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; D: 64 or 128.  All tensors contiguous
// and 16-byte aligned.  Returns the launch's cudaError_t (0 on success); the
// wrapper checks everything else.
extern "C" int dtt_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse, const void* delta,
                                void* dq, int dtype, int B, int H, int Hkv, int Sq,
                                int Sk, int D, float scale_log2, float scale,
                                int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!valid_dims(B, H, Hkv, Sq, Sk)) return (int)cudaErrorInvalidValue;
#define DQ_ARGS q, k, v, dout, lse, delta, dq, B, H, Hkv, Sq, Sk, scale_log2, scale, causal, s
  if (dtype == 1 && D == 128) return (int)launch_dq<__nv_bfloat16, 128>(DQ_ARGS);
  if (dtype == 1 && D == 64) return (int)launch_dq<__nv_bfloat16, 64>(DQ_ARGS);
  if (dtype == 0 && D == 128) return (int)launch_dq<float, 128>(DQ_ARGS);
  if (dtype == 0 && D == 64) return (int)launch_dq<float, 64>(DQ_ARGS);
#undef DQ_ARGS
  return (int)cudaErrorInvalidValue;
}

extern "C" int dtt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse, const void* delta,
                                 void* dk, void* dv, int dtype, int B, int H, int Hkv,
                                 int Sq, int Sk, int D, float scale_log2, float scale,
                                 int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!valid_dims(B, H, Hkv, Sq, Sk)) return (int)cudaErrorInvalidValue;
#define DKV_ARGS q, k, v, dout, lse, delta, dk, dv, B, H, Hkv, Sq, Sk, scale_log2, scale, causal, s
  if (dtype == 1 && D == 128) return (int)launch_dkv_bf16<128>(DKV_ARGS);
  if (dtype == 1 && D == 64) return (int)launch_dkv_bf16<64>(DKV_ARGS);
  if (dtype == 0 && D == 128) return (int)launch_dkv_f32<128>(DKV_ARGS);
  if (dtype == 0 && D == 64) return (int)launch_dkv_f32<64>(DKV_ARGS);
#undef DKV_ARGS
  return (int)cudaErrorInvalidValue;
}
