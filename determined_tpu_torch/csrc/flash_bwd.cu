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
// so both are bound by operations, barely: their products have to run near
// the tensor cores' rate, with the loads and the elementwise work out of the
// way.  The serving path runs no backward.
//
// What the designs do about it.  Neither kernel writes a [Sq, Sk] tensor:
// p, dp and ds live in registers in the tensor cores' accumulator layout.
// - dq, bf16 (flash_bwd_dq_wgmma): a CTA owns 64 q rows of one (batch,
//   head): a consumer warpgroup, and a producer warp that issues every load:
//   * loads overlap compute: the producer loads the CTA's Q and dO once by
//     TMA, then streams 64-key K and V tiles of the kv head into a
//     two-stage ring on full/empty mbarriers; 3-D tensor maps
//     ([B*H, Sq, D], [B*Hkv, Sk, D]) zero-fill a ragged tile inside its
//     head and clip dq's store.  Each consumer thread reads its rows' lse
//     and delta once: the rows do not change across the walk.
//   * every product is a wgmma: s = Q.K^T and dp = dO.V^T, both operands
//     K-major in 128-byte-swizzled shared memory, are issued together and
//     waited for once; p and ds run in the accumulator layout (masked only
//     on tiles that cross the diagonal or a ragged edge); ds, cast to bf16
//     as the JAX kernel casts it, is the register A operand of dq += ds.K,
//     whose B is the same K tile read MN-major with the transpose bit.
//   * a consumer thread holds dq (64 f32 at D = 128), s and dp (32 each)
//     and ds as bf16 (16): 162 registers at D = 128, so two CTAs share an
//     SM and one CTA's elementwise work runs beside the other's products.
//     128-row CTAs (two consumer warpgroups given a producer warpgroup's
//     registers by setmaxnreg, as the forward's) were 7% slower at the
//     training shape (PERF.md, Findings).
//   * the products run in series.  Keeping one tile's dq product in flight
//     behind the next tile's s and dp holds 144 registers beside the
//     addresses: at D = 128 ptxas serialised every wgmma (C7512) in the
//     168 registers two CTAs an SM allow, and in a 128-row CTA's 240 alike;
//     allowed more, the CTA took 182 and ran one an SM, slower still.
//   * causal: a CTA walks key tiles up to its last real row's diagonal.
//   * heaviest first: the last q tiles (which walk every key tile) of 16
//     heads start together, then their next-to-last, and so on
//     (hopper::group_order), so the group's K and V stay in L2.
//   * dq leaves as bf16 through Q's tile and a TMA store.
//   f32 (flash_bwd_dq_kernel) keeps the FMA kernel: four warps own a 64-row
//   q tile, walk 64-key tiles loaded synchronously into padded shared
//   memory, and each warp keeps its 16 dq rows in f32 registers (wgmma in
//   tf32 would not hold the f32 tolerance).
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

// ---------------------------------------------------------------------------
// f32: FMA kernels
// ---------------------------------------------------------------------------

constexpr int WARPS = 4;  // each warp owns 16 rows of the CTA's 64-row tile
constexpr int THREADS = WARPS * 32;
constexpr int BLOCK_M = 64;   // rows a CTA owns: q rows (dq), k rows (dkv)
constexpr int BLOCK_KN = 64;  // key tile the dq kernel walks
constexpr int BLOCK_QN = 32;  // q tile the dkv kernel walks

// shared-memory row stride in floats: 16 bytes of padding per row keeps the
// fragment loads of a warp on distinct banks
template <int D>
struct Row {
  static constexpr int STRIDE = D + 4;
};

// Copy rows [row0, row0 + ROWS) of a [rows, D] matrix into a padded smem tile
// with 16-byte vectors; rows at or past `rows` are zero-filled so that masked
// rows multiply zeros, never stale memory.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int row0, int rows) {
  constexpr int PER_ROW = D / 4;
  constexpr int STRIDE = Row<D>::STRIDE;
  for (int i = threadIdx.x; i < ROWS * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW;
    const int c = (i % PER_ROW) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < rows) val = *reinterpret_cast<const float4*>(src + (size_t)(row0 + r) * D + c);
    *reinterpret_cast<float4*>(dst + r * STRIDE + c) = val;
  }
}

// Thread layout (the mma.sync m16n8 accumulator layout): in a warp,
// lane = 4 * g + t holds, for every 8-column tile n, the elements (row g,
// cols 8n + 2t, 8n + 2t + 1) in slots 0, 1 and (row g + 8, same cols) in
// slots 2, 3 of the warp's 16-row slab.

// acc[16 x 8NT] += A[16 x D] . B[8NT x D]^T, with A the warp's 16 rows and B
// 8NT rows of D-wide smem tiles (both row-major, padded stride).
template <int D, int NT>
__device__ __forceinline__ void warp_abt(float acc[NT][4], const float* A, const float* B, int g,
                                         int t) {
  constexpr int STRIDE = Row<D>::STRIDE;
  const float* a0 = A + g * STRIDE;
  const float* a1 = a0 + 8 * STRIDE;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const float* b0 = B + (n * 8 + 2 * t) * STRIDE;
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

// o[16 x D] += P[16 x KN] . B[KN x D], with P this warp's accumulators and B
// KN rows of a D-wide smem tile; P is staged in the warp's `pw` scratch
// (16 x KN floats).
template <int D, int KN>
__device__ __forceinline__ void warp_pb(float o[D / 8][4], float p[KN / 8][4], const float* B,
                                        float* pw, int g, int t) {
  constexpr int STRIDE = Row<D>::STRIDE;
#pragma unroll
  for (int n = 0; n < KN / 8; ++n) {
    const int c = n * 8 + 2 * t;
    pw[g * KN + c] = p[n][0];
    pw[g * KN + c + 1] = p[n][1];
    pw[(g + 8) * KN + c] = p[n][2];
    pw[(g + 8) * KN + c + 1] = p[n][3];
  }
  __syncwarp();
  for (int kk = 0; kk < KN; ++kk) {
    const float p0 = pw[g * KN + kk];
    const float p1 = pw[(g + 8) * KN + kk];
    const float* br = B + kk * STRIDE + 2 * t;
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

template <int N>
__device__ __forceinline__ void zero(float a[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n) a[n][0] = a[n][1] = a[n][2] = a[n][3] = 0.f;
}

// Write this warp's 16 accumulator rows (row0 + g, row0 + g + 8) of a
// [rows, D] output; rows past `rows` are dropped.
template <int D>
__device__ __forceinline__ void store_rows(float* out, float acc[D / 8][4], int row0, int rows,
                                           int g, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= rows) continue;
    float* orow = out + (size_t)row * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(orow + n * 8) = make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
  }
}

// ---- dq ----------------------------------------------------------------------

template <int D>
struct DqSmem {
  static constexpr int TILE = BLOCK_M * Row<D>::STRIDE;  // 64 rows
  // Q, dO, K, V tiles, then the warp-private ds rows
  static constexpr size_t BYTES = (4 * TILE + WARPS * 16 * BLOCK_KN) * sizeof(float);
};

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dq, int H, int Hkv, int Sq, int Sk, float scale_log2,
                    float scale, int causal) {
  using S = DqSmem<D>;
  constexpr int STRIDE = Row<D>::STRIDE;
  constexpr int NT_S = BLOCK_KN / 8;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* dOs = Qs + S::TILE;
  float* Ks = dOs + S::TILE;
  float* Vs = Ks + S::TILE;
  float* Ps = Vs + S::TILE;

  const int q0 = blockIdx.x * BLOCK_M;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;

  const size_t qoff = ((size_t)b * H + h) * Sq;
  const float* kh = k + ((size_t)b * Hkv + hk) * Sk * D;
  const float* vh = v + ((size_t)b * Hkv + hk) * Sk * D;

  load_tile<D, BLOCK_M>(Qs, q + qoff * D, q0, Sq);
  load_tile<D, BLOCK_M>(dOs, dout + qoff * D, q0, Sq);

  const int qpos[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = qpos[r] < Sq;  // rows past Sq are computed, never stored
    lse_r[r] = in ? lse[qoff + qpos[r]] : 0.f;
    delta_r[r] = in ? delta[qoff + qpos[r]] : 0.f;
  }
  const float* Qw = Qs + warp * 16 * STRIDE;
  const float* dOw = dOs + warp * 16 * STRIDE;
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
    load_tile<D, BLOCK_KN>(Ks, kh, k0, Sk);
    load_tile<D, BLOCK_KN>(Vs, vh, k0, Sk);
    __syncthreads();

    float s[NT_S][4], dp[NT_S][4];
    zero<NT_S>(s);
    zero<NT_S>(dp);
    warp_abt<D, NT_S>(s, Qw, Ks, g, t);
    warp_abt<D, NT_S>(dp, dOw, Vs, g, t);

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
    warp_pb<D, BLOCK_KN>(acc, s, Ks, pw, g, t);  // dq += ds . K
  }
  store_rows<D>(dq + qoff * D, acc, q0 + warp * 16, Sq, g, t);
}

// ---- dk, dv ------------------------------------------------------------------

template <int D>
struct DkvSmem {
  static constexpr int KTILE = BLOCK_M * Row<D>::STRIDE;   // 64 key rows
  static constexpr int QTILE = BLOCK_QN * Row<D>::STRIDE;  // 32 q rows
  // K, V, Q, dO tiles, lse and delta of the q tile, then the warp-private
  // p^T / ds^T rows
  static constexpr size_t BYTES =
      (2 * KTILE + 2 * QTILE + 2 * BLOCK_QN + WARPS * 16 * BLOCK_QN) * sizeof(float);
};

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dk, float* __restrict__ dv, int H, int Hkv, int Sq,
                     int Sk, float scale_log2, float scale, int causal) {
  using S = DkvSmem<D>;
  constexpr int STRIDE = Row<D>::STRIDE;
  constexpr int NT_S = BLOCK_QN / 8;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);
  float* Vs = Ks + S::KTILE;
  float* Qs = Vs + S::KTILE;
  float* dOs = Qs + S::QTILE;
  float* lse_s = dOs + S::QTILE;
  float* delta_s = lse_s + BLOCK_QN;
  float* Ps = delta_s + BLOCK_QN;

  const int k0 = blockIdx.x * BLOCK_M;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int n_rep = H / Hkv;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;

  const size_t koff = ((size_t)b * Hkv + hk) * Sk;
  load_tile<D, BLOCK_M>(Ks, k + koff * D, k0, Sk);
  load_tile<D, BLOCK_M>(Vs, v + koff * D, k0, Sk);

  const int kpos[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  const float* Kw = Ks + warp * 16 * STRIDE;
  const float* Vw = Vs + warp * 16 * STRIDE;
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
      load_tile<D, BLOCK_QN>(Qs, q + qoff * D, q0, Sq);
      load_tile<D, BLOCK_QN>(dOs, dout + qoff * D, q0, Sq);
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
      warp_abt<D, NT_S>(sT, Kw, Qs, g, t);
      warp_abt<D, NT_S>(dsT, Vw, dOs, g, t);
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
      warp_pb<D, BLOCK_QN>(dv_acc, sT, dOs, pw, g, t);   // dv += p^T . dO
      warp_pb<D, BLOCK_QN>(dk_acc, dsT, Qs, pw, g, t);   // dk += ds^T . Q
    }
  }
  store_rows<D>(dk + koff * D, dk_acc, k0 + warp * 16, Sk, g, t);
  store_rows<D>(dv + koff * D, dv_acc, k0 + warp * 16, Sk, g, t);
}

// ---------------------------------------------------------------------------
// bf16: TMA + wgmma, warp-specialised
// ---------------------------------------------------------------------------

constexpr int STAGES = 2;

// ---- dq ----------------------------------------------------------------------

// 64 q rows and 64 keys a ring stage (hopper::QTileCfg), a lone producer warp
template <int D>
struct DqCfg : hopper::QTileCfg<D, 1, 64> {
  using Base = hopper::QTileCfg<D, 1, 64>;
  // shared memory: Q | dO | K[STAGES] | V[STAGES] | mbarriers
  static constexpr int OFF_DO = Base::Q_BYTES;
  static constexpr int OFF_K = 2 * Base::Q_BYTES;
  static constexpr int OFF_V = OFF_K + STAGES * Base::KV_BYTES;
  static constexpr int OFF_BAR = OFF_V + STAGES * Base::KV_BYTES;
  static constexpr int SMEM = OFF_BAR + 64 + 1024;  // + 1 KB to align the base to 1024 bytes
};

template <int D>
__global__ void __launch_bounds__(DqCfg<D>::THREADS, DqCfg<D>::MIN_BLOCKS)
flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                   const __grid_constant__ CUtensorMap tm_dq, const float* __restrict__ lse,
                   const float* __restrict__ delta, int BH, int H, int Hkv, int Sq, int Sk,
                   float scale_log2, float scale, int causal) {
  using C = DqCfg<D>;
  constexpr int BN = C::BN;
  using namespace hopper;

  extern __shared__ unsigned char smem_raw[];
  const SmemBase sm = align_smem_1024(smem_raw);
  const uint32_t base = sm.addr;
  const uint32_t sQ = base, sDO = base + C::OFF_DO, sK = base + C::OFF_K, sV = base + C::OFF_V;
  const uint32_t q_full = base + C::OFF_BAR;
  auto full = [&](int s) { return q_full + 8 * (1 + s); };
  auto empty = [&](int s) { return q_full + 8 * (1 + STAGES + s); };
  const QTileWalk w = q_tile_walk<C::BM, BN>(BH, H, Hkv, Sq, Sk, causal);
  const int bh = w.bh, bhk = w.bhk, q0 = w.q0, n_kt = w.n_kt;
  init_ring_barriers<1, STAGES>(q_full, 4);  // released by lane 0 of every consumer warp

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp == 4) {
    // ---- producer warp: lane 0 issues the TMA copies ------------------------------
    if (lane == 0) {
      mbar_arrive_expect_tx(q_full, 2 * C::Q_BYTES);
      for (int c = 0; c < D / 64; ++c) {
        tma_load_3d(sQ + c * C::Q_SUB, &tm_q, q_full, 64 * c, q0, bh);
        tma_load_3d(sDO + c * C::Q_SUB, &tm_do, q_full, 64 * c, q0, bh);
      }
      for (int kt = 0, s = 0, phase = 0; kt < n_kt; ++kt) {
        mbar_wait(empty(s), phase ^ 1);
        mbar_arrive_expect_tx(full(s), 2 * C::KV_BYTES);
        for (int c = 0; c < D / 64; ++c) {
          tma_load_3d(sK + s * C::KV_BYTES + c * C::KV_SUB, &tm_k, full(s), 64 * c, kt * BN, bhk);
          tma_load_3d(sV + s * C::KV_BYTES + c * C::KV_SUB, &tm_v, full(s), 64 * c, kt * BN, bhk);
        }
        if (++s == STAGES) s = 0, phase ^= 1;
      }
    }
  } else {
    // ---- consumer warpgroup: the CTA's 64 q rows, 16 a warp ------------------------
    const int g = lane / 4;
    const int t = lane % 4;
    const int qpos[2] = {q0 + 16 * warp + g, q0 + 16 * warp + g + 8};
    float lse_r[2], delta_r[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool in = qpos[r] < Sq;  // rows past Sq are computed, never stored
      lse_r[r] = in ? lse[(size_t)bh * Sq + qpos[r]] : 0.f;
      delta_r[r] = in ? delta[(size_t)bh * Sq + qpos[r]] : 0.f;
    }
    const uint64_t da_q = desc_kmajor(sQ), da_do = desc_kmajor(sDO);  // K-major A operands

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    mbar_wait(q_full, 0);
    for (int kt = 0; kt < n_kt; ++kt) {
      const int s = kt % STAGES;
      const int k0 = kt * BN;
      const uint32_t sKs = sK + s * C::KV_BYTES, sVs = sV + s * C::KV_BYTES;
      mbar_wait(full(s), (kt / STAGES) & 1);

      // ---- s = Q K^T and dp = dO V^T, all operands K-major, one wait ----------------
      float sc[BN / 2], dp[BN / 2];
      uint32_t pa[BN / 16][4];
      const uint64_t db_k = desc_kmajor(sKs), db_v = desc_kmajor(sVs);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t col = (kk % 4) * 32;  // 16 columns along the swizzled row
        const uint32_t a_off = (kk / 4) * C::Q_SUB + col, b_off = (kk / 4) * C::KV_SUB + col;
        wgmma_ss<BN, 0>(sc, desc_add(da_q, a_off), desc_add(db_k, b_off), kk);
        wgmma_ss<BN, 0>(dp, desc_add(da_do, a_off), desc_add(db_v, b_off), kk);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);

      // ---- p = exp2(s2 - lse) under the forward's mask, ds = p (dp - delta) scale --
      const bool masked = k0 + BN > Sk || (causal && k0 + BN - 1 > q0);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int r = (i >> 1) & 1;
        float x = sc[i] * scale_log2;
        if (masked) {
          const int key = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
          if (key >= Sk || (causal && key > qpos[r])) x = NEG_INF;
        }
        sc[i] = exp2f(x - lse_r[r]) * (dp[i] - delta_r[r]) * scale;
      }
      acc_to_a<BN>(sc, pa);  // ds cast to bf16, as the JAX kernel casts it

      // ---- dq += ds K: A from registers, K MN-major (transposed) ----------------------
      const uint64_t db_kt = desc_mnmajor(sKs, C::KV_SUB);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < BN / 16; ++j) wgmma_rs<D, 1>(acc, pa[j], desc_add(db_kt, j * 16 * 128));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(pa);
      if (lane == 0) mbar_arrive(empty(s));  // this warp is done with the stage
    }

    // ---- epilogue: dq as bf16 through Q's tile (free once the last s product
    // has read it) and a TMA store -------------------------------------------------
    bar_sync(1, 128);
    store_acc_tma<D>(&tm_dq, sm.ptr, base, sQ, C::Q_SUB, acc, 1, q0, bh);
  }
}

// ---- dk, dv ------------------------------------------------------------------

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

  // aligned here, not by hopper::align_smem_1024: ptxas spills 4 bytes more
  // a thread at D = 64 with the helper
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
    store_acc_tma<D>(wg == 0 ? &tm_dv : &tm_dk, smem, base, wg == 0 ? sV : sK, C::K_SUB, acc,
                     2 + wg, k0, bhk);
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
// launches
// ---------------------------------------------------------------------------

template <int D>
cudaError_t launch_dq_f32(const void* q, const void* k, const void* v, const void* dout,
                          const void* lse, const void* delta, void* dq, int B, int H, int Hkv,
                          int Sq, int Sk, float scale_log2, float scale, int causal,
                          cudaStream_t stream) {
  static std::atomic<unsigned long long> smem_set{0};
  auto kernel = flash_bwd_dq_kernel<D>;
  const size_t smem = DqSmem<D>::BYTES;
  cudaError_t err = hopper::smem_limit_once((const void*)kernel, (int)smem, smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BLOCK_M - 1) / BLOCK_M, H, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dq), H, Hkv, Sq, Sk, scale_log2,
      scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq_bf16(const void* q, const void* k, const void* v, const void* dout,
                           const void* lse, const void* delta, void* dq, int B, int H, int Hkv,
                           int Sq, int Sk, float scale_log2, float scale, int causal,
                           cudaStream_t stream) {
  using C = DqCfg<D>;
  static std::atomic<unsigned long long> smem_set{0};
  auto kernel = flash_bwd_dq_wgmma<D>;
  cudaError_t err = hopper::smem_limit_once((const void*)kernel, C::SMEM, smem_set);
  if (err != cudaSuccess) return err;
  CUtensorMap tm_q, tm_k, tm_v, tm_do, tm_dq;
  if ((err = hopper::make_tmap(&tm_q, q, B * H, Sq, D, C::BM)) != cudaSuccess ||
      (err = hopper::make_tmap(&tm_do, dout, B * H, Sq, D, C::BM)) != cudaSuccess ||
      (err = hopper::make_tmap(&tm_k, k, B * Hkv, Sk, D, C::BN)) != cudaSuccess ||
      (err = hopper::make_tmap(&tm_v, v, B * Hkv, Sk, D, C::BN)) != cudaSuccess ||
      (err = hopper::make_tmap(&tm_dq, dq, B * H, Sq, D, 64)) != cudaSuccess)
    return err;
  const int n_qt = (Sq + C::BM - 1) / C::BM;
  kernel<<<n_qt * B * H, C::THREADS, C::SMEM, stream>>>(
      tm_q, tm_k, tm_v, tm_do, tm_dq, static_cast<const float*>(lse),
      static_cast<const float*>(delta), B * H, H, Hkv, Sq, Sk, scale_log2, scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_f32(const void* q, const void* k, const void* v, const void* dout,
                           const void* lse, const void* delta, void* dk, void* dv, int B,
                           int H, int Hkv, int Sq, int Sk, float scale_log2, float scale,
                           int causal, cudaStream_t stream) {
  static std::atomic<unsigned long long> smem_set{0};
  auto kernel = flash_bwd_dkv_kernel<D>;
  const size_t smem = DkvSmem<D>::BYTES;
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
  if (dtype == 1 && D == 128) return (int)launch_dq_bf16<128>(DQ_ARGS);
  if (dtype == 1 && D == 64) return (int)launch_dq_bf16<64>(DQ_ARGS);
  if (dtype == 0 && D == 128) return (int)launch_dq_f32<128>(DQ_ARGS);
  if (dtype == 0 && D == 64) return (int)launch_dq_f32<64>(DQ_ARGS);
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
