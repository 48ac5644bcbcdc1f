// Flash attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: determined_tpu/ops/flash_attention.py `_flash_fwd_call`
// (kernels `_fwd_kernel` and `_fwd_kernel_single`, scores from `_scores`).
// Same function: causal or full attention in log2 space.  The qk product is
// scaled by scale*log2(e), masked to a finite -1e30 where q_pos < k_pos (no
// offset) and at key >= Sk, and run through exp2; m, l and the accumulator
// stay in f32, p is cast to the input dtype before P.V, and l is floored at
// 1e-30.  Outputs: `out` in the input dtype and a base-2 `lse` = m + log2(l)
// laid out [b, h, 1, Sq] in f32.  GQA reads kv head h / (H / Hkv) directly
// instead of materialising the repeated kv.
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s HBM), bf16
// causal, q/k/v/out read or written once and lse written once:
//   training [8, 16, 1024, 128]: 34.4 GFLOP -> 34.8 us; 134.7 MB -> 40.2 us
//   serving  [1, 16, 1024, 128]:  4.3 GFLOP ->  4.3 us;  16.8 MB ->  5.0 us
// so both shapes are bound by bytes, barely: the kernel has to run its
// products near the tensor cores' rate to come close.
//
// The bf16 kernel (flash_fwd_wgmma), one CTA per q tile of one (b, h):
// - Loads overlap compute: one producer thread issues TMA copies of the Q tile
//   once and of the K and V tiles into a two-stage ring; each copy completes
//   on an mbarrier, and the consumers hand a slot back through an "empty"
//   mbarrier, so the next tiles load while the current ones are multiplied.
//   Q/out are described as 3-D [B*H, Sq, D] and K/V as [B*Hkv, Sk, D]
//   tensor maps, so a ragged last tile is zero-filled (and its store
//   dropped) at the head's end instead of reading the next head.
// - No operand goes through registers on its way to the tensor cores: tiles
//   land 128-byte swizzled, S = Q.K^T is a wgmma with both operands in
//   shared memory (K-major), and O += P.V takes P from registers (the S
//   accumulator cast to bf16) and V from shared memory with the transpose
//   bit (V[keys, D] is MN-major for that product).
// - Every product is a wgmma: one or two consumer warpgroups of 64 q rows
//   each, and the two warpgroups' softmax and products interleave on the
//   SM.  With two, a producer warpgroup gives its registers to them
//   (setmaxnreg: 24 and 240 a thread).
// - Heaviest tiles first: under causal masking the last q tile walks the
//   most key tiles, so the grid starts the last q tiles of 16 heads, then
//   their next-to-last, and so on (hopper::group_order), and the short
//   tiles fill the tail.  Those 16 heads' K and V (8 MB at the training
//   shape) stay in L2 while their CTAs run; interleaving every head re-reads
//   K and V from device memory, and walking one head at a time pairs heavy
//   tiles on an SM when all CTAs fit at once (the serving shape).
// Tile size: 128 q rows (two warpgroups) and 128-key stages, or 64 rows
// (one warpgroup, 64-key stages, two CTAs an SM) when the 128-row tiles
// would not give every SM one; `dtt_flash_fwd_rows` forces either.
// The online softmax runs in the accumulator layout with quad shuffles.  O
// is written as bf16 through shared memory with a TMA store.
//
// f32 inputs keep the FMA kernel (flash_fwd_f32): wgmma in tf32 would not
// hold the f32 tolerance.  One CTA of four warps owns a 64-row q tile, walks
// 64-key tiles loaded synchronously into padded shared memory, and each warp
// keeps its 16 rows' m, l and accumulator in registers.

#include "hopper.cuh"

namespace {

using hopper::NEG_INF;

// ---------------------------------------------------------------------------
// f32: FMA kernel
// ---------------------------------------------------------------------------

constexpr int F32_BLOCK = 64;  // q rows per CTA and keys per tile
constexpr int F32_THREADS = 128;

template <int D>
struct F32Smem {
  static constexpr int STRIDE = D + 4;  // 16 bytes of padding per row
  static constexpr int TILE = F32_BLOCK * STRIDE;
  // Q, K, V tiles, then the warp-private P rows
  static constexpr size_t BYTES = (3 * TILE + F32_BLOCK * F32_BLOCK) * sizeof(float);
};

// Copy rows [row0, row0 + 64) of a [rows, D] matrix into a padded smem tile;
// rows at or past `rows` are zero-filled so that masked keys multiply zeros.
template <int D>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src, int row0, int rows) {
  constexpr int PER_ROW = D / 4;
  for (int i = threadIdx.x; i < F32_BLOCK * PER_ROW; i += F32_THREADS) {
    const int r = i / PER_ROW;
    const int c = (i % PER_ROW) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < rows) val = *reinterpret_cast<const float4*>(src + (size_t)(row0 + r) * D + c);
    *reinterpret_cast<float4*>(dst + r * F32Smem<D>::STRIDE + c) = val;
  }
}

// Thread layout (the mma m16n8 accumulator layout): in warp w, lane 4g + t
// holds, for every 8-column tile n, (row 16w + g, cols 8n + 2t, 8n + 2t + 1)
// in slots 0, 1 and (row 16w + g + 8, same cols) in slots 2, 3.
template <int D>
__global__ void __launch_bounds__(F32_THREADS)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ out, float* __restrict__ lse,
              int H, int Hkv, int Sq, int Sk, float scale_log2, int causal) {
  using S = F32Smem<D>;
  constexpr int STRIDE = S::STRIDE;
  constexpr int NT_S = F32_BLOCK / 8;  // 8-key column tiles of the scores
  constexpr int NT_O = D / 8;          // 8-wide column tiles of the output

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Ks = Qs + S::TILE;
  float* Vs = Ks + S::TILE;
  float* Ps = Vs + S::TILE;

  const int q0 = blockIdx.x * F32_BLOCK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;

  const float* kh = k + ((size_t)b * Hkv + hk) * Sk * D;
  const float* vh = v + ((size_t)b * Hkv + hk) * Sk * D;

  load_tile_f32<D>(Qs, q + ((size_t)b * H + h) * Sq * D, q0, Sq);

  float o[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF};
  float l_run[2] = {0.f, 0.f};  // this thread's share of the row sum
  const int qpos[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  int n_kt = (Sk + F32_BLOCK - 1) / F32_BLOCK;
  if (causal) {
    // key tiles touching or below the diagonal of this q tile's last real row
    const int last_q = min(q0 + F32_BLOCK, Sq) - 1;
    n_kt = min(n_kt, last_q / F32_BLOCK + 1);
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * F32_BLOCK;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile_f32<D>(Ks, kh, k0, Sk);
    load_tile_f32<D>(Vs, vh, k0, Sk);
    __syncthreads();

    // ---- scores s = q k^T ---------------------------------------------------
    float s[NT_S][4];
    const float* qr0 = Qs + (warp * 16 + g) * STRIDE;
    const float* qr1 = qr0 + 8 * STRIDE;
#pragma unroll
    for (int n = 0; n < NT_S; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const float* kr0 = Ks + (n * 8 + 2 * t) * STRIDE;
      const float* kr1 = kr0 + STRIDE;
      for (int d = 0; d < D; ++d) {
        const float a0 = qr0[d], a1 = qr1[d], c0 = kr0[d], c1 = kr1[d];
        s[n][0] = fmaf(a0, c0, s[n][0]);
        s[n][1] = fmaf(a0, c1, s[n][1]);
        s[n][2] = fmaf(a1, c0, s[n][2]);
        s[n][3] = fmaf(a1, c1, s[n][3]);
      }
    }

    // ---- log2-space scale, causal and ragged-edge mask, online softmax ------
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < NT_S; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + n * 8 + 2 * t + (e & 1);
        const int r = e >> 1;
        float x = s[n][e] * scale_log2;
        if (key >= Sk || (causal && key > qpos[r])) x = NEG_INF;
        s[n][e] = x;
        mx[r] = fmaxf(mx[r], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      alpha[r] = exp2f(m_run[r] - m_new);
      m_run[r] = m_new;
    }
    float rowsum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < NT_S; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[n][e] - m_run[e >> 1]);
        s[n][e] = p;
        rowsum[e >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = alpha[r] * l_run[r] + rowsum[r];
#pragma unroll
    for (int n = 0; n < NT_O; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // ---- o += p v: stage this warp's 16 rows of p in shared memory ------------
    float* pw = Ps + warp * 16 * F32_BLOCK;
#pragma unroll
    for (int n = 0; n < NT_S; ++n) {
      const int c = n * 8 + 2 * t;
      pw[g * F32_BLOCK + c] = s[n][0];
      pw[g * F32_BLOCK + c + 1] = s[n][1];
      pw[(g + 8) * F32_BLOCK + c] = s[n][2];
      pw[(g + 8) * F32_BLOCK + c + 1] = s[n][3];
    }
    __syncwarp();
    for (int kk = 0; kk < F32_BLOCK; ++kk) {
      const float p0 = pw[g * F32_BLOCK + kk];
      const float p1 = pw[(g + 8) * F32_BLOCK + kk];
      const float* vr = Vs + kk * STRIDE + 2 * t;
#pragma unroll
      for (int n = 0; n < NT_O; ++n) {
        const float v0 = vr[n * 8], v1 = vr[n * 8 + 1];
        o[n][0] = fmaf(p0, v0, o[n][0]);
        o[n][1] = fmaf(p0, v1, o[n][1]);
        o[n][2] = fmaf(p1, v0, o[n][2]);
        o[n][3] = fmaf(p1, v1, o[n][3]);
      }
    }
    __syncwarp();  // reads of pw done before the next tile rewrites it
  }

  // ---- epilogue: out = o / l, lse = m + log2(l) ------------------------------
  float* oh = out + ((size_t)b * H + h) * Sq * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l = fmaxf(l, 1e-30f);
    if (qpos[r] >= Sq) continue;
    if (t == 0) lse[((size_t)b * H + h) * Sq + qpos[r]] = m_run[r] + log2f(l);
    float* orow = oh + (size_t)qpos[r] * D + 2 * t;
#pragma unroll
    for (int n = 0; n < NT_O; ++n) {
      *reinterpret_cast<float2*>(orow + n * 8) =
          make_float2(o[n][2 * r] / l, o[n][2 * r + 1] / l);
    }
  }
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out, void* lse, int B,
                       int H, int Hkv, int Sq, int Sk, float scale_log2, int causal,
                       cudaStream_t stream) {
  static std::atomic<unsigned long long> smem_set{0};
  auto kernel = flash_fwd_f32<D>;
  const size_t smem = F32Smem<D>::BYTES;
  cudaError_t err = hopper::smem_limit_once((const void*)kernel, (int)smem, smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + F32_BLOCK - 1) / F32_BLOCK, H, B);
  kernel<<<grid, F32_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), static_cast<float*>(lse), H, Hkv, Sq, Sk, scale_log2, causal);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: TMA + wgmma, warp-specialised
// ---------------------------------------------------------------------------

constexpr int STAGES = 2;

// 64 * NWG q rows and keys of one ring stage (hopper::QTileCfg).  With
// 64-row tiles the consumers' o, s and p (112 registers) fit the registers
// the launch gives, and a producer warpgroup would halve the CTAs an SM holds.
template <int D, int NWG>
struct FwdCfg : hopper::QTileCfg<D, NWG, 64 * NWG> {
  using Base = hopper::QTileCfg<D, NWG, 64 * NWG>;
  // shared memory: Q | K[STAGES] | V[STAGES] | mbarriers
  static constexpr int OFF_K = Base::Q_BYTES;
  static constexpr int OFF_V = OFF_K + STAGES * Base::KV_BYTES;
  static constexpr int OFF_BAR = OFF_V + STAGES * Base::KV_BYTES;
  static constexpr int SMEM = OFF_BAR + 64 + 1024;  // + 1 KB to align the base to 1024 bytes
};

template <int D, int NWG>
__global__ void __launch_bounds__(FwdCfg<D, NWG>::THREADS, FwdCfg<D, NWG>::MIN_BLOCKS)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_o,
                float* __restrict__ lse, int BH, int H, int Hkv, int Sq, int Sk, float scale_log2,
                int causal) {
  using C = FwdCfg<D, NWG>;
  constexpr int BN = C::BN;
  using namespace hopper;

  extern __shared__ unsigned char smem_raw[];
  const SmemBase sm = align_smem_1024(smem_raw);
  const uint32_t base = sm.addr;
  const uint32_t sQ = base, sK = base + C::OFF_K, sV = base + C::OFF_V;
  const uint32_t q_full = base + C::OFF_BAR;
  auto k_full = [&](int s) { return q_full + 8 * (1 + s); };
  auto v_full = [&](int s) { return q_full + 8 * (1 + STAGES + s); };
  auto empty = [&](int s) { return q_full + 8 * (1 + 2 * STAGES + s); };
  const QTileWalk w = q_tile_walk<C::BM, BN>(BH, H, Hkv, Sq, Sk, causal);
  const int bh = w.bh, bhk = w.bhk, q0 = w.q0, n_kt = w.n_kt;
  init_ring_barriers<2, STAGES>(q_full, 4 * NWG);  // released by lane 0 of every consumer warp

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= 4 * NWG) {
    // ---- producer: lane 0 of its first warp issues the TMA copies ----------------
    if constexpr (C::REBALANCE) regs_dealloc<C::REG_PRODUCER>();
    if (warp == 4 * NWG && lane == 0) {
      mbar_arrive_expect_tx(q_full, C::Q_BYTES);
      for (int c = 0; c < D / 64; ++c) tma_load_3d(sQ + c * C::Q_SUB, &tm_q, q_full, 64 * c, q0, bh);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % STAGES;
        mbar_wait(empty(s), ((kt / STAGES) & 1) ^ 1);
        const uint32_t k_dst = sK + s * C::KV_BYTES, v_dst = sV + s * C::KV_BYTES;
        mbar_arrive_expect_tx(k_full(s), C::KV_BYTES);
        for (int c = 0; c < D / 64; ++c)
          tma_load_3d(k_dst + c * C::KV_SUB, &tm_k, k_full(s), 64 * c, kt * BN, bhk);
        mbar_arrive_expect_tx(v_full(s), C::KV_BYTES);
        for (int c = 0; c < D / 64; ++c)
          tma_load_3d(v_dst + c * C::KV_SUB, &tm_v, v_full(s), 64 * c, kt * BN, bhk);
      }
    }
  } else {
    // ---- consumer warpgroup wg: 64 q rows ---------------------------------------
    if constexpr (C::REBALANCE) regs_alloc<C::REG_CONSUMER>();
    const int wg = warp / 4;
    const int wl = warp % 4;  // warp in the warpgroup: rows 16 wl .. 16 wl + 15
    const int g = lane / 4;
    const int t = lane % 4;
    const int row0 = q0 + 64 * wg;
    const int qpos[2] = {row0 + 16 * wl + g, row0 + 16 * wl + g + 8};
    const uint32_t sQw = sQ + 64 * 128 * wg;  // this warpgroup's rows of each Q sub-tile

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m_run[2] = {NEG_INF, NEG_INF};
    float l_run[2] = {0.f, 0.f};  // this thread's share of the row sum

    mbar_wait(q_full, 0);
    for (int kt = 0; kt < n_kt; ++kt) {
      const int s = kt % STAGES;
      const uint32_t parity = (kt / STAGES) & 1;
      const int k0 = kt * BN;
      const uint32_t sKs = sK + s * C::KV_BYTES, sVs = sV + s * C::KV_BYTES;

      // ---- S = Q K^T, both operands K-major in shared memory ---------------------
      float sc[BN / 2];
      uint32_t pa[BN / 16][4];
      mbar_wait(k_full(s), parity);
      const uint64_t dq = desc_kmajor(sQw), dk = desc_kmajor(sKs);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;  // 16 columns along the swizzled row
        wgmma_ss<BN, 0>(sc, desc_add(dq, (kk / 4) * C::Q_SUB + off),
                        desc_add(dk, (kk / 4) * C::KV_SUB + off), kk);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      // ---- log2-space scale, mask, online softmax ---------------------------------
      const bool masked = k0 + BN > Sk || (causal && k0 + BN - 1 > row0);
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int r = (i >> 1) & 1;
        float x = sc[i] * scale_log2;
        if (masked) {
          const int key = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
          if (key >= Sk || (causal && key > qpos[r])) x = NEG_INF;
        }
        sc[i] = x;
        mx[r] = fmaxf(mx[r], x);
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_run[r], mx[r]);
        alpha[r] = exp2f(m_run[r] - m_new);
        m_run[r] = m_new;
      }
      float rowsum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int r = (i >> 1) & 1;
        const float p = exp2f(sc[i] - m_run[r]);
        sc[i] = p;
        rowsum[r] += p;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l_run[r] = alpha[r] * l_run[r] + rowsum[r];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      acc_to_a<BN>(sc, pa);  // p cast to bf16, as the TPU kernel casts it

      // ---- O += P V: P from registers, V MN-major (transposed) ------------------
      mbar_wait(v_full(s), parity);
      const uint64_t dv = desc_mnmajor(sVs, C::KV_SUB);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < BN / 16; ++j) wgmma_rs<D, 1>(o, pa[j], desc_add(dv, j * 16 * 128));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pa);
      if (lane == 0) mbar_arrive(empty(s));  // this warp is done with the stage
    }

    // ---- epilogue: out = o / l through shared memory and a TMA store; lse -------
    float l_tot[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_run[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      l = fmaxf(l, 1e-30f);
      l_tot[r] = l;
      if (t == 0 && qpos[r] < Sq) lse[(size_t)bh * Sq + qpos[r]] = m_run[r] + log2f(l);
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = o[i] / l_tot[(i >> 1) & 1];
    // the warpgroup's Q rows are free once its last product has read them
    bar_sync(1 + wg, 128);
    store_acc_tma<D>(&tm_o, sm.ptr, base, sQw, C::Q_SUB, o, 1 + wg, row0, bh);
  }
}

template <int D, int NWG>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* out, void* lse, int B,
                        int H, int Hkv, int Sq, int Sk, float scale_log2, int causal,
                        cudaStream_t stream) {
  using C = FwdCfg<D, NWG>;
  static std::atomic<unsigned long long> smem_set{0};
  static std::atomic<int> regs_checked{0};
  auto kernel = flash_fwd_wgmma<D, NWG>;
  cudaError_t err = hopper::smem_limit_once((const void*)kernel, C::SMEM, smem_set);
  if (err != cudaSuccess) return err;
  if (C::REBALANCE && !hopper::reg_pool_ok((const void*)kernel, C::PRODUCERS, C::REG_PRODUCER,
                                           128 * NWG, C::REG_CONSUMER, regs_checked))
    return cudaErrorInvalidConfiguration;
  CUtensorMap tm_q, tm_k, tm_v, tm_o;
  if ((err = hopper::make_tmap(&tm_q, q, B * H, Sq, D, C::BM)) != cudaSuccess ||
      (err = hopper::make_tmap(&tm_k, k, B * Hkv, Sk, D, C::BN)) != cudaSuccess ||
      (err = hopper::make_tmap(&tm_v, v, B * Hkv, Sk, D, C::BN)) != cudaSuccess ||
      (err = hopper::make_tmap(&tm_o, out, B * H, Sq, D, 64)) != cudaSuccess)
    return err;
  const int n_qt = (Sq + C::BM - 1) / C::BM;
  kernel<<<n_qt * B * H, C::THREADS, C::SMEM, stream>>>(
      tm_q, tm_k, tm_v, tm_o, static_cast<float*>(lse), B * H, H, Hkv, Sq, Sk, scale_log2, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16_rows(int block_m, const void* q, const void* k, const void* v, void* out,
                             void* lse, int B, int H, int Hkv, int Sq, int Sk, float scale_log2,
                             int causal, cudaStream_t stream) {
  if (block_m == 0) {
    // 128-row tiles unless they would leave SMs without a CTA
    const long tiles128 = (long)B * H * ((Sq + 127) / 128);
    block_m = tiles128 >= hopper::sm_count() ? 128 : 64;
  }
  if (block_m == 128)
    return launch_bf16<D, 2>(q, k, v, out, lse, B, H, Hkv, Sq, Sk, scale_log2, causal, stream);
  if (block_m == 64)
    return launch_bf16<D, 1>(q, k, v, out, lse, B, H, Hkv, Sq, Sk, scale_log2, causal, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Layouts: q/out [B, H, Sq, D],
// k/v [B, Hkv, Sk, D], lse [B, H, 1, Sq] f32, all contiguous and 16-byte
// aligned.  block_m: q rows of a bf16 CTA, 64 or 128, or 0 to let the launch
// pick (f32 takes 0 only).  Returns the launch's cudaError_t (0 on success);
// the wrapper checks everything else.
extern "C" int dtt_flash_fwd_rows(const void* q, const void* k, const void* v, void* out,
                                  void* lse, int dtype, int B, int H, int Hkv, int Sq, int Sk,
                                  int D, float scale_log2, int causal, int block_m, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || H < 1 || Hkv < 1 || H % Hkv || Sq < 1 || Sk < 1) return (int)cudaErrorInvalidValue;
#define FWD_ARGS q, k, v, out, lse, B, H, Hkv, Sq, Sk, scale_log2, causal, s
  if (dtype == 1 && D == 128) return (int)launch_bf16_rows<128>(block_m, FWD_ARGS);
  if (dtype == 1 && D == 64) return (int)launch_bf16_rows<64>(block_m, FWD_ARGS);
  if (block_m != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && D == 128) return (int)launch_f32<128>(FWD_ARGS);
  if (dtype == 0 && D == 64) return (int)launch_f32<64>(FWD_ARGS);
#undef FWD_ARGS
  return (int)cudaErrorInvalidValue;
}

extern "C" int dtt_flash_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                             int dtype, int B, int H, int Hkv, int Sq, int Sk, int D,
                             float scale_log2, int causal, void* stream) {
  return dtt_flash_fwd_rows(q, k, v, out, lse, dtype, B, H, Hkv, Sq, Sk, D, scale_log2, causal, 0,
                            stream);
}
