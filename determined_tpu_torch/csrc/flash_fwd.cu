// Flash attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: determined_tpu/ops/flash_attention.py `_flash_fwd_call`
// (kernels `_fwd_kernel` and `_fwd_kernel_single`, scores from `_scores`).
// Same function: causal or full attention in log2 space.  The qk product is
// scaled by scale*log2(e), masked to a finite -1e30 where q_pos < k_pos, and
// run through exp2; m, l and the accumulator stay in f32 and l is floored at
// 1e-30.  Outputs: `out` in the input dtype and a base-2 `lse` = m + log2(l)
// laid out [b, h, 1, Sq] in f32.  GQA reads kv head h / (H / Hkv) directly
// instead of materialising the repeated kv.
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s HBM).
// At the serving prefill shape [1, 16, 1024, 128] bf16, causal:
//   operations: 4 * 16 * 128 * (1024 * 1025 / 2) ~ 4.3 GFLOP -> ~4.3 us
//   bytes:      q, k, v and out, 4 * 16 * 1024 * 128 * 2 B ~ 16.8 MB -> ~5.0 us
// so the bound is ~5 us and the kernel is memory-bound at batch 1.
//
// What the design does about it: every input byte is read from device memory
// about once per CTA that needs it, and the [Sq, Sk] scores never leave
// registers.  One CTA of four warps owns a 64-row q tile of one (batch, head);
// each warp owns 16 of its rows.  The CTA walks 64-key tiles of K and V staged
// in shared memory and stops at the causal diagonal.  With bf16 inputs both
// products run on the tensor cores through mma.sync m16n8k16 (f32
// accumulate), and P is cast to bf16 before P.V, as the TPU kernel casts p to
// the input dtype.  With f32 inputs the products are plain f32 FMAs, so f32
// results stay within f32 rounding of the plain version.  The K/V tiles are
// loaded synchronously and the q tiles of one head re-read K and V from L2;
// TMA, wgmma and warp specialisation are left for a later change.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_Q = 64;
constexpr int BLOCK_K = 64;
constexpr int WARPS = 4;  // each warp owns 16 q rows of the tile
constexpr int THREADS = WARPS * 32;
constexpr float NEG_INF = -1e30f;

// shared-memory row stride in elements: 16 bytes of padding per row keeps the
// 32-bit fragment loads of a warp on distinct banks
template <typename T, int D>
struct Smem {
  static constexpr int STRIDE = D + 16 / (int)sizeof(T);
  static constexpr int TILE = BLOCK_Q * STRIDE;  // elements of one 64-row tile
  // Q, K, V tiles, then (f32 only) the warp-private P rows
  static constexpr int P_FLOATS = sizeof(T) == 4 ? BLOCK_Q * BLOCK_K : 0;
  static constexpr size_t BYTES = 3 * TILE * sizeof(T) + P_FLOATS * sizeof(float);
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&t);
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copy rows [row0, row0 + 64) of a [rows, D] matrix into a padded smem tile
// with 16-byte vectors; rows at or past `rows` are zero-filled so that masked
// keys multiply zeros, never stale memory.
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int row0, int rows) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PER_ROW = D / VEC;
  constexpr int STRIDE = Smem<T, D>::STRIDE;
  for (int i = threadIdx.x; i < BLOCK_Q * PER_ROW; i += THREADS) {
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
// accumulator layout): in warp w, lane = 4 * g + t holds, for every 8-column
// tile n, the elements (row 16w + g, cols 8n + 2t, 8n + 2t + 1) in slots 0, 1
// and (row 16w + g + 8, same cols) in slots 2, 3.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int H, int Hkv, int Sq, int Sk,
                 float scale_log2, int causal) {
  using S = Smem<T, D>;
  constexpr int STRIDE = S::STRIDE;
  constexpr bool BF16 = sizeof(T) == 2;
  constexpr int NT_S = BLOCK_K / 8;  // 8-key column tiles of the scores
  constexpr int NT_O = D / 8;        // 8-wide column tiles of the output

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + S::TILE;
  T* Vs = Ks + S::TILE;
  float* Ps = reinterpret_cast<float*>(Vs + S::TILE);  // f32 path only

  const int q0 = blockIdx.x * BLOCK_Q;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;

  const T* qh = q + ((size_t)b * H + h) * Sq * D;
  const T* kh = k + ((size_t)b * Hkv + hk) * Sk * D;
  const T* vh = v + ((size_t)b * Hkv + hk) * Sk * D;

  load_tile<T, D>(Qs, qh, q0, Sq);
  __syncthreads();

  // bf16: this warp's q rows as mma A fragments, kept in registers
  uint32_t qf[BF16 ? D / 16 : 1][4];
  if constexpr (BF16) {
    const T* qr0 = Qs + (warp * 16 + g) * STRIDE;
    const T* qr1 = qr0 + 8 * STRIDE;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk * 16 + 2 * t;
      qf[kk][0] = *reinterpret_cast<const uint32_t*>(qr0 + c);
      qf[kk][1] = *reinterpret_cast<const uint32_t*>(qr1 + c);
      qf[kk][2] = *reinterpret_cast<const uint32_t*>(qr0 + c + 8);
      qf[kk][3] = *reinterpret_cast<const uint32_t*>(qr1 + c + 8);
    }
  }

  float o[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF};
  float l_run[2] = {0.f, 0.f};  // this thread's share of the row sum
  const int qpos[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  int n_kt = (Sk + BLOCK_K - 1) / BLOCK_K;
  if (causal) {
    // key tiles touching or below the diagonal of this q tile's last real row
    const int last_q = min(q0 + BLOCK_Q, Sq) - 1;
    n_kt = min(n_kt, last_q / BLOCK_K + 1);
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BLOCK_K;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<T, D>(Ks, kh, k0, Sk);
    load_tile<T, D>(Vs, vh, k0, Sk);
    __syncthreads();

    // ---- scores s = q k^T in f32 ------------------------------------------
    float s[NT_S][4];
#pragma unroll
    for (int n = 0; n < NT_S; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    if constexpr (BF16) {
#pragma unroll
      for (int n = 0; n < NT_S; ++n) {
        const T* kr = Ks + (n * 8 + g) * STRIDE + 2 * t;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr + kk * 16);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kr + kk * 16 + 8);
          mma_bf16(s[n], qf[kk], b0, b1);
        }
      }
    } else {
      const float* qr0 = reinterpret_cast<const float*>(Qs) + (warp * 16 + g) * STRIDE;
      const float* qr1 = qr0 + 8 * STRIDE;
#pragma unroll
      for (int n = 0; n < NT_S; ++n) {
        const float* kr0 = reinterpret_cast<const float*>(Ks) + (n * 8 + 2 * t) * STRIDE;
        const float* kr1 = kr0 + STRIDE;
        for (int d = 0; d < D; ++d) {
          const float a0 = qr0[d], a1 = qr1[d], c0 = kr0[d], c1 = kr1[d];
          s[n][0] = fmaf(a0, c0, s[n][0]);
          s[n][1] = fmaf(a0, c1, s[n][1]);
          s[n][2] = fmaf(a1, c0, s[n][2]);
          s[n][3] = fmaf(a1, c1, s[n][3]);
        }
      }
    }

    // ---- log2-space scale, causal and ragged-edge mask, online softmax ----
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

    // ---- o += p v ----------------------------------------------------------
    if constexpr (BF16) {
      const uint16_t* Vh = reinterpret_cast<const uint16_t*>(Vs);
#pragma unroll
      for (int j = 0; j < BLOCK_K / 16; ++j) {
        // the score accumulators of column tiles 2j and 2j+1 are exactly the
        // A fragment of keys [16j, 16j + 16)
        uint32_t pa[4];
        pa[0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
        pa[1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
        pa[2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
        pa[3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
        const int kr = 16 * j + 2 * t;
#pragma unroll
        for (int n = 0; n < NT_O; ++n) {
          const int col = n * 8 + g;
          const uint32_t b0 = (uint32_t)Vh[kr * STRIDE + col] |
                              ((uint32_t)Vh[(kr + 1) * STRIDE + col] << 16);
          const uint32_t b1 = (uint32_t)Vh[(kr + 8) * STRIDE + col] |
                              ((uint32_t)Vh[(kr + 9) * STRIDE + col] << 16);
          mma_bf16(o[n], pa, b0, b1);
        }
      }
    } else {
      // f32: stage this warp's 16 rows of p in shared memory, then FMA
      float* pw = Ps + warp * 16 * BLOCK_K;
#pragma unroll
      for (int n = 0; n < NT_S; ++n) {
        const int c = n * 8 + 2 * t;
        pw[g * BLOCK_K + c] = s[n][0];
        pw[g * BLOCK_K + c + 1] = s[n][1];
        pw[(g + 8) * BLOCK_K + c] = s[n][2];
        pw[(g + 8) * BLOCK_K + c + 1] = s[n][3];
      }
      __syncwarp();
      const float* Vf = reinterpret_cast<const float*>(Vs);
      for (int kk = 0; kk < BLOCK_K; ++kk) {
        const float p0 = pw[g * BLOCK_K + kk];
        const float p1 = pw[(g + 8) * BLOCK_K + kk];
        const float* vr = Vf + kk * STRIDE + 2 * t;
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
  }

  // ---- epilogue: out = o / l, lse = m + log2(l) ------------------------------
  float l_tot[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l = fmaxf(l, 1e-30f);
    l_tot[r] = l;
    if (t == 0 && qpos[r] < Sq) {
      lse[((size_t)b * H + h) * Sq + qpos[r]] = m_run[r] + log2f(l);
    }
  }
  T* oh = out + ((size_t)b * H + h) * Sq * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qpos[r] >= Sq) continue;
    T* orow = oh + (size_t)qpos[r] * D + 2 * t;
#pragma unroll
    for (int n = 0; n < NT_O; ++n) {
      const float x0 = o[n][2 * r] / l_tot[r];
      const float x1 = o[n][2 * r + 1] / l_tot[r];
      if constexpr (BF16) {
        *reinterpret_cast<uint32_t*>(orow + n * 8) = pack_bf16(x0, x1);
      } else {
        *reinterpret_cast<float2*>(orow + n * 8) = make_float2(x0, x1);
      }
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* lse, int B, int H, int Hkv, int Sq, int Sk,
                   float scale_log2, int causal, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, D>;
  const size_t smem = Smem<T, D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BLOCK_Q - 1) / BLOCK_Q, H, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), H, Hkv, Sq, Sk, scale_log2, causal);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Layouts: q/out [B, H, Sq, D],
// k/v [B, Hkv, Sk, D], lse [B, H, 1, Sq] f32, all contiguous.  Returns the
// launch's cudaError_t (0 on success); the wrapper checks everything else.
extern "C" int dtt_flash_fwd(const void* q, const void* k, const void* v,
                             void* out, void* lse, int dtype, int B, int H,
                             int Hkv, int Sq, int Sk, int D, float scale_log2,
                             int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || H < 1 || Hkv < 1 || H % Hkv || Sq < 1 || Sk < 1)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1 && D == 128)
    return (int)launch<__nv_bfloat16, 128>(q, k, v, out, lse, B, H, Hkv, Sq, Sk, scale_log2, causal, s);
  if (dtype == 1 && D == 64)
    return (int)launch<__nv_bfloat16, 64>(q, k, v, out, lse, B, H, Hkv, Sq, Sk, scale_log2, causal, s);
  if (dtype == 0 && D == 128)
    return (int)launch<float, 128>(q, k, v, out, lse, B, H, Hkv, Sq, Sk, scale_log2, causal, s);
  if (dtype == 0 && D == 64)
    return (int)launch<float, 64>(q, k, v, out, lse, B, H, Hkv, Sq, Sk, scale_log2, causal, s);
  return (int)cudaErrorInvalidValue;
}
