// Fused AdamW step for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: determined_tpu/ops/fused_adamw.py `_leaf_pallas` (kernel
// `_adamw_kernel`).  Same function, one read-modify-write sweep over a leaf:
//   g  = g * clip_scale
//   m  = m * b1 + g * (1 - b1)          (m read and stored in mu_dtype)
//   v  = v * b2 + g * g * (1 - b2)
//   p  = p - lr * ((m / bc1) / (sqrt(v / bc2) + eps) + wd * p_old)
// with the scalars [lr, clip_scale, 1 - b1^t, 1 - b2^t] read from a [4] f32
// device buffer: the clip scale depends on the global gradient norm, which
// lives on the device, so reading it on the host would add a sync to every
// step.  p, m and v are written in place.  Every operation is an IEEE
// round-to-nearest intrinsic (__fmul_rn, __fdiv_rn, __fsqrt_rn, ...) in the
// order above, so the compiler contracts nothing into an FMA and the result
// follows the plain version's rounding.
//
// What bounds it on an H100 SXM (3.35 TB/s HBM): bytes.  Per element it reads
// p, v, g (f32) and m, and writes p, m, v: 24 B with a bf16 first moment, 28 B
// with an f32 one, against ~15 operations.  A [2048, 8192] leaf with bf16 m
// moves 403 MB -> ~120 us.
//
// What the design does about it: one pass, each byte read and written once,
// each thread handling consecutive elements of a grid-stride loop so a warp's
// loads coalesce.  Vector loads and launching several leaves at once are left
// for a later change.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 16;  // 16 resident blocks on each of 132 SMs

__device__ __forceinline__ float load_m(float x) { return x; }
__device__ __forceinline__ float load_m(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_m(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void store_m(__nv_bfloat16* dst, float x) {
  *dst = __float2bfloat16_rn(x);
}

template <typename M>
__global__ void __launch_bounds__(THREADS)
adamw_kernel(float* __restrict__ p, M* __restrict__ m, float* __restrict__ v,
             const float* __restrict__ g, const float* __restrict__ scalars,
             long long n, float b1, float one_minus_b1, float b2,
             float one_minus_b2, float eps, float wd) {
  const float lr = scalars[0];
  const float cs = scalars[1];
  const float bc1 = scalars[2];
  const float bc2 = scalars[3];
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n; i += stride) {
    const float gi = __fmul_rn(g[i], cs);
    const float mi = __fadd_rn(__fmul_rn(load_m(m[i]), b1), __fmul_rn(gi, one_minus_b1));
    const float vi = __fadd_rn(__fmul_rn(v[i], b2),
                               __fmul_rn(__fmul_rn(gi, gi), one_minus_b2));
    const float mhat = __fdiv_rn(mi, bc1);
    const float vhat = __fdiv_rn(vi, bc2);
    const float pi = p[i];
    const float update = __fadd_rn(__fdiv_rn(mhat, __fadd_rn(__fsqrt_rn(vhat), eps)),
                                   __fmul_rn(wd, pi));
    p[i] = __fsub_rn(pi, __fmul_rn(lr, update));
    store_m(m + i, mi);
    v[i] = vi;
  }
}

template <typename M>
cudaError_t launch(void* p, void* m, void* v, const void* g, const void* scalars,
                   long long n, float b1, float omb1, float b2, float omb2,
                   float eps, float wd, cudaStream_t stream) {
  long long blocks = (n + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  adamw_kernel<M><<<(int)blocks, THREADS, 0, stream>>>(
      static_cast<float*>(p), static_cast<M*>(m), static_cast<float*>(v),
      static_cast<const float*>(g), static_cast<const float*>(scalars), n, b1, omb1,
      b2, omb2, eps, wd);
  return cudaGetLastError();
}

}  // namespace

// mu_dtype: 0 = float32, 1 = bfloat16.  p, v, g f32 and m contiguous with n
// elements each; scalars a [4] f32 device buffer.  one_minus_b1/b2 are
// computed by the caller in double and rounded once, as the JAX kernel's
// (1.0 - b1) is.  Returns the launch's cudaError_t (0 on success).
extern "C" int dtt_fused_adamw(void* p, void* m, void* v, const void* g,
                               const void* scalars, long long n, int mu_dtype,
                               float b1, float one_minus_b1, float b2,
                               float one_minus_b2, float eps, float wd, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1) return (int)cudaErrorInvalidValue;
  if (mu_dtype == 0)
    return (int)launch<float>(p, m, v, g, scalars, n, b1, one_minus_b1, b2,
                              one_minus_b2, eps, wd, s);
  if (mu_dtype == 1)
    return (int)launch<__nv_bfloat16>(p, m, v, g, scalars, n, b1, one_minus_b1, b2,
                                      one_minus_b2, eps, wd, s);
  return (int)cudaErrorInvalidValue;
}
