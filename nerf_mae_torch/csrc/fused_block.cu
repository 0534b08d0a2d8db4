// Whole Swin block forward for Hopper (sm_90a).
//
// Replaces the TPU kernel nerf_mae_tpu/ops/pallas_block.py:_fused_block_kernel
// (forward of fused_swin_block). One block is
//   LN1 -> window MSA (qkv, rel-pos bias, shift mask, softmax, p@v, proj)
//   -> droppath residual -> LN2 -> fc1 -> tanh-GELU -> fc2 -> droppath residual
// with the JAX kernel's rounding points kept where they are observable:
// q scaled in f32 then rounded, y = T(o@Wp + bp), x1 = T(x + T(y * ka)),
// f1 = T(T(h2@W1) + T(b1)), GELU in f32 from f1, f2 = T(T(g@W2) + T(b2)),
// out = T(x1 + T(f2 * km)).
//
// Design: a chain of six launches over window-order rows (see swin_common.cuh):
//   1. gather_rows<LN>: pad + roll + partition by index, LN1, zero pad rows
//   2. gemm EPI_QKV:    h1 @ Wqkv^T + b, q scaled        -> qkv
//   3. window_attn:     one block per (window, head)      -> o (reuses h1)
//   4. gemm EPI_PROJ_RESID: o @ Wp^T + bp, residual       -> x1
//   5. ln_rows:         LN2                               -> h2 (reuses h1)
//   6. gemm EPI_FC1_GELU:   h2 @ W1^T, bias, GELU         -> g
//   7. gemm EPI_FC2_RESID_OUT: g @ W2^T, bias, residual, scatter back through
//      unpartition, un-roll and crop                      -> out
// What bounds it on the H100: the four products are ~24*C^2 FLOPs per token
// (tensor cores, bf16) against ~C*2 bytes in and out per token, so the
// arithmetic intensity is ~6*C FLOP/byte (768 at C=128): bound by operations
// at the flagship stages. This first version stages every intermediate
// through device memory (h1, qkv, x1, g: ~20*C bytes per token in bf16) and
// uses plain WMMA tiles without a copy pipeline, so it runs well below that
// bound; a fused persistent version is later work. Nothing accumulates
// across thread blocks, so there are no atomics and the result is
// deterministic.
#include "swin_common.cuh"

using namespace swin;

template <typename T>
static int run(int B, int G0, int G1, int G2, int C, int F, int heads, int w0,
               int w1, int w2, int s0, int s1, int s2, float eps, float scale,
               const void* x, const float* ln1_s, const float* ln1_b,
               const void* qkv_w, const float* qkv_b, const void* proj_w,
               const float* proj_b, const float* ln2_s, const float* ln2_b,
               const void* fc1_w, const float* fc1_b, const void* fc2_w,
               const float* fc2_b, const float* rel_bias, const float* keep,
               void* h_buf, void* qkv_buf, void* x1_buf, void* g_buf,
               void* out, cudaStream_t st) {
  Geom g = make_geom(B, G0, G1, G2, w0, w1, w2, s0, s1, s2);
  const int M = B * g.nW * g.N;
  cudaError_t err;
  T* h = (T*)h_buf;

  gather_rows<T, true><<<(M + 7) / 8, 256, 0, st>>>(
      (const T*)x, ln1_s, ln1_b, eps, g, C, M, h);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  Epi e = {};
  e.g = g;
  e.keep = keep;

  e.bias = qkv_b; e.scale = scale; e.n_scaled = C; e.out = qkv_buf;
  if ((err = launch_gemm<T, EPI_QKV>(h, (const T*)qkv_w, M, 3 * C, C, e, st)))
    return (int)err;

  if ((err = launch_attn<T>((const T*)qkv_buf, rel_bias, g, C, heads, h, st)))
    return (int)err;

  e.bias = proj_b; e.x = x; e.out = x1_buf;
  if ((err = launch_gemm<T, EPI_PROJ_RESID>(h, (const T*)proj_w, M, C, C, e, st)))
    return (int)err;

  ln_rows<T><<<(M + 7) / 8, 256, 0, st>>>((const T*)x1_buf, ln2_s, ln2_b, eps,
                                           C, M, h);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  e.bias = fc1_b; e.out = g_buf;
  if ((err = launch_gemm<T, EPI_FC1_GELU>(h, (const T*)fc1_w, M, F, C, e, st)))
    return (int)err;

  e.bias = fc2_b; e.x1 = x1_buf; e.out = out;
  if ((err = launch_gemm<T, EPI_FC2_RESID_OUT>((const T*)g_buf, (const T*)fc2_w,
                                               M, C, F, e, st)))
    return (int)err;
  return 0;
}

// dtype: 0 = float32, 1 = bfloat16. (s0, s1, s2) is the effective shift.
// Returns a cudaError_t code (0 on success).
extern "C" int fused_swin_block_fwd(
    int dtype, int B, int G0, int G1, int G2, int C, int F, int heads, int w0,
    int w1, int w2, int s0, int s1, int s2, float eps, float scale,
    const void* x, const float* ln1_s, const float* ln1_b, const void* qkv_w,
    const float* qkv_b, const void* proj_w, const float* proj_b,
    const float* ln2_s, const float* ln2_b, const void* fc1_w,
    const float* fc1_b, const void* fc2_w, const float* fc2_b,
    const float* rel_bias, const float* keep, void* h_buf, void* qkv_buf,
    void* x1_buf, void* g_buf, void* out, void* stream) {
  if (C % 8 || F % 8 || C % heads) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return run<bf16>(B, G0, G1, G2, C, F, heads, w0, w1, w2, s0, s1, s2, eps,
                     scale, x, ln1_s, ln1_b, qkv_w, qkv_b, proj_w, proj_b,
                     ln2_s, ln2_b, fc1_w, fc1_b, fc2_w, fc2_b, rel_bias, keep,
                     h_buf, qkv_buf, x1_buf, g_buf, out, st);
  if (dtype == 0)
    return run<float>(B, G0, G1, G2, C, F, heads, w0, w1, w2, s0, s1, s2, eps,
                      scale, x, ln1_s, ln1_b, qkv_w, qkv_b, proj_w, proj_b,
                      ln2_s, ln2_b, fc1_w, fc1_b, fc2_w, fc2_b, rel_bias, keep,
                      h_buf, qkv_buf, x1_buf, g_buf, out, st);
  return (int)cudaErrorInvalidValue;
}
