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
// What bounds it on the H100: the four products, ~24 C^2 FLOPs per token
// against ~2 C bytes in and out per token in bf16: by operations. The TPU
// kernel keeps the block's weights in VMEM; 12 C^2 bf16 (6 MiB at C = 512)
// does not fit a CTA, so on the H100 the block is a chain of seven launches
// over window-order rows (swin_common.cuh), with every link on the tensor
// cores and every intermediate in bf16:
//   1. gather_rows<LN>: pad + roll + partition by index, LN1, zero pad rows
//   2. qkv product (TMA + wgmma), epilogue + b, q scaled     -> qkv
//   3. tensor-core window attention, one CTA per head of a group of windows
//                                                            -> o (reuses h1)
//   4. proj product, epilogue + bp and the residual          -> x1
//   5. ln_rows: LN2                                          -> h2 (reuses h1)
//   6. fc1 product, epilogue bias + GELU                     -> g
//   7. fc2 product, epilogue bias + residual, scattered back through
//      unpartition, un-roll and crop                         -> out
// What is left of the gap: h1, qkv, x1 and g (~20 C bytes per token) still
// cross device memory between the links. Nothing accumulates across thread
// blocks, so there are no atomics and the result is deterministic. float32
// (dtype 0) runs the same chain on the FMA units.
#include "swin_common.cuh"

using namespace swin;

template <typename T>
static int run(int B, int G0, int G1, int G2, int C, int F, int heads, int w0,
               int w1, int w2, int s0, int s1, int s2, float eps, float scale,
               const void* x, const float* ln1_s, const float* ln1_b,
               const void* qkv_w, const float* qkv_b, const void* proj_w,
               const float* proj_b, const float* ln2_s, const float* ln2_b,
               const void* fc1_w, const float* fc1_b, const void* fc2_w,
               const float* fc2_b, const float* rel_table, const float* keep,
               void* h_buf, void* qkv_buf, void* x1_buf, void* g_buf,
               void* out, cudaStream_t st) {
  Geom g = make_geom(B, G0, G1, G2, w0, w1, w2, s0, s1, s2);
  const int M = B * g.nW * g.N;
  cudaError_t err;
  T* h = (T*)h_buf;

  err = with_row_u(C, [&](auto u) {
    gather_rows<T, true, decltype(u)::value><<<(M + 7) / 8, 256, 0, st>>>(
        (const T*)x, ln1_s, ln1_b, eps, g, C, M, h);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return (int)err;

  Epi e = {};
  e.g = g;
  e.keep = keep;

  e.bias = qkv_b; e.scale = scale; e.n_scaled = C; e.out = qkv_buf;
  if ((err = launch_gemm<T, FORM_NT, EPI_QKV>(h, (const T*)qkv_w, M, 3 * C, C, 0, e, st)))
    return (int)err;

  if ((err = launch_attn<T>((const T*)qkv_buf, rel_table, g, C, heads, h, st)))
    return (int)err;

  e.bias = proj_b; e.x = x; e.out = x1_buf;
  if ((err = launch_gemm<T, FORM_NT, EPI_PROJ_RESID>(h, (const T*)proj_w, M, C, C, 0, e, st)))
    return (int)err;

  err = with_row_u(C, [&](auto u) {
    ln_rows<T, decltype(u)::value><<<(M + 7) / 8, 256, 0, st>>>((const T*)x1_buf, ln2_s,
                                                               ln2_b, eps, C, M, h);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return (int)err;

  e.bias = fc1_b; e.out = g_buf;
  if ((err = launch_gemm<T, FORM_NT, EPI_FC1_GELU>(h, (const T*)fc1_w, M, F, C, 0, e, st)))
    return (int)err;

  e.bias = fc2_b; e.x1 = x1_buf; e.out = out;
  if ((err = launch_gemm<T, FORM_NT, EPI_FC2_RESID_OUT>((const T*)g_buf, (const T*)fc2_w,
                                               M, C, F, 0, e, st)))
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
    const float* rel_table, const float* keep, void* h_buf, void* qkv_buf,
    void* x1_buf, void* g_buf, void* out, void* stream) {
  if (C % 8 || F % 8 || C % heads) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return run<bf16>(B, G0, G1, G2, C, F, heads, w0, w1, w2, s0, s1, s2, eps,
                     scale, x, ln1_s, ln1_b, qkv_w, qkv_b, proj_w, proj_b,
                     ln2_s, ln2_b, fc1_w, fc1_b, fc2_w, fc2_b, rel_table, keep,
                     h_buf, qkv_buf, x1_buf, g_buf, out, st);
  if (dtype == 0)
    return run<float>(B, G0, G1, G2, C, F, heads, w0, w1, w2, s0, s1, s2, eps,
                      scale, x, ln1_s, ln1_b, qkv_w, qkv_b, proj_w, proj_b,
                      ln2_s, ln2_b, fc1_w, fc1_b, fc2_w, fc2_b, rel_table, keep,
                      h_buf, qkv_buf, x1_buf, g_buf, out, st);
  return (int)cudaErrorInvalidValue;
}
