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
// against ~2 C bytes in and out per token in bf16: by operations. Keeping
// the rows adds their ~30 C bytes written per token (0.75 C FLOPs a byte):
// by bytes then up to C = 256, by operations at C = 512. The TPU
// kernel keeps the block's weights in VMEM; 12 C^2 bf16 (6 MiB at C = 512)
// does not fit a CTA, so on the H100 the block is a chain of seven launches
// over window-order rows (swin_common.cuh), with every link on the tensor
// cores and every intermediate in bf16:
//   1. gather_rows<LN>: pad + roll + partition by index, LN1, zero pad rows
//                                                            -> h1
//   2. qkv product (TMA + wgmma), epilogue + b, q scaled     -> qkv
//   3. tensor-core window attention, one CTA per head of a group of windows
//                                                            -> o
//   4. proj product, epilogue + bp and the residual          -> x1
//   5. ln_rows: LN2                                          -> h2
//   6. fc1 product, epilogue bias + GELU                     -> g (and f1)
//   7. fc2 product, epilogue bias + residual, scattered back through
//      unpartition, un-roll and crop                         -> out
// Each link writes its rows where the caller points it. Under autograd the
// caller keeps them for the backward (fused_block_bwd.cu), which reads them
// instead of running links 1-6 again: seven distinct buffers, with f1 kept
// beside g by link 6 (EPI_FC1_BOTH), 7 C + 2 F values per row (30 C bytes
// in bf16 at F = 4 C, pad rows included). Otherwise o and h2 reuse h1's
// buffer, g reuses qkv's, and f1 is not written.
// What is left of the gap: the intermediates (~20 C bytes per token, 28 C
// when kept) still cross device memory between the links. Nothing
// accumulates across thread blocks, so there are no atomics and the result
// is deterministic. float32 (dtype 0) runs the same chain on the FMA units.
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
               void* h1, void* qkv, void* o, void* x1, void* h2, void* f1, void* g_out,
               void* out, cudaStream_t st) {
  Geom g = make_geom(B, G0, G1, G2, w0, w1, w2, s0, s1, s2);
  const int M = B * g.nW * g.N;
  cudaError_t err;

  err = with_row_u(C, [&](auto u) {
    gather_rows<T, true, decltype(u)::value><<<(M + 7) / 8, 256, 0, st>>>(
        (const T*)x, ln1_s, ln1_b, eps, g, C, M, (T*)h1);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return (int)err;

  Epi e = {};
  e.g = g;
  e.keep = keep;

  e.bias = qkv_b; e.scale = scale; e.n_scaled = C; e.out = qkv;
  if ((err = launch_gemm<T, FORM_NT, EPI_QKV>((const T*)h1, (const T*)qkv_w, M, 3 * C, C, 0, e,
                                              st)))
    return (int)err;

  if ((err = launch_attn<T>((const T*)qkv, rel_table, g, C, heads, (T*)o, st)))
    return (int)err;

  e.bias = proj_b; e.x = x; e.out = x1;
  if ((err = launch_gemm<T, FORM_NT, EPI_PROJ_RESID>((const T*)o, (const T*)proj_w, M, C, C, 0,
                                                     e, st)))
    return (int)err;

  err = with_row_u(C, [&](auto u) {
    ln_rows<T, decltype(u)::value><<<(M + 7) / 8, 256, 0, st>>>((const T*)x1, ln2_s, ln2_b,
                                                               eps, C, M, (T*)h2);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return (int)err;

  e.bias = fc1_b; e.out = g_out; e.aux = f1;
  err = f1 ? launch_gemm<T, FORM_NT, EPI_FC1_BOTH>((const T*)h2, (const T*)fc1_w, M, F, C, 0, e,
                                                   st)
           : launch_gemm<T, FORM_NT, EPI_FC1_GELU>((const T*)h2, (const T*)fc1_w, M, F, C, 0, e,
                                                   st);
  if (err) return (int)err;

  e.bias = fc2_b; e.x1 = x1; e.out = out;
  if ((err = launch_gemm<T, FORM_NT, EPI_FC2_RESID_OUT>((const T*)g_out, (const T*)fc2_w,
                                               M, C, F, 0, e, st)))
    return (int)err;
  return 0;
}

// dtype: 0 = float32, 1 = bfloat16. (s0, s1, s2) is the effective shift.
// h1, qkv, o, x1, h2, f1, g: the links' rows [M, C | 3C | C | C | C | F | F];
// o and h2 may be h1, g may be qkv (sized for max(3C, F)) and f1 null when
// nothing is kept. Returns a cudaError_t code (0 on success).
extern "C" int fused_swin_block_fwd(
    int dtype, int B, int G0, int G1, int G2, int C, int F, int heads, int w0,
    int w1, int w2, int s0, int s1, int s2, float eps, float scale,
    const void* x, const float* ln1_s, const float* ln1_b, const void* qkv_w,
    const float* qkv_b, const void* proj_w, const float* proj_b,
    const float* ln2_s, const float* ln2_b, const void* fc1_w,
    const float* fc1_b, const void* fc2_w, const float* fc2_b,
    const float* rel_table, const float* keep, void* h1, void* qkv, void* o,
    void* x1, void* h2, void* f1, void* g, void* out, void* stream) {
  if (C % 8 || F % 8 || C % heads) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return run<bf16>(B, G0, G1, G2, C, F, heads, w0, w1, w2, s0, s1, s2, eps,
                     scale, x, ln1_s, ln1_b, qkv_w, qkv_b, proj_w, proj_b,
                     ln2_s, ln2_b, fc1_w, fc1_b, fc2_w, fc2_b, rel_table, keep,
                     h1, qkv, o, x1, h2, f1, g, out, st);
  if (dtype == 0)
    return run<float>(B, G0, G1, G2, C, F, heads, w0, w1, w2, s0, s1, s2, eps,
                      scale, x, ln1_s, ln1_b, qkv_w, qkv_b, proj_w, proj_b,
                      ln2_s, ln2_b, fc1_w, fc1_b, fc2_w, fc2_b, rel_table, keep,
                      h1, qkv, o, x1, h2, f1, g, out, st);
  return (int)cudaErrorInvalidValue;
}
