// Shifted-window multi-head self-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel
// nerf_mae_tpu/ops/pallas_attention.py:_fused_window_attn_kernel (forward of
// fused_window_attention, with the pad/roll glue of that function): the
// input is already layer-normed; LN and the MLP stay outside.
//   1. gather_rows:  pad + roll + partition by index, pad rows zero -> h
//   2. qkv product (TMA + wgmma): + b, q scaled in f32 then rounded -> qkv
//   3. tensor-core window attention                                -> o (reuses h)
//   4. proj product: + bp, scattered back through unpartition,
//      un-roll and crop                                            -> out
// What bounds it on the H100: ~8*C^2 + 4*N*C FLOPs per token against ~4*C
// bytes of input and output per token: by operations at C >= 128. It
// shares the building blocks of the fused block (swin_common.cuh); h, qkv
// and o cross device memory in bf16. Nothing accumulates across thread
// blocks (no atomics). float32 (dtype 0) runs on the FMA units.
#include "swin_common.cuh"

using namespace swin;

template <typename T>
static int run(int B, int G0, int G1, int G2, int C, int heads, int w0, int w1,
               int w2, int s0, int s1, int s2, float scale, const void* x,
               const void* qkv_w, const float* qkv_b, const void* proj_w,
               const float* proj_b, const float* rel_table, void* h_buf,
               void* qkv_buf, void* out, cudaStream_t st) {
  Geom g = make_geom(B, G0, G1, G2, w0, w1, w2, s0, s1, s2);
  const int M = B * g.nW * g.N;
  cudaError_t err;
  T* h = (T*)h_buf;

  gather_rows<T, false><<<(M + 7) / 8, 256, 0, st>>>(
      (const T*)x, nullptr, nullptr, 0.f, g, C, M, h);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  Epi e = {};
  e.g = g;
  e.bias = qkv_b; e.scale = scale; e.n_scaled = C; e.out = qkv_buf;
  if ((err = launch_gemm<T, FORM_NT, EPI_QKV>(h, (const T*)qkv_w, M, 3 * C, C, 0, e, st)))
    return (int)err;

  if ((err = launch_attn<T>((const T*)qkv_buf, rel_table, g, C, heads, h, st)))
    return (int)err;

  e.bias = proj_b; e.out = out;
  if ((err = launch_gemm<T, FORM_NT, EPI_PROJ_OUT>(h, (const T*)proj_w, M, C, C, 0, e, st)))
    return (int)err;
  return 0;
}

// dtype: 0 = float32, 1 = bfloat16. (s0, s1, s2) is the effective shift.
// Returns a cudaError_t code (0 on success).
extern "C" int fused_window_attention_fwd(
    int dtype, int B, int G0, int G1, int G2, int C, int heads, int w0, int w1,
    int w2, int s0, int s1, int s2, float scale, const void* x,
    const void* qkv_w, const float* qkv_b, const void* proj_w,
    const float* proj_b, const float* rel_table, void* h_buf, void* qkv_buf,
    void* out, void* stream) {
  if (C % 8 || C % heads) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return run<bf16>(B, G0, G1, G2, C, heads, w0, w1, w2, s0, s1, s2, scale, x,
                     qkv_w, qkv_b, proj_w, proj_b, rel_table, h_buf, qkv_buf,
                     out, st);
  if (dtype == 0)
    return run<float>(B, G0, G1, G2, C, heads, w0, w1, w2, s0, s1, s2, scale,
                      x, qkv_w, qkv_b, proj_w, proj_b, rel_table, h_buf,
                      qkv_buf, out, st);
  return (int)cudaErrorInvalidValue;
}
