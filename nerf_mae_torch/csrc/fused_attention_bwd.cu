// Shifted-window multi-head self-attention backward for Hopper (sm_90a).
//
// Replaces the TPU kernel
// nerf_mae_tpu/ops/pallas_attention.py:_fused_window_attn_bwd_kernel (with
// the pad/roll glue of its `_bwd` and the proj-bias sum that glue does
// outside the kernel). It recomputes qkv and the attention from x, then
// runs the VJP: dx, dWqkv, dbqkv, dWproj, dbproj and dlogit [heads, N, N]
// (the caller scatters dlogit into the [343, heads] bias table). Rounding
// points as in the JAX kernel: T(dy) feeds do and dWproj; T(do), T(p), T(dl)
// feed the attention products; dq is scaled after its product, dk uses the
// scaled T(q); T(dqkv) feeds dWqkv and dx; bias and logit sums are float32.
//
//   1. gather_rows:  x and dy into window order (pad rows zero) -> h, dyw
//   2. qkv product and tensor-core attention: recompute qkv and o
//   3. do = T(dyw Wp); dWp = dyw^T o; dbp = column sums of dyw
//   4. tensor-core attention backward: T(dqkv), dbqkv and dlogit partials
//   5. dWqkv = T(dqkv)^T h; dx = T(dqkv) Wqkv, scattered back through
//      unpartition, un-roll and crop
// What bounds it on the H100: ~24 C^2 + 12 N C FLOPs per token against ~6 C
// bytes of x, dy and dx: by operations. It shares the building blocks of
// the block backward (swin_common.cuh): every product on the TMA + wgmma
// core, the attention on mma.sync, every operand in T; weight, bias and
// logit sums are split partials plus a fixed-order sum (deterministic).
#include "swin_common.cuh"

using namespace swin;

// Dimensions: B, G0, G1, G2, C, heads, w0, w1, w2, s0, s1, s2 (effective shift).
struct Dims {
  int B, G0, G1, G2, C, heads, w0, w1, w2, s0, s1, s2;
};

template <typename T>
struct Work {
  T *h, *qkv, *o, *dyw, *dO, *dqkv;
  float *part, *tmp;
};

template <typename T>
static size_t carve(const Dims& d, char* base, Work<T>& w) {
  Geom g = make_geom(d.B, d.G0, d.G1, d.G2, d.w0, d.w1, d.w2, d.s0, d.s1, d.s2);
  const size_t M = (size_t)d.B * g.nW * g.N, C = d.C;
  Carve cv{base};
  w.h = cv.take<T>(M * C);
  w.qkv = cv.take<T>(M * 3 * C);
  w.o = cv.take<T>(M * C);
  w.dyw = cv.take<T>(M * C);
  w.dO = cv.take<T>(M * C);
  w.dqkv = cv.take<T>(M * 3 * C);
  long long part = (long long)wgrad_splits<T>(M, 3 * C, C) * 3 * C * C;
  long long wp = (long long)wgrad_splits<T>(M, C, C) * C * C;
  long long ab = attn_bwd_part_floats<T>(g, d.C, d.heads);
  part = part > wp ? part : wp;
  part = part > ab ? part : ab;
  w.part = cv.take<float>(part);
  w.tmp = cv.take<float>(128 * 3 * C);  // first pass of launch_colsum
  return cv.used;
}

#define CK(call)                                  \
  do {                                            \
    cudaError_t err_ = (call);                    \
    if (err_ != cudaSuccess) return (int)err_;    \
  } while (0)

// ptrs: inputs x, dy, Wqkv, bqkv, Wp, rel_table [(2w-1)^3, heads]; then outputs
// dx, dWqkv, dbqkv, dWp, dbp, dlogit [heads, N, N]. Weights and their
// gradients in torch Linear layout [out, in]; gradients are float32.
template <typename T>
static int run(const Dims& d, float scale, void* const* p, void* ws,
               cudaStream_t st) {
  Geom g = make_geom(d.B, d.G0, d.G1, d.G2, d.w0, d.w1, d.w2, d.s0, d.s1, d.s2);
  const int M = d.B * g.nW * g.N, C = d.C;
  const int rows_grid = (M + 7) / 8;
  Work<T> w;
  carve<T>(d, (char*)ws, w);
  const T* x = (const T*)p[0];
  const T* dy = (const T*)p[1];
  const T* Wqkv = (const T*)p[2];
  const float* bqkv = (const float*)p[3];
  const T* Wp = (const T*)p[4];
  const float* rel = (const float*)p[5];
  T* dx = (T*)p[6];
  float *dWqkv = (float*)p[7], *dbqkv = (float*)p[8];
  float *dWp = (float*)p[9], *dbp = (float*)p[10];
  float* dlogit = (float*)p[11];

  gather_rows<T, false><<<rows_grid, 256, 0, st>>>(x, nullptr, nullptr, 0.f, g, C, M, w.h);
  CK(cudaGetLastError());
  gather_rows<T, false><<<rows_grid, 256, 0, st>>>(dy, nullptr, nullptr, 0.f, g, C, M, w.dyw);
  CK(cudaGetLastError());
  Epi e = {};
  e.g = g;
  e.bias = bqkv; e.scale = scale; e.n_scaled = C; e.out = w.qkv;
  CK((launch_gemm<T, FORM_NT, EPI_QKV>(w.h, Wqkv, M, 3 * C, C, 0, e, st)));
  CK(launch_attn<T>(w.qkv, rel, g, C, d.heads, w.o, st));

  CK(launch_colsum<T>(w.dyw, M, C, w.tmp, dbp, st));
  Epi e2 = {};
  e2.g = g;
  e2.out = w.dO;
  CK((launch_gemm<T, FORM_NN, EPI_T>(w.dyw, Wp, M, C, C, 0, e2, st)));
  CK((weight_grad<T>(w.dyw, w.o, M, C, C, w.part, dWp, st)));
  CK(launch_attn_bwd<T>(w.qkv, w.dO, rel, g, C, d.heads, scale, w.dqkv, w.part, w.tmp,
                        dlogit, dbqkv, st));
  CK((weight_grad<T>(w.dqkv, w.h, M, 3 * C, C, w.part, dWqkv, st)));
  e2.out = dx;
  CK((launch_gemm<T, FORM_NN, EPI_SCATTER_T>(w.dqkv, Wqkv, M, C, 3 * C, 0, e2, st)));
  return 0;
}

static bool read_dims(const int* v, Dims& d) {
  d = Dims{v[0], v[1], v[2], v[3], v[4], v[5], v[6], v[7], v[8], v[9], v[10], v[11]};
  return d.C % 8 == 0 && d.C % d.heads == 0;
}

// Bytes of scratch that fused_window_attention_bwd needs (0: unsupported).
// dtype: 0 = float32, 1 = bfloat16; dims as in Dims.
extern "C" size_t fused_window_attention_bwd_workspace(int dtype, const int* dims) {
  Dims d;
  if (!read_dims(dims, d)) return 0;
  if (dtype == 1) {
    Work<bf16> w;
    return carve<bf16>(d, nullptr, w);
  }
  Work<float> w;
  return carve<float>(d, nullptr, w);
}

// Returns a cudaError_t code (0 on success).
extern "C" int fused_window_attention_bwd(int dtype, const int* dims, float scale,
                                          void* const* ptrs, void* workspace,
                                          void* stream) {
  Dims d;
  if (!read_dims(dims, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1) return run<bf16>(d, scale, ptrs, workspace, st);
  if (dtype == 0) return run<float>(d, scale, ptrs, workspace, st);
  return (int)cudaErrorInvalidValue;
}
