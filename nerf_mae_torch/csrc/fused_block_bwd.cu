// Whole Swin block backward for Hopper (sm_90a).
//
// Replaces the TPU kernel
// nerf_mae_tpu/ops/pallas_block.py:_fused_block_bwd_kernel (with the
// window-order staging of its `_bwd` glue). Like that kernel it saves
// nothing from the forward: it recomputes the block from x and the
// parameters, then runs the hand-derived VJP, returning dx and the float32
// gradients of the 12 parameters plus dlogit [heads, N, N] (the caller
// scatters dlogit into the [343, heads] bias table). The JAX kernel's
// rounding points are kept: T(df2) feeds both of its products; df1 =
// dg * gelu'(f1) in float32, rounded only as an operand; T(do), T(p) and
// T(dl) feed the attention products; dq is scaled after its product; dk uses
// the scaled T(q); T(dqkv) feeds dWqkv and dh1; bias, LayerNorm and logit
// sums are of float32 values; dx is rounded to T last.
//
// Design: a chain of launches over window-order rows (swin_common.cuh):
//   recompute  gather+LN1 -> h1; qkv GEMM; attention -> o; proj GEMM with the
//              residual -> x1; LN2 -> h2; fc1 GEMM keeping f1 and g
//   MLP        df2 = dout * keep_m; dg = T(df2) W2 with the GELU derivative
//              -> df1; dh2 = T(df1) W1; LN2 backward -> dx1, dy_attn
//   attention  do = T(dy_attn) Wp; per (window group, head) dq, dk, dv, dl;
//              dh1 = T(dqkv) Wqkv; LN1 backward, scattered back through
//              unpartition, un-roll and crop -> dx
//   weights    every dW = T(D)^T T(H) as split-row partials plus a fixed-order
//              sum; bias and LN sums as column partials plus a fixed-order
//              sum (no atomics: deterministic).
// What bounds it on the H100: the ~72 C^2 FLOPs per token (recompute and two
// products per forward product) against ~C*6 bytes of x, dy and dx: bound by
// operations. This first version stages every recomputed and gradient row
// through device memory (~60 C bytes per token), reads its GEMM operands with
// scalar loads and runs the attention on FMA units, so it runs far below
// that bound; fusing the recompute into the gradient GEMMs is later work.
#include "swin_common.cuh"

using namespace swin;

// df2[m] = dout[m] * keep_m (float32); dout is dy gathered into window
// order, zero at pad rows. One warp per row.
template <typename T>
__global__ void __launch_bounds__(256)
dout_rows(const T* __restrict__ dy, const float* __restrict__ keep, Geom g,
          int C, int M, float* __restrict__ df2) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= M) return;
  const long long src = row_source(g, row);
  const float km = keep[2 * (row / (g.nW * g.N)) + 1];
  float* dst = df2 + (size_t)row * C;
  for (int c = lane; c < C; c += 32)
    dst[c] = src < 0 ? 0.f : to_f(dy[(size_t)src * C + c]) * km;
}

// Mean, inverse deviation of one row: the forward's fast variance.
template <typename T>
__device__ __forceinline__ void ln_stats(const T* xr, int C, float eps, int lane,
                                         float& mu, float& inv) {
  float s = 0.f, s2 = 0.f;
  for (int c = lane; c < C; c += 32) {
    float v = to_f(xr[c]);
    s += v;
    s2 += v * v;
  }
  s = warp_sum(s);
  s2 = warp_sum(s2);
  mu = s / C;
  inv = rsqrtf(s2 / C - mu * mu + eps);
}

// The two row means of the LayerNorm input gradient:
// a = mean(dh * scale), b = mean(dh * scale * xhat).
template <typename T>
__device__ __forceinline__ void ln_bwd_means(const float* dh, const T* xr,
                                             const float* scale, int C, float mu,
                                             float inv, int lane, float& a,
                                             float& b) {
  a = 0.f;
  b = 0.f;
  for (int c = lane; c < C; c += 32) {
    float xh = (to_f(xr[c]) - mu) * inv;
    float dxh = dh[c] * scale[c];
    a += dxh;
    b += dxh * xh;
  }
  a = warp_sum(a) / C;
  b = warp_sum(b) / C;
}

// dx1 = dout + LN2'(dh2) and dy_attn = dx1 * keep_a, with xhat2 and inv2
// recomputed from x1; t = dh2 * xhat2 for the LN2 scale gradient.
template <typename T>
__global__ void __launch_bounds__(256)
ln2_bwd_rows(const float* __restrict__ dh2, const T* __restrict__ x1,
             const float* __restrict__ scale, const T* __restrict__ dy,
             const float* __restrict__ keep, float eps, Geom g, int C, int M,
             float* __restrict__ dx1, float* __restrict__ dya,
             float* __restrict__ t) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= M) return;
  const size_t base = (size_t)row * C;
  const T* xr = x1 + base;
  const float* dh = dh2 + base;
  float mu, inv, a, b;
  ln_stats(xr, C, eps, lane, mu, inv);
  ln_bwd_means(dh, xr, scale, C, mu, inv, lane, a, b);
  const long long src = row_source(g, row);
  const float ka = keep[2 * (row / (g.nW * g.N))];
  for (int c = lane; c < C; c += 32) {
    float xh = (to_f(xr[c]) - mu) * inv;
    float dxh = dh[c] * scale[c];
    float dout = src < 0 ? 0.f : to_f(dy[(size_t)src * C + c]);
    float v = dout + inv * (dxh - a - xh * b);
    dx1[base + c] = v;
    dya[base + c] = v * ka;
    t[base + c] = dh[c] * xh;
  }
}

// dx[src] = T(dx1 + LN1'(dh1)) with xhat1 and inv1 recomputed from x; pad
// rows get dh1 = 0 (the vjp of the post-LN pad-row mask) and write nothing.
// t = dh1 * xhat1 for the LN1 scale gradient.
template <typename T>
__global__ void __launch_bounds__(256)
ln1_bwd_rows(float* __restrict__ dh1, const T* __restrict__ x,
             const float* __restrict__ scale, const float* __restrict__ dx1,
             float eps, Geom g, int C, int M, float* __restrict__ t,
             T* __restrict__ dx) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= M) return;
  const size_t base = (size_t)row * C;
  float* dh = dh1 + base;
  const long long src = row_source(g, row);
  if (src < 0) {
    for (int c = lane; c < C; c += 32) {
      dh[c] = 0.f;
      t[base + c] = 0.f;
    }
    return;
  }
  const T* xr = x + (size_t)src * C;
  float mu, inv, a, b;
  ln_stats(xr, C, eps, lane, mu, inv);
  ln_bwd_means(dh, xr, scale, C, mu, inv, lane, a, b);
  for (int c = lane; c < C; c += 32) {
    float xh = (to_f(xr[c]) - mu) * inv;
    float dxh = dh[c] * scale[c];
    dx[(size_t)src * C + c] = from_f<T>(dx1[base + c] + inv * (dxh - a - xh * b));
    t[base + c] = dh[c] * xh;
  }
}

// Dimensions: B, G0, G1, G2, C, F, heads, w0, w1, w2, s0, s1, s2 (effective shift).
struct Dims {
  int B, G0, G1, G2, C, F, heads, w0, w1, w2, s0, s1, s2;
};

template <typename T>
struct Work {
  T *h1, *qkv, *o, *x1, *h2, *f1, *g;
  float *df2, *df1, *dh2, *dx1, *dya, *dO, *dqkv, *dh1, *t, *part;
};

template <typename T>
static size_t carve(const Dims& d, char* base, Work<T>& w) {
  Geom g = make_geom(d.B, d.G0, d.G1, d.G2, d.w0, d.w1, d.w2, d.s0, d.s1, d.s2);
  const size_t M = (size_t)d.B * g.nW * g.N, C = d.C, F = d.F;
  Carve cv{base};
  w.h1 = cv.take<T>(M * C);
  w.qkv = cv.take<T>(M * 3 * C);
  w.o = cv.take<T>(M * C);
  w.x1 = cv.take<T>(M * C);
  w.h2 = cv.take<T>(M * C);
  w.f1 = cv.take<T>(M * F);
  w.g = cv.take<T>(M * F);
  w.df2 = cv.take<float>(M * C);
  w.df1 = cv.take<float>(M * F);
  w.dh2 = cv.take<float>(M * C);
  w.dx1 = cv.take<float>(M * C);
  w.dya = cv.take<float>(M * C);
  w.dO = cv.take<float>(M * C);
  w.dqkv = cv.take<float>(M * 3 * C);
  w.dh1 = cv.take<float>(M * C);
  w.t = cv.take<float>(M * C);
  long long part = (long long)colsum_parts(M) * (3 * C > F ? 3 * C : F);
  long long wg = (long long)wgrad_splits(M) * (3 * C * C > F * C ? 3 * C * C : F * C);
  long long ab = attn_bwd_part_floats(g, d.heads);
  part = part > wg ? part : wg;
  part = part > ab ? part : ab;
  w.part = cv.take<float>(part);
  return cv.used;
}

#define CK(call)                                  \
  do {                                            \
    cudaError_t err_ = (call);                    \
    if (err_ != cudaSuccess) return (int)err_;    \
  } while (0)

// ptrs: inputs x, dy, ln1_s, ln1_b, Wqkv, bqkv, Wp, bp, ln2_s, ln2_b, W1, b1,
// W2, b2, rel_bias [heads, N, N], keep [B, 2]; then outputs dx, dln1_s,
// dln1_b, dWqkv, dbqkv, dWp, dbp, dln2_s, dln2_b, dW1, db1, dW2, db2,
// dlogit [heads, N, N]. Weights and their gradients are in torch Linear
// layout [out, in]; gradients are float32.
template <typename T>
static int run(const Dims& d, float eps, float scale, void* const* p, void* ws,
               cudaStream_t st) {
  Geom g = make_geom(d.B, d.G0, d.G1, d.G2, d.w0, d.w1, d.w2, d.s0, d.s1, d.s2);
  const int M = d.B * g.nW * g.N, C = d.C, F = d.F;
  const int rows_grid = (M + 7) / 8;
  Work<T> w;
  carve<T>(d, (char*)ws, w);
  const T* x = (const T*)p[0];
  const T* dy = (const T*)p[1];
  const float *ln1_s = (const float*)p[2], *ln1_b = (const float*)p[3];
  const T* Wqkv = (const T*)p[4];
  const float* bqkv = (const float*)p[5];
  const T* Wp = (const T*)p[6];
  const float* bp = (const float*)p[7];
  const float *ln2_s = (const float*)p[8], *ln2_b = (const float*)p[9];
  const T* W1 = (const T*)p[10];
  const float* b1 = (const float*)p[11];
  const T* W2 = (const T*)p[12];
  const float* b2 = (const float*)p[13];
  const float* rel = (const float*)p[14];
  const float* keep = (const float*)p[15];
  T* dx = (T*)p[16];
  float *dln1_s = (float*)p[17], *dln1_b = (float*)p[18];
  float *dWqkv = (float*)p[19], *dbqkv = (float*)p[20];
  float *dWp = (float*)p[21], *dbp = (float*)p[22];
  float *dln2_s = (float*)p[23], *dln2_b = (float*)p[24];
  float *dW1 = (float*)p[25], *db1 = (float*)p[26];
  float *dW2 = (float*)p[27], *db2 = (float*)p[28];
  float* dlogit = (float*)p[29];

  // ---- recompute the forward ----
  gather_rows<T, true><<<rows_grid, 256, 0, st>>>(x, ln1_s, ln1_b, eps, g, C, M, w.h1);
  CK(cudaGetLastError());
  Epi e = {};
  e.g = g;
  e.keep = keep;
  e.bias = bqkv; e.scale = scale; e.n_scaled = C; e.out = w.qkv;
  CK((launch_gemm<T, EPI_QKV>(w.h1, Wqkv, M, 3 * C, C, e, st)));
  CK(launch_attn<T>(w.qkv, rel, g, C, d.heads, w.o, st));
  e.bias = bp; e.x = x; e.out = w.x1;
  CK((launch_gemm<T, EPI_PROJ_RESID>(w.o, Wp, M, C, C, e, st)));
  ln_rows<T><<<rows_grid, 256, 0, st>>>(w.x1, ln2_s, ln2_b, eps, C, M, w.h2);
  CK(cudaGetLastError());
  e.bias = b1; e.out = w.g; e.aux = w.f1;
  CK((launch_gemm<T, EPI_FC1_BOTH>(w.h2, W1, M, F, C, e, st)));

  // ---- MLP branch: out = x1 + f2 * keep_m ----
  dout_rows<T><<<rows_grid, 256, 0, st>>>(dy, keep, g, C, M, w.df2);
  CK(cudaGetLastError());
  CK(launch_colsum<float>(w.df2, M, C, w.part, db2, st));
  Epi2 e2 = {};
  e2.g = g;
  e2.out = w.df1; e2.aux = w.f1;
  CK((launch_gemm2<T, FORM_NN, E2_GELU_GRAD>(w.df2, W2, M, F, C, 1, e2, st)));
  CK((weight_grad<T>(w.df2, w.g, M, C, F, w.part, dW2, st)));
  CK(launch_colsum<float>(w.df1, M, F, w.part, db1, st));
  e2.out = w.dh2; e2.aux = nullptr;
  CK((launch_gemm2<T, FORM_NN, E2_STORE>(w.df1, W1, M, C, F, 1, e2, st)));
  CK((weight_grad<T>(w.df1, w.h2, M, F, C, w.part, dW1, st)));
  ln2_bwd_rows<T><<<rows_grid, 256, 0, st>>>(w.dh2, w.x1, ln2_s, dy, keep, eps, g,
                                              C, M, w.dx1, w.dya, w.t);
  CK(cudaGetLastError());
  CK(launch_colsum<float>(w.t, M, C, w.part, dln2_s, st));
  CK(launch_colsum<float>(w.dh2, M, C, w.part, dln2_b, st));

  // ---- attention branch: x1 = x + y * keep_a ----
  CK(launch_colsum<float>(w.dya, M, C, w.part, dbp, st));
  e2.out = w.dO;
  CK((launch_gemm2<T, FORM_NN, E2_STORE>(w.dya, Wp, M, C, C, 1, e2, st)));
  CK((weight_grad<T>(w.dya, w.o, M, C, C, w.part, dWp, st)));
  CK(launch_attn_bwd<T>(w.qkv, w.dO, rel, g, C, d.heads, scale, w.dqkv, w.part,
                        dlogit, st));
  CK(launch_colsum<float>(w.dqkv, M, 3 * C, w.part, dbqkv, st));
  CK((weight_grad<T>(w.dqkv, w.h1, M, 3 * C, C, w.part, dWqkv, st)));
  e2.out = w.dh1;
  CK((launch_gemm2<T, FORM_NN, E2_STORE>(w.dqkv, Wqkv, M, C, 3 * C, 1, e2, st)));
  ln1_bwd_rows<T><<<rows_grid, 256, 0, st>>>(w.dh1, x, ln1_s, w.dx1, eps, g, C, M,
                                              w.t, dx);
  CK(cudaGetLastError());
  CK(launch_colsum<float>(w.t, M, C, w.part, dln1_s, st));
  CK(launch_colsum<float>(w.dh1, M, C, w.part, dln1_b, st));
  return 0;
}

static bool read_dims(const int* v, Dims& d) {
  d = Dims{v[0], v[1], v[2], v[3], v[4], v[5], v[6], v[7], v[8], v[9], v[10], v[11], v[12]};
  return d.C % 8 == 0 && d.F % 8 == 0 && d.C % d.heads == 0;
}

// Bytes of scratch that fused_swin_block_bwd needs (0: unsupported).
// dtype: 0 = float32, 1 = bfloat16; dims as in Dims.
extern "C" size_t fused_swin_block_bwd_workspace(int dtype, const int* dims) {
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
extern "C" int fused_swin_block_bwd(int dtype, const int* dims, float eps,
                                    float scale, void* const* ptrs,
                                    void* workspace, void* stream) {
  Dims d;
  if (!read_dims(dims, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1) return run<bf16>(d, eps, scale, ptrs, workspace, st);
  if (dtype == 0) return run<float>(d, eps, scale, ptrs, workspace, st);
  return (int)cudaErrorInvalidValue;
}
