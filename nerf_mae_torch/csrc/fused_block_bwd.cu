// Whole Swin block backward for Hopper (sm_90a).
//
// Replaces the TPU kernel
// nerf_mae_tpu/ops/pallas_block.py:_fused_block_bwd_kernel (with the
// window-order staging of its `_bwd` glue). That kernel saves nothing from
// the forward and recomputes the block, as a TPU step must; this card has
// the room to keep the rows, so the forward (fused_block.cu) keeps what the
// VJP reads, h1, qkv, o, x1 and h2 [M, C | 3C | C | C | C] and f1 and g
// [M, F] in T, in window order with the pad rows, and this kernel reads
// them instead of running the forward's first six links again. It runs the
// hand-derived VJP, returning dx and the float32 gradients of the 12
// parameters plus dlogit [heads, N, N] (the caller scatters dlogit into the
// [343, heads] bias table). The rows are bitwise what a recompute would
// give (the same links on the same inputs), and the JAX kernel's rounding
// points are kept: T(df2) feeds both of its products; df1 = dg * gelu'(f1)
// in float32, rounded only as an operand; T(do), T(p) and T(dl) feed the
// attention products; dq is scaled after its product; dk uses the scaled
// T(q); T(dqkv) feeds dWqkv and dh1; bias, LayerNorm and logit sums are of
// float32 values; dx is rounded to T last. The LayerNorm statistics are
// recomputed from x and x1 in the row passes that read them anyway.
//
// What bounds it on the H100: ~48 C^2 FLOPs per token (two products per
// forward product) against x, dy and dx and the kept rows, ~36 C bytes per
// token in bf16: ~1.3 C FLOPs a byte, so by bytes at C = 128 (stage 0, the
// kept rows) and by operations from C = 256 on. The TPU kernel keeps the
// block in VMEM; a CTA cannot hold a block's weights (12 C^2 bf16), so here
// the VJP is a chain of launches over window-order rows (swin_common.cuh),
// and the design makes each link cheap:
//   MLP        df2 = dout * keep_m -> T(df2) and db2 partials (one row pass);
//              dg = T(df2) W2 with the GELU derivative in the epilogue ->
//              T(df1) and db1 partials; dh2 = T(df1) W1; LN2 backward ->
//              dx1, T(dy_attn) and the dln2 / dbp partials
//   attention  do = T(dy_attn) Wp -> T(do); tensor-core backward -> T(dqkv)
//              with the dbqkv and dlogit partials; dh1 = T(dqkv) Wqkv; LN1
//              backward, scattered back through unpartition, un-roll and
//              crop -> dx, with the dln1 partials
//   weights    every dW = T(D)^T T(H) straight from the bf16 rows (wgmma
//              reads them MN-major): split-row partials plus a fixed-order
//              sum.
// Every product runs on the TMA + wgmma core; every operand crosses device
// memory once, in T, rounded by the epilogue that produced it (the JAX
// `.astype(d)`); float32 rows stay only where they are read row-wise (dh2,
// then dh1 in the same buffer, and dx1): 8 C bytes per row. No float
// atomics: every gradient is bitwise deterministic.
// What is left of the gap: the scratch (T(df2) then T(do), T(df1) then
// T(dqkv), T(dy_attn), and the two float32 rows: 20 C bytes per row at
// F = 4 C) and the kept rows are written once and read once or twice each;
// at C = 512 the products run at ~100 TFLOP/s, a tenth of the tensor-core
// rate.
#include <algorithm>

#include "swin_common.cuh"

using namespace swin;

// Row passes: a grid of at most RP_CTAS CTAs of 8 warps, CTA c taking rows
// [c per, (c + 1) per), one warp per row held in registers (load_row); column
// sums of float32 values are kept per lane and written as one partial row
// per CTA, added later in a fixed order.
constexpr int RP_CTAS = 1056;  // 8 per SM

inline int row_pass_ctas(int M) {
  int c = (M + 63) / 64;
  return c < RP_CTAS ? c : RP_CTAS;
}

// part[q][cta][c] = sum over the CTA's warps (in order) of acc[q].
template <int NQ, int U>
__device__ __forceinline__ void write_col_parts(const float (&acc)[NQ][U][4], int C, int P,
                                                float* part) {
  __shared__ __align__(16) float red[8][U * 128];
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    store_row(red[w], C, lane, acc[q]);
    __syncthreads();
    for (int c = threadIdx.x; c < C; c += 256) {
      float s = 0.f;
      for (int i = 0; i < 8; ++i) s += red[i][c];
      part[((size_t)q * P + blockIdx.x) * C + c] = s;
    }
    __syncthreads();
  }
}

template <int NQ, int U>
__device__ __forceinline__ void zero_acc(float (&acc)[NQ][U][4]) {
#pragma unroll
  for (int q = 0; q < NQ; ++q) zero_row(acc[q]);
}

// df2[m] = T(dout[m] * keep_m), dout = dy gathered into window order (zero
// at pad rows); partials of the float32 df2 for db2.
template <typename T, int U>
__global__ void __launch_bounds__(256)
dout_rows(const T* __restrict__ dy, const float* __restrict__ keep, Geom g, int C, int M,
          int per, T* __restrict__ df2, float* __restrict__ part) {
  float acc[1][U][4];
  zero_acc(acc);
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = blockIdx.x * per, r1 = r0 + per < M ? r0 + per : M;
  for (int row = r0 + w; row < r1; row += 8) {
    const long long src = row_source(g, row);
    const float km = keep[2 * (row / (g.nW * g.N)) + 1];
    float v[U][4];
    if (src < 0) {
      zero_row(v);
    } else {
      load_row(dy + (size_t)src * C, C, lane, v);
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        v[u][k] *= km;
        acc[0][u][k] += v[u][k];
      }
    store_row(df2 + (size_t)row * C, C, lane, v);
  }
  write_col_parts(acc, C, gridDim.x, part);
}

// The LayerNorm input gradient of one row in registers, given the float32
// output gradient dh, the input x and the scale: into dx (added), with
// xhat for the scale gradient. Means a = mean(dh * scale),
// b = mean(dh * scale * xhat).
template <int U>
__device__ __forceinline__ void ln_bwd_row(const float (&x)[U][4], const float (&dh)[U][4],
                                           const float (&sc)[U][4], int C, float eps,
                                           float (&xh)[U][4], float (&dx)[U][4]) {
  float mu, inv;
  row_stats(x, C, eps, mu, inv);
  float a = 0.f, b = 0.f;
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      xh[u][k] = (x[u][k] - mu) * inv;
      const float dxh = dh[u][k] * sc[u][k];
      a += dxh;
      b += dxh * xh[u][k];
    }
  a = warp_sum(a) / C;
  b = warp_sum(b) / C;
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int k = 0; k < 4; ++k) dx[u][k] += inv * (dh[u][k] * sc[u][k] - a - xh[u][k] * b);
}

// dx1 = dout + LN2'(dh2) (float32) and dya = T(dx1 * keep_a), with xhat2 and
// inv2 recomputed from x1; partials of dh2 * xhat2 (dln2_scale), dh2
// (dln2_bias) and dx1 * keep_a (dproj_bias).
template <typename T, int U>
__global__ void __launch_bounds__(256)
ln2_bwd_rows(const float* __restrict__ dh2, const T* __restrict__ x1,
             const float* __restrict__ scale, const T* __restrict__ dy,
             const float* __restrict__ keep, float eps, Geom g, int C, int M, int per,
             float* __restrict__ dx1, T* __restrict__ dya, float* __restrict__ part) {
  float acc[3][U][4];
  zero_acc(acc);
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  float sc[U][4];
  load_row(scale, C, lane, sc);
  const int r0 = blockIdx.x * per, r1 = r0 + per < M ? r0 + per : M;
  for (int row = r0 + w; row < r1; row += 8) {
    const size_t base = (size_t)row * C;
    float x[U][4], dh[U][4], xh[U][4], v[U][4];
    load_row(x1 + base, C, lane, x);
    load_row(dh2 + base, C, lane, dh);
    const long long src = row_source(g, row);
    if (src < 0) {
      zero_row(v);
    } else {
      load_row(dy + (size_t)src * C, C, lane, v);
    }
    ln_bwd_row(x, dh, sc, C, eps, xh, v);
    store_row(dx1 + base, C, lane, v);
    const float ka = keep[2 * (row / (g.nW * g.N))];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        acc[0][u][k] += dh[u][k] * xh[u][k];
        acc[1][u][k] += dh[u][k];
        v[u][k] *= ka;
        acc[2][u][k] += v[u][k];
      }
    store_row(dya + base, C, lane, v);
  }
  write_col_parts(acc, C, gridDim.x, part);
}

// dx[src] = T(dx1 + LN1'(dh1)) with xhat1 and inv1 recomputed from x; pad
// rows take dh1 = 0 (the vjp of the post-LN pad-row mask) and write
// nothing. Partials of dh1 * xhat1 (dln1_scale) and dh1 (dln1_bias).
template <typename T, int U>
__global__ void __launch_bounds__(256)
ln1_bwd_rows(const float* __restrict__ dh1, const T* __restrict__ x,
             const float* __restrict__ scale, const float* __restrict__ dx1, float eps,
             Geom g, int C, int M, int per, T* __restrict__ dx, float* __restrict__ part) {
  float acc[2][U][4];
  zero_acc(acc);
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  float sc[U][4];
  load_row(scale, C, lane, sc);
  const int r0 = blockIdx.x * per, r1 = r0 + per < M ? r0 + per : M;
  for (int row = r0 + w; row < r1; row += 8) {
    const long long src = row_source(g, row);
    if (src < 0) continue;
    const size_t base = (size_t)row * C;
    float xr[U][4], dh[U][4], xh[U][4], v[U][4];
    load_row(x + (size_t)src * C, C, lane, xr);
    load_row(dh1 + base, C, lane, dh);
    load_row(dx1 + base, C, lane, v);
    ln_bwd_row(xr, dh, sc, C, eps, xh, v);
    store_row(dx + (size_t)src * C, C, lane, v);
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        acc[0][u][k] += dh[u][k] * xh[u][k];
        acc[1][u][k] += dh[u][k];
      }
  }
  write_col_parts(acc, C, gridDim.x, part);
}

// Dimensions: B, G0, G1, G2, C, F, heads, w0, w1, w2, s0, s1, s2 (effective shift).
struct Dims {
  int B, G0, G1, G2, C, F, heads, w0, w1, w2, s0, s1, s2;
};

// The VJP's scratch. df2 is dead once dW2 is summed and df1 once dW1 is, so
// dO takes df2's rows and dqkv df1's.
template <typename T>
struct Work {
  T *df2, *df1, *dya, *dO, *dqkv;
  float *dh, *dx1, *part, *tmp;
};

template <typename T>
static size_t carve(const Dims& d, char* base, Work<T>& w) {
  Geom g = make_geom(d.B, d.G0, d.G1, d.G2, d.w0, d.w1, d.w2, d.s0, d.s1, d.s2);
  const long long M = (long long)d.B * g.nW * g.N, C = d.C, F = d.F;
  Carve cv{base};
  w.df2 = w.dO = cv.take<T>(M * C);
  w.df1 = w.dqkv = cv.take<T>(M * std::max(F, 3 * C));
  w.dya = cv.take<T>(M * C);
  w.dh = cv.take<float>(M * C);
  w.dx1 = cv.take<float>(M * C);
  // partials: row passes (3 sums), the dgelu product's column sums, weight
  // gradient splits and the attention backward, one at a time
  const long long tile = gemm_row_tile<T>();
  long long part = 3LL * row_pass_ctas((int)M) * C;
  part = std::max(part, (M + tile - 1) / tile * F);
  part = std::max(part, (long long)wgrad_splits<T>(M, F, C) * F * C);
  part = std::max(part, (long long)wgrad_splits<T>(M, 3 * C, C) * 3 * C * C);
  part = std::max(part, (long long)wgrad_splits<T>(M, C, C) * C * C);
  part = std::max(part, attn_bwd_part_floats<T>(g, d.C, d.heads));
  w.part = cv.take<float>(part);
  w.tmp = cv.take<float>(128 * std::max(3 * C, F));  // first pass of launch_colsum
  return cv.used;
}

#define CK(call)                                  \
  do {                                            \
    cudaError_t err_ = (call);                    \
    if (err_ != cudaSuccess) return (int)err_;    \
  } while (0)

// ptrs: inputs x, dy, ln1_s, ln1_b, Wqkv, bqkv, Wp, bp, ln2_s, ln2_b, W1, b1,
// W2, b2, rel_table [(2w-1)^3, heads], keep [B, 2]; the rows the forward
// kept, h1, qkv, o, x1, h2, f1, g; then outputs dx, dln1_s, dln1_b, dWqkv,
// dbqkv, dWp, dbp, dln2_s, dln2_b, dW1, db1, dW2, db2, dlogit [heads, N, N].
// Weights and their gradients are in torch Linear layout [out, in];
// gradients are float32.
template <typename T>
static int run(const Dims& d, float eps, float scale, void* const* p, void* ws,
               cudaStream_t st) {
  Geom g = make_geom(d.B, d.G0, d.G1, d.G2, d.w0, d.w1, d.w2, d.s0, d.s1, d.s2);
  const int M = d.B * g.nW * g.N, C = d.C, F = d.F;
  const int rp = row_pass_ctas(M), rp_per = (M + rp - 1) / rp;
  const int tiles = (M + gemm_row_tile<T>() - 1) / gemm_row_tile<T>();
  Work<T> w;
  carve<T>(d, (char*)ws, w);
  // the biases and the LN shifts (p[3], 5, 7, 9, 11, 13) reach only the
  // forward's rows, which are kept
  const T* x = (const T*)p[0];
  const T* dy = (const T*)p[1];
  const float* ln1_s = (const float*)p[2];
  const T* Wqkv = (const T*)p[4];
  const T* Wp = (const T*)p[6];
  const float* ln2_s = (const float*)p[8];
  const T* W1 = (const T*)p[10];
  const T* W2 = (const T*)p[12];
  const float* rel = (const float*)p[14];
  const float* keep = (const float*)p[15];
  const T *h1 = (const T*)p[16], *qkv = (const T*)p[17], *o = (const T*)p[18];
  const T *x1 = (const T*)p[19], *h2 = (const T*)p[20], *f1 = (const T*)p[21];
  const T* gl = (const T*)p[22];
  T* dx = (T*)p[23];
  float *dln1_s = (float*)p[24], *dln1_b = (float*)p[25];
  float *dWqkv = (float*)p[26], *dbqkv = (float*)p[27];
  float *dWp = (float*)p[28], *dbp = (float*)p[29];
  float *dln2_s = (float*)p[30], *dln2_b = (float*)p[31];
  float *dW1 = (float*)p[32], *db1 = (float*)p[33];
  float *dW2 = (float*)p[34], *db2 = (float*)p[35];
  float* dlogit = (float*)p[36];
  // the q-th column sum of a row pass
  auto row_sum = [&](int q, float* out) {
    return launch_colsum<float>(w.part + (size_t)q * rp * C, rp, C, w.tmp, out, st);
  };

  // ---- MLP branch: out = x1 + f2 * keep_m ----
  CK(with_row_u(C, [&](auto u) {
    dout_rows<T, decltype(u)::value><<<rp, 256, 0, st>>>(dy, keep, g, C, M, rp_per, w.df2,
                                                        w.part);
    return cudaGetLastError();
  }));
  CK(row_sum(0, db2));
  Epi e2 = {};
  e2.g = g;
  e2.out = w.df1; e2.aux = (void*)f1; e2.colpart = w.part;
  CK((launch_gemm<T, FORM_NN, EPI_DGELU>(w.df2, W2, M, F, C, 0, e2, st)));
  CK(launch_colsum<float>(w.part, tiles, F, w.tmp, db1, st));
  CK((weight_grad<T>(w.df2, gl, M, C, F, w.part, dW2, st)));
  e2 = Epi{};
  e2.out = w.dh;
  CK((launch_gemm<T, FORM_NN, EPI_F32>(w.df1, W1, M, C, F, 0, e2, st)));
  CK((weight_grad<T>(w.df1, h2, M, F, C, w.part, dW1, st)));
  CK(with_row_u(C, [&](auto u) {
    ln2_bwd_rows<T, decltype(u)::value><<<rp, 256, 0, st>>>(
        w.dh, x1, ln2_s, dy, keep, eps, g, C, M, rp_per, w.dx1, w.dya, w.part);
    return cudaGetLastError();
  }));
  CK(row_sum(0, dln2_s));
  CK(row_sum(1, dln2_b));
  CK(row_sum(2, dbp));

  // ---- attention branch: x1 = x + y * keep_a ----
  e2.out = w.dO;
  CK((launch_gemm<T, FORM_NN, EPI_T>(w.dya, Wp, M, C, C, 0, e2, st)));
  CK((weight_grad<T>(w.dya, o, M, C, C, w.part, dWp, st)));
  CK(launch_attn_bwd<T>(qkv, w.dO, rel, g, C, d.heads, scale, w.dqkv, w.part, w.tmp,
                        dlogit, dbqkv, st));
  CK((weight_grad<T>(w.dqkv, h1, M, 3 * C, C, w.part, dWqkv, st)));
  e2.out = w.dh;
  CK((launch_gemm<T, FORM_NN, EPI_F32>(w.dqkv, Wqkv, M, C, 3 * C, 0, e2, st)));
  CK(with_row_u(C, [&](auto u) {
    ln1_bwd_rows<T, decltype(u)::value><<<rp, 256, 0, st>>>(w.dh, x, ln1_s, w.dx1, eps, g, C,
                                                           M, rp_per, dx, w.part);
    return cudaGetLastError();
  }));
  CK(row_sum(0, dln1_s));
  CK(row_sum(1, dln1_b));
  return 0;
}

static bool read_dims(const int* v, Dims& d) {
  d = Dims{v[0], v[1], v[2], v[3], v[4], v[5], v[6], v[7], v[8], v[9], v[10], v[11], v[12]};
  return d.C % 8 == 0 && d.F % 8 == 0 && d.C % d.heads == 0 && d.C <= 512;
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

// Test hook, not part of the block's interface: one bf16 product into a
// float32 [M, N] output, so that the card tests reach the GEMM core's ragged
// edges directly. form: 0 = A W^T (A [M, K], W [N, K]), 1 = A W (W [K, N]),
// 2 = A^T B (A [K, M], B [K, N]). Returns a cudaError_t code.
extern "C" int gemm_core_for_tests(int form, int M, int N, long long K, const void* A,
                              const void* B, float* out, void* stream) {
  Epi e = {};
  e.out = out;
  cudaStream_t st = (cudaStream_t)stream;
  const bf16 *a = (const bf16*)A, *b = (const bf16*)B;
  if (form == 0) return (int)launch_gemm<bf16, FORM_NT, EPI_F32>(a, b, M, N, K, 0, e, st);
  if (form == 1) return (int)launch_gemm<bf16, FORM_NN, EPI_F32>(a, b, M, N, K, 0, e, st);
  if (form == 2) return (int)launch_gemm<bf16, FORM_TN, EPI_F32>(a, b, M, N, K, 0, e, st);
  return (int)cudaErrorInvalidValue;
}
