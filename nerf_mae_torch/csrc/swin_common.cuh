// Building blocks shared by the fused Swin-block and fused window-attention
// kernels: the forwards (fused_block.cu, fused_attention.cu) and the
// backwards (fused_block_bwd.cu, fused_attention_bwd.cu).
//
// They replace the VMEM-resident bodies of the TPU kernels in
// nerf_mae_tpu/ops/pallas_block.py (_fused_block_kernel,
// _fused_block_bwd_kernel) and nerf_mae_tpu/ops/pallas_attention.py
// (_fused_window_attn_kernel, _fused_window_attn_bwd_kernel). A TPU kernel
// keeps a whole block (12 C^2 bf16 weights, 6 MiB at C = 512) and its
// weight gradients in VMEM across a sequential grid; a Hopper CTA has 227 KB
// of shared memory and runs beside 131 others in no order, so on the H100 a
// block is a chain of launches over window-order rows, and what bounds it is
// the rate of its matrix products and the bytes each link moves through
// device memory. The design answers both:
//   - swin_gemm.cuh: every bf16 product runs on a TMA + mbarrier + wgmma
//     core (3-stage ring, one producer warp, two consumer warpgroups) with
//     the epilogue applied from the accumulator registers; float32 (dtype 0)
//     keeps an FMA-unit GEMM with the same epilogues.
//   - swin_attn.cuh: window attention on the tensor cores (mma.sync
//     m16n8k16), forward and backward, softmax in float32 registers.
//   - this file: geometry (pad, roll and partition as index arithmetic),
//     LayerNorm rows, the fused epilogues, and the fixed-order reductions
//     that replace the TPU's resident gradient sums (no float atomics: every
//     gradient is bitwise deterministic).
//
// Layouts: activations are channel-last; inside a block the tokens travel in
// window order, row r = ((b * nW + window) * N + token), so that one window's
// N tokens are N consecutive rows. Padding, the cyclic shift and the window
// partition are index arithmetic on the way in (gather_rows) and on the way
// out (the scattering epilogues); no padded or rolled copy is made. Weights
// are in torch Linear layout [out, in].
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace swin {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T and read back: one rounding point of the JAX kernel.
template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_f(from_f<T>(v));
}

// Two neighbouring values rounded to T and stored with one access.
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *(__nv_bfloat162*)p = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *(float2*)p = make_float2(a, b);
}

// Geometry of one block: original grid G, padded grid P, window w,
// effective shift s (0 along axes the window covers).
struct Geom {
  int B, G0, G1, G2, P0, P1, P2, w0, w1, w2, s0, s1, s2, nw1, nw2, N, nW;
};

inline Geom make_geom(int B, int G0, int G1, int G2, int w0, int w1, int w2,
                      int s0, int s1, int s2) {
  Geom g;
  g.B = B; g.G0 = G0; g.G1 = G1; g.G2 = G2;
  g.w0 = w0; g.w1 = w1; g.w2 = w2;
  g.s0 = s0; g.s1 = s1; g.s2 = s2;
  g.P0 = (G0 + w0 - 1) / w0 * w0;
  g.P1 = (G1 + w1 - 1) / w1 * w1;
  g.P2 = (G2 + w2 - 1) / w2 * w2;
  g.nw1 = g.P1 / w1;
  g.nw2 = g.P2 / w2;
  g.N = w0 * w1 * w2;
  g.nW = (g.P0 / w0) * g.nw1 * g.nw2;
  return g;
}

// Position of token t of window w on the padded, rolled grid.
__device__ __forceinline__ void rolled_pos(const Geom& g, int w, int t,
                                           int& p0, int& p1, int& p2) {
  p0 = (w / (g.nw1 * g.nw2)) * g.w0 + t / (g.w1 * g.w2);
  p1 = ((w / g.nw2) % g.nw1) * g.w1 + (t / g.w2) % g.w1;
  p2 = (w % g.nw2) * g.w2 + t % g.w2;
}

// Flat index of the original token that window-order row `row` holds, or -1
// for a zero-pad row. Rolling by -s means rolled[p] = padded[(p + s) % P].
__device__ __forceinline__ long long row_source(const Geom& g, long long row) {
  int t = (int)(row % g.N);
  long long bw = row / g.N;
  int w = (int)(bw % g.nW);
  int b = (int)(bw / g.nW);
  int p0, p1, p2;
  rolled_pos(g, w, t, p0, p1, p2);
  p0 = (p0 + g.s0) % g.P0;
  p1 = (p1 + g.s1) % g.P1;
  p2 = (p2 + g.s2) % g.P2;
  if (p0 >= g.G0 || p1 >= g.G1 || p2 >= g.G2) return -1;
  return (((long long)b * g.G0 + p0) * g.G1 + p1) * g.G2 + p2;
}

// Shift-mask region label (0..26) of token t of window w: the 27-region
// labelling of shifted_window_mask, computed instead of stored.
__device__ __forceinline__ int region_label(const Geom& g, int w, int t) {
  int p0, p1, p2;
  rolled_pos(g, w, t, p0, p1, p2);
  int l0 = p0 < g.P0 - g.w0 ? 0 : (p0 < g.P0 - g.s0 ? 1 : 2);
  int l1 = p1 < g.P1 - g.w1 ? 0 : (p1 < g.P1 - g.s1 ? 1 : 2);
  int l2 = p2 < g.P2 - g.w2 ? 0 : (p2 < g.P2 - g.s2 ? 1 : 2);
  return (l0 * 3 + l1) * 3 + l2;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Row passes hold a row in registers, one warp per row: lane l takes the
// 4-column groups c = 128 u + 4 l, u < U, with U = row_u(C) (C <= 512), so
// that a narrow row costs no registers for the columns it does not have.
inline int row_u(int C) { return C <= 128 ? 1 : (C <= 256 ? 2 : 4); }

// Calls f(std::integral_constant<int, U>()) with U = row_u(C).
template <typename F> inline cudaError_t with_row_u(int C, F f) {
  if (C <= 128) return f(std::integral_constant<int, 1>());
  if (C <= 256) return f(std::integral_constant<int, 2>());
  return f(std::integral_constant<int, 4>());
}

__device__ __forceinline__ void load4(const bf16* p, float (&v)[4]) {
  const uint2 r = *(const uint2*)p;
  const __nv_bfloat162 a = *(const __nv_bfloat162*)&r.x, b = *(const __nv_bfloat162*)&r.y;
  v[0] = __low2float(a);
  v[1] = __high2float(a);
  v[2] = __low2float(b);
  v[3] = __high2float(b);
}
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 r = *(const float4*)p;
  v[0] = r.x;
  v[1] = r.y;
  v[2] = r.z;
  v[3] = r.w;
}
__device__ __forceinline__ void store4(bf16* p, const float (&v)[4]) {
  uint2 r;
  *(__nv_bfloat162*)&r.x = __floats2bfloat162_rn(v[0], v[1]);
  *(__nv_bfloat162*)&r.y = __floats2bfloat162_rn(v[2], v[3]);
  *(uint2*)p = r;
}
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *(float4*)p = make_float4(v[0], v[1], v[2], v[3]);
}

template <int U>
__device__ __forceinline__ void zero_row(float (&v)[U][4]) {
#pragma unroll
  for (int u = 0; u < U; ++u) v[u][0] = v[u][1] = v[u][2] = v[u][3] = 0.f;
}

// A row of C values (T or float) into registers, zeros past C.
template <int U, typename S>
__device__ __forceinline__ void load_row(const S* row, int C, int lane, float (&v)[U][4]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int c = 128 * u + 4 * lane;
    if (c < C) {
      load4(row + c, v[u]);
    } else {
      v[u][0] = v[u][1] = v[u][2] = v[u][3] = 0.f;
    }
  }
}

template <int U, typename S>
__device__ __forceinline__ void store_row(S* row, int C, int lane, const float (&v)[U][4]) {
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (128 * u + 4 * lane < C) store4(row + 128 * u + 4 * lane, v[u]);
}

// Mean and inverse deviation of a row in registers: the fast variance
// E[x^2] - mu^2 of flax / _ln_fwd.
template <int U>
__device__ __forceinline__ void row_stats(const float (&v)[U][4], int C, float eps,
                                          float& mu, float& inv) {
  float s = 0.f, s2 = 0.f;
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      s += v[u][k];
      s2 += v[u][k] * v[u][k];
    }
  s = warp_sum(s);
  s2 = warp_sum(s2);
  mu = s / C;
  inv = rsqrtf(s2 / C - mu * mu + eps);
}

// One warp: dst = T(LayerNorm(src)) in float32, ((x - mu) * inv) * scale + bias.
template <int U, typename T>
__device__ __forceinline__ void ln_row(const T* src, const float* scale,
                                       const float* bias, float eps, int C,
                                       T* dst, int lane) {
  float v[U][4], sc[U][4], bi[U][4];
  load_row(src, C, lane, v);
  load_row(scale, C, lane, sc);
  load_row(bias, C, lane, bi);
  float mu, inv;
  row_stats(v, C, eps, mu, inv);
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int k = 0; k < 4; ++k) v[u][k] = (v[u][k] - mu) * inv * sc[u][k] + bi[u][k];
  store_row(dst, C, lane, v);
}

// Window-order gather, one warp per row: pad + roll + partition by index.
// With LN the row is layer-normed; pad rows are written as zeros (the
// post-LN pad-row mask of the JAX kernel, i.e. LN before the zero pad).
template <typename T, bool LN, int U = 1>
__global__ void __launch_bounds__(256)
gather_rows(const T* __restrict__ x, const float* __restrict__ scale,
            const float* __restrict__ bias, float eps, Geom g, int C, int M,
            T* __restrict__ out) {
  int row = blockIdx.x * 8 + threadIdx.x / 32;
  int lane = threadIdx.x % 32;
  if (row >= M) return;
  long long src = row_source(g, row);
  T* dst = out + (size_t)row * C;
  if (src < 0) {
    for (int c = lane; c < C; c += 32) dst[c] = from_f<T>(0.f);
    return;
  }
  const T* xr = x + (size_t)src * C;
  if (LN) {
    ln_row<U>(xr, scale, bias, eps, C, dst, lane);
  } else {
    for (int c = lane; c < C; c += 32) dst[c] = xr[c];
  }
}

// Row-wise LayerNorm of a window-order buffer, one warp per row.
template <typename T, int U>
__global__ void __launch_bounds__(256)
ln_rows(const T* __restrict__ x, const float* __restrict__ scale,
        const float* __restrict__ bias, float eps, int C, int M,
        T* __restrict__ out) {
  int row = blockIdx.x * 8 + threadIdx.x / 32;
  if (row >= M) return;
  ln_row<U>(x + (size_t)row * C, scale, bias, eps, C, out + (size_t)row * C,
            threadIdx.x % 32);
}

__device__ __forceinline__ float gelu_tanh(float x) {
  // jax.nn.gelu(approximate=True), same operation order as _gelu_tanh
  const float k0 = 0.7978845608028654f, c = 0.044715f;
  float u = k0 * (x + c * x * x * x);
  return 0.5f * x * (1.f + tanhf(u));
}

__device__ __forceinline__ float gelu_tanh_grad(float x) {
  // _gelu_tanh_grad of the JAX kernel, same operation order
  const float k0 = 0.7978845608028654f, c = 0.044715f;
  float u = k0 * (x + c * x * x * x);
  float t = tanhf(u);
  float du = k0 * (1.f + 3.f * c * x * x);
  return 0.5f * (1.f + t) + 0.5f * x * (1.f - t * t) * du;
}

// ---------------------------------------------------------------------------
// Fused epilogues of the products C[m, n] (float32 accumulator acc). Each is
// applied to two neighbouring columns (n even; every N is a multiple of 8).
// ---------------------------------------------------------------------------

enum Epilogue {
  // forward products C = A W^T
  EPI_QKV = 0,        // + bias (f32), q columns * scale, -> T
  EPI_PROJ_RESID,     // y = T(acc + b); x1 = T(x + T(y * T(keep_a)))
  EPI_FC1_GELU,       // f1 = T(T(acc) + T(b)); g = T(gelu_tanh(f1))
  EPI_FC2_RESID_OUT,  // f2 = T(T(acc) + T(b)); out[src] = T(x1 + T(f2 * T(keep_m)))
  EPI_PROJ_OUT,       // out[src] = T(acc + b)
  EPI_FC1_BOTH,       // as EPI_FC1_GELU, and f1 kept in aux for the backward
  // backward products
  EPI_PART,           // out[z][m, n] = acc: split partials of a weight gradient
  EPI_F32,            // out[m, n] = acc (float32 rows read row-wise later)
  EPI_T,              // out[m, n] = T(acc): a product operand, rounded once
  EPI_SCATTER_T,      // out[row_source(m), n] = T(acc); pad rows dropped
  EPI_DGELU,          // d = acc * gelu'(aux[m, n]); out = T(d); column sums of d
};

template <int MODE> struct EpiTraits {
  // reads row_source of its rows
  static constexpr bool src = MODE == EPI_PROJ_RESID || MODE == EPI_FC2_RESID_OUT ||
                              MODE == EPI_PROJ_OUT || MODE == EPI_SCATTER_T;
  // reads the sample of its rows (droppath factors)
  static constexpr bool sample = MODE == EPI_PROJ_RESID || MODE == EPI_FC2_RESID_OUT;
  // writes row m to row row_source(m) of its output; pad rows dropped
  static constexpr bool scatter = MODE == EPI_FC2_RESID_OUT || MODE == EPI_PROJ_OUT ||
                                  MODE == EPI_SCATTER_T;
  // outputs: out (and aux), float32 or T
  static constexpr int planes = MODE == EPI_FC1_BOTH ? 2 : 1;
  static constexpr bool f32 = MODE == EPI_PART || MODE == EPI_F32;
  // writes per-row-tile column partials of the float32 values it produces
  static constexpr bool colsum = MODE == EPI_DGELU;
};

struct Epi {
  const float* bias;
  float scale;          // EPI_QKV: q scale
  int n_scaled;         // EPI_QKV: columns [0, n_scaled) are q
  const void* x;        // EPI_PROJ_RESID: residual, original layout
  const void* x1;       // EPI_FC2_RESID_OUT: residual, window order
  const float* keep;    // [B, 2] per-sample droppath factors
  void* out;
  void* aux;            // EPI_FC1_BOTH: f1 out; EPI_DGELU: f1 in
  float* colpart;       // colsum modes: [row tiles, N] float32 partials
  Geom g;
};

// The values of columns n, n + 1 of row m, o[plane][column], in float32
// (rounded to the output type where they are stored). `src` is row_source
// of row m, `b` the sample of row m. Returns the float32 values whose column
// sums a colsum mode accumulates.
template <typename T, int MODE>
__device__ __forceinline__ float2 epilogue_vals(const Epi& e, int Nc, int m, int n,
                                                long long src, int b, float a0, float a1,
                                                float (&o)[2][2]) {
  float2 cs = make_float2(0.f, 0.f);
  const size_t i = (size_t)m * Nc + n;
  o[0][0] = a0;
  o[0][1] = a1;
  if (MODE == EPI_QKV) {
    o[0][0] = a0 + e.bias[n];
    o[0][1] = a1 + e.bias[n + 1];
    if (n < e.n_scaled) {
      o[0][0] *= e.scale;
      o[0][1] *= e.scale;
    }
  } else if (MODE == EPI_PROJ_RESID) {
    const float ka = rnd<T>(e.keep[2 * b]);
    const float y0 = rnd<T>(a0 + e.bias[n]), y1 = rnd<T>(a1 + e.bias[n + 1]);
    float x0 = 0.f, x1 = 0.f;
    if (src >= 0) {
      const T* xr = (const T*)e.x + (size_t)src * Nc + n;
      x0 = to_f(xr[0]);
      x1 = to_f(xr[1]);
    }
    o[0][0] = x0 + rnd<T>(y0 * ka);
    o[0][1] = x1 + rnd<T>(y1 * ka);
  } else if (MODE == EPI_FC1_GELU || MODE == EPI_FC1_BOTH) {
    const float f0 = rnd<T>(rnd<T>(a0) + rnd<T>(e.bias[n]));
    const float f1 = rnd<T>(rnd<T>(a1) + rnd<T>(e.bias[n + 1]));
    o[0][0] = gelu_tanh(f0);
    o[0][1] = gelu_tanh(f1);
    o[1][0] = f0;
    o[1][1] = f1;
  } else if (MODE == EPI_FC2_RESID_OUT) {
    if (src < 0) return cs;
    const float km = rnd<T>(e.keep[2 * b + 1]);
    const float f0 = rnd<T>(rnd<T>(a0) + rnd<T>(e.bias[n]));
    const float f1 = rnd<T>(rnd<T>(a1) + rnd<T>(e.bias[n + 1]));
    const T* x1 = (const T*)e.x1 + i;
    o[0][0] = to_f(x1[0]) + rnd<T>(f0 * km);
    o[0][1] = to_f(x1[1]) + rnd<T>(f1 * km);
  } else if (MODE == EPI_PROJ_OUT) {
    o[0][0] = a0 + e.bias[n];
    o[0][1] = a1 + e.bias[n + 1];
  } else if (MODE == EPI_DGELU) {
    const T* f = (const T*)e.aux + i;
    cs.x = o[0][0] = a0 * gelu_tanh_grad(to_f(f[0]));
    cs.y = o[0][1] = a1 * gelu_tanh_grad(to_f(f[1]));
  }
  return cs;
}

// Output plane p of a product (EPI_PART: this split's partial).
template <int MODE>
__device__ __forceinline__ void* epi_plane(const Epi& e, int p, int M, int Nc) {
  if (MODE == EPI_PART) return (float*)e.out + (size_t)blockIdx.z * M * Nc;
  return p == 0 ? e.out : e.aux;
}

// Columns n, n + 1 of row m computed and stored straight to device memory.
template <typename T, int MODE>
__device__ __forceinline__ float2 epilogue2(const Epi& e, int M, int Nc, int m, int n,
                                            long long src, int b, float a0, float a1) {
  float o[2][2];
  const float2 cs = epilogue_vals<T, MODE>(e, Nc, m, n, src, b, a0, a1, o);
  if (EpiTraits<MODE>::scatter && src < 0) return cs;
  const size_t i = (size_t)(EpiTraits<MODE>::scatter ? src : m) * Nc + n;
#pragma unroll
  for (int p = 0; p < EpiTraits<MODE>::planes; ++p) {
    if (EpiTraits<MODE>::f32)
      store2((float*)epi_plane<MODE>(e, p, M, Nc) + i, o[p][0], o[p][1]);
    else
      store2((T*)epi_plane<MODE>(e, p, M, Nc) + i, o[p][0], o[p][1]);
  }
  return cs;
}

// ---------------------------------------------------------------------------
// Fixed-order reductions. The TPU backward kernels add every weight, bias,
// LayerNorm and logit gradient into outputs that stay resident across a
// sequential grid. CUDA blocks run concurrently and in no order, so every
// such sum is split: each block writes a float32 partial over its share of
// the rows, and one or two more launches add the partials in a fixed order.
// ---------------------------------------------------------------------------

// out[i] = sum_p part[p * L + i] over p = 0 .. P-1 in order.
__global__ void __launch_bounds__(256)
sum_parts(const float* __restrict__ part, int P, long long L,
          float* __restrict__ out) {
  long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= L) return;
  float s = 0.f;
  for (int p = 0; p < P; ++p) s += part[(size_t)p * L + i];
  out[i] = s;
}

inline cudaError_t launch_sum_parts(const float* part, int P, long long L,
                                    float* out, cudaStream_t st) {
  sum_parts<<<(unsigned)((L + 255) / 256), 256, 0, st>>>(part, P, L, out);
  return cudaGetLastError();
}

// Column sums of a row-major [M, N] matrix, first pass: block (x, p) sums
// columns [32x, 32x + 32) over rows [p * rows_per, (p + 1) * rows_per) and
// writes part[p, column]. Thread (tx, ty) = (column, row phase).
template <typename S>
__global__ void __launch_bounds__(256)
colsum_part(const S* __restrict__ src, long long M, int N, long long rows_per,
            float* __restrict__ part) {
  __shared__ float red[8][33];
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const int col = blockIdx.x * 32 + tx;
  const long long r0 = (long long)blockIdx.y * rows_per;
  const long long r1 = r0 + rows_per < M ? r0 + rows_per : M;
  float s = 0.f;
  if (col < N)
    for (long long r = r0 + ty; r < r1; r += 8) s += to_f(src[r * N + col]);
  red[ty][tx] = s;
  __syncthreads();
  if (ty == 0 && col < N) {
    float t = 0.f;
    for (int i = 0; i < 8; ++i) t += red[i][tx];
    part[(size_t)blockIdx.y * N + col] = t;
  }
}

// Row chunks of colsum_part: at most 128, of at least 1024 rows.
inline int colsum_parts(long long M) {
  long long p = (M + 1023) / 1024;
  return (int)(p < 1 ? 1 : (p > 128 ? 128 : p));
}

// out[n] = sum_m src[m, n] (float32), deterministic. tmp holds
// colsum_parts(M) * N floats.
template <typename S>
inline cudaError_t launch_colsum(const S* src, long long M, int N, float* tmp,
                                 float* out, cudaStream_t st) {
  const int P = colsum_parts(M);
  const long long rows_per = (M + P - 1) / P;
  colsum_part<S><<<dim3((N + 31) / 32, P), 256, 0, st>>>(src, M, N, rows_per, tmp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_sum_parts(tmp, P, N, out, st);
}

// Bump allocator over one workspace buffer (256-byte aligned pieces). With
// a null base it only measures: the total is the bytes to allocate.
struct Carve {
  char* base;
  size_t used = 0;
  template <typename X> X* take(size_t n) {
    X* r = (X*)(base + used);
    used += (n * sizeof(X) + 255) / 256 * 256;
    return r;
  }
};

}  // namespace swin

#include "swin_gemm.cuh"
#include "swin_attn.cuh"
