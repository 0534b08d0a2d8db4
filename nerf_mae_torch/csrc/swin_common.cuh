// Building blocks shared by the fused Swin-block and fused window-attention
// kernels: the forwards (fused_block.cu, fused_attention.cu) and the
// backwards (fused_block_bwd.cu, fused_attention_bwd.cu).
//
// Layouts: activations are channel-last; inside a block the tokens travel in
// window order, row r = ((b * nW + window) * N + token), so that one window's
// N tokens are N consecutive rows. Padding, the cyclic shift and the window
// partition are index arithmetic on the way in (gather_rows) and on the way
// out (the scattering GEMM epilogues); no padded or rolled copy is made.
// Weights are in torch Linear layout [out, in], so every product is
// C[m, n] = sum_k A[m, k] * W[n, k].
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

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

// One warp: dst = T(LayerNorm(src)) in float32 with the fast variance
// E[x^2] - mu^2 (flax / _ln_fwd), ((x - mu) * inv) * scale + bias.
template <typename T>
__device__ __forceinline__ void ln_row(const T* src, const float* scale,
                                       const float* bias, float eps, int C,
                                       T* dst, int lane) {
  float s = 0.f, s2 = 0.f;
  for (int c = lane; c < C; c += 32) {
    float v = to_f(src[c]);
    s += v;
    s2 += v * v;
  }
  s = warp_sum(s);
  s2 = warp_sum(s2);
  float mu = s / C;
  float inv = rsqrtf(s2 / C - mu * mu + eps);
  for (int c = lane; c < C; c += 32)
    dst[c] = from_f<T>((to_f(src[c]) - mu) * inv * scale[c] + bias[c]);
}

// Window-order gather, one warp per row: pad + roll + partition by index.
// With LN the row is layer-normed; pad rows are written as zeros (the
// post-LN pad-row mask of the JAX kernel, i.e. LN before the zero pad).
template <typename T, bool LN>
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
    ln_row<T>(xr, scale, bias, eps, C, dst, lane);
  } else {
    for (int c = lane; c < C; c += 32) dst[c] = xr[c];
  }
}

// Row-wise LayerNorm of a window-order buffer, one warp per row.
template <typename T>
__global__ void __launch_bounds__(256)
ln_rows(const T* __restrict__ x, const float* __restrict__ scale,
        const float* __restrict__ bias, float eps, int C, int M,
        T* __restrict__ out) {
  int row = blockIdx.x * 8 + threadIdx.x / 32;
  if (row >= M) return;
  ln_row<T>(x + (size_t)row * C, scale, bias, eps, C, out + (size_t)row * C,
            threadIdx.x % 32);
}

// ---------------------------------------------------------------------------
// GEMM C[M, Nc] = A[M, K] W[Nc, K]^T with a fused epilogue.
// ---------------------------------------------------------------------------

enum Epilogue {
  EPI_QKV = 0,        // + bias (f32), q columns * scale, -> T
  EPI_PROJ_RESID,     // y = T(acc + b); x1 = T(x + T(y * T(keep_a)))
  EPI_FC1_GELU,       // f1 = T(T(acc) + T(b)); g = T(gelu_tanh(f1))
  EPI_FC2_RESID_OUT,  // f2 = T(T(acc) + T(b)); out[src] = T(x1 + T(f2 * T(keep_m)))
  EPI_PROJ_OUT,       // out[src] = T(acc + b)
  EPI_FC1_BOTH,       // as EPI_FC1_GELU, and f1 kept in aux (backward recompute)
};

struct Epi {
  const float* bias;
  float scale;          // EPI_QKV: q scale
  int n_scaled;         // EPI_QKV: columns [0, n_scaled) are q
  const void* x;        // EPI_PROJ_RESID: residual, original layout
  const void* x1;       // EPI_FC2_RESID_OUT: residual, window order
  const float* keep;    // [B, 2] per-sample droppath factors
  void* out;
  void* aux;            // EPI_FC1_BOTH: f1
  Geom g;
};

__device__ __forceinline__ float gelu_tanh(float x) {
  // jax.nn.gelu(approximate=True), same operation order as _gelu_tanh
  const float k0 = 0.7978845608028654f, c = 0.044715f;
  float u = k0 * (x + c * x * x * x);
  return 0.5f * x * (1.f + tanhf(u));
}

// One output element. `src` is row_source of row m (rows scattered back to
// the original layout), `b` the sample of row m.
template <typename T, int MODE>
__device__ __forceinline__ void epilogue(const Epi& e, int Nc, int m, int n,
                                         long long src, int b, float acc) {
  T* out = (T*)e.out;
  if (MODE == EPI_QKV) {
    float v = acc + e.bias[n];
    if (n < e.n_scaled) v *= e.scale;
    out[(size_t)m * Nc + n] = from_f<T>(v);
  } else if (MODE == EPI_PROJ_RESID) {
    float y = rnd<T>(acc + e.bias[n]);
    float xv = src < 0 ? 0.f : to_f(((const T*)e.x)[(size_t)src * Nc + n]);
    float ka = rnd<T>(e.keep[2 * b]);
    out[(size_t)m * Nc + n] = from_f<T>(xv + rnd<T>(y * ka));
  } else if (MODE == EPI_FC1_GELU || MODE == EPI_FC1_BOTH) {
    float f1 = rnd<T>(rnd<T>(acc) + rnd<T>(e.bias[n]));
    out[(size_t)m * Nc + n] = from_f<T>(gelu_tanh(f1));
    if (MODE == EPI_FC1_BOTH) ((T*)e.aux)[(size_t)m * Nc + n] = from_f<T>(f1);
  } else if (MODE == EPI_FC2_RESID_OUT) {
    if (src < 0) return;
    float f2 = rnd<T>(rnd<T>(acc) + rnd<T>(e.bias[n]));
    float km = rnd<T>(e.keep[2 * b + 1]);
    float x1 = to_f(((const T*)e.x1)[(size_t)m * Nc + n]);
    out[(size_t)src * Nc + n] = from_f<T>(x1 + rnd<T>(f2 * km));
  } else {  // EPI_PROJ_OUT
    if (src < 0) return;
    out[(size_t)src * Nc + n] = from_f<T>(acc + e.bias[n]);
  }
}

// bf16 tensor-core GEMM: 128x64 block tile, 8 warps of 32x32 (2x2 WMMA
// 16x16x16 fragments), f32 accumulation, K step 32. The accumulator tile is
// staged through shared memory so the epilogue writes coalesced rows.
// Needs K % 8 == 0 and 16-byte aligned A and W (checked by the caller).
constexpr int GB_M = 128, GB_N = 64, GB_K = 32;
constexpr int G_LDS = GB_K + 8;  // bf16 elements; 80-byte rows
constexpr int G_LDC = GB_N + 4;  // floats

template <int MODE>
__global__ void __launch_bounds__(256)
gemm_bf16(const bf16* __restrict__ A, const bf16* __restrict__ W, int M,
          int Nc, int K, Epi e) {
  using namespace nvcuda;
  __shared__ __align__(128) unsigned char smem[GB_M * G_LDC * 4];
  __shared__ long long row_src[GB_M];
  __shared__ int row_b[GB_M];
  bf16* As = (bf16*)smem;
  bf16* Bs = As + GB_M * G_LDS;
  float* Cs = (float*)smem;  // reused after the main loop

  const int tid = threadIdx.x, warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;
  const int m0 = blockIdx.y * GB_M, n0 = blockIdx.x * GB_N;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += GB_K) {
    for (int v = tid; v < GB_M * GB_K / 8; v += 256) {
      int r = v / (GB_K / 8), c = (v % (GB_K / 8)) * 8;
      int gm = m0 + r, gk = k0 + c;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (gm < M && gk < K) val = *(const uint4*)(A + (size_t)gm * K + gk);
      *(uint4*)(As + r * G_LDS + c) = val;
    }
    for (int v = tid; v < GB_N * GB_K / 8; v += 256) {
      int r = v / (GB_K / 8), c = (v % (GB_K / 8)) * 8;
      int gn = n0 + r, gk = k0 + c;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (gn < Nc && gk < K) val = *(const uint4*)(W + (size_t)gn * K + gk);
      *(uint4*)(Bs + r * G_LDS + c) = val;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GB_K; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wm * 32 + i * 16) * G_LDS + kk, G_LDS);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bfr[j], Bs + (wn * 32 + j * 16) * G_LDS + kk, G_LDS);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], bfr[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * G_LDC + wn * 32 + j * 16,
                              acc[i][j], G_LDC, wmma::mem_row_major);
  if (tid < GB_M) {
    long long m = (long long)m0 + tid;
    row_src[tid] = m < M ? row_source(e.g, m) : -1;
    row_b[tid] = (int)(m / ((long long)e.g.nW * e.g.N));
  }
  __syncthreads();
  for (int idx = tid; idx < GB_M * GB_N; idx += 256) {
    int r = idx / GB_N, c = idx % GB_N;
    int m = m0 + r, n = n0 + c;
    if (m < M && n < Nc)
      epilogue<bf16, MODE>(e, Nc, m, n, row_src[r], row_b[r], Cs[r * G_LDC + c]);
  }
}

// float32 GEMM on the FMA units: 64x64 block tile, 4x4 per thread. Used by
// the float32 configuration only.
template <int MODE>
__global__ void __launch_bounds__(256)
gemm_f32(const float* __restrict__ A, const float* __restrict__ W, int M,
         int Nc, int K, Epi e) {
  constexpr int TM = 64, TN = 64, TK = 16;
  __shared__ float As[TK][TM + 4];
  __shared__ float Bs[TK][TN + 4];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += TK) {
    for (int v = tid; v < TM * TK; v += 256) {
      int r = v / TK, k = v % TK;
      int gm = m0 + r, gn = n0 + r, gk = k0 + k;
      As[k][r] = (gm < M && gk < K) ? A[(size_t)gm * K + gk] : 0.f;
      Bs[k][r] = (gn < Nc && gk < K) ? W[(size_t)gn * K + gk] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < TK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  for (int i = 0; i < 4; ++i) {
    int m = m0 + ty * 4 + i;
    if (m >= M) continue;
    long long src = row_source(e.g, m);
    int b = (int)(m / ((long long)e.g.nW * e.g.N));
    for (int j = 0; j < 4; ++j) {
      int n = n0 + tx * 4 + j;
      if (n < Nc) epilogue<float, MODE>(e, Nc, m, n, src, b, acc[i][j]);
    }
  }
}

template <typename T, int MODE>
inline cudaError_t launch_gemm(const T* A, const T* W, int M, int Nc, int K,
                               const Epi& e, cudaStream_t st) {
  if (sizeof(T) == 2) {
    dim3 grid((Nc + GB_N - 1) / GB_N, (M + GB_M - 1) / GB_M);
    gemm_bf16<MODE><<<grid, 256, 0, st>>>((const bf16*)A, (const bf16*)W, M, Nc, K, e);
  } else {
    dim3 grid((Nc + 63) / 64, (M + 63) / 64);
    gemm_f32<MODE><<<grid, 256, 0, st>>>((const float*)A, (const float*)W, M, Nc, K, e);
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Window attention: one block per (window, head). q (already scaled and
// rounded to T by the qkv epilogue), k and v of the window's N tokens are
// staged in shared memory as float; logits, relative-position bias, shift
// mask (-100 between region labels) and the softmax stay in float32; p is
// rounded to T before p @ v, as in the JAX kernel.
// ---------------------------------------------------------------------------

inline size_t attn_smem_bytes(int N, int hd) {
  return sizeof(float) * ((size_t)N * hd * 2 + (size_t)N * (hd + 1) +
                          (size_t)N * (N + 1)) +
         sizeof(int) * N;
}

template <typename T>
__global__ void __launch_bounds__(256)
window_attn(const T* __restrict__ qkv, const float* __restrict__ rel_bias,
            Geom g, int C, int heads, int has_shift, T* __restrict__ o) {
  extern __shared__ float sm[];
  const int N = g.N, hd = C / heads;
  const int bw = blockIdx.x, h = blockIdx.y, w = bw % g.nW;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  float* q = sm;
  float* k = q + N * hd;
  float* v = k + N * (hd + 1);
  float* P = v + N * hd;
  int* lab = (int*)(P + N * (N + 1));

  const size_t base = (size_t)bw * N * 3 * C;
  for (int idx = tid; idx < N * hd; idx += 256) {
    int i = idx / hd, d = idx % hd;
    const T* row = qkv + base + (size_t)i * 3 * C + h * hd + d;
    q[i * hd + d] = to_f(row[0]);
    k[i * (hd + 1) + d] = to_f(row[C]);
    v[i * hd + d] = to_f(row[2 * C]);
  }
  if (has_shift)
    for (int t = tid; t < N; t += 256) lab[t] = region_label(g, w, t);
  __syncthreads();

  const float* rb = rel_bias + (size_t)h * N * N;
  for (int idx = tid; idx < N * N; idx += 256) {
    int i = idx / N, j = idx % N;
    float s = 0.f;
    for (int d = 0; d < hd; ++d) s = fmaf(q[i * hd + d], k[j * (hd + 1) + d], s);
    s += rb[idx];
    if (has_shift && lab[i] != lab[j]) s += -100.f;
    P[i * (N + 1) + j] = s;
  }
  __syncthreads();

  for (int i = warp; i < N; i += 8) {
    float* pr = P + i * (N + 1);
    float mx = -INFINITY;
    for (int j = lane; j < N; j += 32) mx = fmaxf(mx, pr[j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < N; j += 32) {
      float ex = expf(pr[j] - mx);
      pr[j] = ex;
      sum += ex;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < N; j += 32) pr[j] = rnd<T>(pr[j] / sum);
  }
  __syncthreads();

  for (int idx = tid; idx < N * hd; idx += 256) {
    int i = idx / hd, d = idx % hd;
    const float* pr = P + i * (N + 1);
    float s = 0.f;
    for (int j = 0; j < N; ++j) s = fmaf(pr[j], v[j * hd + d], s);
    o[((size_t)bw * N + i) * C + h * hd + d] = from_f<T>(s);
  }
}

template <typename T>
inline cudaError_t launch_attn(const T* qkv, const float* rel_bias,
                               const Geom& g, int C, int heads, T* o,
                               cudaStream_t st) {
  size_t smem = attn_smem_bytes(g.N, C / heads);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        window_attn<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  int has_shift = (g.s0 + g.s1 + g.s2) > 0;
  dim3 grid(g.B * g.nW, heads);
  window_attn<T><<<grid, 256, smem, st>>>(qkv, rel_bias, g, C, heads, has_shift, o);
  return cudaGetLastError();
}


// ===========================================================================
// Backward building blocks.
//
// The TPU backward kernels add the weight, bias, LayerNorm and logit
// gradients into outputs that stay resident across a sequential grid. CUDA
// blocks run concurrently and in no order, so every such sum is split here:
// each block writes a float32 partial over its share of the rows, and one
// more launch (sum_parts) adds the partials in a fixed order. There are no
// float atomics, so every result is deterministic.
// ===========================================================================

__device__ __forceinline__ float gelu_tanh_grad(float x) {
  // _gelu_tanh_grad of the JAX kernel, same operation order
  const float k0 = 0.7978845608028654f, c = 0.044715f;
  float u = k0 * (x + c * x * x * x);
  float t = tanhf(u);
  float du = k0 * (1.f + 3.f * c * x * x);
  return 0.5f * (1.f + t) + 0.5f * x * (1.f - t * t) * du;
}

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

// out[n] = sum_m src[m, n] (float32), deterministic. part holds
// colsum_parts(M) * N floats.
template <typename S>
inline cudaError_t launch_colsum(const S* src, long long M, int N, float* part,
                                 float* out, cudaStream_t st) {
  const int P = colsum_parts(M);
  const long long rows_per = (M + P - 1) / P;
  colsum_part<S><<<dim3((N + 31) / 32, P), 256, 0, st>>>(src, M, N, rows_per, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_sum_parts(part, P, N, out, st);
}

// ---------------------------------------------------------------------------
// Backward products, float32 accumulation:
//   FORM_NN: C[m, n] = sum_k A[m, k] B[k, n], A row-major [M, K]
//            (dh = d @ W, W the torch-layout [K, N] weight);
//   FORM_TN: C[m, n] = sum_k A[k, m] B[k, n], A row-major [K, M]
//            (dW = D^T H, the sum running over the token rows).
// B is row-major [K, N]. Both operands are rounded to the compute type T on
// their way into shared memory: the JAX kernel's `.astype(d)` of a float32
// gradient before its product. The K range is split over blockIdx.z; with
// E2_STORE each split writes its own partial at out + z * M * N, which
// sum_parts adds in order.
// ---------------------------------------------------------------------------

enum Form { FORM_NN = 0, FORM_TN };

enum Epilogue2 {
  E2_STORE = 0,   // out[z][m, n] = acc
  E2_GELU_GRAD,   // out[m, n] = acc * gelu_tanh_grad(aux[m, n]), aux = f1 in T
  E2_SCATTER,     // out_t[row_source(m), n] = T(acc); pad rows dropped
};

struct Epi2 {
  float* out;
  const void* aux;
  void* out_t;
  Geom g;
};

template <typename T, int EPI>
__device__ __forceinline__ void epilogue2(const Epi2& e, int M, int N, int m,
                                          int n, long long src, float acc) {
  const size_t i = (size_t)m * N + n;
  if (EPI == E2_STORE) {
    e.out[(size_t)blockIdx.z * M * N + i] = acc;
  } else if (EPI == E2_GELU_GRAD) {
    e.out[i] = acc * gelu_tanh_grad(to_f(((const T*)e.aux)[i]));
  } else if (src >= 0) {
    ((T*)e.out_t)[(size_t)src * N + n] = from_f<T>(acc);
  }
}

// bf16 tensor cores: the forward GEMM's 128x64 tile and warp layout.
constexpr int G2_LDA_NN = GB_K + 8;  // As[m][k]
constexpr int G2_LDA_TN = GB_M + 8;  // As[k][m]
constexpr int G2_LDB = GB_N + 8;     // Bs[k][n]
constexpr int G2_BS_OFF = GB_M * G2_LDA_NN;  // >= GB_K * G2_LDA_TN

template <int FORM, int EPI, typename SA, typename SB>
__global__ void __launch_bounds__(256)
gemm2_bf16(const SA* __restrict__ A, const SB* __restrict__ B, int M, int N,
           long long K, long long k_per_split, Epi2 e) {
  using namespace nvcuda;
  __shared__ __align__(128) unsigned char smem[GB_M * G_LDC * 4];
  __shared__ long long row_src[GB_M];
  bf16* As = (bf16*)smem;
  bf16* Bs = As + G2_BS_OFF;
  float* Cs = (float*)smem;  // reused after the main loop

  const int tid = threadIdx.x, warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;
  const int m0 = blockIdx.y * GB_M, n0 = blockIdx.x * GB_N;
  const long long kb = (long long)blockIdx.z * k_per_split;
  const long long ke = kb + k_per_split < K ? kb + k_per_split : K;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (long long k0 = kb; k0 < ke; k0 += GB_K) {
    if (FORM == FORM_NN) {
      for (int v = tid; v < GB_M * GB_K; v += 256) {
        int r = v / GB_K, c = v % GB_K;
        long long gk = k0 + c;
        int gm = m0 + r;
        float a = (gm < M && gk < ke) ? to_f(A[(size_t)gm * K + gk]) : 0.f;
        As[r * G2_LDA_NN + c] = from_f<bf16>(a);
      }
    } else {
      for (int v = tid; v < GB_M * GB_K; v += 256) {
        int r = v / GB_M, c = v % GB_M;  // r: k, c: m
        long long gk = k0 + r;
        int gm = m0 + c;
        float a = (gm < M && gk < ke) ? to_f(A[(size_t)gk * M + gm]) : 0.f;
        As[r * G2_LDA_TN + c] = from_f<bf16>(a);
      }
    }
    for (int v = tid; v < GB_K * GB_N; v += 256) {
      int r = v / GB_N, c = v % GB_N;
      long long gk = k0 + r;
      int gn = n0 + c;
      float b = (gn < N && gk < ke) ? to_f(B[(size_t)gk * N + gn]) : 0.f;
      Bs[r * G2_LDB + c] = from_f<bf16>(b);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GB_K; kk += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr[2];
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bfr[j], Bs + kk * G2_LDB + wn * 32 + j * 16, G2_LDB);
      if constexpr (FORM == FORM_NN) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(a[i], As + (wm * 32 + i * 16) * G2_LDA_NN + kk,
                                 G2_LDA_NN);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], bfr[j], acc[i][j]);
      } else {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(a[i], As + kk * G2_LDA_TN + wm * 32 + i * 16,
                                 G2_LDA_TN);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], bfr[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * G_LDC + wn * 32 + j * 16,
                              acc[i][j], G_LDC, wmma::mem_row_major);
  if (tid < GB_M) {
    long long m = (long long)m0 + tid;
    row_src[tid] = (EPI == E2_SCATTER && m < M) ? row_source(e.g, m) : -1;
  }
  __syncthreads();
  for (int idx = tid; idx < GB_M * GB_N; idx += 256) {
    int r = idx / GB_N, c = idx % GB_N;
    int m = m0 + r, n = n0 + c;
    if (m < M && n < N)
      epilogue2<bf16, EPI>(e, M, N, m, n, row_src[r], Cs[r * G_LDC + c]);
  }
}

// float32 on the FMA units, 64x64 tile, 4x4 per thread: the float32
// configuration only.
template <int FORM, int EPI, typename SA, typename SB>
__global__ void __launch_bounds__(256)
gemm2_f32(const SA* __restrict__ A, const SB* __restrict__ B, int M, int N,
          long long K, long long k_per_split, Epi2 e) {
  constexpr int TM = 64, TN = 64, TK = 16;
  __shared__ float As[TK][TM + 4];
  __shared__ float Bs[TK][TN + 4];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  const long long kb = (long long)blockIdx.z * k_per_split;
  const long long ke = kb + k_per_split < K ? kb + k_per_split : K;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (long long k0 = kb; k0 < ke; k0 += TK) {
    for (int v = tid; v < TM * TK; v += 256) {
      int r, k;
      if (FORM == FORM_NN) { r = v / TK; k = v % TK; } else { k = v / TM; r = v % TM; }
      int gm = m0 + r;
      long long gk = k0 + k;
      float a = 0.f;
      if (gm < M && gk < ke)
        a = to_f(FORM == FORM_NN ? A[(size_t)gm * K + gk] : A[(size_t)gk * M + gm]);
      As[k][r] = a;
      int kb2 = v / TN, c = v % TN, gn = n0 + c;
      long long gk2 = k0 + kb2;
      Bs[kb2][c] = (gn < N && gk2 < ke) ? to_f(B[(size_t)gk2 * N + gn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < TK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  for (int i = 0; i < 4; ++i) {
    int m = m0 + ty * 4 + i;
    if (m >= M) continue;
    long long src = EPI == E2_SCATTER ? row_source(e.g, m) : -1;
    for (int j = 0; j < 4; ++j) {
      int n = n0 + tx * 4 + j;
      if (n < N) epilogue2<float, EPI>(e, M, N, m, n, src, acc[i][j]);
    }
  }
}

// T is the compute type: bf16 runs the tensor-core kernel, float the FMA one.
// `splits` cuts K into ranges of whole K tiles (E2_STORE only).
template <typename T, int FORM, int EPI, typename SA, typename SB>
inline cudaError_t launch_gemm2(const SA* A, const SB* B, int M, int N,
                                long long K, int splits, const Epi2& e,
                                cudaStream_t st) {
  long long per = (K + splits - 1) / splits;
  per = (per + GB_K - 1) / GB_K * GB_K;
  if constexpr (sizeof(T) == 2) {
    dim3 grid((N + GB_N - 1) / GB_N, (M + GB_M - 1) / GB_M, splits);
    gemm2_bf16<FORM, EPI, SA, SB><<<grid, 256, 0, st>>>(A, B, M, N, K, per, e);
  } else {
    dim3 grid((N + 63) / 64, (M + 63) / 64, splits);
    gemm2_f32<FORM, EPI, SA, SB><<<grid, 256, 0, st>>>(A, B, M, N, K, per, e);
  }
  return cudaGetLastError();
}

// Row splits of a weight-gradient product: ranges of at least 2048 rows,
// at most 64 of them.
inline int wgrad_splits(long long rows) {
  long long s = (rows + 2047) / 2048;
  return (int)(s < 1 ? 1 : (s > 64 ? 64 : s));
}

// out[n1, n2] = sum_r T(D[r, n1]) * T(H[r, n2]) over `rows` rows, in float32:
// split-row partials, then a fixed-order sum. part holds
// wgrad_splits(rows) * n1 * n2 floats.
template <typename T, typename SA, typename SB>
inline cudaError_t weight_grad(const SA* D, const SB* H, long long rows, int n1,
                               int n2, float* part, float* out, cudaStream_t st) {
  const int S = wgrad_splits(rows);
  Epi2 e = {};
  e.out = part;
  cudaError_t err = launch_gemm2<T, FORM_TN, E2_STORE>(D, H, n1, n2, rows, S, e, st);
  if (err != cudaSuccess) return err;
  return launch_sum_parts(part, S, (long long)n1 * n2, out, st);
}

// ---------------------------------------------------------------------------
// Window attention backward: one block per (group of windows, head). Per
// window it recomputes p (float32, as the forward) from the T-rounded q
// (already scaled), k, v, the bias and the shift mask, then
//   dp = T(do) v^T, dv = T(p)^T T(do), dl = p * (dp - rowsum(dp * p)),
//   dq = (T(dl) k) * scale, dk = T(dl)^T q,
// written into dqkv [M, 3C] (float32, the qkv column layout). The group's
// dl are summed in window order into dlogit_part[group, head]; sum_parts
// then adds the groups in order.
// ---------------------------------------------------------------------------

inline size_t attn_bwd_smem_bytes(int N, int hd) {
  return sizeof(float) * (4 * (size_t)N * (hd + 1) + 2 * (size_t)N * (N + 1) +
                          (size_t)N * N) +
         sizeof(int) * N;
}

// Windows per block: groups of enough windows that at most ~1024 groups
// (each a [heads, N, N] partial) are written.
inline int attn_bwd_windows_per_group(long long n_win) {
  return (int)((n_win + 1023) / 1024);
}

template <typename T>
__global__ void __launch_bounds__(256)
window_attn_bwd(const T* __restrict__ qkv, const float* __restrict__ dout,
                const float* __restrict__ rel_bias, Geom g, int C, int heads,
                int has_shift, int wpg, int n_win, float scale,
                float* __restrict__ dqkv, float* __restrict__ dlogit_part) {
  extern __shared__ float sm[];
  const int N = g.N, hd = C / heads, ld = hd + 1, lp = N + 1;
  const int grp = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  float* q = sm;
  float* k = q + N * ld;
  float* v = k + N * ld;
  float* dO = v + N * ld;
  float* P = dO + N * ld;
  float* D = P + N * lp;
  float* acc = D + N * lp;
  int* lab = (int*)(acc + N * N);
  for (int idx = tid; idx < N * N; idx += 256) acc[idx] = 0.f;
  const float* rb = rel_bias + (size_t)h * N * N;
  const int w_end = (grp + 1) * wpg < n_win ? (grp + 1) * wpg : n_win;

  for (int bw = grp * wpg; bw < w_end; ++bw) {
    const int w = bw % g.nW;
    const size_t row0 = (size_t)bw * N;
    __syncthreads();  // the previous window is done with shared memory
    for (int idx = tid; idx < N * hd; idx += 256) {
      int i = idx / hd, d = idx % hd;
      const T* r = qkv + (row0 + i) * 3 * C + h * hd + d;
      q[i * ld + d] = to_f(r[0]);
      k[i * ld + d] = to_f(r[C]);
      v[i * ld + d] = to_f(r[2 * C]);
      dO[i * ld + d] = rnd<T>(dout[(row0 + i) * C + h * hd + d]);
    }
    if (has_shift)
      for (int t = tid; t < N; t += 256) lab[t] = region_label(g, w, t);
    __syncthreads();

    for (int idx = tid; idx < N * N; idx += 256) {
      int i = idx / N, j = idx % N;
      float s = 0.f, dp = 0.f;
      for (int d = 0; d < hd; ++d) {
        s = fmaf(q[i * ld + d], k[j * ld + d], s);
        dp = fmaf(dO[i * ld + d], v[j * ld + d], dp);
      }
      s += rb[idx];
      if (has_shift && lab[i] != lab[j]) s += -100.f;
      P[i * lp + j] = s;
      D[i * lp + j] = dp;
    }
    __syncthreads();

    for (int i = warp; i < N; i += 8) {
      float* pr = P + i * lp;
      float* dr = D + i * lp;
      float mx = -INFINITY;
      for (int j = lane; j < N; j += 32) mx = fmaxf(mx, pr[j]);
      mx = warp_max(mx);
      float sum = 0.f;
      for (int j = lane; j < N; j += 32) {
        float ex = expf(pr[j] - mx);
        pr[j] = ex;
        sum += ex;
      }
      sum = warp_sum(sum);
      float dot = 0.f;
      for (int j = lane; j < N; j += 32) {
        pr[j] = pr[j] / sum;
        dot += dr[j] * pr[j];
      }
      dot = warp_sum(dot);
      for (int j = lane; j < N; j += 32) {
        float dl = pr[j] * (dr[j] - dot);
        dr[j] = dl;
        acc[i * N + j] += dl;
      }
    }
    __syncthreads();

    for (int idx = tid; idx < N * hd; idx += 256) {
      int i = idx / hd, d = idx % hd;
      float dq = 0.f, dk = 0.f, dv = 0.f;
      for (int j = 0; j < N; ++j) {
        dq = fmaf(rnd<T>(D[i * lp + j]), k[j * ld + d], dq);
        dk = fmaf(rnd<T>(D[j * lp + i]), q[j * ld + d], dk);
        dv = fmaf(rnd<T>(P[j * lp + i]), dO[j * ld + d], dv);
      }
      float* out = dqkv + (row0 + i) * 3 * C + h * hd + d;
      out[0] = dq * scale;
      out[C] = dk;
      out[2 * C] = dv;
    }
  }
  __syncthreads();
  float* part = dlogit_part + ((size_t)grp * heads + h) * N * N;
  for (int idx = tid; idx < N * N; idx += 256) part[idx] = acc[idx];
}

// dqkv [M, 3C] and dlogit [heads, N, N] from qkv (T) and do (float32).
// part holds attn_bwd_part_floats(...) floats.
inline long long attn_bwd_part_floats(const Geom& g, int heads) {
  const long long n_win = (long long)g.B * g.nW;
  const int wpg = attn_bwd_windows_per_group(n_win);
  return (n_win + wpg - 1) / wpg * heads * (long long)g.N * g.N;
}

template <typename T>
inline cudaError_t launch_attn_bwd(const T* qkv, const float* dout,
                                   const float* rel_bias, const Geom& g, int C,
                                   int heads, float scale, float* dqkv,
                                   float* part, float* dlogit, cudaStream_t st) {
  const size_t smem = attn_bwd_smem_bytes(g.N, C / heads);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        window_attn_bwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int n_win = g.B * g.nW;
  const int wpg = attn_bwd_windows_per_group(n_win);
  const int groups = (n_win + wpg - 1) / wpg;
  const int has_shift = (g.s0 + g.s1 + g.s2) > 0;
  window_attn_bwd<T><<<dim3(groups, heads), 256, smem, st>>>(
      qkv, dout, rel_bias, g, C, heads, has_shift, wpg, n_win, scale, dqkv, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_sum_parts(part, groups, (long long)heads * g.N * g.N, dlogit, st);
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
