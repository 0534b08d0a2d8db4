// Building blocks shared by the fused Swin-block and fused window-attention
// forward kernels (fused_block.cu, fused_attention.cu).
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
};

struct Epi {
  const float* bias;
  float scale;          // EPI_QKV: q scale
  int n_scaled;         // EPI_QKV: columns [0, n_scaled) are q
  const void* x;        // EPI_PROJ_RESID: residual, original layout
  const void* x1;       // EPI_FC2_RESID_OUT: residual, window order
  const float* keep;    // [B, 2] per-sample droppath factors
  void* out;
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
  } else if (MODE == EPI_FC1_GELU) {
    float f1 = rnd<T>(rnd<T>(acc) + rnd<T>(e.bias[n]));
    out[(size_t)m * Nc + n] = from_f<T>(gelu_tanh(f1));
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

}  // namespace swin
