// Window attention of the fused Swin-block and window-attention kernels,
// forward and backward.
//
// bf16 (window_attn_tc, window_attn_bwd_tc): the tensor cores, mma.sync
// m16n8k16 with float32 accumulators. One CTA of 4 warps takes one head of
// a group of windows, so the head's [N, N] relative-position bias is read
// into shared memory once per CTA; q, k, v (and do) of each window are
// staged in shared memory as bf16 with 16-byte loads, padded to 64 tokens
// and to a head dim of 16, 32 or 64 with zeros. Warp w owns query rows
// [16 w, 16 w + 16): S = q k^T stays in registers, the bias, the shift mask
// (-100 between region labels) and the softmax are float32 there, and p is
// rounded to bf16 as the A operand of p v (the JAX rounding point). The
// backward recomputes p, then dp = T(do) v^T, dl = p (dp - rowsum(dp p)),
// dq = (T(dl) k) scale in registers; T(p) and T(dl) go through shared
// memory for dv = T(p)^T T(do) and dk = T(dl)^T q. dlogit is summed per CTA
// over its windows in registers and the qkv bias sums per CTA over its rows;
// both are written as partials that fixed-order passes add (deterministic).
// What bounds it: ~4 N hd FLOPs per token and head forward, 12 N hd
// backward, against q, k, v, o (and do, dqkv) in bf16: the bytes, at
// hd = 32.
//
// bf16, any other shape (window_attn_gen, window_attn_bwd_gen): windows of
// more than 64 tokens (e.g. 4 x 4 x 8) or heads wider than 64 also run on
// mma.sync, one window at a time in shared memory, keys in blocks of 64 with
// the softmax statistics recomputed per pass; see their section below.
//
// float32 (window_attn_fma, window_attn_bwd_fma): one block per (window or
// window group, head) on the FMA units, the float32 configuration only.
#pragma once

namespace swin {

// Relative-position bias of head h between window tokens i and j, read from
// the [(2 w0 - 1)(2 w1 - 1)(2 w2 - 1), heads] float32 table: the index of
// relative_position_index_3d computed instead of gathered.
__device__ __forceinline__ float rel_table_at(const float* table, int heads, const Geom& g, int h,
                                             int i, int j) {
  const int a = i / (g.w1 * g.w2) - j / (g.w1 * g.w2) + g.w0 - 1;
  const int b = (i / g.w2) % g.w1 - (j / g.w2) % g.w1 + g.w1 - 1;
  const int c = i % g.w2 - j % g.w2 + g.w2 - 1;
  return table[((a * (2 * g.w1 - 1) + b) * (2 * g.w2 - 1) + c) * heads + h];
}

// ---------------------------------------------------------------------------
// float32 configuration
// ---------------------------------------------------------------------------

inline size_t attn_fma_smem_bytes(int N, int hd) {
  return sizeof(float) * ((size_t)N * hd * 2 + (size_t)N * (hd + 1) + (size_t)N * (N + 1)) +
         sizeof(int) * N;
}

__global__ void __launch_bounds__(256)
window_attn_fma(const float* __restrict__ qkv, const float* __restrict__ rel_table, Geom g,
                int C, int heads, int has_shift, float* __restrict__ o) {
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
    const float* row = qkv + base + (size_t)i * 3 * C + h * hd + d;
    q[i * hd + d] = row[0];
    k[i * (hd + 1) + d] = row[C];
    v[i * hd + d] = row[2 * C];
  }
  if (has_shift)
    for (int t = tid; t < N; t += 256) lab[t] = region_label(g, w, t);
  __syncthreads();

  for (int idx = tid; idx < N * N; idx += 256) {
    int i = idx / N, j = idx % N;
    float s = 0.f;
    for (int d = 0; d < hd; ++d) s = fmaf(q[i * hd + d], k[j * (hd + 1) + d], s);
    s += rel_table_at(rel_table, heads, g, h, i, j);
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
    for (int j = lane; j < N; j += 32) pr[j] = pr[j] / sum;
  }
  __syncthreads();

  for (int idx = tid; idx < N * hd; idx += 256) {
    int i = idx / hd, d = idx % hd;
    const float* pr = P + i * (N + 1);
    float s = 0.f;
    for (int j = 0; j < N; ++j) s = fmaf(pr[j], v[j * hd + d], s);
    o[((size_t)bw * N + i) * C + h * hd + d] = s;
  }
}

inline size_t attn_bwd_fma_smem_bytes(int N, int hd) {
  return sizeof(float) * (4 * (size_t)N * (hd + 1) + 2 * (size_t)N * (N + 1) + (size_t)N * N) +
         sizeof(int) * N;
}

// Windows per block of window_attn_bwd_fma: at most ~1024 groups.
inline int attn_bwd_fma_windows_per_group(long long n_win) {
  return (int)((n_win + 1023) / 1024);
}

__global__ void __launch_bounds__(256)
window_attn_bwd_fma(const float* __restrict__ qkv, const float* __restrict__ dout,
                    const float* __restrict__ rel_table, Geom g, int C, int heads,
                    int has_shift, int wpg, int n_win, float scale, float* __restrict__ dqkv,
                    float* __restrict__ dlogit_part) {
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
  const int w_end = (grp + 1) * wpg < n_win ? (grp + 1) * wpg : n_win;

  for (int bw = grp * wpg; bw < w_end; ++bw) {
    const int w = bw % g.nW;
    const size_t row0 = (size_t)bw * N;
    __syncthreads();  // the previous window is done with shared memory
    for (int idx = tid; idx < N * hd; idx += 256) {
      int i = idx / hd, d = idx % hd;
      const float* r = qkv + (row0 + i) * 3 * C + h * hd + d;
      q[i * ld + d] = r[0];
      k[i * ld + d] = r[C];
      v[i * ld + d] = r[2 * C];
      dO[i * ld + d] = dout[(row0 + i) * C + h * hd + d];
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
      s += rel_table_at(rel_table, heads, g, h, i, j);
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
        dq = fmaf(D[i * lp + j], k[j * ld + d], dq);
        dk = fmaf(D[j * lp + i], q[j * ld + d], dk);
        dv = fmaf(P[j * lp + i], dO[j * ld + d], dv);
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

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int AT_NP = 64;           // window tokens, padded
constexpr int AT_LDP = AT_NP + 8;   // row stride of P, dl (bf16) and bias (f32)

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// d[16 x 8] += a[16 x 16] b[16 x 8], bf16 in, float32 accumulators.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *(uint32_t*)&v;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// dst[i][d] = src[row0 + i][col0 + d] for i < N, d < hd (bf16, dst rows of
// LD), with 16-byte cp.async where the columns allow (in flight until
// cp_wait); the rest of dst is left as it is (zero from the start).
__device__ __forceinline__ void load_head(bf16* dst, int LD, const bf16* src, size_t row0,
                                          int ld, int col0, int N, int hd, int tid) {
  if ((hd % 8) == 0 && (ld % 8) == 0 && (col0 % 8) == 0) {
    const int vec = hd / 8;
    for (int v = tid; v < N * vec; v += 128) {
      const int i = v / vec, u = v % vec;
      cp_async16(dst + i * LD + 8 * u, src + (row0 + i) * ld + col0 + 8 * u);
    }
  } else {
    for (int v = tid; v < N * hd; v += 128) {
      const int i = v / hd, d = v % hd;
      dst[i * LD + d] = src[(row0 + i) * ld + col0 + d];
    }
  }
}

// Window bw's q, k, v (and do when NH == 4) of head h into one buffer set
// [NH][AT_NP][HDP + 8], and its region labels.
template <int HDP, int NH>
__device__ __forceinline__ void stage_window(bf16* set, int* lab, const bf16* qkv,
                                             const bf16* dout, const Geom& g, int bw, int C,
                                             int hd, int h, int has_shift, int tid) {
  constexpr size_t HE = (size_t)AT_NP * (HDP + 8);
  const size_t row0 = (size_t)bw * g.N;
#pragma unroll
  for (int k = 0; k < 3; ++k)
    load_head(set + k * HE, HDP + 8, qkv, row0, 3 * C, k * C + h * hd, g.N, hd, tid);
  if (NH == 4) load_head(set + 3 * HE, HDP + 8, dout, row0, C, h * hd, g.N, hd, tid);
  if (has_shift)
    for (int t = tid; t < g.N; t += 128) lab[t] = region_label(g, bw % g.nW, t);
}

// s[t][c] = (X Y^T)[i][j], X, Y [64][HDP + 8] in shared memory, for this
// warp's rows i = 16 w + lane / 4 (+8 for c >= 2) and columns
// j = 8 t + 2 (lane % 4) + (c & 1).
template <int HDP>
__device__ __forceinline__ void xyT_tile(float (&s)[8][4], const bf16* X, const bf16* Y, int w,
                                         int lane) {
  constexpr int LD = HDP + 8;
#pragma unroll
  for (int t = 0; t < 8; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, X + (16 * w + lane % 16) * LD + kk * 16 + 8 * (lane / 16));
#pragma unroll
    for (int tp = 0; tp < 4; ++tp) {
      uint32_t b[4];
      ldsm_x4(b, Y + (16 * tp + lane % 8 + 8 * (lane / 16)) * LD + kk * 16 + 8 * ((lane / 8) % 2));
      mma16816(s[2 * tp], a, b[0], b[1]);
      mma16816(s[2 * tp + 1], a, b[2], b[3]);
    }
  }
}

// o[dt][c] = (T(p) Y)[i][d], p this warp's [16, 64] float32 fragment (as
// from xyT_tile), Y [64][HDP + 8]; d = 8 dt + 2 (lane % 4) + (c & 1).
template <int HDP>
__device__ __forceinline__ void pY_tile(float (&o)[HDP / 8][4], const float (&p)[8][4],
                                        const bf16* Y, int lane) {
  constexpr int LD = HDP + 8;
#pragma unroll
  for (int t = 0; t < HDP / 8; ++t) o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    const uint32_t a[4] = {pack_bf16(p[2 * kc][0], p[2 * kc][1]),
                           pack_bf16(p[2 * kc][2], p[2 * kc][3]),
                           pack_bf16(p[2 * kc + 1][0], p[2 * kc + 1][1]),
                           pack_bf16(p[2 * kc + 1][2], p[2 * kc + 1][3])};
#pragma unroll
    for (int dp = 0; dp < HDP / 16; ++dp) {
      uint32_t b[4];
      ldsm_x4_t(b, Y + (16 * kc + lane % 8 + 8 * ((lane / 8) % 2)) * LD + 16 * dp + 8 * (lane / 16));
      mma16816(o[2 * dp], a, b[0], b[1]);
      mma16816(o[2 * dp + 1], a, b[2], b[3]);
    }
  }
}

// o[dt][c] = (X^T Y)[j][d] for this warp's rows j = 16 w + lane / 4 (+8):
// X [64][AT_LDP] (bf16 p or dl by query row), Y [64][HDP + 8].
template <int HDP>
__device__ __forceinline__ void xTY_tile(float (&o)[HDP / 8][4], const bf16* X, const bf16* Y,
                                         int w, int lane) {
  constexpr int LD = HDP + 8;
#pragma unroll
  for (int t = 0; t < HDP / 8; ++t) o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    uint32_t a[4];
    ldsm_x4_t(a, X + (16 * kc + lane % 8 + 8 * (lane / 16)) * AT_LDP + 16 * w + 8 * ((lane / 8) % 2));
#pragma unroll
    for (int dp = 0; dp < HDP / 16; ++dp) {
      uint32_t b[4];
      ldsm_x4_t(b, Y + (16 * kc + lane % 8 + 8 * ((lane / 8) % 2)) * LD + 16 * dp + 8 * (lane / 16));
      mma16816(o[2 * dp], a, b[0], b[1]);
      mma16816(o[2 * dp + 1], a, b[2], b[3]);
    }
  }
}

// Logits to probabilities in place: + bias (shared, [64][AT_LDP]) + shift
// mask, keys j >= N excluded, float32 softmax over each row.
__device__ __forceinline__ void softmax_tile(float (&s)[8][4], const float* bias, const int* lab,
                                             int has_shift, int N, int w, int lane) {
  const int ia = 16 * w + lane / 4, ib = ia + 8;
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = c < 2 ? ia : ib, j = 8 * t + 2 * (lane % 4) + (c & 1);
      float v = s[t][c] + bias[i * AT_LDP + j];
      if (has_shift && lab[i] != lab[j]) v += -100.f;
      s[t][c] = j < N ? v : -INFINITY;
    }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int c = 0; c < 4; ++c) mx[c / 2] = fmaxf(mx[c / 2], s[t][c]);
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
  }
  // e^x below e^-80 (a share below 2^-115 of the row's sum, e.g. a masked
  // pair at -100) is flushed to zero, as the TPU flushes subnormals, and
  // expf never sees such an x: its out-of-range path and the division of a
  // subnormal made shifted windows ~1.6x slower
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float x = s[t][c] - mx[c / 2];
      const float ex = x < -80.f ? 0.f : expf(fmaxf(x, -80.f));
      s[t][c] = ex;
      sum[c / 2] += ex;
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
  }
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[t][c] = s[t][c] / sum[c / 2];
}

// Rows i = 16 w + lane / 4 (+8) of a [*, hd] head block at out + col0
// (row stride ld) from a fragment; rows >= N and columns >= hd dropped.
// Adds each row pair's values into cs (column sums).
template <int HDP>
__device__ __forceinline__ void store_head(bf16* out, size_t row0, int ld, int col0, int N,
                                           int hd, const float (&o)[HDP / 8][4], float mul,
                                           float (&cs)[HDP / 8][2], int w, int lane) {
#pragma unroll
  for (int dt = 0; dt < HDP / 8; ++dt) {
    const int d = 8 * dt + 2 * (lane % 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 16 * w + lane / 4 + 8 * h;
      const float v0 = o[dt][2 * h] * mul, v1 = o[dt][2 * h + 1] * mul;
      cs[dt][0] += v0;
      cs[dt][1] += v1;
      if (i >= N || d >= hd) continue;
      bf16* p = out + (row0 + i) * ld + col0 + d;
      if (d + 1 < hd && (hd % 2) == 0) {
        store2(p, v0, v1);
      } else {
        p[0] = from_f<bf16>(v0);
        if (d + 1 < hd) p[1] = from_f<bf16>(v1);
      }
    }
  }
}

// Shared memory of the tensor-core kernels, from one 16-byte aligned base.
template <int HDP>
struct AttnSmem {
  static constexpr int LD = HDP + 8;
  static constexpr size_t head = (size_t)AT_NP * LD * sizeof(bf16);
  static constexpr size_t pl = (size_t)AT_NP * AT_LDP * sizeof(bf16);
  static constexpr size_t bias = (size_t)AT_NP * AT_LDP * sizeof(float);
  static constexpr size_t lab = AT_NP * sizeof(int);
  static constexpr size_t red = 4 * 3 * HDP * sizeof(float);
  // two buffer sets of heads and labels: the next window loads while this
  // one computes
  static constexpr size_t fwd = 6 * head + bias + 2 * lab;
  static constexpr size_t bwd = 8 * head + 2 * pl + bias + 2 * lab + red;
};

// The head's [N, N] bias (from the table) into columns [0, 64) of shared
// memory [64][AT_LDP] (zero outside [N, N]), both buffer sets of q / k / v /
// do zeroed with 16-byte stores (the padding stays zero), labels zeroed.
// Thread t fills column j = t % 64 of every other row, so that the
// coordinates of j within the window are found once, not per entry.
__device__ __forceinline__ void attn_setup(bf16* heads_s, int n_heads_s, float* bias_s,
                                           int* lab, const float* rel_table, int heads,
                                           const Geom& g, int h, size_t head_elems, int tid) {
  const int N = g.N, w12 = g.w1 * g.w2, l1 = 2 * g.w1 - 1, l2 = 2 * g.w2 - 1;
  uint4* z = (uint4*)heads_s;  // head_elems is a multiple of 8
  for (size_t i = tid; i < n_heads_s * head_elems / 8; i += 128) z[i] = make_uint4(0, 0, 0, 0);
  const int j = tid % AT_NP;
  const int j0 = j / w12, j1 = (j / g.w2) % g.w1, j2 = j % g.w2;
  for (int i = tid / AT_NP; i < AT_NP; i += 128 / AT_NP) {
    float v = 0.f;
    if (i < N && j < N) {
      const int a = i / w12 - j0 + g.w0 - 1, b = (i / g.w2) % g.w1 - j1 + g.w1 - 1;
      const int c = i % g.w2 - j2 + g.w2 - 1;
      v = rel_table[((a * l1 + b) * l2 + c) * heads + h];
    }
    bias_s[i * AT_LDP + j] = v;
  }
  for (int t = tid; t < 2 * AT_NP; t += 128) lab[t] = 0;
}

template <int HDP>
__global__ void __launch_bounds__(128)
window_attn_tc(const bf16* __restrict__ qkv, const float* __restrict__ rel_table, Geom g,
               int C, int heads, int has_shift, int wpg, int n_win, bf16* __restrict__ o) {
  using S = AttnSmem<HDP>;
  constexpr int LD = S::LD;
  extern __shared__ __align__(16) unsigned char sm_raw[];
  constexpr size_t HE = (size_t)AT_NP * LD;
  bf16* heads_s = (bf16*)sm_raw;  // [2 sets][q, k, v][AT_NP][LD]
  float* Bs = (float*)(sm_raw + 6 * S::head);
  int* labs = (int*)(sm_raw + 6 * S::head + S::bias);  // [2 sets][AT_NP]
  const int N = g.N, hd = C / heads, grp = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, w = tid / 32, lane = tid % 32;
  attn_setup(heads_s, 6, Bs, labs, rel_table, heads, g, h, HE, tid);
  __syncthreads();
  float unused[HDP / 8][2] = {};
  const int first = grp * wpg;
  const int nwin = ((grp + 1) * wpg < n_win ? (grp + 1) * wpg : n_win) - first;
  if (nwin > 0)
    stage_window<HDP, 3>(heads_s, labs, qkv, nullptr, g, first, C, hd, h, has_shift, tid);
  cp_commit();
  for (int it = 0; it < nwin; ++it) {
    const int set = it & 1, bw = first + it;
    if (it + 1 < nwin)
      stage_window<HDP, 3>(heads_s + (set ^ 1) * 3 * HE, labs + (set ^ 1) * AT_NP, qkv, nullptr,
                           g, bw + 1, C, hd, h, has_shift, tid);
    cp_commit();
    cp_wait<1>();
    __syncthreads();  // window bw has landed
    const bf16* Qs = heads_s + set * 3 * HE;
    float s[8][4];
    xyT_tile<HDP>(s, Qs, Qs + HE, w, lane);
    softmax_tile(s, Bs, labs + set * AT_NP, has_shift, N, w, lane);
    float ov[HDP / 8][4];
    pY_tile<HDP>(ov, s, Qs + 2 * HE, lane);
    store_head<HDP>(o, (size_t)bw * N, C, h * hd, N, hd, ov, 1.f, unused, w, lane);
    __syncthreads();  // this set is free for the window after next
  }
}

template <int HDP>
__global__ void __launch_bounds__(128)
window_attn_bwd_tc(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                   const float* __restrict__ rel_table, Geom g, int C, int heads, int has_shift,
                   int wpg, int n_win, float scale, bf16* __restrict__ dqkv,
                   float* __restrict__ dlogit_part, float* __restrict__ col_part) {
  using S = AttnSmem<HDP>;
  constexpr int LD = S::LD;
  extern __shared__ __align__(16) unsigned char sm_raw[];
  constexpr size_t HE = (size_t)AT_NP * LD;
  bf16* heads_s = (bf16*)sm_raw;  // [2 sets][q, k, v, do][AT_NP][LD]
  bf16* Ps = (bf16*)(sm_raw + 8 * S::head);
  bf16* Ls = (bf16*)(sm_raw + 8 * S::head + S::pl);
  float* Bs = (float*)(sm_raw + 8 * S::head + 2 * S::pl);
  int* labs = (int*)(sm_raw + 8 * S::head + 2 * S::pl + S::bias);  // [2 sets][AT_NP]
  float* red = (float*)(sm_raw + 8 * S::head + 2 * S::pl + S::bias + 2 * S::lab);
  const int N = g.N, hd = C / heads, grp = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, w = tid / 32, lane = tid % 32;
  attn_setup(heads_s, 8, Bs, labs, rel_table, heads, g, h, HE, tid);
  __syncthreads();

  float dla[8][4];
#pragma unroll
  for (int t = 0; t < 8; ++t) dla[t][0] = dla[t][1] = dla[t][2] = dla[t][3] = 0.f;
  float cs[3][HDP / 8][2];
#pragma unroll
  for (int q = 0; q < 3; ++q)
#pragma unroll
    for (int t = 0; t < HDP / 8; ++t) cs[q][t][0] = cs[q][t][1] = 0.f;

  const int first = grp * wpg;
  const int nwin = ((grp + 1) * wpg < n_win ? (grp + 1) * wpg : n_win) - first;
  if (nwin > 0)
    stage_window<HDP, 4>(heads_s, labs, qkv, dout, g, first, C, hd, h, has_shift, tid);
  cp_commit();
  for (int it = 0; it < nwin; ++it) {
    const int set = it & 1, bw = first + it;
    if (it + 1 < nwin)
      stage_window<HDP, 4>(heads_s + (set ^ 1) * 4 * HE, labs + (set ^ 1) * AT_NP, qkv, dout, g,
                           bw + 1, C, hd, h, has_shift, tid);
    cp_commit();
    cp_wait<1>();
    __syncthreads();  // window bw has landed
    const size_t row0 = (size_t)bw * N;
    const bf16* Qs = heads_s + set * 4 * HE;
    const bf16* Ks = Qs + HE;
    const bf16* Vs = Ks + HE;
    const bf16* Ds = Vs + HE;
    const int* lab = labs + set * AT_NP;

    float p[8][4], dp[8][4];
    xyT_tile<HDP>(p, Qs, Ks, w, lane);
    softmax_tile(p, Bs, lab, has_shift, N, w, lane);
    xyT_tile<HDP>(dp, Ds, Vs, w, lane);
    float dot[2] = {0.f, 0.f};
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int c = 0; c < 4; ++c) dot[c / 2] += dp[t][c] * p[t][c];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      dot[hh] += __shfl_xor_sync(0xffffffffu, dot[hh], 1);
      dot[hh] += __shfl_xor_sync(0xffffffffu, dot[hh], 2);
    }
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        dp[t][c] = p[t][c] * (dp[t][c] - dot[c / 2]);  // dl
        dla[t][c] += dp[t][c];
      }
    {  // dq = (T(dl) k) * scale
      float acc[HDP / 8][4];
      pY_tile<HDP>(acc, dp, Ks, lane);
      store_head<HDP>(dqkv, row0, 3 * C, h * hd, N, hd, acc, scale, cs[0], w, lane);
    }
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int i = 16 * w + lane / 4 + 8 * hh, j = 8 * t + 2 * (lane % 4);
        *(uint32_t*)(Ps + i * AT_LDP + j) = pack_bf16(p[t][2 * hh], p[t][2 * hh + 1]);
        *(uint32_t*)(Ls + i * AT_LDP + j) = pack_bf16(dp[t][2 * hh], dp[t][2 * hh + 1]);
      }
    __syncthreads();
    {  // dv = T(p)^T T(do)
      float acc[HDP / 8][4];
      xTY_tile<HDP>(acc, Ps, Ds, w, lane);
      store_head<HDP>(dqkv, row0, 3 * C, 2 * C + h * hd, N, hd, acc, 1.f, cs[2], w, lane);
    }
    {  // dk = T(dl)^T q
      float acc[HDP / 8][4];
      xTY_tile<HDP>(acc, Ls, Qs, w, lane);
      store_head<HDP>(dqkv, row0, 3 * C, C + h * hd, N, hd, acc, 1.f, cs[1], w, lane);
    }
    __syncthreads();  // this set, P and dl are free for the next windows
  }

  // this CTA's dlogit partial
  float* part = dlogit_part + ((size_t)grp * heads + h) * N * N;
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = 16 * w + lane / 4 + 8 * (c / 2), j = 8 * t + 2 * (lane % 4) + (c & 1);
      if (i < N && j < N) part[i * N + j] = dla[t][c];
    }
  // column sums of dq, dk, dv over the CTA's rows: lanes, then warps in order
#pragma unroll
  for (int q = 0; q < 3; ++q)
#pragma unroll
    for (int t = 0; t < HDP / 8; ++t)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float v = cs[q][t][c];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (lane < 4) red[(w * 3 + q) * HDP + 8 * t + 2 * lane + c] = v;
      }
  __syncthreads();
  for (int idx = tid; idx < 3 * hd; idx += 128) {
    const int q = idx / hd, d = idx % hd;
    float s = 0.f;
    for (int ww = 0; ww < 4; ++ww) s += red[(ww * 3 + q) * HDP + d];
    col_part[(size_t)grp * 3 * C + q * C + h * hd + d] = s;
  }
}

// ---------------------------------------------------------------------------
// bf16, any other window or head width: tensor cores over key blocks
// ---------------------------------------------------------------------------
// q, k, v (and do) of one window stay in shared memory, NP = N rounded up to
// 16 rows, HDP = hd rounded up to DC columns, zero padded. Warp w takes the
// query rows [16 s, 16 s + 16) for s = w, w + 4, ... and walks the keys in
// blocks of 64, recomputing S on each pass: the row max, then the row sum,
// then p = exp(s - max) / sum with the same float32 softmax and flush as
// softmax_tile (no running rescale, so p and its bf16 rounding point are
// those of the JAX kernel). Outputs are built DC columns at a time. The
// backward keeps each query row's max, sum and rowsum(dp p) in shared memory;
// dq and the dlogit partial are built by query rows, dk and dv by key rows
// from S^T = k q^T and dp^T = v do^T, so no [N, N] matrix is ever stored.

constexpr int AG_KB = 64;  // keys (or queries) per block of a pass

// s = X[r0, r0 + 16) Y[c0, c0 + 64)^T over KD columns; 16-row blocks of Y at
// or past NP are skipped and leave s zero.
__device__ __forceinline__ void gen_xyT(float (&s)[8][4], const bf16* X, int r0, const bf16* Y,
                                        int c0, int NP, int LD, int KD, int lane) {
#pragma unroll
  for (int t = 0; t < 8; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
  for (int kk = 0; kk < KD; kk += 16) {
    uint32_t a[4];
    ldsm_x4(a, X + (r0 + lane % 16) * LD + kk + 8 * (lane / 16));
#pragma unroll
    for (int tp = 0; tp < 4; ++tp) {
      if (c0 + 16 * tp < NP) {
        uint32_t b[4];
        ldsm_x4(b, Y + (c0 + 16 * tp + lane % 8 + 8 * (lane / 16)) * LD + kk + 8 * ((lane / 8) % 2));
        mma16816(s[2 * tp], a, b[0], b[1]);
        mma16816(s[2 * tp + 1], a, b[2], b[3]);
      }
    }
  }
}

// o += T(p) Y[c0, c0 + 64)[:, dc, dc + DC): p this warp's [16, 64] fragment.
template <int DC>
__device__ __forceinline__ void gen_pY(float (&o)[DC / 8][4], const float (&p)[8][4],
                                       const bf16* Y, int c0, int dc, int NP, int LD, int lane) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    if (c0 + 16 * kc < NP) {
      const uint32_t a[4] = {pack_bf16(p[2 * kc][0], p[2 * kc][1]),
                             pack_bf16(p[2 * kc][2], p[2 * kc][3]),
                             pack_bf16(p[2 * kc + 1][0], p[2 * kc + 1][1]),
                             pack_bf16(p[2 * kc + 1][2], p[2 * kc + 1][3])};
#pragma unroll
      for (int dp = 0; dp < DC / 16; ++dp) {
        uint32_t b[4];
        ldsm_x4_t(b, Y + (c0 + 16 * kc + lane % 8 + 8 * ((lane / 8) % 2)) * LD + dc + 16 * dp +
                         8 * (lane / 16));
        mma16816(o[2 * dp], a, b[0], b[1]);
        mma16816(o[2 * dp + 1], a, b[2], b[3]);
      }
    }
  }
}

template <int DC>
__device__ __forceinline__ void zero_frag(float (&o)[DC / 8][4]) {
#pragma unroll
  for (int t = 0; t < DC / 8; ++t) o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;
}

// Fragment coordinates: element c of tile t is at row r0 + lane / 4 (+8 for
// c >= 2) and column c0 + 8 t + 2 (lane % 4) + (c & 1).
__device__ __forceinline__ int frag_row(int r0, int c, int lane) { return r0 + lane / 4 + 8 * (c / 2); }
__device__ __forceinline__ int frag_col(int c0, int t, int c, int lane) {
  return c0 + 8 * t + 2 * (lane % 4) + (c & 1);
}

// Logit of query i and key j (both < N) from q . k: + bias + shift mask, as
// softmax_tile.
struct AttnCtx {
  const float* rel;
  Geom g;
  int heads, h, has_shift;
  const int* lab;
  __device__ __forceinline__ float logit(float raw, int i, int j) const {
    float v = raw + rel_table_at(rel, heads, g, h, i, j);
    if (has_shift && lab[i] != lab[j]) v += -100.f;
    return v;
  }
};

__device__ __forceinline__ float flushed_exp(float x) {
  return x < -80.f ? 0.f : expf(fmaxf(x, -80.f));
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Max and sum of exp over all keys of this warp's query rows r0 + lane / 4
// (+8); rows at or past N get -inf and 0.
__device__ __forceinline__ void gen_row_stats(float (&mx)[2], float (&sum)[2], const bf16* Qs,
                                              const bf16* Ks, int r0, int NP, int LD, int HDP,
                                              const AttnCtx& a, int lane) {
  const int N = a.g.N;
  mx[0] = mx[1] = -INFINITY;
  for (int c0 = 0; c0 < NP; c0 += AG_KB) {
    float s[8][4];
    gen_xyT(s, Qs, r0, Ks, c0, NP, LD, HDP, lane);
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = frag_row(r0, c, lane), j = frag_col(c0, t, c, lane);
        if (i < N && j < N) mx[c / 2] = fmaxf(mx[c / 2], a.logit(s[t][c], i, j));
      }
  }
  mx[0] = quad_max(mx[0]);
  mx[1] = quad_max(mx[1]);
  sum[0] = sum[1] = 0.f;
  for (int c0 = 0; c0 < NP; c0 += AG_KB) {
    float s[8][4];
    gen_xyT(s, Qs, r0, Ks, c0, NP, LD, HDP, lane);
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = frag_row(r0, c, lane), j = frag_col(c0, t, c, lane);
        if (i < N && j < N) sum[c / 2] += flushed_exp(a.logit(s[t][c], i, j) - mx[c / 2]);
      }
  }
  sum[0] = quad_sum(sum[0]);
  sum[1] = quad_sum(sum[1]);
}

// p = softmax of this warp's [16, 64] block of logits in place (0 outside
// [N, N]), given the rows' max and sum.
__device__ __forceinline__ void gen_probs(float (&s)[8][4], int r0, int c0, const float (&mx)[2],
                                          const float (&sum)[2], const AttnCtx& a, int lane) {
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = frag_row(r0, c, lane), j = frag_col(c0, t, c, lane);
      s[t][c] = i < a.g.N && j < a.g.N
                    ? flushed_exp(a.logit(s[t][c], i, j) - mx[c / 2]) / sum[c / 2]
                    : 0.f;
    }
}

// Rows r0 + lane / 4 (+8) < N, columns dc + ... < hd of a fragment * mul into
// out + col0 (row stride ld). With cs (this warp's [HDP] row of column sums)
// the float32 values are added there, lanes first, in a fixed order.
template <int DC>
__device__ __forceinline__ void gen_store(bf16* out, size_t row0, int ld, int col0, int N,
                                          int hd, int dc, int r0, const float (&o)[DC / 8][4],
                                          float mul, float* cs, int lane) {
#pragma unroll
  for (int dt = 0; dt < DC / 8; ++dt) {
    const int d = dc + 8 * dt + 2 * (lane % 4);
    float c0 = 0.f, c1 = 0.f;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int i = r0 + lane / 4 + 8 * hh;
      const float v0 = o[dt][2 * hh] * mul, v1 = o[dt][2 * hh + 1] * mul;
      if (i >= N) continue;
      c0 += v0;
      c1 += v1;
      if (d >= hd) continue;
      bf16* p = out + (row0 + i) * ld + col0 + d;
      if (d + 1 < hd && (hd % 2) == 0) {
        store2(p, v0, v1);
      } else {
        p[0] = from_f<bf16>(v0);
        if (d + 1 < hd) p[1] = from_f<bf16>(v1);
      }
    }
    if (cs != nullptr) {
#pragma unroll
      for (int o2 = 4; o2 < 32; o2 *= 2) {
        c0 += __shfl_xor_sync(0xffffffffu, c0, o2);
        c1 += __shfl_xor_sync(0xffffffffu, c1, o2);
      }
      if (lane < 4) {
        cs[d] += c0;
        cs[d + 1] += c1;
      }
    }
  }
}

// Shared memory of the general kernels: NH heads [NP][HDP + 8] bf16, labels,
// and for the backward the rows' statistics [3][NP] and column sums
// [4 warps][3][HDP] (float32).
inline size_t attn_gen_smem(int N, int HDP, bool bwd) {
  const size_t NP = (N + 15) / 16 * 16;
  size_t b = (bwd ? 4 : 3) * NP * (HDP + 8) * sizeof(bf16) + NP * sizeof(int);
  if (bwd) b += 3 * NP * sizeof(float) + 4 * 3 * (size_t)HDP * sizeof(float);
  return b;
}

template <int DC>
__global__ void __launch_bounds__(128)
window_attn_gen(const bf16* __restrict__ qkv, const float* __restrict__ rel_table, Geom g,
                int C, int heads, int has_shift, int HDP, int wpg, int n_win,
                bf16* __restrict__ o) {
  extern __shared__ __align__(16) unsigned char sm_raw[];
  const int N = g.N, NP = (N + 15) / 16 * 16, LD = HDP + 8, hd = C / heads;
  const size_t HE = (size_t)NP * LD;
  bf16* Qs = (bf16*)sm_raw;
  bf16* Ks = Qs + HE;
  bf16* Vs = Ks + HE;
  int* lab = (int*)(Vs + HE);
  const int grp = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, w = tid / 32, lane = tid % 32;
  for (size_t i = tid; i < 3 * HE / 8; i += 128) ((uint4*)sm_raw)[i] = make_uint4(0, 0, 0, 0);
  for (int t = tid; t < NP; t += 128) lab[t] = 0;
  const AttnCtx a{rel_table, g, heads, h, has_shift, lab};
  const int last = (grp + 1) * wpg < n_win ? (grp + 1) * wpg : n_win;
  for (int bw = grp * wpg; bw < last; ++bw) {
    const size_t row0 = (size_t)bw * N;
    __syncthreads();  // the previous window is done with shared memory
    for (int k = 0; k < 3; ++k)
      load_head(Qs + k * HE, LD, qkv, row0, 3 * C, k * C + h * hd, N, hd, tid);
    if (has_shift)
      for (int t = tid; t < N; t += 128) lab[t] = region_label(g, bw % g.nW, t);
    cp_commit();
    cp_wait<0>();
    __syncthreads();
    for (int r0 = 16 * w; r0 < NP; r0 += 64) {
      float mx[2], sum[2];
      gen_row_stats(mx, sum, Qs, Ks, r0, NP, LD, HDP, a, lane);
      for (int dc = 0; dc < HDP; dc += DC) {
        float acc[DC / 8][4];
        zero_frag<DC>(acc);
        for (int c0 = 0; c0 < NP; c0 += AG_KB) {
          float s[8][4];
          gen_xyT(s, Qs, r0, Ks, c0, NP, LD, HDP, lane);
          gen_probs(s, r0, c0, mx, sum, a, lane);
          gen_pY<DC>(acc, s, Vs, c0, dc, NP, LD, lane);
        }
        gen_store<DC>(o, row0, C, h * hd, N, hd, dc, r0, acc, 1.f, nullptr, lane);
      }
    }
  }
}

template <int DC>
__global__ void __launch_bounds__(128)
window_attn_bwd_gen(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                    const float* __restrict__ rel_table, Geom g, int C, int heads,
                    int has_shift, int HDP, int wpg, int n_win, float scale,
                    bf16* __restrict__ dqkv, float* __restrict__ dlogit_part,
                    float* __restrict__ col_part) {
  extern __shared__ __align__(16) unsigned char sm_raw[];
  const int N = g.N, NP = (N + 15) / 16 * 16, LD = HDP + 8, hd = C / heads;
  const size_t HE = (size_t)NP * LD;
  bf16* Qs = (bf16*)sm_raw;
  bf16* Ks = Qs + HE;
  bf16* Vs = Ks + HE;
  bf16* Ds = Vs + HE;
  int* lab = (int*)(Ds + HE);
  float* st_m = (float*)(lab + NP);  // each query row's max, sum and rowsum(dp p)
  float* st_l = st_m + NP;
  float* st_d = st_l + NP;
  float* red = st_d + NP;  // [4 warps][dq, dk, dv][HDP] column sums
  const int grp = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, w = tid / 32, lane = tid % 32;
  for (size_t i = tid; i < 4 * HE / 8; i += 128) ((uint4*)sm_raw)[i] = make_uint4(0, 0, 0, 0);
  for (int t = tid; t < NP; t += 128) lab[t] = 0;
  for (int t = tid; t < 12 * HDP; t += 128) red[t] = 0.f;
  const AttnCtx a{rel_table, g, heads, h, has_shift, lab};
  float* part = dlogit_part + ((size_t)grp * heads + h) * N * N;
  const int first = grp * wpg, last = (grp + 1) * wpg < n_win ? (grp + 1) * wpg : n_win;
  for (int bw = first; bw < last; ++bw) {
    const size_t row0 = (size_t)bw * N;
    __syncthreads();  // the previous window is done with shared memory
    for (int k = 0; k < 3; ++k)
      load_head(Qs + k * HE, LD, qkv, row0, 3 * C, k * C + h * hd, N, hd, tid);
    load_head(Ds, LD, dout, row0, C, h * hd, N, hd, tid);
    if (has_shift)
      for (int t = tid; t < N; t += 128) lab[t] = region_label(g, bw % g.nW, t);
    cp_commit();
    cp_wait<0>();
    __syncthreads();

    // by query rows: statistics, dq = (T(dl) k) scale and the dlogit partial
    for (int r0 = 16 * w; r0 < NP; r0 += 64) {
      float mx[2], sum[2], dot[2] = {0.f, 0.f};
      gen_row_stats(mx, sum, Qs, Ks, r0, NP, LD, HDP, a, lane);
      for (int c0 = 0; c0 < NP; c0 += AG_KB) {
        float p[8][4], dp[8][4];
        gen_xyT(p, Qs, r0, Ks, c0, NP, LD, HDP, lane);
        gen_probs(p, r0, c0, mx, sum, a, lane);
        gen_xyT(dp, Ds, r0, Vs, c0, NP, LD, HDP, lane);
#pragma unroll
        for (int t = 0; t < 8; ++t)
#pragma unroll
          for (int c = 0; c < 4; ++c) dot[c / 2] += dp[t][c] * p[t][c];
      }
      dot[0] = quad_sum(dot[0]);
      dot[1] = quad_sum(dot[1]);
      if (lane % 4 == 0)
        for (int hh = 0; hh < 2; ++hh) {
          const int i = r0 + lane / 4 + 8 * hh;
          const bool in = i < N;
          st_m[i] = in ? mx[hh] : 0.f;
          st_l[i] = in ? sum[hh] : 1.f;
          st_d[i] = in ? dot[hh] : 0.f;
        }
      for (int dc = 0; dc < HDP; dc += DC) {
        float acc[DC / 8][4];
        zero_frag<DC>(acc);
        for (int c0 = 0; c0 < NP; c0 += AG_KB) {
          float p[8][4], dl[8][4];
          gen_xyT(p, Qs, r0, Ks, c0, NP, LD, HDP, lane);
          gen_probs(p, r0, c0, mx, sum, a, lane);
          gen_xyT(dl, Ds, r0, Vs, c0, NP, LD, HDP, lane);
#pragma unroll
          for (int t = 0; t < 8; ++t)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int i = frag_row(r0, c, lane), j = frag_col(c0, t, c, lane);
              const bool in = i < N && j < N;
              dl[t][c] = in ? p[t][c] * (dl[t][c] - dot[c / 2]) : 0.f;
              if (dc == 0 && in) {
                float* q = part + (size_t)i * N + j;
                *q = bw == first ? dl[t][c] : *q + dl[t][c];
              }
            }
          gen_pY<DC>(acc, dl, Ks, c0, dc, NP, LD, lane);
        }
        gen_store<DC>(dqkv, row0, 3 * C, h * hd, N, hd, dc, r0, acc, scale,
                      red + (w * 3 + 0) * HDP, lane);
      }
    }
    __syncthreads();  // every query row's statistics are in shared memory

    // by key rows: dk = T(dl)^T q and dv = T(p)^T T(do) from S^T and dp^T
    for (int r0 = 16 * w; r0 < NP; r0 += 64) {
      for (int dc = 0; dc < HDP; dc += DC) {
        float ak[DC / 8][4], av[DC / 8][4];
        zero_frag<DC>(ak);
        zero_frag<DC>(av);
        for (int c0 = 0; c0 < NP; c0 += AG_KB) {
          float pt[8][4], dlt[8][4];
          gen_xyT(pt, Ks, r0, Qs, c0, NP, LD, HDP, lane);
          gen_xyT(dlt, Vs, r0, Ds, c0, NP, LD, HDP, lane);
#pragma unroll
          for (int t = 0; t < 8; ++t)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int j = frag_row(r0, c, lane), i = frag_col(c0, t, c, lane);
              if (i < N && j < N) {
                const float p = flushed_exp(a.logit(pt[t][c], i, j) - st_m[i]) / st_l[i];
                pt[t][c] = p;
                dlt[t][c] = p * (dlt[t][c] - st_d[i]);
              } else {
                pt[t][c] = dlt[t][c] = 0.f;
              }
            }
          gen_pY<DC>(ak, dlt, Qs, c0, dc, NP, LD, lane);
          gen_pY<DC>(av, pt, Ds, c0, dc, NP, LD, lane);
        }
        gen_store<DC>(dqkv, row0, 3 * C, C + h * hd, N, hd, dc, r0, ak, 1.f,
                      red + (w * 3 + 1) * HDP, lane);
        gen_store<DC>(dqkv, row0, 3 * C, 2 * C + h * hd, N, hd, dc, r0, av, 1.f,
                      red + (w * 3 + 2) * HDP, lane);
      }
    }
  }
  __syncthreads();
  for (int idx = tid; idx < 3 * hd; idx += 128) {
    const int q = idx / hd, d = idx % hd;
    float s = 0.f;
    for (int ww = 0; ww < 4; ++ww) s += red[(ww * 3 + q) * HDP + d];
    col_part[(size_t)grp * 3 * C + q * C + h * hd + d] = s;
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

// Padded head dim of the 64-token kernels (0: the general kernels run).
inline int attn_hdp(int N, int hd) {
  if (N > AT_NP) return 0;
  return hd <= 16 ? 16 : (hd <= 32 ? 32 : (hd <= 64 ? 64 : 0));
}

// Column chunk of the general kernels (their HDP is hd rounded up to it).
inline int attn_gen_dc(int hd) { return hd <= 16 ? 16 : 32; }

// Window groups: forward ~528 CTAs in all, one wave of 4 per SM on the
// H100's 132 (each CTA fills its head's bias once and pipelines its
// windows; measured faster than 1056 or 4096 at swin_b's stages 0 and 2);
// backward ~6 per SM (each group writes a [heads, N, N] dlogit partial and
// a [3C] bias partial).
inline int attn_groups(long long n_win, int heads, int target) {
  long long gr = (target + heads - 1) / heads;
  if (gr > n_win) gr = n_win;
  if (gr < 1) gr = 1;
  const long long wpg = (n_win + gr - 1) / gr;
  return (int)((n_win + wpg - 1) / wpg);
}
constexpr int ATTN_FWD_CTAS = 528, ATTN_BWD_CTAS = 792;

template <int HDP>
inline cudaError_t attn_tc_fwd(const bf16* qkv, const float* rel, const Geom& g, int C,
                               int heads, bf16* o, cudaStream_t st) {
  const size_t smem = AttnSmem<HDP>::fwd;
  cudaError_t err = cudaFuncSetAttribute(window_attn_tc<HDP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_win = g.B * g.nW;
  const int groups = attn_groups(n_win, heads, ATTN_FWD_CTAS);
  const int wpg = (n_win + groups - 1) / groups;
  const int has_shift = (g.s0 + g.s1 + g.s2) > 0;
  window_attn_tc<HDP><<<dim3(groups, heads), 128, smem, st>>>(qkv, rel, g, C, heads, has_shift,
                                                             wpg, n_win, o);
  return cudaGetLastError();
}

template <int DC>
inline cudaError_t attn_gen_fwd(const bf16* qkv, const float* rel, const Geom& g, int C,
                                int heads, bf16* o, cudaStream_t st) {
  const int hd = C / heads, HDP = (hd + DC - 1) / DC * DC;
  const size_t smem = attn_gen_smem(g.N, HDP, false);
  cudaError_t err = cudaFuncSetAttribute(window_attn_gen<DC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_win = g.B * g.nW;
  const int groups = attn_groups(n_win, heads, ATTN_FWD_CTAS);
  const int wpg = (n_win + groups - 1) / groups;
  const int has_shift = (g.s0 + g.s1 + g.s2) > 0;
  window_attn_gen<DC><<<dim3(groups, heads), 128, smem, st>>>(qkv, rel, g, C, heads, has_shift,
                                                              HDP, wpg, n_win, o);
  return cudaGetLastError();
}

template <int DC>
inline cudaError_t attn_gen_bwd(const bf16* qkv, const bf16* dout, const float* rel,
                                const Geom& g, int C, int heads, float scale, int groups,
                                bf16* dqkv, float* dl_part, float* col_part, cudaStream_t st) {
  const int hd = C / heads, HDP = (hd + DC - 1) / DC * DC;
  const size_t smem = attn_gen_smem(g.N, HDP, true);
  cudaError_t err = cudaFuncSetAttribute(window_attn_bwd_gen<DC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_win = g.B * g.nW;
  const int wpg = (n_win + groups - 1) / groups;
  const int has_shift = (g.s0 + g.s1 + g.s2) > 0;
  window_attn_bwd_gen<DC><<<dim3(groups, heads), 128, smem, st>>>(
      qkv, dout, rel, g, C, heads, has_shift, HDP, wpg, n_win, scale, dqkv, dl_part, col_part);
  return cudaGetLastError();
}

// o [M, C] from qkv [M, 3C] (q already scaled and rounded).
template <typename T>
inline cudaError_t launch_attn(const T* qkv, const float* rel_table, const Geom& g, int C,
                               int heads, T* o, cudaStream_t st) {
  if constexpr (sizeof(T) == 2) {
    switch (attn_hdp(g.N, C / heads)) {
      case 16: return attn_tc_fwd<16>(qkv, rel_table, g, C, heads, o, st);
      case 32: return attn_tc_fwd<32>(qkv, rel_table, g, C, heads, o, st);
      case 64: return attn_tc_fwd<64>(qkv, rel_table, g, C, heads, o, st);
      default:
        return attn_gen_dc(C / heads) == 16 ? attn_gen_fwd<16>(qkv, rel_table, g, C, heads, o, st)
                                            : attn_gen_fwd<32>(qkv, rel_table, g, C, heads, o, st);
    }
  } else {
    const size_t smem = attn_fma_smem_bytes(g.N, C / heads);
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          window_attn_fma, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
    }
    const int has_shift = (g.s0 + g.s1 + g.s2) > 0;
    window_attn_fma<<<dim3(g.B * g.nW, heads), 256, smem, st>>>(qkv, rel_table, g, C, heads,
                                                               has_shift, o);
    return cudaGetLastError();
  }
}

// Window groups of the backward of compute type T.
template <typename T>
inline int attn_bwd_groups(const Geom& g, int heads) {
  const long long n_win = (long long)g.B * g.nW;
  if (sizeof(T) == 2) {
    // windows past 64 tokens: fewer groups, so that the [heads, N, N]
    // partials stay ~ATTN_BWD_CTAS * 64^2 floats (at least 132 CTAs)
    const long long t = (long long)ATTN_BWD_CTAS * AT_NP * AT_NP / ((long long)g.N * g.N);
    return attn_groups(n_win, heads, (int)(t < 132 ? 132 : (t > ATTN_BWD_CTAS ? ATTN_BWD_CTAS : t)));
  }
  const int wpg = attn_bwd_fma_windows_per_group(n_win);
  return (int)((n_win + wpg - 1) / wpg);
}

// Workspace floats of launch_attn_bwd: dlogit partials, then bias partials.
template <typename T>
inline long long attn_bwd_part_floats(const Geom& g, int C, int heads) {
  const long long gr = attn_bwd_groups<T>(g, heads);
  return gr * heads * (long long)g.N * g.N + (sizeof(T) == 2 ? gr * 3 * C : 0);
}

template <int HDP>
inline cudaError_t attn_tc_bwd(const bf16* qkv, const bf16* dout, const float* rel,
                               const Geom& g, int C, int heads, float scale, int groups,
                               bf16* dqkv, float* dl_part, float* col_part, cudaStream_t st) {
  const size_t smem = AttnSmem<HDP>::bwd;
  cudaError_t err = cudaFuncSetAttribute(window_attn_bwd_tc<HDP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_win = g.B * g.nW;
  const int wpg = (n_win + groups - 1) / groups;
  const int has_shift = (g.s0 + g.s1 + g.s2) > 0;
  window_attn_bwd_tc<HDP><<<dim3(groups, heads), 128, smem, st>>>(
      qkv, dout, rel, g, C, heads, has_shift, wpg, n_win, scale, dqkv, dl_part, col_part);
  return cudaGetLastError();
}

// dqkv [M, 3C] (T, the qkv column layout), dlogit [heads, N, N] and dbqkv
// [3C] (float32 sums of the float32 dqkv) from qkv (T) and do (T). part
// holds attn_bwd_part_floats<T>(...) floats, tmp colsum_parts(M) * 3C.
template <typename T>
inline cudaError_t launch_attn_bwd(const T* qkv, const T* dout, const float* rel_table,
                                   const Geom& g, int C, int heads, float scale, T* dqkv,
                                   float* part, float* tmp, float* dlogit, float* dbqkv,
                                   cudaStream_t st) {
  const int groups = attn_bwd_groups<T>(g, heads);
  const long long M = (long long)g.B * g.nW * g.N;
  cudaError_t err;
  if constexpr (sizeof(T) == 2) {
    float* col_part = part + (long long)groups * heads * g.N * g.N;
    switch (attn_hdp(g.N, C / heads)) {
      case 16: err = attn_tc_bwd<16>(qkv, dout, rel_table, g, C, heads, scale, groups, dqkv, part, col_part, st); break;
      case 32: err = attn_tc_bwd<32>(qkv, dout, rel_table, g, C, heads, scale, groups, dqkv, part, col_part, st); break;
      case 64: err = attn_tc_bwd<64>(qkv, dout, rel_table, g, C, heads, scale, groups, dqkv, part, col_part, st); break;
      default:
        err = attn_gen_dc(C / heads) == 16
                  ? attn_gen_bwd<16>(qkv, dout, rel_table, g, C, heads, scale, groups, dqkv, part, col_part, st)
                  : attn_gen_bwd<32>(qkv, dout, rel_table, g, C, heads, scale, groups, dqkv, part, col_part, st);
    }
    if (err != cudaSuccess) return err;
    err = launch_colsum<float>(col_part, groups, 3 * C, tmp, dbqkv, st);
  } else {
    const size_t smem = attn_bwd_fma_smem_bytes(g.N, C / heads);
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(window_attn_bwd_fma,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
    }
    const int n_win = g.B * g.nW;
    const int wpg = attn_bwd_fma_windows_per_group(n_win);
    const int has_shift = (g.s0 + g.s1 + g.s2) > 0;
    window_attn_bwd_fma<<<dim3(groups, heads), 256, smem, st>>>(
        qkv, dout, rel_table, g, C, heads, has_shift, wpg, n_win, scale, dqkv, part);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    err = launch_colsum<float>(dqkv, M, 3 * C, tmp, dbqkv, st);
  }
  if (err != cudaSuccess) return err;
  return launch_sum_parts(part, groups, (long long)heads * g.N * g.N, dlogit, st);
}

}  // namespace swin
