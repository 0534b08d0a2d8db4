// Instance norm + LeakyReLU (slope 0.01) of the UNETR residual block
// (models/unetr.py UnetResBlock3D), forward and backward:
//
//   norm_act:      out = lrelu(IN(a + bias_a))
//   norm_add_act:  out = lrelu(IN(a + bias_a) + IN(r + bias_r))   (mode 1)
//                  out = lrelu(IN(a + bias_a) + r)                (mode 2)
//
// Replaces no TPU kernel: the JAX package leaves the block's norms to XLA,
// which fuses them. In the port they were a chain of PyTorch passes (the
// conv's bias add, float32 copies, the statistics, the normalisation, each
// LeakyReLU and the residual add, each with its backward) that moved about
// ten times the bytes the chain needs. What bounds it on the H100: bytes,
// a few float32 operations an element against 2 bytes read or written in
// bf16. The design moves each operand the fewest times:
//   * stats: per (sample, channel) mean and rstd of one or two NDHWC
//     tensors in one launch. A block takes a tile of voxels of one sample
//     across all C channels; each thread loads 16 bytes (8 bf16 or 4 float32
//     channels), neighbouring threads neighbouring addresses, and keeps
//     shifted float32 sums in registers; the block combines its threads'
//     (count, mean, M2) by Chan's formula in shared memory into a per-block
//     partial, and a small second launch combines the partials in double.
//     The accuracy of two passes without a second read; no atomics, so the
//     same bits every run.
//   * apply: normalise, add the second normalised operand or the raw
//     residual, LeakyReLU, one rounding to the output type.
//   * bwd_reduce: the pre-activation recomputed from the saved inputs and
//     the statistics, gp = g * (pre > 0 ? 1 : 0.01), and per (sample,
//     channel) the sums of gp and of gp * xhat of each normalised operand
//     (per-block partials, then a combining launch).
//   * bwd_apply: dx = rstd * (gp - mean(gp) - xhat * mean(gp * xhat)) of
//     each normalised operand, gp itself for a raw residual, and per channel
//     the sums of the dx written: the gradient of the conv bias before the
//     norm (per-block partials, then a combining launch).
// A conv bias shifts its channel's mean by itself and cancels in the
// normalised value, so the kernels read the convolution's output without
// it; it keeps its gradient.
//
// Layout: x[b][v][c], v the voxel (D * H * W of them). A thread takes N
// channels: N = 16 / sizeof(T) where C is a multiple of it (every res block
// of the cells' presets), else N = 1 (a small preset's 6 or 12 channels,
// one element a load); C / N <= 256. The incoming gradient may have a row
// stride gs >= C, a multiple of N, between voxels (a channel slice of a
// concatenation's gradient); every other tensor is contiguous. Every entry returns a
// cudaError_t code (0 on success).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;  // threads of a block, at most (rows x groups)
constexpr int kUnroll = 4;     // voxels a thread has in flight
constexpr int kCombine = 256;  // threads of a block combining per-block partials
constexpr float kSlope = 0.01f;

// Vectors of N elements of T as float32, each loaded and stored as one
// word: 16 bytes (8 bf16 or 4 float32 channels) where C is a multiple of
// that, else one element (a narrow C, as a small preset's res blocks have).
template <typename T, int N> struct Vec;

template <> struct Vec<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float (&f)[4]) {
    const float4 u = __ldg(reinterpret_cast<const float4*>(p));
    f[0] = u.x; f[1] = u.y; f[2] = u.z; f[3] = u.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&f)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};

template <> struct Vec<float, 1> {
  static __device__ __forceinline__ void load(const float* p, float (&f)[1]) { f[0] = __ldg(p); }
  static __device__ __forceinline__ void store(float* p, const float (&f)[1]) { *p = f[0]; }
};

template <> struct Vec<bf16, 8> {
  static __device__ __forceinline__ void load(const bf16* p, float (&f)[8]) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // the lower address is the low half
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
           ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
  }
  static __device__ __forceinline__ void store(bf16* p, const float (&f)[8]) {
    *reinterpret_cast<uint4*>(p) = make_uint4(pack(f[0], f[1]), pack(f[2], f[3]),
                                              pack(f[4], f[5]), pack(f[6], f[7]));
  }
};

template <> struct Vec<bf16, 1> {
  static __device__ __forceinline__ void load(const bf16* p, float (&f)[1]) {
    f[0] = __uint_as_float((uint32_t)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
  }
  static __device__ __forceinline__ void store(bf16* p, const float (&f)[1]) {
    *p = __float2bfloat16_rn(f[0]);
  }
};

// v as the kernel stores it in T.
template <typename T> __device__ __forceinline__ float round_to(float v) { return v; }
template <> __device__ __forceinline__ float round_to<bf16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Elements of T a thread loads at once for C channels: 16 bytes' worth
// where C is a multiple of it, else 1.
template <typename T> constexpr int wide() { return 16 / (int)sizeof(T); }

// A block's share of one sample: voxels [v0, v1) of tile blockIdx.x of
// nblk, sample blockIdx.y. Thread t takes channel group gi = t % G
// (channels gi * N ..) and the voxels v0 + r, v0 + r + R, ... (r = t / G).
struct Tile {
  int G, R, gi, r;
  long long v0, v1;
  __device__ __forceinline__ long long count() const {
    const long long len = v1 - v0;
    return len > r ? (len - r + R - 1) / R : 0;
  }
};

template <int N>
__device__ __forceinline__ Tile make_tile(long long V, int C, int nblk) {
  Tile t;
  t.G = C / N;
  t.R = blockDim.x / t.G;
  t.gi = threadIdx.x % t.G;
  t.r = threadIdx.x / t.G;
  t.v0 = (long long)blockIdx.x * V / nblk;
  t.v1 = (long long)(blockIdx.x + 1) * V / nblk;
  return t;
}

// One voxel's vectors of a thread: the gradient g, operand a, and b (the
// second normalised operand or the raw residual).
template <int N> struct Row {
  float g[N], a[N], b[N];
};

// use(row, offset) over the thread's voxels, kUnroll loads in flight.
// x offsets: xbase + i * xstep; g offsets: gbase + i * gstep.
template <typename T, int N, bool kG, bool kB, typename Use>
__device__ __forceinline__ void sweep(const T* __restrict__ g, const T* __restrict__ a,
                                      const T* __restrict__ b, size_t xbase, size_t xstep,
                                      size_t gbase, size_t gstep, long long count, Use use) {
  long long i = 0;
  for (; i + kUnroll <= count; i += kUnroll) {
    Row<N> rows[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const size_t off = xbase + (size_t)(i + u) * xstep;
      if (kG) Vec<T, N>::load(g + gbase + (size_t)(i + u) * gstep, rows[u].g);
      Vec<T, N>::load(a + off, rows[u].a);
      if (kB) Vec<T, N>::load(b + off, rows[u].b);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) use(rows[u], xbase + (size_t)(i + u) * xstep);
  }
  for (; i < count; ++i) {
    Row<N> row;
    const size_t off = xbase + (size_t)i * xstep;
    if (kG) Vec<T, N>::load(g + gbase + (size_t)i * gstep, row.g);
    Vec<T, N>::load(a + off, row.a);
    if (kB) Vec<T, N>::load(b + off, row.b);
    use(row, off);
  }
}

// stats[z][0 | 1][b][c]: mean and rstd of operand z.
template <int N>
__device__ __forceinline__ void load_stats(const float* __restrict__ stats, int z, int b, int B,
                                           int C, int c0, float (&mean)[N], float (&rstd)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    mean[i] = stats[((size_t)(2 * z) * B + b) * C + c0 + i];
    rstd[i] = stats[((size_t)(2 * z + 1) * B + b) * C + c0 + i];
  }
}

// The normalised operands and the pre-activation. xhat is rounded once,
// as a product (no contraction), so that the forward and both backward
// kernels see the same pre-activation bit for bit.
template <int M>
__device__ __forceinline__ float pre_act(float a, float m0, float r0, float b, float m1, float r1,
                                         float& xa, float& xb) {
  xa = __fmul_rn(a - m0, r0);
  xb = M == 1 ? __fmul_rn(b - m1, r1) : (M == 2 ? b : 0.f);
  return M == 0 ? xa : xa + xb;
}

// Sums over the block's rows of K per-thread vectors; out[k * C + c] for
// every channel c (shared memory: K * R * C floats).
template <int K, int N>
__device__ __forceinline__ void block_sums(const Tile& t, int C, const float (&acc)[K][N],
                                           float* __restrict__ out) {
  extern __shared__ float sm[];
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < N; ++i) sm[((size_t)k * t.R + t.r) * C + t.gi * N + i] = acc[k][i];
  __syncthreads();
  for (int j = threadIdx.x; j < K * C; j += blockDim.x) {
    const int k = j / C, c = j % C;
    float s = 0.f;
    for (int r = 0; r < t.R; ++r) s += sm[((size_t)k * t.R + r) * C + c];
    out[j] = s;
  }
}

// Chan's combination of (n, mean, m2) with (nb, mb, m2b).
template <typename F>
__device__ __forceinline__ void chan(F& n, F& mean, F& m2, F nb, F mb, F m2b) {
  if (nb <= 0) return;
  const F tot = n + nb, d = mb - mean;
  mean += d * (nb / tot);
  m2 += m2b + d * d * (n * nb / tot);
  n = tot;
}

// Partials of operand z = blockIdx.z (x0 or x1): part[((z * B + b) *
// nblk + tile) * (2C + 1)] = count, mean[C], M2[C].
template <typename T, int N>
__global__ void __launch_bounds__(kThreads) stats_kernel(const T* __restrict__ x0,
                                                         const T* __restrict__ x1, long long V,
                                                         int C, int nblk,
                                                         float* __restrict__ part) {
  const Tile t = make_tile<N>(V, C, nblk);
  const T* x = blockIdx.z ? x1 : x0;
  const int b = blockIdx.y;
  const long long count = t.count();
  const size_t base = ((size_t)b * V + t.v0 + t.r) * C + (size_t)t.gi * N;
  float k[N], s1[N], s2[N];
#pragma unroll
  for (int i = 0; i < N; ++i) k[i] = s1[i] = s2[i] = 0.f;
  if (count > 0) Vec<T, N>::load(x + base, k);  // the shift: the thread's first voxel
  sweep<T, N, false, false>(nullptr, x, nullptr, base, (size_t)t.R * C, 0, 0, count,
                         [&](const Row<N>& row, size_t) {
#pragma unroll
                           for (int i = 0; i < N; ++i) {
                             const float d = row.a[i] - k[i];
                             s1[i] += d;
                             s2[i] = fmaf(d, d, s2[i]);
                           }
                         });
  extern __shared__ float sm[];  // [R][C] means, [R][C] M2, [R] counts
  float* sm_mean = sm;
  float* sm_m2 = sm + (size_t)t.R * C;
  float* sm_n = sm + (size_t)2 * t.R * C;
  const float n = (float)count;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const size_t j = (size_t)t.r * C + t.gi * N + i;
    sm_mean[j] = count ? k[i] + s1[i] / n : 0.f;
    sm_m2[j] = count ? fmaxf(s2[i] - s1[i] * (s1[i] / n), 0.f) : 0.f;
  }
  if (t.gi == 0) sm_n[t.r] = n;
  __syncthreads();
  float* out = part + (((size_t)blockIdx.z * gridDim.y + b) * nblk + blockIdx.x) * (2 * C + 1);
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float cn = 0.f, cm = 0.f, cq = 0.f;
    for (int r = 0; r < t.R; ++r) chan(cn, cm, cq, sm_n[r], sm_mean[r * C + c], sm_m2[r * C + c]);
    out[1 + c] = cm;
    out[1 + C + c] = cq;
  }
  if (threadIdx.x == 0) out[0] = (float)(t.v1 - t.v0);
}

// stats[z][0][b][c] = mean, stats[z][1][b][c] = 1 / sqrt(M2 / V + eps):
// one block per (z, b, c); its threads combine the nblk partials in
// double, then a fixed tree in shared memory.
__global__ void __launch_bounds__(kCombine) stats_finalize(const float* __restrict__ part, int C,
                                                           int nblk, long long V, float eps,
                                                           float* __restrict__ stats, int B) {
  const int c = blockIdx.x % C, zb = blockIdx.x / C, z = zb / B, b = zb % B, t = threadIdx.x;
  const float* p = part + (size_t)zb * nblk * (2 * C + 1);
  __shared__ double sn[kCombine], sm[kCombine], sq[kCombine];
  double n = 0., mean = 0., m2 = 0.;
  for (int j = t; j < nblk; j += kCombine) {
    const float* q = p + (size_t)j * (2 * C + 1);
    chan<double>(n, mean, m2, q[0], q[1 + c], q[1 + C + c]);
  }
  sn[t] = n;
  sm[t] = mean;
  sq[t] = m2;
  __syncthreads();
  for (int s = kCombine / 2; s > 0; s >>= 1) {
    if (t < s) chan<double>(sn[t], sm[t], sq[t], sn[t + s], sm[t + s], sq[t + s]);
    __syncthreads();
  }
  if (t == 0) {
    stats[((size_t)(2 * z) * B + b) * C + c] = (float)sm[0];
    stats[((size_t)(2 * z + 1) * B + b) * C + c] = (float)(1.0 / sqrt(sq[0] / (double)V + eps));
  }
}

template <typename T, int N, int M>
__global__ void __launch_bounds__(kThreads) apply_kernel(const T* __restrict__ x0,
                                                         const T* __restrict__ x1,
                                                         const float* __restrict__ stats, int B,
                                                         long long V, int C, int nblk,
                                                         T* __restrict__ out) {
  const Tile t = make_tile<N>(V, C, nblk);
  const int b = blockIdx.y, c0 = t.gi * N;
  float m0[N], r0[N], m1[N], r1[N];
  load_stats<N>(stats, 0, b, B, C, c0, m0, r0);
  if (M == 1) load_stats<N>(stats, 1, b, B, C, c0, m1, r1);
  const size_t base = ((size_t)b * V + t.v0 + t.r) * C + c0;
  sweep<T, N, false, M != 0>(nullptr, x0, x1, base, (size_t)t.R * C, 0, 0, t.count(),
                          [&](const Row<N>& row, size_t off) {
                            float y[N];
#pragma unroll
                            for (int i = 0; i < N; ++i) {
                              float xa, xb;
                              const float p = pre_act<M>(row.a[i], m0[i], r0[i], row.b[i],
                                                         M == 1 ? m1[i] : 0.f,
                                                         M == 1 ? r1[i] : 0.f, xa, xb);
                              y[i] = p > 0.f ? p : p * kSlope;
                            }
                            Vec<T, N>::store(out + off, y);
                          });
}

// part[(b * nblk + tile) * K * C + k * C + c], k: sum of gp, of gp * xa and
// (mode 1) of gp * xb.
template <typename T, int N, int M>
__global__ void __launch_bounds__(kThreads) bwd_reduce_kernel(
    const T* __restrict__ g, long long gs, const T* __restrict__ x0, const T* __restrict__ x1,
    const float* __restrict__ stats, int B, long long V, int C, int nblk,
    float* __restrict__ part) {
  constexpr int K = M == 1 ? 3 : 2;
  const Tile t = make_tile<N>(V, C, nblk);
  const int b = blockIdx.y, c0 = t.gi * N;
  float m0[N], r0[N], m1[N], r1[N], acc[K][N];
  load_stats<N>(stats, 0, b, B, C, c0, m0, r0);
  if (M == 1) load_stats<N>(stats, 1, b, B, C, c0, m1, r1);
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < N; ++i) acc[k][i] = 0.f;
  const size_t base = ((size_t)b * V + t.v0 + t.r) * C + c0;
  const size_t gbase = ((size_t)b * V + t.v0 + t.r) * gs + c0;
  sweep<T, N, true, M != 0>(g, x0, x1, base, (size_t)t.R * C, gbase, (size_t)t.R * gs, t.count(),
                         [&](const Row<N>& row, size_t) {
#pragma unroll
                           for (int i = 0; i < N; ++i) {
                             float xa, xb;
                             const float p = pre_act<M>(row.a[i], m0[i], r0[i], row.b[i],
                                                        M == 1 ? m1[i] : 0.f,
                                                        M == 1 ? r1[i] : 0.f, xa, xb);
                             const float gp = p > 0.f ? row.g[i] : row.g[i] * kSlope;
                             acc[0][i] += gp;
                             acc[1][i] = fmaf(gp, xa, acc[1][i]);
                             if (M == 1) acc[K - 1][i] = fmaf(gp, xb, acc[K - 1][i]);
                           }
                         });
  block_sums<K, N>(t, C, acc, part + ((size_t)b * nblk + blockIdx.x) * K * C);
}

// out[grp][j] = scale * the sum over r < rows of part[(grp * rows + r) *
// cols + j], in double: one block per (grp, j), a fixed tree in shared
// memory.
__global__ void __launch_bounds__(kCombine) sum_rows(const float* __restrict__ part, int rows,
                                                     int cols, double scale,
                                                     float* __restrict__ out) {
  const int grp = blockIdx.x / cols, j = blockIdx.x % cols, t = threadIdx.x;
  __shared__ double sh[kCombine];
  double s = 0.;
  for (int r = t; r < rows; r += kCombine) s += part[((size_t)grp * rows + r) * cols + j];
  sh[t] = s;
  __syncthreads();
  for (int h = kCombine / 2; h > 0; h >>= 1) {
    if (t < h) sh[t] += sh[t + h];
    __syncthreads();
  }
  if (t == 0) out[blockIdx.x] = (float)(sh[0] * scale);
}

// sums[b][k][c]: mean of gp, of gp * xa and (mode 1) of gp * xb. dx0 and,
// in modes 1-2, dx1 (gp itself in mode 2); part[(b * nblk + tile) * KB * C
// + k * C + c]: the sums of the dx0 (and mode 1's dx1) written, rounded.
template <typename T, int N, int M>
__global__ void __launch_bounds__(kThreads) bwd_apply_kernel(
    const T* __restrict__ g, long long gs, const T* __restrict__ x0, const T* __restrict__ x1,
    const float* __restrict__ stats, const float* __restrict__ sums, int B, long long V, int C,
    int nblk, T* __restrict__ dx0, T* __restrict__ dx1, float* __restrict__ part) {
  constexpr int K = M == 1 ? 3 : 2, KB = M == 1 ? 2 : 1;
  const Tile t = make_tile<N>(V, C, nblk);
  const int b = blockIdx.y, c0 = t.gi * N;
  float m0[N], r0[N], m1[N], r1[N], gm[N], ga[N], gb[N], db[KB][N];
  load_stats<N>(stats, 0, b, B, C, c0, m0, r0);
  if (M == 1) load_stats<N>(stats, 1, b, B, C, c0, m1, r1);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float* s = sums + (size_t)b * K * C + c0 + i;
    gm[i] = s[0];
    ga[i] = s[C];
    gb[i] = M == 1 ? s[2 * C] : 0.f;
#pragma unroll
    for (int k = 0; k < KB; ++k) db[k][i] = 0.f;
  }
  const size_t base = ((size_t)b * V + t.v0 + t.r) * C + c0;
  const size_t gbase = ((size_t)b * V + t.v0 + t.r) * gs + c0;
  sweep<T, N, true, M != 0>(g, x0, x1, base, (size_t)t.R * C, gbase, (size_t)t.R * gs, t.count(),
                         [&](const Row<N>& row, size_t off) {
                           float y0[N], y1[N];
#pragma unroll
                           for (int i = 0; i < N; ++i) {
                             float xa, xb;
                             const float p = pre_act<M>(row.a[i], m0[i], r0[i], row.b[i],
                                                        M == 1 ? m1[i] : 0.f,
                                                        M == 1 ? r1[i] : 0.f, xa, xb);
                             const float gp = p > 0.f ? row.g[i] : row.g[i] * kSlope;
                             y0[i] = round_to<T>(r0[i] * (gp - gm[i] - xa * ga[i]));
                             db[0][i] += y0[i];
                             if (M == 1) {
                               y1[i] = round_to<T>(r1[i] * (gp - gm[i] - xb * gb[i]));
                               db[KB - 1][i] += y1[i];
                             } else {
                               y1[i] = gp;
                             }
                           }
                           Vec<T, N>::store(dx0 + off, y0);
                           if (M != 0) Vec<T, N>::store(dx1 + off, y1);
                         });
  block_sums<KB, N>(t, C, db, part + ((size_t)b * nblk + blockIdx.x) * KB * C);
}

inline int last_error() { return (int)cudaGetLastError(); }

template <int N>
bool bad_shape(int B, long long V, int C, int nblk) {
  return B < 1 || B > 65535 || V < 1 || C < N || C % N || C / N > kThreads || nblk < 1 ||
         nblk > V;
}

// R rows of G = C / N channel groups: at most kThreads threads.
template <int N>
dim3 block_of(int C) {
  const int G = C / N;
  return dim3(G * (kThreads / G));
}

// Shared memory of a block holding K [R][C] float arrays (and R counts).
template <int N>
size_t shared_of(int C, int K, bool counts) {
  const int G = C / N, R = kThreads / G;
  return ((size_t)K * R * C + (counts ? R : 0)) * sizeof(float);
}

template <typename T, int N>
int stats_run(int B, long long V, int C, int nblk, int nx, const void* x0, const void* x1,
              float eps, float* part, float* stats, cudaStream_t st) {
  if (bad_shape<N>(B, V, C, nblk) || nx < 1 || nx > 2) return (int)cudaErrorInvalidValue;
  stats_kernel<T, N><<<dim3(nblk, B, nx), block_of<N>(C), shared_of<N>(C, 2, true), st>>>(
      (const T*)x0, (const T*)(nx > 1 ? x1 : x0), V, C, nblk, part);
  if (int e = last_error()) return e;
  stats_finalize<<<nx * B * C, kCombine, 0, st>>>(part, C, nblk, V, eps, stats, B);
  return last_error();
}

template <typename T, int N, int M>
int apply_run(int B, long long V, int C, int nblk, const void* x0, const void* x1,
              const float* stats, void* out, cudaStream_t st) {
  if (bad_shape<N>(B, V, C, nblk)) return (int)cudaErrorInvalidValue;
  apply_kernel<T, N, M><<<dim3(nblk, B), block_of<N>(C), 0, st>>>(
      (const T*)x0, (const T*)x1, stats, B, V, C, nblk, (T*)out);
  return last_error();
}

template <typename T, int N, int M>
int bwd_reduce_run(int B, long long V, int C, int nblk, const void* g, long long gs,
                   const void* x0, const void* x1, const float* stats, float* part, float* sums,
                   cudaStream_t st) {
  constexpr int K = M == 1 ? 3 : 2;
  if (bad_shape<N>(B, V, C, nblk) || gs < C || gs % N) return (int)cudaErrorInvalidValue;
  bwd_reduce_kernel<T, N, M><<<dim3(nblk, B), block_of<N>(C), shared_of<N>(C, K, false), st>>>(
      (const T*)g, gs, (const T*)x0, (const T*)x1, stats, B, V, C, nblk, part);
  if (int e = last_error()) return e;
  sum_rows<<<B * K * C, kCombine, 0, st>>>(part, nblk, K * C, 1.0 / (double)V, sums);
  return last_error();
}

template <typename T, int N, int M>
int bwd_apply_run(int B, long long V, int C, int nblk, const void* g, long long gs,
                  const void* x0, const void* x1, const float* stats, const float* sums,
                  void* dx0, void* dx1, float* part, float* dbias, cudaStream_t st) {
  constexpr int KB = M == 1 ? 2 : 1;
  if (bad_shape<N>(B, V, C, nblk) || gs < C || gs % N) return (int)cudaErrorInvalidValue;
  bwd_apply_kernel<T, N, M><<<dim3(nblk, B), block_of<N>(C), shared_of<N>(C, KB, false), st>>>(
      (const T*)g, gs, (const T*)x0, (const T*)x1, stats, sums, B, V, C, nblk, (T*)dx0,
      (T*)dx1, part);
  if (int e = last_error()) return e;
  sum_rows<<<KB * C, kCombine, 0, st>>>(part, B * nblk, KB * C, 1.0, dbias);
  return last_error();
}

template <typename T, int N> struct Elem {
  typedef T type;
  static constexpr int n = N;
};
template <int M> using Mode = std::integral_constant<int, M>;

// f(Elem<T, N>()) for the runtime dtype and C: N = wide<T>() where C is a
// multiple of it, else 1.
template <typename F>
int by_elem(int dtype, int C, F f) {
  if (dtype == 1) return C % wide<bf16>() ? f(Elem<bf16, 1>()) : f(Elem<bf16, wide<bf16>()>());
  if (dtype == 0)
    return C % wide<float>() ? f(Elem<float, 1>()) : f(Elem<float, wide<float>()>());
  return (int)cudaErrorInvalidValue;
}

// f(Mode<M>()) for the runtime mode.
template <typename F>
int by_mode(int mode, F f) {
  if (mode == 0) return f(Mode<0>());
  if (mode == 1) return f(Mode<1>());
  if (mode == 2) return f(Mode<2>());
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. mode: 0 = one normalised operand x0;
// 1 = x0 and x1 normalised; 2 = x0 normalised, x1 the raw residual.
// part: scratch of nx * B * nblk * (2C + 1) floats; stats: [nx][2][B][C].
extern "C" int res_norm_stats(int dtype, int B, long long V, int C, int nblk, int nx,
                              const void* x0, const void* x1, float eps, void* part,
                              void* stats, void* stream) {
  return by_elem(dtype, C, [&](auto e) {
    using E = decltype(e);
    return stats_run<typename E::type, E::n>(B, V, C, nblk, nx, x0, x1, eps, (float*)part,
                                             (float*)stats, (cudaStream_t)stream);
  });
}

extern "C" int res_norm_apply(int dtype, int mode, int B, long long V, int C, int nblk,
                              const void* x0, const void* x1, const void* stats, void* out,
                              void* stream) {
  return by_elem(dtype, C, [&](auto e) {
    using E = decltype(e);
    return by_mode(mode, [&](auto m) {
      return apply_run<typename E::type, E::n, decltype(m)::value>(
          B, V, C, nblk, x0, x1, (const float*)stats, out, (cudaStream_t)stream);
    });
  });
}

// gs: elements between neighbouring voxels of g (C for a contiguous g).
// part: scratch of B * nblk * K * C floats (K = 3 in mode 1, else 2);
// sums: [B][K][C].
extern "C" int res_norm_bwd_reduce(int dtype, int mode, int B, long long V, int C, int nblk,
                                   const void* g, long long gs, const void* x0, const void* x1,
                                   const void* stats, void* part, void* sums, void* stream) {
  return by_elem(dtype, C, [&](auto e) {
    using E = decltype(e);
    return by_mode(mode, [&](auto m) {
      return bwd_reduce_run<typename E::type, E::n, decltype(m)::value>(
          B, V, C, nblk, g, gs, x0, x1, (const float*)stats, (float*)part, (float*)sums,
          (cudaStream_t)stream);
    });
  });
}

// sums: res_norm_bwd_reduce's. part: scratch of B * nblk * KB * C floats
// (KB = 2 in mode 1, else 1); dbias: [KB][C].
extern "C" int res_norm_bwd_apply(int dtype, int mode, int B, long long V, int C, int nblk,
                                  const void* g, long long gs, const void* x0, const void* x1,
                                  const void* stats, const void* sums, void* dx0, void* dx1,
                                  void* part, void* dbias, void* stream) {
  return by_elem(dtype, C, [&](auto e) {
    using E = decltype(e);
    return by_mode(mode, [&](auto m) {
      return bwd_apply_run<typename E::type, E::n, decltype(m)::value>(
          B, V, C, nblk, g, gs, x0, x1, (const float*)stats, (const float*)sums, dx0, dx1,
          (float*)part, (float*)dbias, (cudaStream_t)stream);
    });
  });
}
