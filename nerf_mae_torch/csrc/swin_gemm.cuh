// The products of the fused Swin-block and window-attention kernels.
//
// Three forms, all C[m, n] accumulated in float32 and finished by one of the
// fused epilogues of swin_common.cuh:
//   FORM_NT  C = A W^T, A [M, K], W [N, K] (torch Linear layout): the
//            forward products;
//   FORM_NN  C = A W, W [K, N]: the backward's input gradients dh = d W;
//   FORM_TN  C = A^T B, A [K, M], B [K, N], the sum running over K token
//            rows: the weight gradients dW = D^T H, split over row ranges
//            into float32 partials that sum_parts adds in a fixed order.
//
// bf16 (gemm_tc): Hopper's TMA + mbarrier + wgmma. A 128 x 128 output tile
// per CTA; one producer warp keeps a ring of 3 shared-memory stages of
// 64-deep A and B tiles in flight with cp.async.bulk.tensor (128-byte
// swizzle, zero fill past every ragged edge, so no shape is refused for its
// tiling); two consumer warpgroups each run wgmma.mma_async m64n64k16 on 64
// rows, with one wgmma group in flight while the next stage is waited for.
// An operand whose K runs along rows (the FORM_NN weight, both FORM_TN
// operands) is read MN-major through the wgmma descriptor's transpose bit,
// so no transposing copy is made. The epilogue runs from the accumulator
// registers; colsum epilogues reduce their columns over the CTA's 128 rows
// in a fixed order and write one partial row per tile.
// What bounds it: at C = 128 (stage 0) the products are 128-deep, so the
// bytes of their operands and outputs; at C = 512 (stage 2) the tensor-core
// rate. float32 (gemm_fma): FMA units, 64 x 64 tiles, the same epilogues.
#pragma once

#include <type_traits>

namespace swin {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// 2D TMA load of one box at (c0 inner, c1 outer) into shared memory,
// completing `bytes` on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"((uint64_t)map), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle; lbo / sbo in 16-byte
// units. K-major tiles: rows of 128 bytes, 8-row groups 1024 bytes apart.
// MN-major tiles: one 64-wide MN chunk per instruction, k rows of 128
// bytes, 8-row groups 1024 bytes apart: both offsets are that stride.
__device__ __forceinline__ uint64_t gmma_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)lbo << 16) |
         ((uint64_t)sbo << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_arrive() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N> __device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma that owns them.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 64] += A[64 x 16] B[16 x 64]; TA / TB: operand is MN-major.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

constexpr int TC_BM = 128, TC_BN = 128, TC_BK = 64, TC_STAGES = 3;
constexpr int TC_THREADS = 288;  // two consumer warpgroups + one producer warp
constexpr int TC_TILE_A = TC_BM * TC_BK * 2;
constexpr int TC_TILE_B = TC_BN * TC_BK * 2;
constexpr int TC_STAGE = TC_TILE_A + TC_TILE_B;
constexpr int TC_SMEM = 1024 + TC_STAGES * TC_STAGE + 2 * TC_STAGES * 8 + TC_BM * 8;
// float32 accumulator staging in the (then idle) stage ring, rows padded by
// 8 floats against bank conflicts
constexpr int TC_PITCH = TC_BN + 8;
static_assert(TC_BM * TC_PITCH * 4 <= TC_STAGES * TC_STAGE, "staging fits the ring");

template <int A_MN, int B_MN, int MODE>
__global__ void __launch_bounds__(TC_THREADS, 1)
gemm_tc(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
        int M, int Nc, int kt_total, int kt_per, Epi e) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = (uint64_t*)(smem + TC_STAGES * TC_STAGE);
  uint64_t* empty = full + TC_STAGES;
  long long* rsrc = (long long*)(empty + TC_STAGES);  // row_source of the tile's rows

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.y * TC_BM, n0 = blockIdx.x * TC_BN;
  const int kt0 = blockIdx.z * kt_per;
  const int nk = kt_per < kt_total - kt0 ? kt_per : kt_total - kt0;

  if (tid == 0) {
    for (int s = 0; s < TC_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 8) {  // producer
    if (lane == 0) {
      for (int i = 0; i < nk; ++i) {
        const int s = i % TC_STAGES;
        if (i >= TC_STAGES) mbar_wait(&empty[s], ((i / TC_STAGES) - 1) & 1);
        unsigned char* sa = smem + s * TC_STAGE;
        unsigned char* sb = sa + TC_TILE_A;
        mbar_expect_tx(&full[s], TC_STAGE);
        const int k = (kt0 + i) * TC_BK;
        if (A_MN) {
          tma_load_2d(sa, &ta, &full[s], m0, k);
          tma_load_2d(sa + TC_TILE_A / 2, &ta, &full[s], m0 + 64, k);
        } else {
          tma_load_2d(sa, &ta, &full[s], k, m0);
        }
        if (B_MN) {
          tma_load_2d(sb, &tb, &full[s], n0, k);
          tma_load_2d(sb + TC_TILE_B / 2, &tb, &full[s], n0 + 64, k);
        } else {
          tma_load_2d(sb, &tb, &full[s], k, n0);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of the tile
  const int wg = warp / 4;
  float acc[2][32];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int r = 0; r < 32; ++r) acc[j][r] = 0.f;

  for (int i = 0; i < nk; ++i) {
    const int s = i % TC_STAGES;
    mbar_wait(&full[s], (i / TC_STAGES) & 1);
    const unsigned char* sa = smem + s * TC_STAGE + wg * (TC_TILE_A / 2);
    const unsigned char* sb = smem + s * TC_STAGE + TC_TILE_A;
    fence_regs(acc[0]);
    fence_regs(acc[1]);
    wg_arrive();
#pragma unroll
    for (int kk = 0; kk < TC_BK / 16; ++kk) {
      const uint64_t da = A_MN ? gmma_desc(sa + kk * 2048, 64, 64) : gmma_desc(sa + kk * 32, 1, 64);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const unsigned char* b = sb + j * (TC_TILE_B / 2);
        const uint64_t db = B_MN ? gmma_desc(b + kk * 2048, 64, 64) : gmma_desc(b + kk * 32, 1, 64);
        wgmma_m64n64k16<A_MN, B_MN>(acc[j], da, db);
      }
    }
    wg_commit();
    wg_wait<1>();
    fence_regs(acc[0]);
    fence_regs(acc[1]);
    if (i > 0 && tid % 128 == 0) mbar_arrive(&empty[(i - 1) % TC_STAGES]);
  }
  wg_wait<0>();
  fence_regs(acc[0]);
  fence_regs(acc[1]);

  // Epilogue. The float32 accumulators (thread: rows r, r + 8 and, per
  // 8-wide column group t of chunk j, columns 64 j + 8 t + 2 (lane % 4) +
  // {0, 1}) are staged in the idle stage ring; then each thread takes 8
  // neighbouring columns of a row, so that the epilogue's reads (bias,
  // residual, f1) and its stores are whole 16-byte vectors along rows.
  using Tr = EpiTraits<MODE>;
  typedef typename std::conditional<Tr::f32, float, bf16>::type O;
  float* stage = (float*)smem;  // [TC_BM][TC_PITCH] float32
  asm volatile("bar.sync 1, 256;" ::: "memory");  // both warpgroups done with the ring
  if (Tr::src && tid < TC_BM) rsrc[tid] = m0 + tid < M ? row_source(e.g, m0 + tid) : -1;
  {
    const int rl = wg * 64 + (warp % 4) * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *(float2*)(stage + (rl + 8 * h) * TC_PITCH + 64 * j + 8 * t + 2 * (lane % 4)) =
              make_float2(acc[j][4 * t + 2 * h], acc[j][4 * t + 2 * h + 1]);
  }
  asm volatile("bar.sync 1, 256;" ::: "memory");
  const int chunk = tid % (TC_BN / 8), n = n0 + 8 * chunk;
  float cs[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int ml = tid / (TC_BN / 8); ml < TC_BM; ml += 256 / (TC_BN / 8)) {
    const int m = m0 + ml;
    if (m >= M || n >= Nc) continue;
    const long long src = Tr::src ? rsrc[ml] : -1;
    if (Tr::scatter && src < 0) continue;
    const int b = Tr::sample ? (int)((long long)m / ((long long)e.g.nW * e.g.N)) : 0;
    const float* a = stage + ml * TC_PITCH + 8 * chunk;
    float o[2][8];
#pragma unroll
    for (int k = 0; k < 8; k += 2) {
      float v[2][2];
      const float2 c = epilogue_vals<bf16, MODE>(e, Nc, m, n + k, src, b, a[k], a[k + 1], v);
      cs[k] += c.x;
      cs[k + 1] += c.y;
#pragma unroll
      for (int p = 0; p < Tr::planes; ++p) {
        o[p][k] = v[p][0];
        o[p][k + 1] = v[p][1];
      }
    }
    const size_t i = (size_t)(Tr::scatter ? src : m) * Nc + n;
#pragma unroll
    for (int p = 0; p < Tr::planes; ++p) {
      O* dst = (O*)epi_plane<MODE>(e, p, M, Nc) + i;
      if (Tr::f32) {
        *(float4*)dst = make_float4(o[p][0], o[p][1], o[p][2], o[p][3]);
        *(float4*)((float*)dst + 4) = make_float4(o[p][4], o[p][5], o[p][6], o[p][7]);
      } else {
        uint4 r;
        *(__nv_bfloat162*)&r.x = __floats2bfloat162_rn(o[p][0], o[p][1]);
        *(__nv_bfloat162*)&r.y = __floats2bfloat162_rn(o[p][2], o[p][3]);
        *(__nv_bfloat162*)&r.z = __floats2bfloat162_rn(o[p][4], o[p][5]);
        *(__nv_bfloat162*)&r.w = __floats2bfloat162_rn(o[p][6], o[p][7]);
        *(uint4*)dst = r;
      }
    }
  }
  if (Tr::colsum) {
    // column sums over the tile's rows: each thread's rows, then the row
    // groups in order
    asm volatile("bar.sync 1, 256;" ::: "memory");
    float* red16 = stage;  // [256 / 16 row groups][TC_BN]
#pragma unroll
    for (int k = 0; k < 8; ++k) red16[(tid / (TC_BN / 8)) * TC_BN + 8 * chunk + k] = cs[k];
    asm volatile("bar.sync 1, 256;" ::: "memory");
    for (int col = tid; col < TC_BN; col += 256) {
      if (n0 + col >= Nc) continue;
      float s = 0.f;
      for (int r = 0; r < 256 / (TC_BN / 8); ++r) s += red16[r * TC_BN + col];
      e.colpart[(size_t)blockIdx.y * Nc + n0 + col] = s;
    }
  }
}

// float32 products on the FMA units (the float32 configuration): 64 x 64
// tile, 4 x 4 outputs per thread, the same forms and epilogues.
constexpr int FMA_TM = 64;

template <int A_MN, int B_MN, int MODE>
__global__ void __launch_bounds__(256)
gemm_fma(const float* __restrict__ A, const float* __restrict__ B, int M, int Nc,
         long long K, long long k_per_split, Epi e) {
  constexpr int TM = FMA_TM, TN = 64, TK = 16;
  __shared__ float As[TK][TM + 4];
  __shared__ float Bs[TK][TN + 4];
  __shared__ long long row_src[TM];
  __shared__ int row_smp[TM];
  __shared__ float red[16][TN];
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
      if (A_MN) { k = v / TM; r = v % TM; } else { r = v / TK; k = v % TK; }
      const int gm = m0 + r;
      const long long gk = k0 + k;
      As[k][r] = (gm < M && gk < ke) ? (A_MN ? A[gk * M + gm] : A[(size_t)gm * K + gk]) : 0.f;
      int c, kb2;
      if (B_MN) { kb2 = v / TN; c = v % TN; } else { c = v / TK; kb2 = v % TK; }
      const int gn = n0 + c;
      const long long gk2 = k0 + kb2;
      Bs[kb2][c] = (gn < Nc && gk2 < ke) ? (B_MN ? B[gk2 * Nc + gn] : B[(size_t)gn * K + gk2]) : 0.f;
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
  if (tid < TM) {
    const long long m = m0 + tid;
    row_src[tid] = -1;
    row_smp[tid] = 0;
    if (EpiTraits<MODE>::src && m < M) {
      row_src[tid] = row_source(e.g, m);
      row_smp[tid] = (int)(m / ((long long)e.g.nW * e.g.N));
    }
  }
  __syncthreads();
  float cs[4] = {0.f, 0.f, 0.f, 0.f};
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
    for (int jp = 0; jp < 2; ++jp) {
      const int n = n0 + tx * 4 + 2 * jp;
      if (n >= Nc) continue;
      float2 c = epilogue2<float, MODE>(e, M, Nc, m, n, row_src[ty * 4 + i],
                                        row_smp[ty * 4 + i], acc[i][2 * jp], acc[i][2 * jp + 1]);
      cs[2 * jp] += c.x;
      cs[2 * jp + 1] += c.y;
    }
  }
  if (EpiTraits<MODE>::colsum) {
    for (int j = 0; j < 4; ++j) red[ty][tx * 4 + j] = cs[j];
    __syncthreads();
    if (tid < TN && n0 + tid < Nc) {
      float s = 0.f;
      for (int y = 0; y < 16; ++y) s += red[y][tid];
      e.colpart[(size_t)blockIdx.y * Nc + n0 + tid] = s;
    }
  }
}

// ---------------------------------------------------------------------------
// Host side.
// ---------------------------------------------------------------------------

enum Form { FORM_NT = 0, FORM_NN, FORM_TN };

// Rows of one M tile: colsum epilogues write one partial row per tile.
template <typename T> inline int gemm_row_tile() { return sizeof(T) == 2 ? TC_BM : FMA_TM; }

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime (no
// link against libcuda).
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (EncodeTiledFn)p;
  }
  return fn;
}

// Tensor map of a row-major bf16 matrix [outer, inner], read in boxes of
// box_inner x box_outer with the 128-byte swizzle; zeros outside the matrix.
inline cudaError_t make_map(CUtensorMap* map, const void* ptr, long long inner,
                            long long outer, int box_inner, int box_outer) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  cuuint64_t strides[1] = {(cuuint64_t)inner * 2};
  cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_outer};
  cuuint32_t estr[2] = {1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
                  strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// C [M, Nc] of one form with epilogue MODE. K is split into ranges of
// k_per_split (0: one range; a multiple of 64 otherwise), one per grid z
// (EPI_PART writes one partial per range). T = bf16 runs gemm_tc, float
// gemm_fma. Every pointer 16-byte aligned, K and Nc multiples of 8.
template <typename T, int FORM, int MODE>
inline cudaError_t launch_gemm(const T* A, const T* B, int M, int Nc, long long K,
                               long long k_per_split, const Epi& e, cudaStream_t st) {
  constexpr int A_MN = FORM == FORM_TN, B_MN = FORM != FORM_NT;
  if (k_per_split <= 0) k_per_split = K;
  const int splits = (int)((K + k_per_split - 1) / k_per_split);
  if constexpr (sizeof(T) == 2) {
    if (splits > 1 && k_per_split % TC_BK) return cudaErrorInvalidValue;
    CUtensorMap ta, tb;
    cudaError_t err = make_map(&ta, A, A_MN ? M : K, A_MN ? K : M, 64, A_MN ? 64 : TC_BM);
    if (err != cudaSuccess) return err;
    err = make_map(&tb, B, B_MN ? Nc : K, B_MN ? K : Nc, 64, B_MN ? 64 : TC_BN);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(gemm_tc<A_MN, B_MN, MODE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, TC_SMEM);
    if (err != cudaSuccess) return err;
    const int kt = (int)((K + TC_BK - 1) / TC_BK);
    const int kt_per = (int)((k_per_split + TC_BK - 1) / TC_BK);
    dim3 grid((Nc + TC_BN - 1) / TC_BN, (M + TC_BM - 1) / TC_BM, splits);
    gemm_tc<A_MN, B_MN, MODE><<<grid, TC_THREADS, TC_SMEM, st>>>(ta, tb, M, Nc, kt, kt_per, e);
  } else {
    dim3 grid((Nc + 63) / 64, (M + FMA_TM - 1) / FMA_TM, splits);
    gemm_fma<A_MN, B_MN, MODE><<<grid, 256, 0, st>>>((const float*)A, (const float*)B, M, Nc,
                                                    K, k_per_split, e);
  }
  return cudaGetLastError();
}

// Rows per split of a weight-gradient product dW [n1, n2] summed over
// `rows` rows: whole 64-row K tiles, at least 4 per split, and enough
// splits that about two waves of CTAs (264 on 132 SMs) are in flight.
template <typename T>
inline long long wgrad_rows_per_split(long long rows, int n1, int n2) {
  const int tile = gemm_row_tile<T>();
  const long long tiles = (long long)((n1 + tile - 1) / tile) * ((n2 + tile - 1) / tile);
  const long long kt = (rows + 63) / 64;
  long long s = (264 + tiles - 1) / tiles;
  const long long cap = kt / 4 > 1 ? kt / 4 : 1;
  if (s > cap) s = cap;
  return (kt + s - 1) / s * 64;
}

template <typename T>
inline int wgrad_splits(long long rows, int n1, int n2) {
  const long long per = wgrad_rows_per_split<T>(rows, n1, n2);
  return (int)((rows + per - 1) / per);
}

// out[n1, n2] = sum_r D[r, n1] H[r, n2] over `rows` rows of the T operands,
// in float32: split-row partials, then a fixed-order sum. part holds
// wgrad_splits<T>(rows, n1, n2) * n1 * n2 floats.
template <typename T>
inline cudaError_t weight_grad(const T* D, const T* H, long long rows, int n1, int n2,
                               float* part, float* out, cudaStream_t st) {
  Epi e = {};
  e.out = part;
  cudaError_t err = launch_gemm<T, FORM_TN, EPI_PART>(
      D, H, n1, n2, rows, wgrad_rows_per_split<T>(rows, n1, n2), e, st);
  if (err != cudaSuccess) return err;
  return launch_sum_parts(part, wgrad_splits<T>(rows, n1, n2), (long long)n1 * n2, out, st);
}

}  // namespace swin
