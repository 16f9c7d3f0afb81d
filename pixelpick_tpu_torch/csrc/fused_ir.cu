// Fused inverted-residual block, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernels pixelpick_tpu/ops/fused_ir.py:_fwd_kernel
// (launched by _fused_fwd's pl.pallas_call) and :_bwd_kernel (launched by
// _fused_ir_bwd's pl.pallas_call; its math is _staged_vjp). Same function:
// one stride-1 MobileNetV2 block with ghost BatchNorm, per group of `group`
// images,
//
//   xp = zero-pad(x, d)                                   (padded domain)
//   h1 = T(xp @ we)          mu1, var1 over the padded domain, border included
//   a1 = relu6(T(bn1(h1)))
//   h2 = T(sum of the 9 taps a1[.. + tap * d] * wd[tap])  mu2, var2
//   a2 = relu6(T(bn2(h2)))
//   h3 = T(a2 @ wp)                                       mu3, var3
//   y  = T(bn3(h3)) (+ x when in == out)
//
// T is the compute dtype (float or bfloat16); sums and moments are f32;
// moments use the fast variance max(0, E[h^2] - E[h]^2); bn(h) = (h - mu) *
// (rsqrt(var + eps) * gamma) + beta. The backward recomputes h1, h2, h3 from
// x and walks the vector-Jacobian product stage by stage, as _staged_vjp
// does, with JAX's gradient rules at ties: relu6 = min(max(u, 0), 6) passes
// 0.5 of the gradient at exactly 0 and exactly 6, and max(0, z) of the
// variance 0.5 at z == 0.
//
// The TPU design holds one whole group in VMEM (~100 MB). A Hopper SM has
// 228 KB of shared memory and the group's hidden tensor is tens of MB, so
// the design here is a fixed sequence of phases, each a grid over (pixel
// tile x channel tile) of the whole batch: 64x64-output GEMM tiles from
// 16-deep shared-memory slabs, and 64-pixel x 32-channel tiles for the
// depthwise and elementwise phases. Each BatchNorm needs its group's moments
// before it can normalise, so each one is a phase boundary: every tile
// writes its per-(group, channel) partial sums, and one small kernel reduces
// them in a fixed order. The weight gradients are reductions over every
// pixel of the batch; they are split into 512-row chunks per group, and the
// chunks' partial products are summed in a fixed order. Nothing uses float
// atomics, so two calls give bit-equal results.
//
// Arithmetic: CUDA-core f32 FMA from shared-memory tiles in both dtypes
// (f32 is "highest" precision, no TF32; bf16 products are exact in f32), and
// the elementwise BatchNorm math in separately rounded multiply and add, as
// the plain PyTorch version computes it. What bounds the block on this card:
// the flops, about 2 * pixels * (Cin * Ch + Ch * Cout) + 18 * pixels * Ch
// forward, at 67 TFLOP/s f32, against the thin tensors at 3.35 TB/s. This
// first version stores h1, h2, h3 (and in the backward the gradients of the
// hidden tensors) in device memory, from scratch the caller allocates;
// recomputing instead of storing, wgmma and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr float kEps = 1e-5f;
constexpr int BM = 64, BN = 64, BK = 16, GEMM_THREADS = 256;
constexpr int TP = 64;   // pixels per tile of the depthwise/elementwise phases
constexpr int CW = 32;   // channels per CTA there
constexpr int PY = 8;    // pixel lanes per CTA there (block = CW x PY)
constexpr int SPLIT_ROWS = 512;  // pixels per chunk of a weight gradient
constexpr int EW_THREADS = 256;

static_assert(TP == BM, "GEMM and depthwise tiles share one partial layout");

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to()
}
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_float(from_float<T>(v));
}

__device__ __forceinline__ float bn_apply(float h, float mean, float mul,
                                          float beta) {
  return __fadd_rn(__fmul_rn(__fsub_rn(h, mean), mul), beta);
}

template <typename T>
__device__ __forceinline__ float bn_relu6(float h, float mean, float mul,
                                          float beta) {
  const float u = round_to<T>(bn_apply(h, mean, mul, beta));
  return fminf(fmaxf(u, 0.f), 6.f);
}

// d relu6(u) / du with JAX's rule for min/max at ties
__device__ __forceinline__ float relu6_grad(float u) {
  if (u < 0.f) return 0.f;
  if (u == 0.f) return 0.5f;
  if (u < 6.f) return 1.f;
  if (u == 6.f) return 0.5f;
  return 0.f;
}

struct Geo {
  int H, W, d;  // the unpadded image and the dilation (= the padding)
};

enum RowMap { ROW_DIRECT = 0, ROW_PAD_FROM_X = 1, ROW_INTERIOR_TO_PAD = 2 };

// Element offset of row r's first element in a row-major source with `ld`
// columns, or -1 where the row is a zero border.
// ROW_DIRECT: r indexes the source's own rows.
// ROW_PAD_FROM_X: r is a padded-domain pixel, the source is unpadded.
// ROW_INTERIOR_TO_PAD: r is an unpadded pixel, the source is padded.
__device__ __forceinline__ int64_t row_offset(int map, int64_t r, Geo g,
                                              int ld) {
  if (map == ROW_DIRECT) return r * ld;
  const int hp = g.H + 2 * g.d, wp = g.W + 2 * g.d;
  if (map == ROW_PAD_FROM_X) {
    const int64_t plane = (int64_t)hp * wp;
    const int64_t b = r / plane;
    const int rem = (int)(r - b * plane);
    const int y = rem / wp - g.d, x = rem % wp - g.d;
    if (y < 0 || y >= g.H || x < 0 || x >= g.W) return -1;
    return ((b * g.H + y) * g.W + x) * ld;
  }
  const int64_t plane = (int64_t)g.H * g.W;
  const int64_t b = r / plane;
  const int rem = (int)(r - b * plane);
  const int y = rem / g.W, x = rem % g.W;
  return ((b * hp + y + g.d) * wp + x + g.d) * ld;
}

// ---------------------------------------------------------------------------
// Row GEMM: C[r, n] = sum_k A(r, k) * B(k, n) over the rows of each group,
// 64x64 outputs per CTA, each thread 4x4. A may be a BatchNorm + ReLU6 of a
// stored pre-BN tensor, applied as it is loaded. The epilogue rounds to T and
// either stores with per-tile column sums of (v, v^2) (EPI_MOMENTS), applies
// the ReLU6 gradient mask of a BatchNormed tensor and sums (g, g*(h - mu))
// (EPI_RELU6_GRAD), or adds a residual (EPI_PLUS).

enum Epi { EPI_MOMENTS = 0, EPI_RELU6_GRAD = 1, EPI_PLUS = 2 };

struct RowGemm {
  const void* a;
  int a_map;
  int K;
  const float* a_mean;  // (ngroups, K); BN + ReLU6 on load when non-null
  const float* a_mul;   // (ngroups, K)
  const float* a_beta;  // (K)
  const void* b;
  int b_trans;  // B(k, n) = b[n * K + k] when set, else b[k * N + n]
  int N;
  int64_t rows_per_group;
  int ngroups, tiles;  // tiles of BM rows per group
  Geo geo;
  int epi;
  void* c;      // (rows, N), T
  float* part;  // (2, ngroups, tiles, N) column sums, or null
  const void* e_src;     // EPI_RELU6_GRAD: pre-BN h (rows, N); EPI_PLUS: residual or null
  const float* e_mean;   // EPI_RELU6_GRAD: BN of h, (ngroups, N)
  const float* e_mul;
  const float* e_beta;   // (N)
};

template <typename T>
__global__ void __launch_bounds__(GEMM_THREADS) row_gemm(RowGemm p) {
  __shared__ float As[BK][BM];
  __shared__ float Bs[BK][BN];
  __shared__ int64_t rows[BM];
  __shared__ float red[2][BM][BN + 1];

  const int g = blockIdx.x / p.tiles, tile = blockIdx.x % p.tiles;
  const int64_t m0 = (int64_t)tile * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int64_t base = (int64_t)g * p.rows_per_group;
  if (tid < BM) {
    const int64_t m = m0 + tid;
    rows[tid] = m < p.rows_per_group
                    ? row_offset(p.a_map, base + m, p.geo, p.K)
                    : -1;
  }
  __syncthreads();

  const T* A = static_cast<const T*>(p.a);
  const T* Bm = static_cast<const T*>(p.b);
  const float* mean = p.a_mean ? p.a_mean + (int64_t)g * p.K : nullptr;
  const float* mul = p.a_mean ? p.a_mul + (int64_t)g * p.K : nullptr;
  const int tx = tid % 16, ty = tid / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < p.K; k0 += BK) {
#pragma unroll
    for (int l = 0; l < (BM * BK) / GEMM_THREADS; ++l) {
      const int e = tid + l * GEMM_THREADS;
      const int mm = e / BK, kk = e % BK, k = k0 + kk;
      const int64_t off = rows[mm];
      float v = 0.f;
      if (off >= 0 && k < p.K) {
        v = to_float(A[off + k]);
        if (mean) v = bn_relu6<T>(v, mean[k], mul[k], p.a_beta[k]);
      }
      As[kk][mm] = v;
    }
#pragma unroll
    for (int l = 0; l < (BK * BN) / GEMM_THREADS; ++l) {
      const int e = tid + l * GEMM_THREADS;
      const int kk = e / BN, nn = e % BN, k = k0 + kk, n = n0 + nn;
      float v = 0.f;
      if (k < p.K && n < p.N)
        v = to_float(p.b_trans ? Bm[(int64_t)n * p.K + k]
                               : Bm[(int64_t)k * p.N + n]);
      Bs[kk][nn] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  T* C = static_cast<T*>(p.c);
  const T* E = static_cast<const T*>(p.e_src);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t m = m0 + ty * 4 + i;
      const int n = n0 + tx * 4 + j;
      float s1 = 0.f, s2 = 0.f;
      if (m < p.rows_per_group && n < p.N) {
        const int64_t idx = (base + m) * p.N + n;
        float v = round_to<T>(acc[i][j]);
        if (p.epi == EPI_MOMENTS) {
          s1 = v;
          s2 = __fmul_rn(v, v);
        } else if (p.epi == EPI_RELU6_GRAD) {
          const int64_t gi = (int64_t)g * p.N + n;
          const float h = to_float(E[idx]);
          const float u =
              round_to<T>(bn_apply(h, p.e_mean[gi], p.e_mul[gi], p.e_beta[n]));
          v = __fmul_rn(v, relu6_grad(u));
          s1 = v;
          s2 = __fmul_rn(v, __fsub_rn(h, p.e_mean[gi]));
        } else if (E) {
          v = round_to<T>(__fadd_rn(v, to_float(E[idx])));
        }
        C[idx] = from_float<T>(v);
      }
      red[0][ty * 4 + i][tx * 4 + j] = s1;
      red[1][ty * 4 + i][tx * 4 + j] = s2;
    }
  }
  if (p.part == nullptr) return;
  __syncthreads();
  if (tid < 2 * BN) {
    const int which = tid / BN, nn = tid % BN, n = n0 + nn;
    float s = 0.f;
    for (int mm = 0; mm < BM; ++mm) s += red[which][mm][nn];
    if (n < p.N)
      p.part[(((int64_t)which * p.ngroups + g) * p.tiles + tile) * p.N + n] = s;
  }
}

// ---------------------------------------------------------------------------
// Weight gradient, split over pixel chunks: part[s, i, j] = sum over the
// chunk's pixels p of A(p, i) * D(p, j), A optionally BN + ReLU6 of a stored
// tensor. The chunks (SPLIT_ROWS pixels, never across a group) are summed by
// sum_splits in a fixed order.

struct WGrad {
  const void* a;
  int a_map;
  int I;
  const float* a_mean;  // (ngroups, I) or null
  const float* a_mul;
  const float* a_beta;
  const void* d;
  int d_map;
  int J;
  int64_t rows_per_group;
  int ngroups, splits;  // splits per group
  Geo geo;
  float* part;  // (ngroups * splits, I, J)
};

template <typename T>
__global__ void __launch_bounds__(GEMM_THREADS) wgrad_partial(WGrad p) {
  __shared__ float As[BK][BM];
  __shared__ float Ds[BK][BN];
  __shared__ int64_t arow[BK], drow[BK];

  const int g = blockIdx.x / p.splits, s = blockIdx.x % p.splits;
  const int i0 = blockIdx.y * BM, j0 = blockIdx.z * BN;
  const int64_t base = (int64_t)g * p.rows_per_group;
  const int64_t r_begin = (int64_t)s * SPLIT_ROWS;
  const int64_t r_end = min(r_begin + SPLIT_ROWS, p.rows_per_group);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const T* A = static_cast<const T*>(p.a);
  const T* D = static_cast<const T*>(p.d);
  const float* mean = p.a_mean ? p.a_mean + (int64_t)g * p.I : nullptr;
  const float* mul = p.a_mean ? p.a_mul + (int64_t)g * p.I : nullptr;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int64_t r0 = r_begin; r0 < r_end; r0 += BK) {
    if (tid < BK) {
      const int64_t r = r0 + tid;
      arow[tid] = r < r_end ? row_offset(p.a_map, base + r, p.geo, p.I) : -1;
    } else if (tid < 2 * BK) {
      const int64_t r = r0 + tid - BK;
      drow[tid - BK] =
          r < r_end ? row_offset(p.d_map, base + r, p.geo, p.J) : -1;
    }
    __syncthreads();
#pragma unroll
    for (int l = 0; l < (BK * BM) / GEMM_THREADS; ++l) {
      const int e = tid + l * GEMM_THREADS;
      const int pp = e / BM, ii = e % BM, i = i0 + ii, j = j0 + ii;
      float v = 0.f;
      const int64_t ao = arow[pp];
      if (ao >= 0 && i < p.I) {
        v = to_float(A[ao + i]);
        if (mean) v = bn_relu6<T>(v, mean[i], mul[i], p.a_beta[i]);
      }
      As[pp][ii] = v;
      float w = 0.f;
      const int64_t dof = drow[pp];
      if (dof >= 0 && j < p.J) w = to_float(D[dof + j]);
      Ds[pp][ii] = w;
    }
    __syncthreads();
#pragma unroll
    for (int pp = 0; pp < BK; ++pp) {
      float av[4], dv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[pp][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) dv[j] = Ds[pp][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], dv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ii = i0 + ty * 4 + i, jj = j0 + tx * 4 + j;
      if (ii < p.I && jj < p.J)
        p.part[((int64_t)blockIdx.x * p.I + ii) * p.J + jj] = acc[i][j];
    }
  }
}

__global__ void sum_splits(const float* __restrict__ part, int64_t n_splits,
                           int64_t len, float* __restrict__ out) {
  const int64_t l = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= len) return;
  float s = 0.f;
  for (int64_t k = 0; k < n_splits; ++k) s += part[k * len + l];
  out[l] = s;
}

// ---------------------------------------------------------------------------
// Depthwise phases. Block (CW, PY): threadIdx.x walks channels (coalesced),
// threadIdx.y pixels of the tile.

struct DwArgs {
  const void* h1;  // (B, Hp, Wp, C) pre-BN expand output
  const void* wd;  // (3, 3, C)
  const float* mean1;  // (ngroups, C)
  const float* mul1;
  const float* beta1;  // (C)
  const void* dh2;  // backward: (B, H, W, C) gradient of h2
  void* out;        // forward: h2 (B, H, W, C); backward: g1 (B, Hp, Wp, C)
  float* part;      // (2, ngroups, tiles, C)
  int C;
  int64_t rows_per_group;  // forward G*H*W, backward G*Hp*Wp
  int ngroups, tiles;
  Geo geo;
};

template <typename T>
__device__ __forceinline__ void store_tile_sums(float (*red)[PY][CW], float s1,
                                                float s2, const DwArgs& p,
                                                int g, int tile, int c) {
  red[0][threadIdx.y][threadIdx.x] = s1;
  red[1][threadIdx.y][threadIdx.x] = s2;
  __syncthreads();
  if (threadIdx.y < 2 && c < p.C) {
    float s = 0.f;
    for (int k = 0; k < PY; ++k) s += red[threadIdx.y][k][threadIdx.x];
    p.part[(((int64_t)threadIdx.y * p.ngroups + g) * p.tiles + tile) * p.C +
           c] = s;
  }
}

// h2 = T(sum over taps of relu6(T(bn1(h1))) * wd), with its tile sums
template <typename T>
__global__ void __launch_bounds__(CW * PY) dw_forward(DwArgs p) {
  __shared__ float red[2][PY][CW];
  const int g = blockIdx.x / p.tiles, tile = blockIdx.x % p.tiles;
  const int c = blockIdx.y * CW + threadIdx.x;
  const int hp = p.geo.H + 2 * p.geo.d, wp = p.geo.W + 2 * p.geo.d;
  const int d = p.geo.d;
  float s1 = 0.f, s2 = 0.f;
  if (c < p.C) {
    const T* wd = static_cast<const T*>(p.wd);
    const T* h1 = static_cast<const T*>(p.h1);
    T* h2 = static_cast<T*>(p.out);
    float w[9];
#pragma unroll
    for (int t = 0; t < 9; ++t) w[t] = to_float(wd[t * p.C + c]);
    const int64_t gi = (int64_t)g * p.C + c;
    const float mu = p.mean1[gi], mul = p.mul1[gi], beta = p.beta1[c];
    const int64_t plane = (int64_t)p.geo.H * p.geo.W;
    for (int q = threadIdx.y; q < TP; q += PY) {
      const int64_t m = (int64_t)tile * TP + q;
      if (m >= p.rows_per_group) break;
      const int64_t r = (int64_t)g * p.rows_per_group + m;
      const int64_t b = r / plane;
      const int rem = (int)(r - b * plane);
      const int y = rem / p.geo.W, x = rem % p.geo.W;
      const T* src = h1 + ((b * hp + y) * wp + x) * p.C + c;
      float acc = 0.f;
#pragma unroll
      for (int ky = 0; ky < 3; ++ky)
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float a = bn_relu6<T>(
              to_float(src[((int64_t)ky * d * wp + kx * d) * p.C]), mu, mul,
              beta);
          acc = __fadd_rn(acc, __fmul_rn(a, w[ky * 3 + kx]));
        }
      const float v = round_to<T>(acc);
      h2[r * p.C + c] = from_float<T>(v);
      s1 += v;
      s2 += __fmul_rn(v, v);
    }
  }
  store_tile_sums<T>(red, s1, s2, p, g, tile, c);
}

// Over the padded domain: da1 = the sum of dh2 at the taps that read this
// pixel times wd, g1 = da1 * relu6'(T(bn1(h1))), with tile sums of g1 and
// g1 * (h1 - mu1).
template <typename T>
__global__ void __launch_bounds__(CW * PY) dw_backward_data(DwArgs p) {
  __shared__ float red[2][PY][CW];
  const int g = blockIdx.x / p.tiles, tile = blockIdx.x % p.tiles;
  const int c = blockIdx.y * CW + threadIdx.x;
  const int H = p.geo.H, W = p.geo.W, d = p.geo.d;
  const int hp = H + 2 * d, wp = W + 2 * d;
  float s1 = 0.f, s2 = 0.f;
  if (c < p.C) {
    const T* wd = static_cast<const T*>(p.wd);
    const T* h1 = static_cast<const T*>(p.h1);
    const T* dh2 = static_cast<const T*>(p.dh2);
    T* g1 = static_cast<T*>(p.out);
    float w[9];
#pragma unroll
    for (int t = 0; t < 9; ++t) w[t] = to_float(wd[t * p.C + c]);
    const int64_t gi = (int64_t)g * p.C + c;
    const float mu = p.mean1[gi], mul = p.mul1[gi], beta = p.beta1[c];
    const int64_t plane = (int64_t)hp * wp;
    for (int q = threadIdx.y; q < TP; q += PY) {
      const int64_t m = (int64_t)tile * TP + q;
      if (m >= p.rows_per_group) break;
      const int64_t r = (int64_t)g * p.rows_per_group + m;
      const int64_t b = r / plane;
      const int rem = (int)(r - b * plane);
      const int yq = rem / wp, xq = rem % wp;
      float acc = 0.f;
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        const int yo = yq - ky * d;
        if (yo < 0 || yo >= H) continue;
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const int xo = xq - kx * d;
          if (xo < 0 || xo >= W) continue;
          // each tap's contribution rounded to T and summed in T, as the
          // JAX VJP does (per-slice casts, then adds in the compute dtype)
          acc = round_to<T>(__fadd_rn(
              acc, round_to<T>(__fmul_rn(
                       to_float(dh2[((b * H + yo) * W + xo) * p.C + c]),
                       w[ky * 3 + kx]))));
        }
      }
      const float h = to_float(h1[r * p.C + c]);
      const float u = round_to<T>(bn_apply(h, mu, mul, beta));
      const float v = __fmul_rn(acc, relu6_grad(u));
      g1[r * p.C + c] = from_float<T>(v);
      s1 += v;
      s2 += __fmul_rn(v, __fsub_rn(h, mu));
    }
  }
  store_tile_sums<T>(red, s1, s2, p, g, tile, c);
}

// part[s, tap, c] = sum over the chunk's pixels of a1[pixel + tap] * dh2
template <typename T>
__global__ void __launch_bounds__(CW * PY) dw_backward_weight(DwArgs p,
                                                              int splits) {
  __shared__ float red[9][PY][CW];
  const int g = blockIdx.x / splits, s = blockIdx.x % splits;
  const int c = blockIdx.y * CW + threadIdx.x;
  const int H = p.geo.H, W = p.geo.W, d = p.geo.d;
  const int hp = H + 2 * d, wp = W + 2 * d;
  float acc[9];
#pragma unroll
  for (int t = 0; t < 9; ++t) acc[t] = 0.f;
  if (c < p.C) {
    const T* h1 = static_cast<const T*>(p.h1);
    const T* dh2 = static_cast<const T*>(p.dh2);
    const int64_t gi = (int64_t)g * p.C + c;
    const float mu = p.mean1[gi], mul = p.mul1[gi], beta = p.beta1[c];
    const int64_t plane = (int64_t)H * W;
    const int64_t r_end = min((int64_t)(s + 1) * SPLIT_ROWS, p.rows_per_group);
    for (int64_t m = (int64_t)s * SPLIT_ROWS + threadIdx.y; m < r_end;
         m += PY) {
      const int64_t r = (int64_t)g * p.rows_per_group + m;
      const int64_t b = r / plane;
      const int rem = (int)(r - b * plane);
      const int y = rem / W, x = rem % W;
      const float gv = to_float(dh2[r * p.C + c]);
      const T* src = h1 + ((b * hp + y) * wp + x) * p.C + c;
#pragma unroll
      for (int ky = 0; ky < 3; ++ky)
#pragma unroll
        for (int kx = 0; kx < 3; ++kx)
          acc[ky * 3 + kx] =
              fmaf(bn_relu6<T>(to_float(src[((int64_t)ky * d * wp + kx * d) *
                                            p.C]),
                               mu, mul, beta),
                   gv, acc[ky * 3 + kx]);
    }
  }
#pragma unroll
  for (int t = 0; t < 9; ++t) red[t][threadIdx.y][threadIdx.x] = acc[t];
  __syncthreads();
  if (threadIdx.y == 0 && c < p.C) {
    for (int t = 0; t < 9; ++t) {
      float v = 0.f;
      for (int k = 0; k < PY; ++k) v += red[t][k][threadIdx.x];
      p.part[((int64_t)blockIdx.x * 9 + t) * p.C + c] = v;
    }
  }
}

// ---------------------------------------------------------------------------
// BatchNorm phases.

// Tile sums of (g, g * (h - mu)) for a gradient g of a BatchNorm output.
template <typename T>
__global__ void __launch_bounds__(CW * PY)
    bn_grad_sums(const T* __restrict__ gsrc, const T* __restrict__ h,
                 const float* __restrict__ mean, int C, int64_t rows_per_group,
                 int ngroups, int tiles, float* __restrict__ part) {
  __shared__ float red[2][PY][CW];
  const int g = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  const int c = blockIdx.y * CW + threadIdx.x;
  float s1 = 0.f, s2 = 0.f;
  if (c < C) {
    const float mu = mean[(int64_t)g * C + c];
    for (int q = threadIdx.y; q < TP; q += PY) {
      const int64_t m = (int64_t)tile * TP + q;
      if (m >= rows_per_group) break;
      const int64_t idx = ((int64_t)g * rows_per_group + m) * C + c;
      const float gv = to_float(gsrc[idx]);
      s1 += gv;
      s2 += __fmul_rn(gv, __fsub_rn(to_float(h[idx]), mu));
    }
  }
  red[0][threadIdx.y][threadIdx.x] = s1;
  red[1][threadIdx.y][threadIdx.x] = s2;
  __syncthreads();
  if (threadIdx.y < 2 && c < C) {
    float s = 0.f;
    for (int k = 0; k < PY; ++k) s += red[threadIdx.y][k][threadIdx.x];
    part[(((int64_t)threadIdx.y * ngroups + g) * tiles + tile) * C + c] = s;
  }
}

// mean, var (fast variance), mul = rsqrt(var + eps) * gamma and the tie
// factor of max(0, z) per (group, channel), from the tile sums in order.
__global__ void moments_finish(const float* __restrict__ part, int ngroups,
                               int tiles, int C, float count,
                               const float* __restrict__ gamma,
                               float* __restrict__ mean,
                               float* __restrict__ var, float* __restrict__ mul,
                               float* __restrict__ tie) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (int64_t)ngroups * C) return;
  const int g = (int)(idx / C), c = (int)(idx % C);
  float s1 = 0.f, s2 = 0.f;
  for (int t = 0; t < tiles; ++t) {
    s1 += part[((int64_t)g * tiles + t) * C + c];
    s2 += part[(((int64_t)ngroups + g) * tiles + t) * C + c];
  }
  const float mu = __fdiv_rn(s1, count), m2 = __fdiv_rn(s2, count);
  const float z = __fsub_rn(m2, __fmul_rn(mu, mu));
  const float v = fmaxf(0.f, z);
  mean[idx] = mu;
  var[idx] = v;
  mul[idx] = __fmul_rn(__fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(v, kEps))),
                       gamma[c]);
  tie[idx] = z > 0.f ? 1.f : (z == 0.f ? 0.5f : 0.f);
}

// From the gradient tile sums S1 = sum g, S2 = sum g (h - mu): dgamma,
// dbeta (summed over groups in order) and per (group, channel) the
// coefficients of dh = mul * (g - S1 / n) + coef * (h - mu).
__global__ void bn_grad_finish(const float* __restrict__ part, int ngroups,
                               int tiles, int C, float count,
                               const float* __restrict__ var,
                               const float* __restrict__ tie,
                               const float* __restrict__ gamma,
                               float* __restrict__ mean_g,
                               float* __restrict__ coef,
                               float* __restrict__ dgamma,
                               float* __restrict__ dbeta) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float dg = 0.f, db = 0.f;
  for (int g = 0; g < ngroups; ++g) {
    float s1 = 0.f, s2 = 0.f;
    for (int t = 0; t < tiles; ++t) {
      s1 += part[((int64_t)g * tiles + t) * C + c];
      s2 += part[(((int64_t)ngroups + g) * tiles + t) * C + c];
    }
    const int64_t gi = (int64_t)g * C + c;
    const float r = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var[gi], kEps)));
    dg += s2 * r;
    db += s1;
    const float dz = -0.5f * r * r * r * gamma[c] * s2 * tie[gi];
    mean_g[gi] = __fdiv_rn(s1, count);
    coef[gi] = __fdiv_rn(2.f * dz, count);
  }
  dgamma[c] = dg;
  dbeta[c] = db;
}

// out = T(mul * (g - mean_g) + coef * (h - mu)); out may alias gsrc.
template <typename T>
__global__ void bn_grad_apply(const T* gsrc, const T* __restrict__ h, T* out,
                              const float* __restrict__ mean,
                              const float* __restrict__ mul,
                              const float* __restrict__ mean_g,
                              const float* __restrict__ coef, int C,
                              int64_t rows_per_group, int64_t total) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int64_t r = idx / C;
  const int c = (int)(idx % C);
  const int64_t gi = (r / rows_per_group) * C + c;
  const float v = __fadd_rn(
      __fmul_rn(mul[gi], __fsub_rn(to_float(gsrc[idx]), mean_g[gi])),
      __fmul_rn(coef[gi], __fsub_rn(to_float(h[idx]), mean[gi])));
  out[idx] = from_float<T>(v);
}

// y = T(T(bn3(h3)) + x) (or without x)
template <typename T>
__global__ void bn_output(const T* __restrict__ h3, const T* __restrict__ x,
                          T* __restrict__ y, const float* __restrict__ mean,
                          const float* __restrict__ mul,
                          const float* __restrict__ beta, int C,
                          int64_t rows_per_group, int64_t total) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int64_t r = idx / C;
  const int c = (int)(idx % C);
  const int64_t gi = (r / rows_per_group) * C + c;
  float v = round_to<T>(bn_apply(to_float(h3[idx]), mean[gi], mul[gi], beta[c]));
  if (x) v = __fadd_rn(v, to_float(x[idx]));
  y[idx] = from_float<T>(v);
}

// ---------------------------------------------------------------------------
// Host side: dimensions, the scratch layout, and the phase sequences.

struct Dims {
  int B, H, W, Cin, Ch, Cout, group, d, use_res;
  int ng() const { return B / group; }
  int hp() const { return H + 2 * d; }
  int wp() const { return W + 2 * d; }
  int64_t rpg1() const { return (int64_t)group * hp() * wp(); }  // padded
  int64_t rpg() const { return (int64_t)group * H * W; }
  int tiles1() const { return (int)((rpg1() + BM - 1) / BM); }
  int tiles() const { return (int)((rpg() + BM - 1) / BM); }
  int splits() const { return (int)((rpg() + SPLIT_ROWS - 1) / SPLIT_ROWS); }
  Geo geo() const { return Geo{H, W, d}; }
};

// Carves 256-byte-aligned pieces from the caller's workspace; with a null
// base it only counts, so the size query and the launches share one layout.
struct Carver {
  char* base;
  size_t used = 0;
  template <typename P>
  P* take(int64_t count, size_t elem = sizeof(P)) {
    const size_t off = (used + 255) & ~(size_t)255;
    used = off + (size_t)count * elem;
    return base ? reinterpret_cast<P*>(base + off) : nullptr;
  }
};

struct Stage {
  float *part, *mean, *var, *mul, *tie;
};

struct Work {
  void *h1, *h2, *h3;
  Stage s1, s2, s3;
  // backward only
  void *dh3, *g2, *g1;
  float *mg1, *cf1, *mg2, *cf2, *mg3, *cf3, *wpart;
};

Work carve(Carver& cv, const Dims& D, size_t item, bool backward,
           float* fwd_stats[6]) {
  Work w{};
  const int ng = D.ng();
  w.h1 = cv.take<char>((int64_t)D.B * D.hp() * D.wp() * D.Ch, item);
  w.h2 = cv.take<char>((int64_t)D.B * D.H * D.W * D.Ch, item);
  w.h3 = cv.take<char>((int64_t)D.B * D.H * D.W * D.Cout, item);
  const int cs[3] = {D.Ch, D.Ch, D.Cout};
  const int ts[3] = {D.tiles1(), D.tiles(), D.tiles()};
  Stage* st[3] = {&w.s1, &w.s2, &w.s3};
  for (int k = 0; k < 3; ++k) {
    st[k]->part = cv.take<float>(2LL * ng * ts[k] * cs[k]);
    if (backward) {
      st[k]->mean = cv.take<float>((int64_t)ng * cs[k]);
      st[k]->var = cv.take<float>((int64_t)ng * cs[k]);
    } else {
      st[k]->mean = fwd_stats[2 * k];
      st[k]->var = fwd_stats[2 * k + 1];
    }
    st[k]->mul = cv.take<float>((int64_t)ng * cs[k]);
    st[k]->tie = cv.take<float>((int64_t)ng * cs[k]);
  }
  if (!backward) return w;
  w.dh3 = cv.take<char>((int64_t)D.B * D.H * D.W * D.Cout, item);
  w.g2 = cv.take<char>((int64_t)D.B * D.H * D.W * D.Ch, item);
  w.g1 = cv.take<char>((int64_t)D.B * D.hp() * D.wp() * D.Ch, item);
  w.mg1 = cv.take<float>((int64_t)ng * D.Ch);
  w.cf1 = cv.take<float>((int64_t)ng * D.Ch);
  w.mg2 = cv.take<float>((int64_t)ng * D.Ch);
  w.cf2 = cv.take<float>((int64_t)ng * D.Ch);
  w.mg3 = cv.take<float>((int64_t)ng * D.Cout);
  w.cf3 = cv.take<float>((int64_t)ng * D.Cout);
  int64_t wmax = (int64_t)D.Ch * D.Cout;
  if ((int64_t)D.Cin * D.Ch > wmax) wmax = (int64_t)D.Cin * D.Ch;
  if (9LL * D.Ch > wmax) wmax = 9LL * D.Ch;
  w.wpart = cv.take<float>((int64_t)ng * D.splits() * wmax);
  return w;
}

#define PP_CHECK(expr)                     \
  do {                                     \
    cudaError_t e_ = (expr);               \
    if (e_ != cudaSuccess) return e_;      \
  } while (0)

inline unsigned blocks_for(int64_t n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

cudaError_t finish_moments(const Stage& s, int ng, int tiles, int C,
                           int64_t count, const float* gamma,
                           cudaStream_t st) {
  moments_finish<<<blocks_for((int64_t)ng * C, 128), 128, 0, st>>>(
      s.part, ng, tiles, C, (float)count, gamma, s.mean, s.var, s.mul, s.tie);
  return cudaGetLastError();
}

// The forward phases up to h3 and its moments (shared by both entries).
template <typename T>
cudaError_t forward_phases(const Dims& D, const Work& w, const void* x,
                           const void* we, const void* wd, const void* wp,
                           const float* g1, const float* b1, const float* g2,
                           const float* b2, const float* g3, cudaStream_t st) {
  const int ng = D.ng();
  // 1. expand over the padded domain
  RowGemm e{};
  e.a = x; e.a_map = ROW_PAD_FROM_X; e.K = D.Cin;
  e.b = we; e.b_trans = 0; e.N = D.Ch;
  e.rows_per_group = D.rpg1(); e.ngroups = ng; e.tiles = D.tiles1();
  e.geo = D.geo(); e.epi = EPI_MOMENTS; e.c = w.h1; e.part = w.s1.part;
  row_gemm<T><<<dim3(ng * D.tiles1(), (D.Ch + BN - 1) / BN), GEMM_THREADS,
                0, st>>>(e);
  PP_CHECK(cudaGetLastError());
  PP_CHECK(finish_moments(w.s1, ng, D.tiles1(), D.Ch, D.rpg1(), g1, st));
  // 2. depthwise with BN1 + ReLU6 on load
  DwArgs a{};
  a.h1 = w.h1; a.wd = wd; a.mean1 = w.s1.mean; a.mul1 = w.s1.mul;
  a.beta1 = b1; a.out = w.h2; a.part = w.s2.part; a.C = D.Ch;
  a.rows_per_group = D.rpg(); a.ngroups = ng; a.tiles = D.tiles();
  a.geo = D.geo();
  dw_forward<T><<<dim3(ng * D.tiles(), (D.Ch + CW - 1) / CW), dim3(CW, PY),
                  0, st>>>(a);
  PP_CHECK(cudaGetLastError());
  PP_CHECK(finish_moments(w.s2, ng, D.tiles(), D.Ch, D.rpg(), g2, st));
  // 3. project with BN2 + ReLU6 on load
  RowGemm pj{};
  pj.a = w.h2; pj.a_map = ROW_DIRECT; pj.K = D.Ch;
  pj.a_mean = w.s2.mean; pj.a_mul = w.s2.mul; pj.a_beta = b2;
  pj.b = wp; pj.b_trans = 0; pj.N = D.Cout;
  pj.rows_per_group = D.rpg(); pj.ngroups = ng; pj.tiles = D.tiles();
  pj.geo = D.geo(); pj.epi = EPI_MOMENTS; pj.c = w.h3; pj.part = w.s3.part;
  row_gemm<T><<<dim3(ng * D.tiles(), (D.Cout + BN - 1) / BN), GEMM_THREADS,
                0, st>>>(pj);
  PP_CHECK(cudaGetLastError());
  return finish_moments(w.s3, ng, D.tiles(), D.Cout, D.rpg(), g3, st);
}

template <typename T>
cudaError_t run_forward(const void* const* P, const Dims& D, cudaStream_t st) {
  float* stats[6];
  for (int k = 0; k < 6; ++k) stats[k] = (float*)P[11 + k];
  Carver cv{(char*)P[17]};
  const Work w = carve(cv, D, sizeof(T), false, stats);
  PP_CHECK(forward_phases<T>(D, w, P[0], P[1], P[2], P[3], (const float*)P[4],
                             (const float*)P[5], (const float*)P[6],
                             (const float*)P[7], (const float*)P[8], st));
  const int64_t total = (int64_t)D.B * D.H * D.W * D.Cout;
  bn_output<T><<<blocks_for(total, EW_THREADS), EW_THREADS, 0, st>>>(
      (const T*)w.h3, D.use_res ? (const T*)P[0] : nullptr, (T*)P[10],
      w.s3.mean, w.s3.mul, (const float*)P[9], D.Cout, D.rpg(), total);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_backward(const void* const* P, const Dims& D,
                         cudaStream_t st) {
  const void *x = P[0], *dy = P[1], *we = P[2], *wd = P[3], *wp = P[4];
  const float *g1 = (const float*)P[5], *b1 = (const float*)P[6],
              *g2 = (const float*)P[7], *b2 = (const float*)P[8],
              *g3 = (const float*)P[9];
  void* dx = (void*)P[11];
  float *dwe = (float*)P[12], *dwd = (float*)P[13], *dwp = (float*)P[14];
  float *dg1 = (float*)P[15], *db1 = (float*)P[16], *dg2 = (float*)P[17],
        *db2 = (float*)P[18], *dg3 = (float*)P[19], *db3 = (float*)P[20];
  Carver cv{(char*)P[21]};
  const Work w = carve(cv, D, sizeof(T), true, nullptr);
  const int ng = D.ng();
  PP_CHECK(forward_phases<T>(D, w, x, we, wd, wp, g1, b1, g2, b2, g3, st));

  // BN3: sums of dy, dy * (h3 - mu3); dgamma3, dbeta3; dh3
  bn_grad_sums<T><<<dim3(ng * D.tiles(), (D.Cout + CW - 1) / CW),
                    dim3(CW, PY), 0, st>>>((const T*)dy, (const T*)w.h3,
                                           w.s3.mean, D.Cout, D.rpg(), ng,
                                           D.tiles(), w.s3.part);
  PP_CHECK(cudaGetLastError());
  bn_grad_finish<<<blocks_for(D.Cout, 128), 128, 0, st>>>(
      w.s3.part, ng, D.tiles(), D.Cout, (float)D.rpg(), w.s3.var, w.s3.tie,
      g3, w.mg3, w.cf3, dg3, db3);
  PP_CHECK(cudaGetLastError());
  int64_t total = (int64_t)D.B * D.H * D.W * D.Cout;
  bn_grad_apply<T><<<blocks_for(total, EW_THREADS), EW_THREADS, 0, st>>>(
      (const T*)dy, (const T*)w.h3, (T*)w.dh3, w.s3.mean, w.s3.mul, w.mg3,
      w.cf3, D.Cout, D.rpg(), total);
  PP_CHECK(cudaGetLastError());

  // dWp = a2^T dh3
  const int n_splits = ng * D.splits();
  WGrad gp{};
  gp.a = w.h2; gp.a_map = ROW_DIRECT; gp.I = D.Ch;
  gp.a_mean = w.s2.mean; gp.a_mul = w.s2.mul; gp.a_beta = b2;
  gp.d = w.dh3; gp.d_map = ROW_DIRECT; gp.J = D.Cout;
  gp.rows_per_group = D.rpg(); gp.ngroups = ng; gp.splits = D.splits();
  gp.geo = D.geo(); gp.part = w.wpart;
  wgrad_partial<T><<<dim3(n_splits, (D.Ch + BM - 1) / BM,
                          (D.Cout + BN - 1) / BN),
                     GEMM_THREADS, 0, st>>>(gp);
  PP_CHECK(cudaGetLastError());
  int64_t len = (int64_t)D.Ch * D.Cout;
  sum_splits<<<blocks_for(len, EW_THREADS), EW_THREADS, 0, st>>>(
      w.wpart, n_splits, len, dwp);
  PP_CHECK(cudaGetLastError());

  // da2 = dh3 Wp^T, masked by relu6'(T(bn2(h2))), with BN2's gradient sums
  RowGemm da{};
  da.a = w.dh3; da.a_map = ROW_DIRECT; da.K = D.Cout;
  da.b = wp; da.b_trans = 1; da.N = D.Ch;
  da.rows_per_group = D.rpg(); da.ngroups = ng; da.tiles = D.tiles();
  da.geo = D.geo(); da.epi = EPI_RELU6_GRAD; da.c = w.g2; da.part = w.s2.part;
  da.e_src = w.h2; da.e_mean = w.s2.mean; da.e_mul = w.s2.mul;
  da.e_beta = b2;
  row_gemm<T><<<dim3(ng * D.tiles(), (D.Ch + BN - 1) / BN), GEMM_THREADS,
                0, st>>>(da);
  PP_CHECK(cudaGetLastError());
  bn_grad_finish<<<blocks_for(D.Ch, 128), 128, 0, st>>>(
      w.s2.part, ng, D.tiles(), D.Ch, (float)D.rpg(), w.s2.var, w.s2.tie, g2,
      w.mg2, w.cf2, dg2, db2);
  PP_CHECK(cudaGetLastError());
  total = (int64_t)D.B * D.H * D.W * D.Ch;
  bn_grad_apply<T><<<blocks_for(total, EW_THREADS), EW_THREADS, 0, st>>>(
      (const T*)w.g2, (const T*)w.h2, (T*)w.g2, w.s2.mean, w.s2.mul, w.mg2,
      w.cf2, D.Ch, D.rpg(), total);  // g2 now holds dh2
  PP_CHECK(cudaGetLastError());

  // depthwise backward: g1 over the padded domain, and dwd
  DwArgs a{};
  a.h1 = w.h1; a.wd = wd; a.mean1 = w.s1.mean; a.mul1 = w.s1.mul;
  a.beta1 = b1; a.dh2 = w.g2; a.out = w.g1; a.part = w.s1.part; a.C = D.Ch;
  a.rows_per_group = D.rpg1(); a.ngroups = ng; a.tiles = D.tiles1();
  a.geo = D.geo();
  dw_backward_data<T><<<dim3(ng * D.tiles1(), (D.Ch + CW - 1) / CW),
                        dim3(CW, PY), 0, st>>>(a);
  PP_CHECK(cudaGetLastError());
  DwArgs aw = a;
  aw.rows_per_group = D.rpg();
  aw.part = w.wpart;
  dw_backward_weight<T><<<dim3(n_splits, (D.Ch + CW - 1) / CW), dim3(CW, PY),
                          0, st>>>(aw, D.splits());
  PP_CHECK(cudaGetLastError());
  len = 9LL * D.Ch;
  sum_splits<<<blocks_for(len, EW_THREADS), EW_THREADS, 0, st>>>(
      w.wpart, n_splits, len, dwd);
  PP_CHECK(cudaGetLastError());

  // BN1 over the padded domain, border included; g1 becomes dh1
  bn_grad_finish<<<blocks_for(D.Ch, 128), 128, 0, st>>>(
      w.s1.part, ng, D.tiles1(), D.Ch, (float)D.rpg1(), w.s1.var, w.s1.tie,
      g1, w.mg1, w.cf1, dg1, db1);
  PP_CHECK(cudaGetLastError());
  total = (int64_t)D.B * D.hp() * D.wp() * D.Ch;
  bn_grad_apply<T><<<blocks_for(total, EW_THREADS), EW_THREADS, 0, st>>>(
      (const T*)w.g1, (const T*)w.h1, (T*)w.g1, w.s1.mean, w.s1.mul, w.mg1,
      w.cf1, D.Ch, D.rpg1(), total);
  PP_CHECK(cudaGetLastError());

  // dWe = x^T dh1[interior]; the border rows of xp are zero
  WGrad ge{};
  ge.a = x; ge.a_map = ROW_DIRECT; ge.I = D.Cin;
  ge.d = w.g1; ge.d_map = ROW_INTERIOR_TO_PAD; ge.J = D.Ch;
  ge.rows_per_group = D.rpg(); ge.ngroups = ng; ge.splits = D.splits();
  ge.geo = D.geo(); ge.part = w.wpart;
  wgrad_partial<T><<<dim3(n_splits, (D.Cin + BM - 1) / BM,
                          (D.Ch + BN - 1) / BN),
                     GEMM_THREADS, 0, st>>>(ge);
  PP_CHECK(cudaGetLastError());
  len = (int64_t)D.Cin * D.Ch;
  sum_splits<<<blocks_for(len, EW_THREADS), EW_THREADS, 0, st>>>(
      w.wpart, n_splits, len, dwe);
  PP_CHECK(cudaGetLastError());

  // dx = dh1[interior] We^T (+ dy)
  RowGemm dxg{};
  dxg.a = w.g1; dxg.a_map = ROW_INTERIOR_TO_PAD; dxg.K = D.Ch;
  dxg.b = we; dxg.b_trans = 1; dxg.N = D.Cin;
  dxg.rows_per_group = D.rpg(); dxg.ngroups = ng; dxg.tiles = D.tiles();
  dxg.geo = D.geo(); dxg.epi = EPI_PLUS; dxg.c = dx; dxg.part = nullptr;
  dxg.e_src = D.use_res ? dy : nullptr;
  row_gemm<T><<<dim3(ng * D.tiles(), (D.Cin + BN - 1) / BN), GEMM_THREADS,
                0, st>>>(dxg);
  return cudaGetLastError();
}

bool read_dims(const int* v, int* dtype, Dims* D) {
  *dtype = v[0];
  *D = Dims{v[1], v[2], v[3], v[4], v[5], v[6], v[7], v[8], v[9]};
  if (D->B <= 0 || D->H <= 0 || D->W <= 0 || D->Cin <= 0 || D->Ch <= 0 ||
      D->Cout <= 0 || D->group <= 0 || D->B % D->group != 0 || D->d < 1)
    return false;
  if (D->use_res && D->Cin != D->Cout) return false;
  return *dtype == 0 || *dtype == 1;
}

}  // namespace

// dims: {dtype (0 = float32, 1 = bfloat16), B, H, W, Cin, Ch, Cout, group,
// dilation, use_res}. Bytes of scratch the entry needs, 0 for bad dims.
extern "C" size_t pp_fused_ir_workspace(const int* dims, int backward) {
  int dtype;
  Dims D;
  if (!read_dims(dims, &dtype, &D)) return 0;
  float* none[6] = {};
  Carver cv{nullptr};
  carve(cv, D, dtype == 0 ? 4 : 2, backward != 0, none);
  return cv.used + 256;
}

// ptrs: x, we, wd, wp, g1, b1, g2, b2, g3, b3, y, mu1, var1, mu2, var2, mu3,
// var3, workspace. x (B, H, W, Cin), we (Cin, Ch), wd (3, 3, Ch), wp (Ch,
// Cout), y (B, H, W, Cout) in the compute dtype; the BatchNorm vectors and
// the six (B / group, C) moment outputs in f32. Returns a cudaError_t code;
// the launches are asynchronous on `stream`.
extern "C" int pp_fused_ir_fwd(const void* const* ptrs, const int* dims,
                               void* stream) {
  int dtype;
  Dims D;
  if (!read_dims(dims, &dtype, &D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 0 ? run_forward<float>(ptrs, D, s)
                          : run_forward<__nv_bfloat16>(ptrs, D, s));
}

// ptrs: x, dy, we, wd, wp, g1, b1, g2, b2, g3, b3, dx, dwe, dwd, dwp, dg1,
// db1, dg2, db2, dg3, db3, workspace. dy and dx in the compute dtype; the
// nine gradients in f32, shaped like their weights.
extern "C" int pp_fused_ir_bwd(const void* const* ptrs, const int* dims,
                               void* stream) {
  int dtype;
  Dims D;
  if (!read_dims(dims, &dtype, &D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 0 ? run_backward<float>(ptrs, D, s)
                          : run_backward<__nv_bfloat16>(ptrs, D, s));
}
