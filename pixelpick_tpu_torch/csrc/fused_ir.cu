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
// (rsqrt(var + eps) * gamma) + beta. The backward walks the vector-Jacobian
// product stage by stage, as _staged_vjp does, with JAX's gradient rules at
// ties: relu6 = min(max(u, 0), 6) passes 0.5 of the gradient at exactly 0
// and exactly 6, and max(0, z) of the variance 0.5 at z == 0.
//
// The TPU design holds one whole group in VMEM (~100 MB) and, because a
// group's hidden tensors do not fit there twice, recomputes the forward in
// the backward. A Hopper SM has 228 KB of shared memory and the group's
// hidden tensor is tens of MB, so the design here is a fixed sequence of
// phases, each a grid over (pixel tile x channel tile) of the whole batch,
// with h1, h2, h3 in device memory. Each BatchNorm needs its group's
// moments before it can normalise, so each one is a phase boundary: every
// tile writes its per-(group, channel) partial sums, and one small kernel
// reduces them in a fixed order. Nothing uses float atomics, so two calls
// give bit-equal results.
//
// Both passes run their matrix products on one register-tiled core
// (data_gemm for the products over pixel rows, bwd_wgrad for the
// backward's weight gradients): 128-row CTA tiles whose thin side is 32,
// 64 or 128 wide, chosen by the host per product to pad the least (the
// 24- and 32-channel blocks take 32); 8x4 or 8x8 outputs per thread read
// as float4s; 16-deep slabs double-buffered with cp.async, widened to f32
// once per element with the row maps and a2's BN + ReLU6 applied there.
// Where a product's grid would leave the card half idle (the 23x30
// blocks), it splits its depth, and the splits are summed in a fixed
// order by a pass that also finishes the product's epilogue.
//
// Forward (7 launches, 8 where the project splits): the expand h1 = xp We
// over the padded domain (data_gemm, the weights (K, N) as stored) with
// its tile sums; BN1's finish; the depthwise, which stages relu6(T(bn1(h1)))
// of an 8x16-pixel tile and its halo in shared memory once per element and
// takes the nine taps from there, with its tile sums; BN2's finish; the
// project h3 = a2 Wp (data_gemm, BN2 + ReLU6 of h2 applied as each slab is
// widened) with its tile sums; BN3's finish; y. The BatchNorm finishes
// reduce their tile sums with 16 lanes per channel in a fixed order. The
// workspace keeps h1 (padded), h2, h3 and each stage's BatchNorm mul and
// tie factor for the backward.
//
// Backward (16 launches, 17 where dx splits over its depth): it reads the
// forward's workspace and six moments, read only, and recomputes nothing.
// Its BatchNorm finishes reduce like the forward's. Its four matrix
// products (da2 = dh3 Wp^T with the ReLU6-gradient epilogue, dx = dh1 We^T
// (+ dy), dWp = a2^T dh3, dWe = x^T dh1) run on the core, the weights read
// row by row and transposed in shared memory. The weight products walk
// runs of pixels sized to give about one wave of CTAs. The three
// BatchNorm-input gradients dh3, dh2, dh1 are written by one elementwise
// pass each (bn_grad_apply): forming them where they are read instead was
// measured slower, as the products' loaders then carry a second operand.
//
// Arithmetic: CUDA-core f32 FMA from shared-memory tiles in both dtypes
// (f32 is "highest" precision, no TF32; bf16 products are exact in f32), and
// the elementwise BatchNorm math in separately rounded multiply and add, as
// the plain PyTorch version computes it. What bounds the block on this card:
// the flops, 2 * pixels * (Cin * Ch + Ch * Cout) + 18 * pixels * Ch forward
// and twice that backward, at 67 TFLOP/s f32, against the bytes of the thin
// tensors and the hidden h1, h2, h3 (which the forward must write for the
// backward, and the backward reads) at 3.35 TB/s: operations at the wide
// blocks, bytes at the 24-channel block. What holds the forward above that:
// at the 23x30 blocks its launches are a few microseconds of work each, so
// launch gaps, the project's split sum and the products' short grids weigh;
// at the wide blocks the products' share of the f32 rate. In the
// backward's way: the depthwise backward (one thread per pixel and
// channel, nine taps read from device memory), the products' share of the
// f32 rate, the three bn_grad_apply passes, and the launches; wgmma and
// TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr float kEps = 1e-5f;
constexpr int kMaxDilation = 15, kMaxHidden = 8192;  // read_dims
constexpr int TP = 64;  // pixels per tile of the backward's depthwise and
                        // elementwise phases
constexpr int CW = 32;  // channels per CTA of the depthwise and tile-sum phases
constexpr int PY = 8;   // pixel lanes per CTA there (block = CW x PY)
// the depthwise forward's tile of output pixels: a row per lane
constexpr int DF_ROWS = PY, DF_COLS = 16, DF_LOADS = 4;
constexpr int SPLIT_ROWS = 256;  // pixels per chunk of the depthwise weight gradient
constexpr int EW_THREADS = 256;

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

// ---------------------------------------------------------------------------
// Fixed-order finishes. A CTA of (32 columns x FY lanes) reduces 32
// consecutive columns of a (rows, len) array: lane y adds rows y, y + FY,
// ... in order, then lane 0 adds the FY lane sums in order. The rows of one
// column are read by FY lanes at once, 32 columns to a coalesced line, and
// the order depends on the shapes alone, so repeats are bit-equal.

constexpr int FX = 32, FY = 16;

// out[l] = sum over k of part[k][l]: the weight-gradient chunks. The
// CTA's FY rows of threads form FY / lanes column groups of `lanes` lanes
// (a power of two the host picks for the number of chunks), lane y adding
// k = y, y + lanes, ... in order.
__global__ void __launch_bounds__(FX * FY)
    sum_splits(const float* __restrict__ part, int64_t n_splits, int64_t len,
               int lanes, float* __restrict__ out) {
  __shared__ float red[FY][FX];
  const int grp = threadIdx.y / lanes, lane = threadIdx.y % lanes;
  const int64_t l =
      ((int64_t)blockIdx.x * (FY / lanes) + grp) * FX + threadIdx.x;
  float v = 0.f;
  if (l < len)
    for (int64_t k = lane; k < n_splits; k += lanes) v += part[k * len + l];
  red[threadIdx.y][threadIdx.x] = v;
  __syncthreads();
  if (lane == 0 && l < len) {
    float sum = 0.f;
    for (int y = 0; y < lanes; ++y) sum += red[threadIdx.y + y][threadIdx.x];
    out[l] = sum;
  }
}

inline unsigned finish_blocks(int64_t len) {
  return (unsigned)((len + FX - 1) / FX);
}

// ---------------------------------------------------------------------------
// The block's matrix products, forward and backward: register-tiled f32
// FMA.
//
// A CTA computes a GM x TW output tile: GM = 128 pixel rows in the data
// products (forward: h1, h3; backward: da2, dx), 128 hidden channels in
// the backward's weight products (dWp, dWe); TW, the width of the thin
// side, is 32, 64 or 128, chosen by the host per product to pad the
// least. Each thread holds an 8 x TN piece (TN = 4, or 8 at TW = 128), rows
// {4ty..4ty+3, 64+4ty..64+4ty+3} and columns {4tx..4tx+3 (, TW/2+4tx..)},
// read from shared memory as float4s.
// The operands go through GK-deep slabs. cp.async copies 16-byte chunks of
// the sources, in the compute dtype, into one of two raw buffers, so slab
// s + 1 is in flight while slab s is multiplied. Each thread then widens the
// chunks it copied to f32, once per element: zero where the row map gives a
// border or the slab runs past the data, BN + ReLU6 for a2. It writes them
// into one of two f32 buffers in the layout the FMAs read, transposed for
// the data products, whose operands are pixel-major. Their weights are
// read row by row, coalesced: the forward's are (K, N) and go in as they
// are, the backward's are (N, K) and are transposed in shared memory. One
// barrier per slab.

constexpr int GM = 128, GK = 16;

template <int TW>
struct GemmShape {
  static constexpr int TN = TW == 128 ? 8 : 4;
  static constexpr int TX = TW / TN;       // threads along the thin side
  static constexpr int THREADS = 16 * TX;  // 128, 256, 256
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stages elements [k, k + CH) of the source row at `off` (or nothing where
// off < 0) into dst: one cp.async where `vec` says the source rows are
// 16-byte aligned and their length a multiple of CH, else element by
// element. The elements staged are those stage_valid accepts.
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* src, int64_t off,
                                      int k, int len, bool vec) {
  constexpr int CH = 16 / sizeof(T);
  if (off < 0) return;
  if (vec) {
    if (k < len) cp_async16(dst, src + off + k);
    return;
  }
#pragma unroll
  for (int e = 0; e < CH; ++e)
    if (k + e < len) dst[e] = src[off + k + e];
}

__device__ __forceinline__ bool stage_valid(int64_t off, int k, int len) {
  return off >= 0 && k < len;
}

// Four consecutive elements of T, 16- (float) or 8-byte (bfloat16) aligned,
// as floats, and back.
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&t);
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = __bfloat162float(h[k]);
}
__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  uint2 t;
  __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&t);
#pragma unroll
  for (int k = 0; k < 4; ++k) h[k] = __float2bfloat16(v[k]);
  *reinterpret_cast<uint2*>(p) = t;
}

// A staged 16-byte chunk (4 floats or 8 bfloat16) widened to floats, and
// CH floats stored as float4s.
__device__ __forceinline__ void load_chunk(const float* p, float (&v)[4]) {
  load4(p, v);
}
__device__ __forceinline__ void load_chunk(const __nv_bfloat16* p,
                                           float (&v)[8]) {
  const uint4 t = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&t);
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = __bfloat162float(h[k]);
}
template <int CH>
__device__ __forceinline__ void store_f32(float* p, const float (&v)[CH]) {
#pragma unroll
  for (int q = 0; q < CH / 4; ++q)
    *reinterpret_cast<float4*>(p + 4 * q) =
        make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
}

// The source row of row r (a pixel of the domain `map` reads from), or -1
// for a zero border: row_offset without the channel stride, in 32 bits
// (every row index of a block fits).
__device__ __forceinline__ int source_row(int map, int r, Geo g) {
  if (map == ROW_DIRECT) return r;
  const int hp = g.H + 2 * g.d, wp = g.W + 2 * g.d;
  if (map == ROW_PAD_FROM_X) {
    const int plane = hp * wp;
    const int b = r / plane, rem = r - b * plane;
    const int y = rem / wp - g.d, x = rem % wp - g.d;
    if (y < 0 || y >= g.H || x < 0 || x >= g.W) return -1;
    return (b * g.H + y) * g.W + x;
  }
  const int plane = g.H * g.W;
  const int b = r / plane, rem = r - b * plane;
  const int y = rem / g.W, x = rem % g.W;
  return (b * hp + y + g.d) * wp + x + g.d;
}

template <int TN, int TW>
__device__ __forceinline__ void fma_slab(const float* a, int lda,
                                         const float* b, int ldb, int ty,
                                         int tx, float (&acc)[8][TN]) {
#pragma unroll
  for (int kk = 0; kk < GK; ++kk) {
    float av[8], bv[TN];
    *reinterpret_cast<float4*>(av) =
        *reinterpret_cast<const float4*>(a + kk * lda + ty * 4);
    *reinterpret_cast<float4*>(av + 4) =
        *reinterpret_cast<const float4*>(a + kk * lda + 64 + ty * 4);
#pragma unroll
    for (int q = 0; q < TN / 4; ++q)
      *reinterpret_cast<float4*>(bv + 4 * q) =
          *reinterpret_cast<const float4*>(b + kk * ldb + q * (TW / 2) +
                                           tx * 4);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

__device__ __forceinline__ int tile_row(int ty, int i) {
  return (i < 4 ? 0 : 64) + ty * 4 + (i & 3);
}
template <int TW>
__device__ __forceinline__ int tile_col(int tx, int j) {
  return (j >> 2) * (TW / 2) + tx * 4 + (j & 3);
}

// Data product C = A W over the rows of each group, A (rows, K) through a
// row map. KN: W is (K, N) row-major, the forward's expand and project;
// A may be BN + ReLU6 of a stored pre-BN tensor (a2), applied as the slab
// is widened; epilogue EPI_MOMENTS (round to T, store, per-tile column
// sums of (v, v^2)). Else W is (N, K) row-major (C = A W^T), the
// backward's da2 and dx; epilogue EPI_RELU6_GRAD (da2: the ReLU6 gradient
// mask of bn2(h2) and per-tile column sums of (g, g * (h2 - mu2))) or
// EPI_PLUS (dx: plus a residual or not).
enum Epi { EPI_RELU6_GRAD = 1, EPI_PLUS = 2, EPI_MOMENTS = 3 };

struct DataGemm {
  const void* a;
  int a_map;
  int K;
  const float* a_mean;  // KN: (ngroups, K), BN + ReLU6 on load when set
  const float* a_mul;
  const float* a_beta;  // (K)
  const void* w;
  int N;
  int64_t rows_per_group;
  int ngroups, tiles;  // tiles of GM rows per group
  Geo geo;
  int epi;
  void* c;      // (rows, N), T
  float* part;  // EPI_RELU6_GRAD, EPI_MOMENTS: (2, ngroups, tiles, N)
  const void* e_src;    // EPI_RELU6_GRAD: h2; EPI_PLUS: residual or null
  const float* e_mean;  // (ngroups, N)
  const float* e_mul;
  const float* e_beta;  // (N)
  int vec_a, vec_w;
  int vec_c;  // c, e_src and the e_ vectors take 4-wide accesses
  // split over K: CTA z takes k in [z * k_len, (z + 1) * k_len) and, where
  // k_part is set, writes its f32 sums to k_part[z] for rows_sum (EPI_PLUS)
  // or rows_sum_moments (EPI_MOMENTS) to add in order and finish
  int k_len;
  float* k_part;  // (splits, rows, N) or null
};

// The tiles' shared memory; launch_rows adds, for KN with A's BatchNorm,
// its k_len means, muls and betas.
template <typename T, int TW>
size_t rows_smem() {
  return 2 * (size_t)(GM + TW) * GK * sizeof(T) +
         2 * (size_t)GK * (GM + 4 + TW + 4) * sizeof(float);
}

template <typename T, int TW, bool KN>
__global__ void __launch_bounds__(GemmShape<TW>::THREADS)
    data_gemm(DataGemm p) {
  using S = GemmShape<TW>;
  constexpr int TN = S::TN, NT = S::THREADS;
  constexpr int CH = 16 / sizeof(T), KC = GK / CH;  // chunks per slab row
  constexpr int A_CH = GM * KC / NT;
  constexpr int W_CH = (TW * KC + NT - 1) / NT;  // both layouts: TW x GK
  constexpr int WC = TW / CH;  // KN: chunks per slab row of W
  constexpr int LDA = GM + 4, LDW = TW + 4;
  extern __shared__ __align__(16) unsigned char smem[];
  T* rawA = reinterpret_cast<T*>(smem);  // [2][GM][GK]
  T* rawW = rawA + 2 * GM * GK;  // [2][TW][GK]; KN [2][GK][TW]
  float* As = reinterpret_cast<float*>(rawW + 2 * TW * GK);  // [2][GK][LDA]
  float* Ws = As + 2 * GK * LDA;                             // [2][GK][LDW]
  float* bn = Ws + 2 * GK * LDW;  // KN with A's BN: [3][k_len]

  const int g = blockIdx.x / p.tiles, tile = blockIdx.x % p.tiles;
  const int m0 = tile * GM, n0 = blockIdx.y * TW;
  const int tid = threadIdx.x, tx = tid % S::TX, ty = tid / S::TX;
  const int64_t base = (int64_t)g * p.rows_per_group;
  const int k_begin = blockIdx.z * p.k_len;
  const int k_end = min(p.K, k_begin + p.k_len);
  const T* A = static_cast<const T*>(p.a);
  const T* W = static_cast<const T*>(p.w);
  const bool bn_a = KN && p.a_mean != nullptr;
  if (bn_a) {  // this split's channels of A's BatchNorm
    for (int k = tid; k < k_end - k_begin; k += NT) {
      bn[k] = p.a_mean[(int64_t)g * p.K + k_begin + k];
      bn[p.k_len + k] = p.a_mul[(int64_t)g * p.K + k_begin + k];
      bn[2 * p.k_len + k] = p.a_beta[k_begin + k];
    }
    __syncthreads();
  }

  int64_t a_off[A_CH], w_off[W_CH];
#pragma unroll
  for (int l = 0; l < A_CH; ++l) {
    const int m = m0 + (tid + l * NT) / KC;
    const int r =
        m < p.rows_per_group ? source_row(p.a_map, (int)(base + m), p.geo) : -1;
    a_off[l] = r < 0 ? -1 : (int64_t)r * p.K;
  }
  if (!KN) {
#pragma unroll
    for (int l = 0; l < W_CH; ++l) {
      const int c = tid + l * NT, n = n0 + c / KC;
      w_off[l] = c < TW * KC && n < p.N ? (int64_t)n * p.K : -1;
    }
  }
  // KN: the offset of W's row k0 + kk, -1 past the split's end
  auto kn_off = [&](int k) { return k < k_end ? (int64_t)k * p.N : -1; };

  auto issue = [&](int k0, int buf) {
#pragma unroll
    for (int l = 0; l < A_CH; ++l) {
      const int c = tid + l * NT;
      stage(rawA + (buf * GM + c / KC) * GK + (c % KC) * CH, A, a_off[l],
            k0 + (c % KC) * CH, k_end, p.vec_a);
    }
#pragma unroll
    for (int l = 0; l < W_CH; ++l) {
      const int c = tid + l * NT;
      if (c >= TW * KC) continue;
      if (KN) {
        const int kk = c / WC, nc = (c % WC) * CH;
        stage(rawW + (buf * GK + kk) * TW + nc, W, kn_off(k0 + kk), n0 + nc,
              p.N, p.vec_w);
      } else {
        stage(rawW + (buf * TW + c / KC) * GK + (c % KC) * CH, W, w_off[l],
              k0 + (c % KC) * CH, k_end, p.vec_w);
      }
    }
    cp_async_commit();
  };
  // widen, zero what is not data, BN + ReLU6 where asked, transpose A (and
  // the backward's W) to [k][row]
  auto convert = [&](int k0, int buf) {
#pragma unroll
    for (int l = 0; l < A_CH; ++l) {
      const int c = tid + l * NT, m = c / KC, kc = (c % KC) * CH;
      float v[CH];
      load_chunk(rawA + (buf * GM + m) * GK + kc, v);
#pragma unroll
      for (int e = 0; e < CH; ++e) {
        const int k = k0 + kc + e, j = k - k_begin;
        float u = 0.f;
        if (stage_valid(a_off[l], k, k_end))
          u = bn_a ? bn_relu6<T>(v[e], bn[j], bn[p.k_len + j],
                                 bn[2 * p.k_len + j])
                   : v[e];
        As[(buf * GK + kc + e) * LDA + m] = u;
      }
    }
#pragma unroll
    for (int l = 0; l < W_CH; ++l) {
      const int c = tid + l * NT;
      if (c >= TW * KC) continue;
      float v[CH];
      if (KN) {
        const int kk = c / WC, nc = (c % WC) * CH;
        const int64_t off = kn_off(k0 + kk);
        const int at = (buf * GK + kk) * TW + nc;
        load_chunk(rawW + at, v);
#pragma unroll
        for (int e = 0; e < CH; ++e)
          if (!stage_valid(off, n0 + nc + e, p.N)) v[e] = 0.f;
        store_f32<CH>(Ws + (buf * GK + kk) * LDW + nc, v);
      } else {
        const int n = c / KC, kc = (c % KC) * CH;
        load_chunk(rawW + (buf * TW + n) * GK + kc, v);
#pragma unroll
        for (int e = 0; e < CH; ++e)
          Ws[(buf * GK + kc + e) * LDW + n] =
              stage_valid(w_off[l], k0 + kc + e, k_end) ? v[e] : 0.f;
      }
    }
  };

  float acc[8][TN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const int slabs = (k_end - k_begin + GK - 1) / GK;
  if (slabs > 0) issue(k_begin, 0);
  for (int s = 0; s < slabs; ++s) {
    const int buf = s & 1;
    if (s + 1 < slabs) {
      issue(k_begin + (s + 1) * GK, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    convert(k_begin + s * GK, buf);
    __syncthreads();
    fma_slab<TN, TW>(As + buf * GK * LDA, LDA, Ws + buf * GK * LDW, LDW, ty,
                     tx, acc);
  }

  if (p.k_part) {  // this split's sums, for rows_sum or rows_sum_moments
    float* out = p.k_part + (int64_t)blockIdx.z * p.ngroups *
                                p.rows_per_group * p.N;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int64_t m = m0 + tile_row(ty, i);
      if (m >= p.rows_per_group) continue;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int n = n0 + tile_col<TW>(tx, j);
        if (n < p.N) out[(base + m) * p.N + n] = acc[i][j];
      }
    }
    return;
  }
  T* C = static_cast<T*>(p.c);
  const T* E = static_cast<const T*>(p.e_src);
  const bool relu6_grad_epi = !KN && p.epi == EPI_RELU6_GRAD;
  float cs1[TN], cs2[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) cs1[j] = cs2[j] = 0.f;
  // one output: round, then its moments' sums (KN), or the ReLU6-gradient
  // mask and its sums, or the residual
  auto finish = [&](float a, float h, float mean, float mul, float beta,
                    int j) {
    float v = round_to<T>(a);
    if (KN) {
      cs1[j] += v;
      cs2[j] += __fmul_rn(v, v);
    } else if (relu6_grad_epi) {
      v = __fmul_rn(v, relu6_grad(round_to<T>(bn_apply(h, mean, mul, beta))));
      cs1[j] += v;
      cs2[j] += __fmul_rn(v, __fsub_rn(h, mean));
    } else if (E) {
      v = round_to<T>(__fadd_rn(v, h));
    }
    return v;
  };
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t m = m0 + tile_row(ty, i);
    if (m >= p.rows_per_group) continue;
    const int64_t row = (base + m) * p.N;
#pragma unroll
    for (int q = 0; q < TN / 4; ++q) {
      const int nq = n0 + tile_col<TW>(tx, 4 * q);
      const int64_t gq = (int64_t)g * p.N + nq;
      if (p.vec_c && nq + 3 < p.N) {  // four columns at once
        float v[4], h[4] = {}, mean[4] = {}, mul[4] = {}, beta[4] = {};
        if (!KN && E) load4(E + row + nq, h);
        if (relu6_grad_epi) {
          load4(p.e_mean + gq, mean);
          load4(p.e_mul + gq, mul);
          load4(p.e_beta + nq, beta);
        }
#pragma unroll
        for (int k = 0; k < 4; ++k)
          v[k] = finish(acc[i][4 * q + k], h[k], mean[k], mul[k], beta[k],
                        4 * q + k);
        store4(C + row + nq, v);
        continue;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int n = nq + k;
        if (n >= p.N) continue;
        const float v =
            finish(acc[i][4 * q + k], !KN && E ? to_float(E[row + n]) : 0.f,
                   relu6_grad_epi ? p.e_mean[gq + k] : 0.f,
                   relu6_grad_epi ? p.e_mul[gq + k] : 0.f,
                   relu6_grad_epi ? p.e_beta[n] : 0.f, 4 * q + k);
        C[row + n] = from_float<T>(v);
      }
    }
  }
  if (!KN && !relu6_grad_epi) return;
  // column sums over the tile's rows: each thread's 8 rows, then the 16
  // row groups in order (As is free: every thread is past its last FMA)
  __syncthreads();
  float* red = As;  // [2][16][TW]
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    red[(0 * 16 + ty) * TW + tile_col<TW>(tx, j)] = cs1[j];
    red[(1 * 16 + ty) * TW + tile_col<TW>(tx, j)] = cs2[j];
  }
  __syncthreads();
  if (tid < 2 * TW) {
    const int which = tid / TW, nn = tid % TW, n = n0 + nn;
    float sum = 0.f;
    for (int t = 0; t < 16; ++t) sum += red[(which * 16 + t) * TW + nn];
    if (n < p.N)
      p.part[(((int64_t)which * p.ngroups + g) * p.tiles + tile) * p.N + n] =
          sum;
  }
}

// The data product's splits over K added in order, then its epilogue
// (EPI_PLUS): c = T(T(sum) + residual) or T(sum).
template <typename T>
__global__ void rows_sum(const float* __restrict__ part, int splits,
                         int64_t total, const T* __restrict__ res,
                         T* __restrict__ c) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  float v = 0.f;
  for (int z = 0; z < splits; ++z) v += part[z * total + idx];
  v = round_to<T>(v);
  if (res) v = round_to<T>(__fadd_rn(v, to_float(res[idx])));
  c[idx] = from_float<T>(v);
}

// The forward's data product split over K: the splits added in order, then
// its epilogue (EPI_MOMENTS): c = T(sum) and the column sums of (v, v^2)
// over tiles of FY rows (many small CTAs: the split's grids are the small
// ones). A CTA of (FX columns x FY lanes) per tile and FX columns: lane y
// takes the tile's row y, and lanes 0 and 1 add the FY lanes' sums in
// order.
template <typename T>
__global__ void __launch_bounds__(FX * FY)
    rows_sum_moments(const float* __restrict__ part, int splits,
                     int64_t rows_per_group, int N, int ngroups, int tiles,
                     T* __restrict__ c, float* __restrict__ tile_part) {
  __shared__ float red[2][FY][FX];
  const int g = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  const int n = blockIdx.y * FX + threadIdx.x;
  const int64_t m = (int64_t)tile * FY + threadIdx.y;
  const int64_t total = (int64_t)ngroups * rows_per_group * N;
  float s1 = 0.f, s2 = 0.f;
  if (n < N && m < rows_per_group) {
    const int64_t idx = ((int64_t)g * rows_per_group + m) * N + n;
    float v = 0.f;
#pragma unroll 4
    for (int z = 0; z < splits; ++z) v += part[z * total + idx];
    v = round_to<T>(v);
    c[idx] = from_float<T>(v);
    s1 = v;
    s2 = __fmul_rn(v, v);
  }
  red[0][threadIdx.y][threadIdx.x] = s1;
  red[1][threadIdx.y][threadIdx.x] = s2;
  __syncthreads();
  if (threadIdx.y < 2 && n < N) {
    float s = 0.f;
    for (int y = 0; y < FY; ++y) s += red[threadIdx.y][y][threadIdx.x];
    tile_part[(((int64_t)threadIdx.y * ngroups + g) * tiles + tile) * N + n] =
        s;
  }
}

// Weight product, split over pixel chunks: part[s][m * ld_m + n * ld_n] =
// sum over the chunk's pixels r of Am(r, m) * An(r, n). The GM-wide side m
// is the hidden width (a2 for dWp, BN2 + ReLU6 of h2 on load; dh1 for
// dWe), the TW-wide side n the thin tensor (dh3; x). Each chunk is a run of
// `chunk` pixels of one group; sum_splits adds the chunks in order.
struct BwdWgrad {
  const void* am;
  int am_map;
  int M;
  const float* m_mean;  // (ngroups, M): BN + ReLU6 on load when non-null
  const float* m_mul;
  const float* m_beta;  // (M)
  const void* an;
  int an_map;
  int N;
  int64_t rows_per_group;
  int ngroups, splits, chunk;
  Geo geo;
  int64_t ld_m, ld_n;
  float* part;  // (ngroups * splits, M * N)
  int vec_m, vec_n;
};

template <typename T, int TW>
size_t wgrad_smem() {
  return 2 * (size_t)GK * (GM + TW) * (sizeof(T) + sizeof(float));
}

template <typename T, int TW>
__global__ void __launch_bounds__(GemmShape<TW>::THREADS)
    bwd_wgrad(BwdWgrad p) {
  using S = GemmShape<TW>;
  constexpr int TN = S::TN, NT = S::THREADS;
  constexpr int CH = 16 / sizeof(T);
  constexpr int TPR = NT / GK;  // threads per pixel row of a slab
  constexpr int M_CH = GM / CH / TPR;
  constexpr int N_CH = (TW / CH + TPR - 1) / TPR;
  static_assert(M_CH * TPR * CH == GM, "a slab row splits evenly");
  const bool relu6 = p.m_mean != nullptr;
  extern __shared__ __align__(16) unsigned char smem[];
  T* rawM = reinterpret_cast<T*>(smem);  // [2][GK][GM]
  T* rawN = rawM + 2 * GK * GM;          // [2][GK][TW]
  float* Ms = reinterpret_cast<float*>(rawN + 2 * GK * TW);  // [2][GK][GM]
  float* Ns = Ms + 2 * GK * GM;                              // [2][GK][TW]

  const int g = blockIdx.x / p.splits, sp = blockIdx.x % p.splits;
  const int m0 = blockIdx.y * GM, n0 = blockIdx.z * TW;
  const int tid = threadIdx.x, tx = tid % S::TX, ty = tid / S::TX;
  const int pr = tid / TPR, lane = tid % TPR;  // this thread's slab row
  const int64_t base = (int64_t)g * p.rows_per_group;
  const int64_t r_begin = (int64_t)sp * p.chunk;
  const int64_t r_end = min(r_begin + p.chunk, p.rows_per_group);
  const T* Am = static_cast<const T*>(p.am);
  const T* An = static_cast<const T*>(p.an);
  // a2's BatchNorm of this CTA's channels, for the conversion
  __shared__ __align__(16) float bn_mean[GM], bn_mul[GM], bn_beta[GM];
  if (relu6 && tid < GM && m0 + tid < p.M) {
    bn_mean[tid] = p.m_mean[(int64_t)g * p.M + m0 + tid];
    bn_mul[tid] = p.m_mul[(int64_t)g * p.M + m0 + tid];
    bn_beta[tid] = p.m_beta[m0 + tid];
  }
  if (relu6) __syncthreads();

  // the source offsets of this thread's row of a slab
  auto offsets = [&](int64_t r0, int64_t& om, int64_t& on) {
    const int64_t r = r0 + pr;
    om = on = -1;
    if (r >= r_end) return;
    const int rm = source_row(p.am_map, (int)(base + r), p.geo);
    const int rn = source_row(p.an_map, (int)(base + r), p.geo);
    om = rm < 0 ? -1 : (int64_t)rm * p.M;
    on = rn < 0 ? -1 : (int64_t)rn * p.N;
  };
  auto issue = [&](int64_t om, int64_t on, int buf) {
#pragma unroll
    for (int l = 0; l < M_CH; ++l) {
      const int mc = (lane + l * TPR) * CH;
      stage(rawM + (buf * GK + pr) * GM + mc, Am, om, m0 + mc, p.M, p.vec_m);
    }
#pragma unroll
    for (int l = 0; l < N_CH; ++l) {
      const int nc = (lane + l * TPR) * CH;
      if (nc < TW)
        stage(rawN + (buf * GK + pr) * TW + nc, An, on, n0 + nc, p.N,
              p.vec_n);
    }
    cp_async_commit();
  };
  auto convert = [&](int64_t om, int64_t on, int buf) {
#pragma unroll
    for (int l = 0; l < M_CH; ++l) {
      const int mc = (lane + l * TPR) * CH;
      const int at = (buf * GK + pr) * GM + mc;
      float v[CH], mean[CH], mul[CH], beta[CH];
      load_chunk(rawM + at, v);
      if (relu6) {
#pragma unroll
        for (int q = 0; q < CH / 4; ++q) {
          load4(bn_mean + mc + 4 * q, mean + 4 * q);
          load4(bn_mul + mc + 4 * q, mul + 4 * q);
          load4(bn_beta + mc + 4 * q, beta + 4 * q);
        }
      }
#pragma unroll
      for (int e = 0; e < CH; ++e) {
        if (!stage_valid(om, m0 + mc + e, p.M))
          v[e] = 0.f;
        else if (relu6)
          v[e] = bn_relu6<T>(v[e], mean[e], mul[e], beta[e]);
      }
      store_f32<CH>(Ms + at, v);
    }
#pragma unroll
    for (int l = 0; l < N_CH; ++l) {
      const int nc = (lane + l * TPR) * CH;
      if (nc >= TW) continue;
      const int at = (buf * GK + pr) * TW + nc;
      float v[CH];
      load_chunk(rawN + at, v);
#pragma unroll
      for (int e = 0; e < CH; ++e)
        if (!stage_valid(on, n0 + nc + e, p.N)) v[e] = 0.f;
      store_f32<CH>(Ns + at, v);
    }
  };

  float acc[8][TN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const int slabs = (int)((r_end - r_begin + GK - 1) / GK);
  int64_t om = -1, on = -1, om_next = -1, on_next = -1;
  if (slabs > 0) {
    offsets(r_begin, om, on);
    issue(om, on, 0);
  }
  for (int s = 0; s < slabs; ++s) {
    const int buf = s & 1;
    if (s + 1 < slabs) {
      offsets(r_begin + (int64_t)(s + 1) * GK, om_next, on_next);
      issue(om_next, on_next, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    convert(om, on, buf);
    __syncthreads();
    fma_slab<TN, TW>(Ms + buf * GK * GM, GM, Ns + buf * GK * TW, TW, ty, tx,
                     acc);
    om = om_next;
    on = on_next;
  }

  float* out = p.part + (int64_t)blockIdx.x * p.M * p.N;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + tile_row(ty, i);
    if (m >= p.M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tile_col<TW>(tx, j);
      if (n < p.N) out[m * p.ld_m + n * p.ld_n] = acc[i][j];
    }
  }
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

// h2 = T(sum over taps of relu6(T(bn1(h1))) * wd), with its tile sums. A
// CTA takes a DF_ROWS x DF_COLS tile of one image's pixels and CW channels
// (tile = image in the group, then tile row, then tile column). It stages
// a1 = relu6(T(bn1(h1))) of the tile and its d-wide halo, read from the
// padded h1, in shared memory once per element; lane y then computes
// output row y of the tile, its DF_COLS pixels in order, each from nine
// taps there. The tile's sums: each lane's pixels in order, then the lanes
// in order.
template <typename T>
__global__ void __launch_bounds__(CW * PY) dw_forward(DwArgs p) {
  extern __shared__ float a1[];  // [DF_ROWS + 2d][DF_COLS + 2d][CW]
  __shared__ float red[2][PY][CW];
  const int H = p.geo.H, W = p.geo.W, d = p.geo.d;
  const int hp = H + 2 * d, wp = W + 2 * d;
  const int tiles_x = (W + DF_COLS - 1) / DF_COLS;
  const int per_image = (H + DF_ROWS - 1) / DF_ROWS * tiles_x;
  const int g = blockIdx.x / p.tiles, tile = blockIdx.x % p.tiles;
  const int b = g * (int)(p.rows_per_group / (H * W)) + tile / per_image;
  const int t = tile % per_image;
  const int y0 = t / tiles_x * DF_ROWS, x0 = t % tiles_x * DF_COLS;
  const int sw = DF_COLS + 2 * d, n_stage = (DF_ROWS + 2 * d) * sw;
  const int c = blockIdx.y * CW + threadIdx.x;
  const bool live = c < p.C;
  const T* h1 = static_cast<const T*>(p.h1);
  float mu = 0.f, mul = 0.f, beta = 0.f;
  if (live) {
    const int64_t gi = (int64_t)g * p.C + c;
    mu = p.mean1[gi];
    mul = p.mul1[gi];
    beta = p.beta1[c];
  }
  // Lane y stages pixels y, y + PY, ... of the staged tile: (ry, rx)
  // walks them without a division (PY < sw), DF_LOADS loads in flight
  // before their conversions and stores; 32-bit pixel indices (every pixel
  // index of a block fits).
  int ry = threadIdx.y / sw, rx = threadIdx.y % sw;
  for (int q0 = threadIdx.y; q0 < n_stage; q0 += DF_LOADS * PY) {
    float h[DF_LOADS];
    bool in[DF_LOADS];
#pragma unroll
    for (int u = 0; u < DF_LOADS; ++u) {
      const int yy = y0 + ry, xx = x0 + rx;
      in[u] = live && q0 + u * PY < n_stage && yy < hp && xx < wp;
      h[u] = in[u] ? to_float(h1[(int64_t)((b * hp + yy) * wp + xx) * p.C +
                                 c])
                   : 0.f;
      rx += PY;
      if (rx >= sw) {
        rx -= sw;
        ++ry;
      }
    }
#pragma unroll
    for (int u = 0; u < DF_LOADS; ++u) {
      const int q = q0 + u * PY;
      if (q < n_stage)
        a1[q * CW + threadIdx.x] =
            in[u] ? bn_relu6<T>(h[u], mu, mul, beta) : 0.f;
    }
  }
  __syncthreads();
  float s1 = 0.f, s2 = 0.f;
  const int y = y0 + threadIdx.y;
  if (live && y < H) {
    const T* wd = static_cast<const T*>(p.wd);
    T* h2 = static_cast<T*>(p.out);
    float w[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) w[k] = to_float(wd[k * p.C + c]);
    const float* row = a1 + threadIdx.y * sw * CW + threadIdx.x;
#pragma unroll 4
    for (int j = 0; j < DF_COLS; ++j) {
      const int x = x0 + j;
      if (x >= W) break;
      float acc = 0.f;
#pragma unroll
      for (int ky = 0; ky < 3; ++ky)
#pragma unroll
        for (int kx = 0; kx < 3; ++kx)
          acc = __fadd_rn(acc, __fmul_rn(row[(ky * d * sw + j + kx * d) * CW],
                                         w[ky * 3 + kx]));
      const float v = round_to<T>(acc);
      h2[(int64_t)((b * H + y) * W + x) * p.C + c] = from_float<T>(v);
      s1 += v;
      s2 += __fmul_rn(v, v);
    }
  }
  store_tile_sums<T>(red, s1, s2, p, g, tile, c);
}

inline size_t dw_forward_smem(int d) {
  return (size_t)(DF_ROWS + 2 * d) * (DF_COLS + 2 * d) * CW * sizeof(float);
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
    // 32-bit index arithmetic (every row index of a block fits), and the
    // tile's rows unrolled so that their loads are in flight together
    const int plane = hp * wp;
#pragma unroll
    for (int k = 0; k < TP / PY; ++k) {
      const int m = tile * TP + threadIdx.y + k * PY;
      if (m >= p.rows_per_group) continue;
      const int r = g * (int)p.rows_per_group + m;
      const int b = r / plane, rem = r - b * plane;
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
                       to_float(dh2[((int64_t)(b * H + yo) * W + xo) * p.C +
                                    c]),
                       w[ky * 3 + kx]))));
        }
      }
      const float h = to_float(h1[(int64_t)r * p.C + c]);
      const float u = round_to<T>(bn_apply(h, mu, mul, beta));
      const float v = __fmul_rn(acc, relu6_grad(u));
      g1[(int64_t)r * p.C + c] = from_float<T>(v);
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
    const int plane = H * W;
    const int r_end = min((s + 1) * SPLIT_ROWS, (int)p.rows_per_group);
    // 32-bit index arithmetic, four pixels' loads in flight at once
#pragma unroll 4
    for (int m = s * SPLIT_ROWS + threadIdx.y; m < r_end; m += PY) {
      const int r = g * (int)p.rows_per_group + m;
      const int b = r / plane, rem = r - b * plane;
      const int y = rem / W, x = rem % W;
      const float gv = to_float(dh2[(int64_t)r * p.C + c]);
      const T* src = h1 + ((int64_t)(b * hp + y) * wp + x) * p.C + c;
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
// factor of max(0, z) per (group, channel), from the tile sums in a fixed
// order: a CTA of (FX channels x FY lanes) per 32 channels and group, lane
// y adds the tiles y, y + FY, ... in order and lane 0 adds the lanes in
// order.
__global__ void __launch_bounds__(FX * FY)
    moments_finish(const float* __restrict__ part, int ngroups, int tiles,
                   int C, float count, const float* __restrict__ gamma,
                   float* __restrict__ mean, float* __restrict__ var,
                   float* __restrict__ mul, float* __restrict__ tie) {
  __shared__ float red[2][FY][FX];
  const int c = blockIdx.x * FX + threadIdx.x, g = blockIdx.y;
  float s1 = 0.f, s2 = 0.f;
  if (c < C)
    for (int t = threadIdx.y; t < tiles; t += FY) {
      s1 += part[((int64_t)g * tiles + t) * C + c];
      s2 += part[(((int64_t)ngroups + g) * tiles + t) * C + c];
    }
  red[0][threadIdx.y][threadIdx.x] = s1;
  red[1][threadIdx.y][threadIdx.x] = s2;
  __syncthreads();
  if (threadIdx.y != 0 || c >= C) return;
  s1 = s2 = 0.f;
  for (int y = 0; y < FY; ++y) {
    s1 += red[0][y][threadIdx.x];
    s2 += red[1][y][threadIdx.x];
  }
  const int64_t idx = (int64_t)g * C + c;
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
// coefficients of dh = mul * (g - S1 / n) + coef * (h - mu). A CTA of
// (FX channels x FY lanes) per 32 channels; per group, lane y adds the
// tiles y, y + FY, ... in order and lane 0 adds the lanes in order.
__global__ void __launch_bounds__(FX * FY)
    bn_grad_finish(const float* __restrict__ part, int ngroups, int tiles,
                   int C, float count, const float* __restrict__ var,
                   const float* __restrict__ tie,
                   const float* __restrict__ gamma,
                   float* __restrict__ mean_g, float* __restrict__ coef,
                   float* __restrict__ dgamma, float* __restrict__ dbeta) {
  __shared__ float red[2][FY][FX];
  const int c = blockIdx.x * FX + threadIdx.x;
  float dg = 0.f, db = 0.f;
  for (int g = 0; g < ngroups; ++g) {
    float s1 = 0.f, s2 = 0.f;
    if (c < C)
      for (int t = threadIdx.y; t < tiles; t += FY) {
        s1 += part[((int64_t)g * tiles + t) * C + c];
        s2 += part[(((int64_t)ngroups + g) * tiles + t) * C + c];
      }
    red[0][threadIdx.y][threadIdx.x] = s1;
    red[1][threadIdx.y][threadIdx.x] = s2;
    __syncthreads();
    if (threadIdx.y == 0 && c < C) {
      s1 = s2 = 0.f;
      for (int y = 0; y < FY; ++y) {
        s1 += red[0][y][threadIdx.x];
        s2 += red[1][y][threadIdx.x];
      }
      const int64_t gi = (int64_t)g * C + c;
      const float r = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var[gi], kEps)));
      dg += s2 * r;
      db += s1;
      const float dz = -0.5f * r * r * r * gamma[c] * s2 * tie[gi];
      mean_g[gi] = __fdiv_rn(s1, count);
      coef[gi] = __fdiv_rn(2.f * dz, count);
    }
    __syncthreads();
  }
  if (threadIdx.y == 0 && c < C) {
    dgamma[c] = dg;
    dbeta[c] = db;
  }
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
  // tiles of the backward's depthwise and elementwise phases
  int tiles1() const { return (int)((rpg1() + TP - 1) / TP); }
  int tiles() const { return (int)((rpg() + TP - 1) / TP); }
  // the depthwise forward's DF_ROWS x DF_COLS tiles of a group
  int dw_tiles() const {
    return group * ((H + DF_ROWS - 1) / DF_ROWS) *
           ((W + DF_COLS - 1) / DF_COLS);
  }
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

// What the forward keeps in its workspace: the pre-BN hidden tensors and,
// per stage, the tile sums (stages 1 and 3 over sum_tiles, stage 2 over
// the depthwise's pixel tiles), mul and tie (mean and var are the caller's
// six moment outputs). The backward reads it and never writes it.
struct Work {
  void *h1, *h2, *h3;
  Stage s1, s2, s3;
};

int tiles_of(int64_t rows) { return (int)((rows + GM - 1) / GM); }

// The tile width of a product's thin side: the one of 32, 64, 128 that pads
// `n` the least, the wider on a tie.
int pick_width(int n) {
  int best = 128;
  int64_t waste = (int64_t)(n + 127) / 128 * 128 - n;
  for (int w : {64, 32}) {
    const int64_t x = (int64_t)(n + w - 1) / w * w - n;
    if (x < waste) {
      best = w;
      waste = x;
    }
  }
  return best;
}

// One wave of a product's CTAs: the H100's 132 SMs times the CTAs of that
// tile width an SM holds at once (by their registers and shared memory:
// 128 threads at ~80 registers, 5; 256 at ~80, 3; 256 at ~127, 2). The
// splits below aim at one wave, for enough warps per SM to cover the
// slabs' load latency. Constants, not the card's counts, so that the fixed
// order of the sums depends on the shapes alone.
int wave_ctas(int tw) { return 132 * (tw == 32 ? 5 : tw == 64 ? 3 : 2); }

// A weight product's split: chunks of `chunk` pixels per group, as many as
// give the (groups x M-tiles x N-tiles x chunks) grid about one wave, each
// chunk at least 4 slabs.

struct WgradPlan {
  int tw, splits, chunk;
};

WgradPlan wgrad_plan(const Dims& D, int m, int n) {
  WgradPlan w{};
  w.tw = pick_width(n);
  const int64_t tiles =
      (int64_t)D.ng() * ((m + GM - 1) / GM) * ((n + w.tw - 1) / w.tw);
  const int64_t rows = D.rpg();
  int64_t splits = (wave_ctas(w.tw) + tiles - 1) / tiles;
  const int64_t most = (rows + 4 * GK - 1) / (4 * GK);
  if (splits > most) splits = most;
  if (splits < 1) splits = 1;
  int64_t chunk = (rows + splits - 1) / splits;
  chunk = (chunk + GK - 1) / GK * GK;
  w.chunk = (int)chunk;
  w.splits = (int)((rows + chunk - 1) / chunk);
  return w;
}

// A data product's plan over `row_tiles` tiles of GM rows. Its tile
// width: of the widths that pad N the least, the widest whose grid still
// gives every SM a CTA, else the narrowest. Where its CTAs would not fill
// half a wave, a split over K into runs of at least 4 slabs, summed in
// order.
struct RowsPlan {
  int tw, splits, k_len;
};

RowsPlan rows_plan(int64_t row_tiles, int K, int N, bool may_split) {
  const int least = (N + pick_width(N) - 1) / pick_width(N) * pick_width(N);
  RowsPlan r{0, 1, K};
  for (int w : {128, 64, 32}) {
    if ((N + w - 1) / w * w != least) continue;
    r.tw = w;
    if (row_tiles * ((N + w - 1) / w) >= 132) break;
  }
  const int64_t ctas = row_tiles * ((N + r.tw - 1) / r.tw);
  const int wave = wave_ctas(r.tw);
  if (!may_split || ctas >= wave / 2) return r;
  const int64_t splits =
      std::min<int64_t>((wave + ctas - 1) / ctas, K / (4 * GK));
  if (splits <= 1) return r;
  r.k_len = (int)(((K + splits - 1) / splits + GK - 1) / GK * GK);
  r.splits = (K + r.k_len - 1) / r.k_len;
  return r;
}

// The backward's data products, over the image.
RowsPlan da2_plan(const Dims& D) {
  return rows_plan((int64_t)D.ng() * tiles_of(D.rpg()), D.Cout, D.Ch, false);
}
RowsPlan dx_plan(const Dims& D) {
  return rows_plan((int64_t)D.ng() * tiles_of(D.rpg()), D.Ch, D.Cin, true);
}

// The forward's two products: the expand over the padded domain, the
// project over the image.
RowsPlan expand_plan(const Dims& D) {
  return rows_plan((int64_t)D.ng() * tiles_of(D.rpg1()), D.Cin, D.Ch, true);
}
RowsPlan project_plan(const Dims& D) {
  return rows_plan((int64_t)D.ng() * tiles_of(D.rpg()), D.Ch, D.Cout, true);
}

// The tiles of a forward product's tile sums: its GM-row tiles, or, split
// over its depth, rows_sum_moments' FY-row tiles.
int sum_tiles(const RowsPlan& r, int64_t rows) {
  return r.splits > 1 ? (int)((rows + FY - 1) / FY) : tiles_of(rows);
}

Work carve_forward(Carver& cv, const Dims& D, size_t item,
                   float* const stats[6]) {
  Work w{};
  const int ng = D.ng();
  w.h1 = cv.take<char>((int64_t)D.B * D.hp() * D.wp() * D.Ch, item);
  w.h2 = cv.take<char>((int64_t)D.B * D.H * D.W * D.Ch, item);
  w.h3 = cv.take<char>((int64_t)D.B * D.H * D.W * D.Cout, item);
  const int cs[3] = {D.Ch, D.Ch, D.Cout};
  const int ts[3] = {sum_tiles(expand_plan(D), D.rpg1()), D.dw_tiles(),
                     sum_tiles(project_plan(D), D.rpg())};
  Stage* st[3] = {&w.s1, &w.s2, &w.s3};
  for (int k = 0; k < 3; ++k) {
    st[k]->part = cv.take<float>(2LL * ng * ts[k] * cs[k]);
    st[k]->mean = stats[2 * k];
    st[k]->var = stats[2 * k + 1];
    st[k]->mul = cv.take<float>((int64_t)ng * cs[k]);
    st[k]->tie = cv.take<float>((int64_t)ng * cs[k]);
  }
  return w;
}

// The forward's scratch, free again when the call returns: the f32 sums of
// a product split over its depth.
float* carve_forward_scratch(Carver& cv, const Dims& D) {
  const RowsPlan e = expand_plan(D), p = project_plan(D);
  const int64_t need[2] = {
      e.splits > 1 ? (int64_t)e.splits * D.B * D.hp() * D.wp() * D.Ch : 0,
      p.splits > 1 ? (int64_t)p.splits * D.B * D.H * D.W * D.Cout : 0};
  return cv.take<float>(std::max(need[0], need[1]));
}

// The backward's own scratch: per stage the gradient tile sums and the
// coefficients of the BatchNorm gradient, the hidden gradients, and the
// weight-gradient partial products.
struct Back {
  float *part1, *part2, *part3;
  void *dh3, *g2, *g1;
  float *mg1, *cf1, *mg2, *cf2, *mg3, *cf3, *wpart;
};

Back carve_backward(Carver& cv, const Dims& D, size_t item) {
  Back w{};
  const int ng = D.ng();
  w.part1 = cv.take<float>(2LL * ng * D.tiles1() * D.Ch);
  w.part2 = cv.take<float>(2LL * ng * tiles_of(D.rpg()) * D.Ch);
  w.part3 = cv.take<float>(2LL * ng * D.tiles() * D.Cout);
  w.dh3 = cv.take<char>((int64_t)D.B * D.H * D.W * D.Cout, item);
  w.g2 = cv.take<char>((int64_t)D.B * D.H * D.W * D.Ch, item);
  w.g1 = cv.take<char>((int64_t)D.B * D.hp() * D.wp() * D.Ch, item);
  w.mg1 = cv.take<float>((int64_t)ng * D.Ch);
  w.cf1 = cv.take<float>((int64_t)ng * D.Ch);
  w.mg2 = cv.take<float>((int64_t)ng * D.Ch);
  w.cf2 = cv.take<float>((int64_t)ng * D.Ch);
  w.mg3 = cv.take<float>((int64_t)ng * D.Cout);
  w.cf3 = cv.take<float>((int64_t)ng * D.Cout);
  // partial products of dWp, dwd, dWe and dx in turn
  const RowsPlan dxp = dx_plan(D);
  const int64_t need[4] = {
      (int64_t)ng * wgrad_plan(D, D.Ch, D.Cout).splits * D.Ch * D.Cout,
      (int64_t)ng * D.splits() * 9 * D.Ch,
      (int64_t)ng * wgrad_plan(D, D.Ch, D.Cin).splits * D.Cin * D.Ch,
      dxp.splits > 1 ? (int64_t)dxp.splits * D.B * D.H * D.W * D.Cin : 0};
  w.wpart = cv.take<float>(*std::max_element(need, need + 4));
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

// Whether a cp.async of 16 bytes can carry every chunk of a source whose
// rows hold `ld` elements of `item` bytes.
int vec_ok(const void* p, int ld, size_t item) {
  return (reinterpret_cast<uintptr_t>(p) % 16 == 0) && (ld * item) % 16 == 0;
}

// Whether a data product's epilogue can read and write four columns at
// once: N a multiple of 4 and every pointer it touches aligned to that.
int vec_out(const DataGemm& p, size_t item) {
  auto at = [](const void* q, size_t n) {
    return q == nullptr || reinterpret_cast<uintptr_t>(q) % n == 0;
  };
  return p.N % 4 == 0 && at(p.c, 4 * item) && at(p.e_src, 4 * item) &&
         at(p.e_mean, 16) && at(p.e_mul, 16) && at(p.e_beta, 16);
}

template <typename T, int TW, bool KN>
cudaError_t launch_rows(const DataGemm& p, int splits, cudaStream_t st) {
  const size_t smem = rows_smem<T, TW>() +
                      (KN && p.a_mean ? 3 * (size_t)p.k_len * sizeof(float)
                                      : 0);
  PP_CHECK(cudaFuncSetAttribute(data_gemm<T, TW, KN>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem));
  data_gemm<T, TW, KN>
      <<<dim3(p.ngroups * p.tiles, (p.N + TW - 1) / TW, splits),
         GemmShape<TW>::THREADS, smem, st>>>(p);
  return cudaGetLastError();
}

// The data product as `plan` says (KN: the forward's, W (K, N)); a split
// over K goes through `scratch` and rows_sum_moments (KN) or rows_sum.
template <typename T, bool KN>
cudaError_t data_product(DataGemm p, const RowsPlan& plan, float* scratch,
                         cudaStream_t st) {
  p.tiles = tiles_of(p.rows_per_group);
  p.k_len = plan.k_len;
  p.k_part = plan.splits > 1 ? scratch : nullptr;
  switch (plan.tw) {
    case 32: PP_CHECK((launch_rows<T, 32, KN>(p, plan.splits, st))); break;
    case 64: PP_CHECK((launch_rows<T, 64, KN>(p, plan.splits, st))); break;
    default: PP_CHECK((launch_rows<T, 128, KN>(p, plan.splits, st))); break;
  }
  if (plan.splits == 1) return cudaSuccess;
  if (KN) {
    const int tiles = sum_tiles(plan, p.rows_per_group);
    rows_sum_moments<T><<<dim3(p.ngroups * tiles, finish_blocks(p.N)),
                          dim3(FX, FY), 0, st>>>(
        scratch, plan.splits, p.rows_per_group, p.N, p.ngroups, tiles,
        static_cast<T*>(p.c), p.part);
    return cudaGetLastError();
  }
  const int64_t total = (int64_t)p.ngroups * p.rows_per_group * p.N;
  rows_sum<T><<<blocks_for(total, EW_THREADS), EW_THREADS, 0, st>>>(
      scratch, plan.splits, total, static_cast<const T*>(p.e_src),
      static_cast<T*>(p.c));
  return cudaGetLastError();
}

template <typename T, int TW>
cudaError_t launch_wgrad(const BwdWgrad& p, cudaStream_t st) {
  const size_t smem = wgrad_smem<T, TW>();
  PP_CHECK(cudaFuncSetAttribute(bwd_wgrad<T, TW>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem));
  bwd_wgrad<T, TW><<<dim3(p.ngroups * p.splits, (p.M + GM - 1) / GM,
                          (p.N + TW - 1) / TW),
                     GemmShape<TW>::THREADS, smem, st>>>(p);
  return cudaGetLastError();
}

// sum_splits with about 4 chunks per lane, at most FY lanes per column.
cudaError_t sum_chunks(const float* part, int64_t n_splits, int64_t len,
                       float* out, cudaStream_t st) {
  int lanes = 1;
  while (lanes < FY && 8 * lanes <= n_splits) lanes *= 2;
  const int64_t cols = (int64_t)FX * (FY / lanes);
  sum_splits<<<(unsigned)((len + cols - 1) / cols), dim3(FX, FY), 0, st>>>(
      part, n_splits, len, lanes, out);
  return cudaGetLastError();
}

// The weight product and the fixed-order sum of its chunks into `out`.
template <typename T>
cudaError_t weight_product(const BwdWgrad& p, int tw, float* out,
                           cudaStream_t st) {
  switch (tw) {
    case 32: PP_CHECK((launch_wgrad<T, 32>(p, st))); break;
    case 64: PP_CHECK((launch_wgrad<T, 64>(p, st))); break;
    default: PP_CHECK((launch_wgrad<T, 128>(p, st))); break;
  }
  return sum_chunks(p.part, (int64_t)p.ngroups * p.splits,
                    (int64_t)p.M * p.N, out, st);
}

cudaError_t finish_moments(const Stage& s, int ng, int tiles, int C,
                           int64_t count, const float* gamma,
                           cudaStream_t st) {
  moments_finish<<<dim3(finish_blocks(C), ng), dim3(FX, FY), 0, st>>>(
      s.part, ng, tiles, C, (float)count, gamma, s.mean, s.var, s.mul, s.tie);
  return cudaGetLastError();
}

// The forward phases up to h3 and its moments.
template <typename T>
cudaError_t forward_phases(const Dims& D, const Work& w, float* scratch,
                           const void* x, const void* we, const void* wd,
                           const void* wp, const float* g1, const float* b1,
                           const float* g2, const float* b2, const float* g3,
                           cudaStream_t st) {
  const int ng = D.ng();
  const size_t item = sizeof(T);
  // 1. expand over the padded domain, with its tile sums
  DataGemm e{};
  e.a = x; e.a_map = ROW_PAD_FROM_X; e.K = D.Cin;
  e.w = we; e.N = D.Ch;
  e.rows_per_group = D.rpg1(); e.ngroups = ng; e.geo = D.geo();
  e.epi = EPI_MOMENTS; e.c = w.h1; e.part = w.s1.part;
  e.vec_a = vec_ok(x, D.Cin, item); e.vec_w = vec_ok(we, D.Ch, item);
  e.vec_c = vec_out(e, item);
  PP_CHECK((data_product<T, true>(e, expand_plan(D), scratch, st)));
  PP_CHECK(finish_moments(w.s1, ng, sum_tiles(expand_plan(D), D.rpg1()), D.Ch,
                          D.rpg1(), g1, st));
  // 2. depthwise with BN1 + ReLU6 on load
  DwArgs a{};
  a.h1 = w.h1; a.wd = wd; a.mean1 = w.s1.mean; a.mul1 = w.s1.mul;
  a.beta1 = b1; a.out = w.h2; a.part = w.s2.part; a.C = D.Ch;
  a.rows_per_group = D.rpg(); a.ngroups = ng; a.tiles = D.dw_tiles();
  a.geo = D.geo();
  const size_t smem = dw_forward_smem(D.d);
  PP_CHECK(cudaFuncSetAttribute(dw_forward<T>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem));
  dw_forward<T><<<dim3(ng * D.dw_tiles(), (D.Ch + CW - 1) / CW),
                  dim3(CW, PY), smem, st>>>(a);
  PP_CHECK(cudaGetLastError());
  PP_CHECK(finish_moments(w.s2, ng, D.dw_tiles(), D.Ch, D.rpg(), g2, st));
  // 3. project with BN2 + ReLU6 on load, with its tile sums
  DataGemm pj{};
  pj.a = w.h2; pj.a_map = ROW_DIRECT; pj.K = D.Ch;
  pj.a_mean = w.s2.mean; pj.a_mul = w.s2.mul; pj.a_beta = b2;
  pj.w = wp; pj.N = D.Cout;
  pj.rows_per_group = D.rpg(); pj.ngroups = ng; pj.geo = D.geo();
  pj.epi = EPI_MOMENTS; pj.c = w.h3; pj.part = w.s3.part;
  pj.vec_a = vec_ok(w.h2, D.Ch, item); pj.vec_w = vec_ok(wp, D.Cout, item);
  pj.vec_c = vec_out(pj, item);
  PP_CHECK((data_product<T, true>(pj, project_plan(D), scratch, st)));
  return finish_moments(w.s3, ng, sum_tiles(project_plan(D), D.rpg()), D.Cout,
                        D.rpg(), g3, st);
}

template <typename T>
cudaError_t run_forward(const void* const* P, const Dims& D, cudaStream_t st) {
  float* stats[6];
  for (int k = 0; k < 6; ++k) stats[k] = (float*)P[11 + k];
  Carver cv{(char*)P[17]};
  const Work w = carve_forward(cv, D, sizeof(T), stats);
  Carver sv{(char*)P[18]};
  float* scratch = carve_forward_scratch(sv, D);
  PP_CHECK(forward_phases<T>(D, w, scratch, P[0], P[1], P[2], P[3],
                             (const float*)P[4], (const float*)P[5],
                             (const float*)P[6], (const float*)P[7],
                             (const float*)P[8], st));
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
  float* stats[6];
  for (int k = 0; k < 6; ++k) stats[k] = (float*)P[21 + k];
  Carver fv{(char*)P[27]};
  const Work f = carve_forward(fv, D, sizeof(T), stats);  // read only
  Carver cv{(char*)P[28]};
  const Back w = carve_backward(cv, D, sizeof(T));
  const int ng = D.ng();

  // BN3: sums of dy, dy * (h3 - mu3); dgamma3, dbeta3; dh3
  bn_grad_sums<T><<<dim3(ng * D.tiles(), (D.Cout + CW - 1) / CW),
                    dim3(CW, PY), 0, st>>>((const T*)dy, (const T*)f.h3,
                                           f.s3.mean, D.Cout, D.rpg(), ng,
                                           D.tiles(), w.part3);
  PP_CHECK(cudaGetLastError());
  bn_grad_finish<<<finish_blocks(D.Cout), dim3(FX, FY), 0, st>>>(
      w.part3, ng, D.tiles(), D.Cout, (float)D.rpg(), f.s3.var, f.s3.tie,
      g3, w.mg3, w.cf3, dg3, db3);
  PP_CHECK(cudaGetLastError());
  int64_t total = (int64_t)D.B * D.H * D.W * D.Cout;
  bn_grad_apply<T><<<blocks_for(total, EW_THREADS), EW_THREADS, 0, st>>>(
      (const T*)dy, (const T*)f.h3, (T*)w.dh3, f.s3.mean, f.s3.mul, w.mg3,
      w.cf3, D.Cout, D.rpg(), total);
  PP_CHECK(cudaGetLastError());

  // dWp = a2^T dh3
  const size_t item = sizeof(T);
  const WgradPlan pp = wgrad_plan(D, D.Ch, D.Cout);
  BwdWgrad gp{};
  gp.am = f.h2; gp.am_map = ROW_DIRECT; gp.M = D.Ch;
  gp.m_mean = f.s2.mean; gp.m_mul = f.s2.mul; gp.m_beta = b2;
  gp.an = w.dh3; gp.an_map = ROW_DIRECT; gp.N = D.Cout;
  gp.rows_per_group = D.rpg(); gp.ngroups = ng; gp.splits = pp.splits;
  gp.chunk = pp.chunk; gp.geo = D.geo(); gp.ld_m = D.Cout; gp.ld_n = 1;
  gp.part = w.wpart;
  gp.vec_m = vec_ok(f.h2, D.Ch, item); gp.vec_n = vec_ok(w.dh3, D.Cout, item);
  PP_CHECK(weight_product<T>(gp, pp.tw, dwp, st));

  // da2 = dh3 Wp^T, masked by relu6'(T(bn2(h2))), with BN2's gradient sums
  DataGemm da{};
  da.a = w.dh3; da.a_map = ROW_DIRECT; da.K = D.Cout;
  da.w = wp; da.N = D.Ch;
  da.rows_per_group = D.rpg(); da.ngroups = ng;
  da.geo = D.geo(); da.epi = EPI_RELU6_GRAD; da.c = w.g2; da.part = w.part2;
  da.e_src = f.h2; da.e_mean = f.s2.mean; da.e_mul = f.s2.mul;
  da.e_beta = b2;
  da.vec_a = vec_ok(w.dh3, D.Cout, item); da.vec_w = vec_ok(wp, D.Cout, item);
  da.vec_c = vec_out(da, item);
  PP_CHECK((data_product<T, false>(da, da2_plan(D), nullptr, st)));
  bn_grad_finish<<<finish_blocks(D.Ch), dim3(FX, FY), 0, st>>>(
      w.part2, ng, tiles_of(D.rpg()), D.Ch, (float)D.rpg(), f.s2.var,
      f.s2.tie, g2, w.mg2, w.cf2, dg2, db2);
  PP_CHECK(cudaGetLastError());
  total = (int64_t)D.B * D.H * D.W * D.Ch;
  bn_grad_apply<T><<<blocks_for(total, EW_THREADS), EW_THREADS, 0, st>>>(
      (const T*)w.g2, (const T*)f.h2, (T*)w.g2, f.s2.mean, f.s2.mul, w.mg2,
      w.cf2, D.Ch, D.rpg(), total);  // g2 now holds dh2
  PP_CHECK(cudaGetLastError());

  // depthwise backward: g1 over the padded domain, and dwd
  DwArgs a{};
  a.h1 = f.h1; a.wd = wd; a.mean1 = f.s1.mean; a.mul1 = f.s1.mul;
  a.beta1 = b1; a.dh2 = w.g2; a.out = w.g1; a.part = w.part1; a.C = D.Ch;
  a.rows_per_group = D.rpg1(); a.ngroups = ng; a.tiles = D.tiles1();
  a.geo = D.geo();
  dw_backward_data<T><<<dim3(ng * D.tiles1(), (D.Ch + CW - 1) / CW),
                        dim3(CW, PY), 0, st>>>(a);
  PP_CHECK(cudaGetLastError());
  DwArgs aw = a;
  aw.rows_per_group = D.rpg();
  aw.part = w.wpart;
  const int n_splits = ng * D.splits();
  dw_backward_weight<T><<<dim3(n_splits, (D.Ch + CW - 1) / CW), dim3(CW, PY),
                          0, st>>>(aw, D.splits());
  PP_CHECK(cudaGetLastError());
  PP_CHECK(sum_chunks(w.wpart, n_splits, 9LL * D.Ch, dwd, st));

  // BN1 over the padded domain, border included; g1 becomes dh1
  bn_grad_finish<<<finish_blocks(D.Ch), dim3(FX, FY), 0, st>>>(
      w.part1, ng, D.tiles1(), D.Ch, (float)D.rpg1(), f.s1.var, f.s1.tie,
      g1, w.mg1, w.cf1, dg1, db1);
  PP_CHECK(cudaGetLastError());
  total = (int64_t)D.B * D.hp() * D.wp() * D.Ch;
  bn_grad_apply<T><<<blocks_for(total, EW_THREADS), EW_THREADS, 0, st>>>(
      (const T*)w.g1, (const T*)f.h1, (T*)w.g1, f.s1.mean, f.s1.mul, w.mg1,
      w.cf1, D.Ch, D.rpg1(), total);
  PP_CHECK(cudaGetLastError());

  // dWe = x^T dh1[interior]; the border rows of xp are zero. The hidden
  // side is the wide one: M = dh1's channels, N = x's
  const WgradPlan pe = wgrad_plan(D, D.Ch, D.Cin);
  BwdWgrad ge{};
  ge.am = w.g1; ge.am_map = ROW_INTERIOR_TO_PAD; ge.M = D.Ch;
  ge.an = x; ge.an_map = ROW_DIRECT; ge.N = D.Cin;
  ge.rows_per_group = D.rpg(); ge.ngroups = ng; ge.splits = pe.splits;
  ge.chunk = pe.chunk; ge.geo = D.geo(); ge.ld_m = 1; ge.ld_n = D.Ch;
  ge.part = w.wpart;
  ge.vec_m = vec_ok(w.g1, D.Ch, item); ge.vec_n = vec_ok(x, D.Cin, item);
  PP_CHECK(weight_product<T>(ge, pe.tw, dwe, st));

  // dx = dh1[interior] We^T (+ dy)
  DataGemm dxg{};
  dxg.a = w.g1; dxg.a_map = ROW_INTERIOR_TO_PAD; dxg.K = D.Ch;
  dxg.w = we; dxg.N = D.Cin;
  dxg.rows_per_group = D.rpg(); dxg.ngroups = ng;
  dxg.geo = D.geo(); dxg.epi = EPI_PLUS;
  dxg.c = dx; dxg.e_src = D.use_res ? dy : nullptr;
  dxg.vec_a = vec_ok(w.g1, D.Ch, item); dxg.vec_w = vec_ok(we, D.Ch, item);
  dxg.vec_c = vec_out(dxg, item);
  return data_product<T, false>(dxg, dx_plan(D), w.wpart, st);
}

bool read_dims(const int* v, int* dtype, Dims* D) {
  *dtype = v[0];
  *D = Dims{v[1], v[2], v[3], v[4], v[5], v[6], v[7], v[8], v[9]};
  if (D->B <= 0 || D->H <= 0 || D->W <= 0 || D->Cin <= 0 || D->Ch <= 0 ||
      D->Cout <= 0 || D->group <= 0 || D->B % D->group != 0 || D->d < 1)
    return false;
  if (D->use_res && D->Cin != D->Cout) return false;
  // shared memory: the depthwise forward's halo tile grows with d, the
  // project's staged BatchNorm of a2 with the hidden width
  if (D->d > kMaxDilation || D->Ch > kMaxHidden) return false;
  return *dtype == 0 || *dtype == 1;
}

}  // namespace

// dims: {dtype (0 = float32, 1 = bfloat16), B, H, W, Cin, Ch, Cout, group,
// dilation, use_res}. Bytes of scratch the entry needs, 0 for bad dims:
// which = 0, the forward's workspace, which it leaves holding the state the
// backward reads; 1, the backward's own; 2, the forward's scratch, free
// again when the forward returns.
extern "C" size_t pp_fused_ir_workspace(const int* dims, int which) {
  int dtype;
  Dims D;
  if (!read_dims(dims, &dtype, &D) || which < 0 || which > 2) return 0;
  float* none[6] = {};
  Carver cv{nullptr};
  if (which == 0)
    carve_forward(cv, D, dtype == 0 ? 4 : 2, none);
  else if (which == 1)
    carve_backward(cv, D, dtype == 0 ? 4 : 2);
  else
    carve_forward_scratch(cv, D);
  return cv.used + 256;
}

// ptrs: x, we, wd, wp, g1, b1, g2, b2, g3, b3, y, mu1, var1, mu2, var2, mu3,
// var3, workspace, scratch. x (B, H, W, Cin), we (Cin, Ch), wd (3, 3, Ch),
// wp (Ch, Cout), y (B, H, W, Cout) in the compute dtype; the BatchNorm
// vectors and the six (B / group, C) moment outputs in f32. Returns a
// cudaError_t code; the launches are asynchronous on `stream`.
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
// db1, dg2, db2, dg3, db3, mu1, var1, mu2, var2, mu3, var3, the forward's
// workspace, workspace. dy and dx in the compute dtype; the nine gradients
// in f32, shaped like their weights. The six moments and the forward's
// workspace are those a pp_fused_ir_fwd call on the same x and weights
// left, and are only read.
extern "C" int pp_fused_ir_bwd(const void* const* ptrs, const int* dims,
                               void* stream) {
  int dtype;
  Dims D;
  if (!read_dims(dims, &dtype, &D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 0 ? run_backward<float>(ptrs, D, s)
                          : run_backward<__nv_bfloat16>(ptrs, D, s));
}
