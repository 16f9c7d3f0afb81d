// Depthwise 3x3 convolution, stride 1, NHWC, for Hopper (sm_90a).
//
// Replaces the TPU kernel pixelpick_tpu/ops/depthwise.py:_dw_halo_kernel
// (launched by _dw_forward's pl.pallas_call). Same function: a VALID 3x3
// depthwise convolution over an input that the caller has already padded,
// any dilation, f32 or bf16 in and out, the 9 taps accumulated in f32 in
// row-major tap order.
//
//   x: (B, H + 2d, W + 2d, C) contiguous NHWC
//   w: (3, 3, C)              contiguous
//   y: (B, H, W, C)           contiguous NHWC, allocated by the caller
//
// What bounds it on the card: memory. Each output element costs 9
// multiply-adds (18 flops) against one input element read and one output
// element written, about 2 flops per byte in f32, far below the H100's
// ~20 flops/byte balance point for f32 CUDA-core arithmetic (67 TFLOP/s over
// 3.35 TB/s). For the 14 stride-1 launches of one DeepLabv3+/MobileNetV2
// forward at batch 32 and 360x480 the bytes are ~2.2 GB in f32 (input read
// once + output written once), ~0.66 ms at 3.35 TB/s; half that in bf16.
//
// Design, simple and correct first: one thread per output pixel and channel
// group of VEC channels (16 bytes: 4 f32 or 8 bf16 when C and the pointers
// allow, else fewer). Neighbouring threads take neighbouring channel groups,
// then neighbouring pixels, so every load and store of a warp is one
// coalesced 16-byte-per-thread access. The 3x3 window's reuse across
// neighbouring outputs (each input is read by up to 9 threads) is left to
// L1/L2; nothing is staged in shared memory. The TPU kernel's row tiling,
// its 8-wide/128-lane padding and its VMEM-budget fallback have no
// counterpart: every stride-1 shape takes this path, ragged edges included.
// Stride 2 is not this kernel's job (the wrapper keeps the JAX package's
// dispatch to a grouped convolution there).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
  T v[N];
};

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

template <typename T, int VEC>
__global__ void __launch_bounds__(256)
    dw3x3_s1_nhwc(const T* __restrict__ x, const T* __restrict__ w,
                  T* __restrict__ y, int batch, int hp, int wp, int ch,
                  int dil) {
  const int ho = hp - 2 * dil;
  const int wo = wp - 2 * dil;
  const int cvec = ch / VEC;
  const int64_t total = (int64_t)batch * ho * wo * cvec;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;

  const int c0 = (int)(t % cvec) * VEC;
  int64_t r = t / cvec;
  const int ox = (int)(r % wo);
  r /= wo;
  const int oy = (int)(r % ho);
  const int b = (int)(r / ho);

  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;

  const T* xb = x + (((int64_t)b * hp + oy) * wp + ox) * ch + c0;
#pragma unroll
  for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
      const Pack<T, VEC> xv = *reinterpret_cast<const Pack<T, VEC>*>(
          xb + ((int64_t)ky * dil * wp + kx * dil) * ch);
      const Pack<T, VEC> wv = *reinterpret_cast<const Pack<T, VEC>*>(
          w + (ky * 3 + kx) * ch + c0);
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        acc[i] = fmaf(to_float(xv.v[i]), to_float(wv.v[i]), acc[i]);
    }
  }

  Pack<T, VEC> out;
#pragma unroll
  for (int i = 0; i < VEC; ++i) out.v[i] = from_float<T>(acc[i]);
  *reinterpret_cast<Pack<T, VEC>*>(
      y + (((int64_t)b * ho + oy) * wo + ox) * ch + c0) = out;
}

template <typename T, int VEC>
cudaError_t launch_vec(const T* x, const T* w, T* y, int batch, int hp,
                       int wp, int ch, int dil, cudaStream_t stream) {
  const int64_t total =
      (int64_t)batch * (hp - 2 * dil) * (wp - 2 * dil) * (ch / VEC);
  if (total == 0) return cudaSuccess;
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  dw3x3_s1_nhwc<T, VEC><<<(unsigned)blocks, threads, 0, stream>>>(
      x, w, y, batch, hp, wp, ch, dil);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* xv, const void* wv, void* yv, int batch,
                   int hp, int wp, int ch, int dil, cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
  const T* w = static_cast<const T*>(wv);
  T* y = static_cast<T*>(yv);
  // widest access that the channel count and every pointer allow
  const uintptr_t addr = (uintptr_t)xv | (uintptr_t)wv | (uintptr_t)yv;
  int vec = 16 / (int)sizeof(T);
  while (vec > 1 && (ch % vec != 0 || addr % (vec * sizeof(T)) != 0))
    vec /= 2;
  switch (vec) {
    case 8:
      if constexpr (sizeof(T) <= 2)
        return launch_vec<T, 8>(x, w, y, batch, hp, wp, ch, dil, stream);
      break;
    case 4:
      return launch_vec<T, 4>(x, w, y, batch, hp, wp, ch, dil, stream);
    case 2:
      return launch_vec<T, 2>(x, w, y, batch, hp, wp, ch, dil, stream);
    default:
      return launch_vec<T, 1>(x, w, y, batch, hp, wp, ch, dil, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t code, 0 on
// success; the launch is asynchronous on `stream`.
extern "C" int pp_dw3x3_s1_nhwc(const void* x, const void* w, void* y,
                                int dtype, int batch, int hp, int wp, int ch,
                                int dil, void* stream) {
  if (batch < 0 || ch <= 0 || dil < 1 || hp - 2 * dil <= 0 ||
      wp - 2 * dil <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)launch<float>(x, w, y, batch, hp, wp, ch, dil, s);
    case 1:
      return (int)launch<__nv_bfloat16>(x, w, y, batch, hp, wp, ch, dil, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
