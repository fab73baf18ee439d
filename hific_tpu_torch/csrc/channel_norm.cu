// Fused ChannelNorm (+ optional ReLU) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel hific_tpu/ops/pallas_norm.py
// (`_norm_kernel` via `_channel_norm_fwd_pallas`, forward only): for each
// row of an (M, C) channels-last activation, take the mean and the unbiased
// variance (divide by C - 1) over the C channels, normalize with
// rsqrt(var + eps), apply the per-channel affine gamma/beta and, if asked,
// a ReLU. Accumulation is fp32; the output has the input's dtype.
//
// Bound: memory. The kernel does ~8 flops per element and must read M*C
// elements once and write them once, so its least time is
// 2 * M * C * sizeof(T) bytes at 3.35 TB/s (H100 SXM HBM3).
//
// Design, kept simple: one warp per row, with the row held in registers
// (C/32 values per lane, up to C = 1024), so each element is read from
// device memory exactly once. The mean and then the centred sum of squares
// are two warp-shuffle reductions over the registers; this is the two-pass
// formula of the TPU kernel, which keeps its digits at C = 960 where
// E[x^2] - E[x]^2 would not. Where C % 4 == 0 and the pointers are aligned,
// each lane moves 4 elements per load and store (16 bytes in fp32, 8 in
// bf16). Eight rows (warps) per 256-thread block and one block per eight
// rows: at the main path's M (1.5e3 to 3.9e5 rows) that is 192 to 49152
// blocks, enough to fill 132 SMs everywhere but the smallest latent grid.
//
// Plain C interface for ctypes: no PyTorch header, built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// Each entry point launches on the caller's stream and returns
// cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRowsPerBlock = 8;
constexpr int kMaxChannels = 1024;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, offset);
  return v;
}

// W consecutive elements <-> W floats.
template <int W>
__device__ __forceinline__ void load(const float* p, float* v) {
  if constexpr (W == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    v[0] = *p;
  }
}

template <int W>
__device__ __forceinline__ void load(const __nv_bfloat16* p, float* v) {
  if constexpr (W == 4) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  } else {
    v[0] = __bfloat162float(*p);
  }
}

template <int W>
__device__ __forceinline__ void store(float* p, const float* v) {
  if constexpr (W == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *p = v[0];
  }
}

template <int W>
__device__ __forceinline__ void store(__nv_bfloat16* p, const float* v) {
  if constexpr (W == 4) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
    uint2 t;
    t.x = *reinterpret_cast<const unsigned int*>(&a);
    t.y = *reinterpret_cast<const unsigned int*>(&b);
    *reinterpret_cast<uint2*>(p) = t;
  } else {
    *p = __float2bfloat16_rn(v[0]);
  }
}

// One warp per row. Lane `lane` owns the W-element chunks starting at
// columns W * (lane + 32 * j), j < NCHUNK.
template <typename T, int W, int NCHUNK>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
channel_norm_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                    const float* __restrict__ beta, T* __restrict__ y,
                    int64_t m, int c, float eps, int relu) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= m) return;  // whole warps exit together
  const T* xr = x + row * c;
  T* yr = y + row * c;

  float v[NCHUNK][W];
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < NCHUNK; ++j) {
    const int col = W * (lane + 32 * j);
    if (col < c) {
      load<W>(xr + col, v[j]);
#pragma unroll
      for (int k = 0; k < W; ++k) sum += v[j][k];
    }
  }
  const float mean = warp_sum(sum) / static_cast<float>(c);

  float sq = 0.f;
#pragma unroll
  for (int j = 0; j < NCHUNK; ++j) {
    const int col = W * (lane + 32 * j);
    if (col < c) {
#pragma unroll
      for (int k = 0; k < W; ++k) {
        v[j][k] -= mean;
        sq += v[j][k] * v[j][k];
      }
    }
  }
  const float var = warp_sum(sq) / static_cast<float>(c - 1);
  const float r = rsqrtf(var + eps);

#pragma unroll
  for (int j = 0; j < NCHUNK; ++j) {
    const int col = W * (lane + 32 * j);
    if (col < c) {
      float o[W];
#pragma unroll
      for (int k = 0; k < W; ++k) {
        o[k] = v[j][k] * r * __ldg(gamma + col + k) + __ldg(beta + col + k);
        if (relu) o[k] = fmaxf(o[k], 0.f);
      }
      store<W>(yr + col, o);
    }
  }
}

template <typename T, int W, int NCHUNK>
void launch_one(const T* x, const float* gamma, const float* beta, T* y,
                int64_t m, int c, float eps, int relu, cudaStream_t stream) {
  const int64_t blocks = (m + kRowsPerBlock - 1) / kRowsPerBlock;
  channel_norm_kernel<T, W, NCHUNK>
      <<<static_cast<unsigned int>(blocks), 32 * kRowsPerBlock, 0, stream>>>(
          x, gamma, beta, y, m, c, eps, relu);
}

// Picks the smallest register footprint that holds a row.
template <typename T>
int launch(const void* xp, const void* gp, const void* bp, void* yp,
           int64_t m, int c, float eps, int relu, void* stream_ptr) {
  if (c < 2 || c > kMaxChannels || m < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return static_cast<int>(cudaGetLastError());
  const T* x = static_cast<const T*>(xp);
  T* y = static_cast<T*>(yp);
  const float* g = static_cast<const float*>(gp);
  const float* b = static_cast<const float*>(bp);
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  constexpr uintptr_t kVecBytes = 4 * sizeof(T);
  const bool vec = c % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % kVecBytes == 0 &&
                   reinterpret_cast<uintptr_t>(y) % kVecBytes == 0;
  if (vec) {
    const int chunks = (c / 4 + 31) / 32;  // <= 8
    if (chunks <= 1) launch_one<T, 4, 1>(x, g, b, y, m, c, eps, relu, s);
    else if (chunks <= 2) launch_one<T, 4, 2>(x, g, b, y, m, c, eps, relu, s);
    else if (chunks <= 4) launch_one<T, 4, 4>(x, g, b, y, m, c, eps, relu, s);
    else launch_one<T, 4, 8>(x, g, b, y, m, c, eps, relu, s);
  } else {
    const int chunks = (c + 31) / 32;  // <= 32
    if (chunks <= 1) launch_one<T, 1, 1>(x, g, b, y, m, c, eps, relu, s);
    else if (chunks <= 2) launch_one<T, 1, 2>(x, g, b, y, m, c, eps, relu, s);
    else if (chunks <= 4) launch_one<T, 1, 4>(x, g, b, y, m, c, eps, relu, s);
    else if (chunks <= 8) launch_one<T, 1, 8>(x, g, b, y, m, c, eps, relu, s);
    else if (chunks <= 16) launch_one<T, 1, 16>(x, g, b, y, m, c, eps, relu, s);
    else launch_one<T, 1, 32>(x, g, b, y, m, c, eps, relu, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int hific_channel_norm_f32(const void* x, const void* gamma,
                                      const void* beta, void* y, int64_t m,
                                      int c, float eps, int relu,
                                      void* stream) {
  return launch<float>(x, gamma, beta, y, m, c, eps, relu, stream);
}

extern "C" int hific_channel_norm_bf16(const void* x, const void* gamma,
                                       const void* beta, void* y, int64_t m,
                                       int c, float eps, int relu,
                                       void* stream) {
  return launch<__nv_bfloat16>(x, gamma, beta, y, m, c, eps, relu, stream);
}
