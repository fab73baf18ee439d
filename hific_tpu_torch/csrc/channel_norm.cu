// Fused ChannelNorm (+ optional ReLU) for Hopper (sm_90a): forward and
// backward.
//
// Forward. Replaces the Pallas TPU kernel hific_tpu/ops/pallas_norm.py
// (`_norm_kernel` via `_channel_norm_fwd_pallas`): for each row of an
// (M, C) channels-last activation, take the mean and the unbiased variance
// (divide by C - 1) over the C channels, normalize with rsqrt(var + eps),
// apply the per-channel affine gamma/beta and, if asked, a ReLU.
// Accumulation is fp32; the output has the input's dtype.
//
// Backward. Replaces `_cn_bwd` (hific_tpu/ops/pallas_norm.py:74-95, the
// closed-form backward under the kernel's custom_vjp). From x it recomputes
// mu, the unbiased var, r = rsqrt(var + eps) and x_hat = (x - mu) * r; for
// act='relu' it masks g where x_hat * gamma + beta <= 0 (recomputed, not
// read from the forward's output); then, with d = g * gamma,
//   dx     = r * (d - sum_C(d) / C - x_hat * sum_C(d * x_hat) / (C - 1)),
//   dgamma = sum_M(g * x_hat),  dbeta = sum_M(g).
//
// Bound: memory. The forward reads M*C elements and writes M*C; the
// backward reads x and g and writes dx, 3*M*C elements. Both do ~10-20
// flops per element, far below the card's ~20 flops per byte, so their
// least times are those bytes at 3.35 TB/s (H100 SXM HBM3).
//
// Design, kept simple: one warp per row, with the row held in registers
// (C/32 values per lane, up to C = 1024), so each element is read from
// device memory exactly once. The mean and then the centred sum of squares
// are two warp-shuffle reductions over the registers; this is the two-pass
// formula of the TPU kernel, which keeps its digits at C = 960 where
// E[x^2] - E[x]^2 would not. Where C % 4 == 0 and the pointers are aligned,
// each lane moves 4 elements per load and store (16 bytes in fp32, 8 in
// bf16). Eight rows (warps) per 256-thread block. The forward takes one
// block per eight rows. The backward takes at most kBwdMaxBlocks blocks
// that stride over the rows, each lane summing g * x_hat and g for its own
// columns in registers; the warps of a block add their sums in shared
// memory in warp order, each block writes one row of partial sums, and a
// second kernel adds the rows in block order. No float atomics: two runs
// give the same bits.
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
constexpr int kBwdMaxBlocks = 528;  // 4 per SM of an H100 SXM

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


// Backward, one warp per row, blocks striding over the rows. `partial` is
// (gridDim.x, 2, C): per block, the sums of g * x_hat and of g per column.
template <typename T, int W, int NCHUNK>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
channel_norm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                        const float* __restrict__ gamma,
                        const float* __restrict__ beta, T* __restrict__ dx,
                        float* __restrict__ partial, int64_t m, int c,
                        float eps, int relu) {
  extern __shared__ float block_sums[];  // 2 * c floats
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  float acc_g[NCHUNK][W];  // sum over this lane's rows of g * x_hat
  float acc_b[NCHUNK][W];  // ... and of g
#pragma unroll
  for (int j = 0; j < NCHUNK; ++j) {
#pragma unroll
    for (int k = 0; k < W; ++k) {
      acc_g[j][k] = 0.f;
      acc_b[j][k] = 0.f;
    }
  }

  const int64_t stride = static_cast<int64_t>(gridDim.x) * kRowsPerBlock;
  for (int64_t row = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + warp;
       row < m; row += stride) {
    const T* xr = x + row * c;
    const T* gr = g + row * c;
    T* dr = dx + row * c;

    float v[NCHUNK][W];
    float gv[NCHUNK][W];
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < NCHUNK; ++j) {
      const int col = W * (lane + 32 * j);
      if (col < c) {
        load<W>(xr + col, v[j]);
        load<W>(gr + col, gv[j]);
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

    // v <- x_hat, gv <- masked g; the sums of d = g * gamma and d * x_hat.
    float sum_d = 0.f;
    float sum_dx = 0.f;
#pragma unroll
    for (int j = 0; j < NCHUNK; ++j) {
      const int col = W * (lane + 32 * j);
      if (col < c) {
#pragma unroll
        for (int k = 0; k < W; ++k) {
          const float gam = __ldg(gamma + col + k);
          v[j][k] = v[j][k] * r;
          if (relu && !(v[j][k] * gam + __ldg(beta + col + k) > 0.f))
            gv[j][k] = 0.f;
          acc_g[j][k] += gv[j][k] * v[j][k];
          acc_b[j][k] += gv[j][k];
          const float d = gv[j][k] * gam;
          sum_d += d;
          sum_dx += d * v[j][k];
        }
      }
    }
    const float mean_d = warp_sum(sum_d) / static_cast<float>(c);
    const float proj = warp_sum(sum_dx) / static_cast<float>(c - 1);

#pragma unroll
    for (int j = 0; j < NCHUNK; ++j) {
      const int col = W * (lane + 32 * j);
      if (col < c) {
        float o[W];
#pragma unroll
        for (int k = 0; k < W; ++k)
          o[k] = r * (gv[j][k] * __ldg(gamma + col + k) - mean_d
                      - v[j][k] * proj);
        store<W>(dr + col, o);
      }
    }
  }

  // The block's warps add their column sums in warp order.
  for (int w = 0; w < kRowsPerBlock; ++w) {
    if (warp == w) {
#pragma unroll
      for (int j = 0; j < NCHUNK; ++j) {
        const int col = W * (lane + 32 * j);
        if (col < c) {
#pragma unroll
          for (int k = 0; k < W; ++k) {
            block_sums[col + k] =
                (w == 0 ? 0.f : block_sums[col + k]) + acc_g[j][k];
            block_sums[c + col + k] =
                (w == 0 ? 0.f : block_sums[c + col + k]) + acc_b[j][k];
          }
        }
      }
    }
    __syncthreads();
  }
  float* out = partial + static_cast<int64_t>(blockIdx.x) * 2 * c;
  for (int i = threadIdx.x; i < 2 * c; i += blockDim.x) out[i] = block_sums[i];
}

// out[i] = sum over blocks b, in order, of partial[b][i]; i < 2 * c.
__global__ void channel_norm_bwd_reduce(const float* __restrict__ partial,
                                        int blocks, int c2,
                                        float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= c2) return;
  float s = 0.f;
  for (int b = 0; b < blocks; ++b) s += partial[static_cast<int64_t>(b) * c2 + i];
  out[i] = s;
}

template <typename T, int W, int NCHUNK>
void launch_bwd_one(const T* x, const T* g, const float* gamma,
                    const float* beta, T* dx, float* partial, int blocks,
                    int64_t m, int c, float eps, int relu,
                    cudaStream_t stream) {
  channel_norm_bwd_kernel<T, W, NCHUNK>
      <<<blocks, 32 * kRowsPerBlock, 2 * c * sizeof(float), stream>>>(
          x, g, gamma, beta, dx, partial, m, c, eps, relu);
}

// partial: (blocks, 2, c) fp32 scratch; dgb: (2, c) fp32, dgamma then dbeta.
template <typename T>
int launch_bwd(const void* xp, const void* gp, const void* gammap,
               const void* betap, void* dxp, void* partialp, void* dgbp,
               int64_t m, int c, float eps, int relu, int blocks,
               void* stream_ptr) {
  if (c < 2 || c > kMaxChannels || m < 0 || blocks < 1 ||
      blocks > kBwdMaxBlocks)
    return static_cast<int>(cudaErrorInvalidValue);
  const T* x = static_cast<const T*>(xp);
  const T* g = static_cast<const T*>(gp);
  T* dx = static_cast<T*>(dxp);
  const float* gamma = static_cast<const float*>(gammap);
  const float* beta = static_cast<const float*>(betap);
  float* partial = static_cast<float*>(partialp);
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  constexpr uintptr_t kVecBytes = 4 * sizeof(T);
  const bool vec = c % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % kVecBytes == 0 &&
                   reinterpret_cast<uintptr_t>(g) % kVecBytes == 0 &&
                   reinterpret_cast<uintptr_t>(dx) % kVecBytes == 0;
  if (vec) {
    const int chunks = (c / 4 + 31) / 32;  // <= 8
    if (chunks <= 1)
      launch_bwd_one<T, 4, 1>(x, g, gamma, beta, dx, partial, blocks, m, c, eps, relu, s);
    else if (chunks <= 2)
      launch_bwd_one<T, 4, 2>(x, g, gamma, beta, dx, partial, blocks, m, c, eps, relu, s);
    else if (chunks <= 4)
      launch_bwd_one<T, 4, 4>(x, g, gamma, beta, dx, partial, blocks, m, c, eps, relu, s);
    else
      launch_bwd_one<T, 4, 8>(x, g, gamma, beta, dx, partial, blocks, m, c, eps, relu, s);
  } else {
    const int chunks = (c + 31) / 32;  // <= 32
    if (chunks <= 1)
      launch_bwd_one<T, 1, 1>(x, g, gamma, beta, dx, partial, blocks, m, c, eps, relu, s);
    else if (chunks <= 2)
      launch_bwd_one<T, 1, 2>(x, g, gamma, beta, dx, partial, blocks, m, c, eps, relu, s);
    else if (chunks <= 4)
      launch_bwd_one<T, 1, 4>(x, g, gamma, beta, dx, partial, blocks, m, c, eps, relu, s);
    else if (chunks <= 8)
      launch_bwd_one<T, 1, 8>(x, g, gamma, beta, dx, partial, blocks, m, c, eps, relu, s);
    else if (chunks <= 16)
      launch_bwd_one<T, 1, 16>(x, g, gamma, beta, dx, partial, blocks, m, c, eps, relu, s);
    else
      launch_bwd_one<T, 1, 32>(x, g, gamma, beta, dx, partial, blocks, m, c, eps, relu, s);
  }
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const int threads = 128;
  channel_norm_bwd_reduce<<<(2 * c + threads - 1) / threads, threads, 0, s>>>(
      partial, blocks, 2 * c, static_cast<float*>(dgbp));
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

extern "C" int hific_channel_norm_bwd_f32(const void* x, const void* g,
                                          const void* gamma, const void* beta,
                                          void* dx, void* partial, void* dgb,
                                          int64_t m, int c, float eps,
                                          int relu, int blocks, void* stream) {
  return launch_bwd<float>(x, g, gamma, beta, dx, partial, dgb, m, c, eps,
                           relu, blocks, stream);
}

extern "C" int hific_channel_norm_bwd_bf16(const void* x, const void* g,
                                           const void* gamma,
                                           const void* beta, void* dx,
                                           void* partial, void* dgb,
                                           int64_t m, int c, float eps,
                                           int relu, int blocks,
                                           void* stream) {
  return launch_bwd<__nv_bfloat16>(x, g, gamma, beta, dx, partial, dgb, m, c,
                                   eps, relu, blocks, stream);
}
