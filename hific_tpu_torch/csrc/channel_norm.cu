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
// Forward design, kept simple: one warp per row, with the row held in
// registers (C/32 values per lane, up to C = 1024), so each element is read
// from device memory exactly once. The mean and then the centred sum of
// squares are two warp-shuffle reductions over the registers; this is the
// two-pass formula of the TPU kernel, which keeps its digits at C = 960
// where E[x^2] - E[x]^2 would not. Where C % 4 == 0 and the pointers are
// aligned, each lane moves 4 elements per load and store (16 bytes in fp32,
// 8 in bf16). Eight rows (warps) per 256-thread block.
//
// Backward design, for Hopper. Its first version (one warp per row, like
// the forward) held a whole row of x and g plus its columns' sums in each
// lane: 183 registers at C = 960, so few warps per SM and 6x its bound at
// the generator's M = 2048 rows; at C = 60 a row had 15 chunks of 4 for 32
// lanes, so half the lanes idled. Now a row is spread over as few threads
// as hold it with two chunks of 4 each (a power of two, 8 to 128), so a
// thread holds two chunks of x and g and 16 column sums at every C <= 1024
// (at C = 60, 8 threads per row and 32 rows per 256-thread block; at
// C = 960, 128 threads per row and 2 rows per block, summed through shared
// memory). A ring of tiles in shared memory, filled by cp.async, keeps the
// next rows' loads in flight while a row is computed. At most
// kBwdMaxBlocks blocks stride over the rows; each block adds its rows'
// column sums in row order and writes one row of
// partial sums, and a second kernel adds the partial rows with a fixed tree
// (8 strided slices, then the slices in order). No float atomics: two runs
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
constexpr int kBwdThreads = 256;
constexpr int kBwdMaxBlocks = 264;  // 2 per SM of an H100 SXM

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


// ---------------------------------------------------------------------------
// Backward.
//
// A block of kBwdThreads threads takes kBwdThreads / TPR rows at a time, each
// row spread over TPR threads (a power of two, from 8 to 256). Thread t of a
// row owns the NV chunks of W elements at columns W * (t + TPR * j), j < NV,
// in every row it takes, so its dgamma/dbeta sums are 2 * NV * W registers,
// whatever C is. The row's sums are shuffles inside a segment of TPR lanes
// (TPR <= 32) or warp shuffles plus one exchange through shared memory
// (TPR > 32). The block walks over its rows with a ring of kStages tiles in
// shared memory: cp.async copies the x and g chunks of the rows kStages - 1
// iterations ahead while the current row is computed.
template <int TPR>
struct RowSum {
  static constexpr int kWarps = TPR > 32 ? TPR / 32 : 1;

  // Sums each of v[0..N) over the TPR threads of this row; every thread gets
  // the same bits (each butterfly step adds the same two values in both
  // lanes). red holds N floats per warp for this call's slot.
  template <int N>
  __device__ static void sum(float (&v)[N], float* red) {
    if constexpr (TPR <= 32) {
#pragma unroll
      for (int o = TPR / 2; o > 0; o >>= 1) {
#pragma unroll
        for (int i = 0; i < N; ++i) v[i] += __shfl_xor_sync(0xffffffffu, v[i], o);
      }
    } else {
      const int warp = threadIdx.x >> 5;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        v[i] = warp_sum(v[i]);
        if ((threadIdx.x & 31) == 0) red[N * warp + i] = v[i];
      }
      __syncthreads();
      const int first = warp / kWarps * kWarps;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        v[i] = red[N * first + i];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) v[i] += red[N * (first + w) + i];
      }
    }
  }
};

template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(s), "l"(gmem) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
                 :: "r"(s), "l"(gmem), "n"(BYTES) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// `partial` is (gridDim.x, 2, C): per block, the sums of g * x_hat and of g
// per column over the block's rows.
template <typename T, int W, int TPR, int NV>
__global__ void __launch_bounds__(kBwdThreads, 2)
channel_norm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                        const float* __restrict__ gamma,
                        const float* __restrict__ beta, T* __restrict__ dx,
                        float* __restrict__ partial, int64_t m, int c,
                        float eps, int relu) {
  constexpr int kRows = kBwdThreads / TPR;           // rows at a time
  constexpr int kStages = NV == 1 ? 3 : 2;
  constexpr int kChunkBytes = W * static_cast<int>(sizeof(T));
  constexpr bool kAsync = kChunkBytes >= 4;          // cp.async moves 4-16 B
  constexpr int kTile = NV * kBwdThreads * W;        // elements per tensor
  constexpr int kStageBytes = kStages * 2 * kTile * static_cast<int>(sizeof(T));
  constexpr int kColBytes = 2 * kBwdThreads * NV * W * static_cast<int>(sizeof(float));
  __shared__ __align__(16) unsigned char smem[kStageBytes > kColBytes
                                              ? kStageBytes : kColBytes];
  __shared__ float red[3][2 * kBwdThreads / 32];
  T* const ring = reinterpret_cast<T*>(smem);  // [kStages][x, g][NV][threads][W]

  const int t = threadIdx.x % TPR;
  const int rg = threadIdx.x / TPR;
  const int64_t groups = (m + kRows - 1) / kRows;
  const int64_t n_it = (groups - blockIdx.x + gridDim.x - 1) / gridDim.x;

  // gamma and beta of this thread's columns, the same in every row.
  float gam[NV][W], bet[NV][W];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int col = W * (t + TPR * j);
#pragma unroll
    for (int k = 0; k < W; ++k) {
      gam[j][k] = col < c ? __ldg(gamma + col + k) : 0.f;
      bet[j][k] = col < c ? __ldg(beta + col + k) : 0.f;
    }
  }

  // Copies the chunks of iteration `it` into its slot of the ring.
  auto fetch = [&](int64_t it) {
    if (it < n_it) {
      const int64_t row = (blockIdx.x + it * gridDim.x) * kRows + rg;
      if (row < m) {
        T* sx = ring + (it % kStages) * 2 * kTile;
        T* sg = sx + kTile;
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          const int col = W * (t + TPR * j);
          if (col < c) {
            const int s = (j * kBwdThreads + threadIdx.x) * W;
            if constexpr (kAsync) {
              cp_async<kChunkBytes>(sx + s, x + row * c + col);
              cp_async<kChunkBytes>(sg + s, g + row * c + col);
            } else {
#pragma unroll
              for (int k = 0; k < W; ++k) {
                sx[s + k] = x[row * c + col + k];
                sg[s + k] = g[row * c + col + k];
              }
            }
          }
        }
      }
    }
    if constexpr (kAsync) cp_async_commit();
  };

  float acc_g[NV][W];  // sum over this thread's rows of g * x_hat
  float acc_b[NV][W];  // ... and of g
#pragma unroll
  for (int j = 0; j < NV; ++j) {
#pragma unroll
    for (int k = 0; k < W; ++k) {
      acc_g[j][k] = 0.f;
      acc_b[j][k] = 0.f;
    }
  }

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) fetch(s);
  for (int64_t it = 0; it < n_it; ++it) {
    fetch(it + kStages - 1);
    if constexpr (kAsync) cp_async_wait<kStages - 1>();
    const int64_t row = (blockIdx.x + it * gridDim.x) * kRows + rg;
    const bool live = row < m;  // the same for the TPR threads of a row
    const T* sx = ring + (it % kStages) * 2 * kTile;
    const T* sg = sx + kTile;

    float v[NV][W], gv[NV][W];
    float sum[1] = {0.f};
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int col = W * (t + TPR * j);
      if (live && col < c) {
        const int s = (j * kBwdThreads + threadIdx.x) * W;
        load<W>(sx + s, v[j]);
        load<W>(sg + s, gv[j]);
#pragma unroll
        for (int k = 0; k < W; ++k) sum[0] += v[j][k];
      } else {
#pragma unroll
        for (int k = 0; k < W; ++k) v[j][k] = gv[j][k] = 0.f;
      }
    }
    RowSum<TPR>::sum(sum, red[0]);
    const float mean = sum[0] / static_cast<float>(c);

    float sq[1] = {0.f};
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int col = W * (t + TPR * j);
      if (live && col < c) {
#pragma unroll
        for (int k = 0; k < W; ++k) {
          v[j][k] -= mean;
          sq[0] += v[j][k] * v[j][k];
        }
      }
    }
    RowSum<TPR>::sum(sq, red[1]);
    const float r = rsqrtf(sq[0] / static_cast<float>(c - 1) + eps);

    // v <- x_hat, gv <- masked g; the sums of d = g * gamma and d * x_hat.
    float sums[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NV; ++j) {
#pragma unroll
      for (int k = 0; k < W; ++k) {
        v[j][k] = v[j][k] * r;
        if (relu && !(v[j][k] * gam[j][k] + bet[j][k] > 0.f)) gv[j][k] = 0.f;
        acc_g[j][k] += gv[j][k] * v[j][k];
        acc_b[j][k] += gv[j][k];
        const float d = gv[j][k] * gam[j][k];
        sums[0] += d;
        sums[1] += d * v[j][k];
      }
    }
    RowSum<TPR>::sum(sums, red[2]);
    const float mean_d = sums[0] / static_cast<float>(c);
    const float proj = sums[1] / static_cast<float>(c - 1);

    if (live) {
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int col = W * (t + TPR * j);
        if (col < c) {
          float o[W];
#pragma unroll
          for (int k = 0; k < W; ++k)
            o[k] = r * (gv[j][k] * gam[j][k] - mean_d - v[j][k] * proj);
          store<W>(dx + row * c + col, o);
        }
      }
    }
  }

  // The block's rows add their column sums in row-group order, through the
  // ring's memory.
  if constexpr (kAsync) cp_async_wait<0>();
  __syncthreads();
  float* cols = reinterpret_cast<float*>(smem);  // [kRows][2][c]
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int col = W * (t + TPR * j);
    if (col < c) {
#pragma unroll
      for (int k = 0; k < W; ++k) {
        cols[rg * 2 * c + col + k] = acc_g[j][k];
        cols[rg * 2 * c + c + col + k] = acc_b[j][k];
      }
    }
  }
  __syncthreads();
  float* out = partial + static_cast<int64_t>(blockIdx.x) * 2 * c;
  for (int i = threadIdx.x; i < 2 * c; i += kBwdThreads) {
    float s = cols[i];
#pragma unroll
    for (int q = 1; q < kRows; ++q) s += cols[q * 2 * c + i];
    out[i] = s;
  }
}

// out[i] = sum over the rows p of partial[p][i], i < c2: a block takes 32
// columns; its 8 warps each add every 8th row in order, then warp 0 adds the
// 8 sums in warp order. A fixed order, so two runs give the same bits.
__global__ void __launch_bounds__(256)
channel_norm_bwd_colsum(const float* __restrict__ partial, int rows, int c2,
                        float* __restrict__ out) {
  __shared__ float part[8][32];
  const int lane = threadIdx.x & 31;
  const int slice = threadIdx.x >> 5;
  const int i = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (i < c2)
    for (int p = slice; p < rows; p += 8)
      s += partial[static_cast<int64_t>(p) * c2 + i];
  part[slice][lane] = s;
  __syncthreads();
  if (slice == 0 && i < c2) {
#pragma unroll
    for (int q = 1; q < 8; ++q) s += part[q][lane];
    out[i] = s;
  }
}

struct BwdShape {
  int tpr;  // threads per row
  int nv;   // chunks per thread
};

// Chunks of 4 elements where the rows allow it: the fewest threads per row
// (8 to 128) that hold a row with two chunks each, one chunk at C <= 32.
// Else chunks of one element: the fewest threads (32 to 256) that hold a
// row with one chunk each, up to 4 chunks at 256 threads. (At the training
// step's shapes, two chunks per thread took 0.775 ms per step against
// 0.857 ms with one chunk and twice the threads per row; NVIDIA H100 80GB
// HBM3, 700 W.)
inline BwdShape bwd_shape(int c, bool vec) {
  const int chunks = vec ? c / 4 : c;
  int tpr = vec ? 8 : 32;
  const int per_thread = vec ? 2 : 1;
  const int most = vec ? kBwdThreads / 2 : kBwdThreads;
  while (per_thread * tpr < chunks && tpr < most) tpr *= 2;
  return {tpr, (chunks + tpr - 1) / tpr};
}

template <typename T, int W, int TPR, int NV>
void launch_bwd_one(const T* x, const T* g, const float* gamma,
                    const float* beta, T* dx, float* partial, int blocks,
                    int64_t m, int c, float eps, int relu,
                    cudaStream_t stream) {
  channel_norm_bwd_kernel<T, W, TPR, NV><<<blocks, kBwdThreads, 0, stream>>>(
      x, g, gamma, beta, dx, partial, m, c, eps, relu);
}

// partial: (blocks, 2, c) fp32 scratch; dgb: (2, c) fp32, dgamma then dbeta.
// stages: 1 runs the row kernel, 2 the column sums of `partial`, 3 both
// (the first two alone are for timing each step).
template <typename T>
int launch_bwd(const void* xp, const void* gp, const void* gammap,
               const void* betap, void* dxp, void* partialp, void* dgbp,
               int64_t m, int c, float eps, int relu, int blocks, int stages,
               void* stream_ptr) {
  if (c < 2 || c > kMaxChannels || m < 0 || blocks < 1 ||
      blocks > kBwdMaxBlocks || stages < 1 || stages > 3)
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
  const BwdShape shape = bwd_shape(c, vec);
  const int64_t groups = (m + kBwdThreads / shape.tpr - 1) /
                         (kBwdThreads / shape.tpr);
  blocks = static_cast<int>(groups < blocks ? (groups > 1 ? groups : 1)
                                            : blocks);
  if (stages & 1) {
#define HIFIC_BWD(W, TPR, NV) \
  launch_bwd_one<T, W, TPR, NV>(x, g, gamma, beta, dx, partial, blocks, m, c, eps, relu, s)
    if (vec) {
      switch (shape.tpr * 4 + shape.nv) {
        case 8 * 4 + 1: HIFIC_BWD(4, 8, 1); break;
        case 8 * 4 + 2: HIFIC_BWD(4, 8, 2); break;
        case 16 * 4 + 2: HIFIC_BWD(4, 16, 2); break;
        case 32 * 4 + 2: HIFIC_BWD(4, 32, 2); break;
        case 64 * 4 + 2: HIFIC_BWD(4, 64, 2); break;
        default: HIFIC_BWD(4, 128, 2); break;
      }
    } else if (shape.tpr < kBwdThreads) {
      switch (shape.tpr) {
        case 32: HIFIC_BWD(1, 32, 1); break;
        case 64: HIFIC_BWD(1, 64, 1); break;
        default: HIFIC_BWD(1, 128, 1); break;
      }
    } else {
      switch (shape.nv) {
        case 1: HIFIC_BWD(1, 256, 1); break;
        case 2: HIFIC_BWD(1, 256, 2); break;
        case 3: HIFIC_BWD(1, 256, 3); break;
        default: HIFIC_BWD(1, 256, 4); break;
      }
    }
#undef HIFIC_BWD
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  if (stages & 2) {
    channel_norm_bwd_colsum<<<(2 * c + 31) / 32, 256, 0, s>>>(
        partial, blocks, 2 * c, static_cast<float*>(dgbp));
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

extern "C" int hific_channel_norm_bwd_f32(const void* x, const void* g,
                                          const void* gamma, const void* beta,
                                          void* dx, void* partial, void* dgb,
                                          int64_t m, int c, float eps,
                                          int relu, int blocks, int stages,
                                          void* stream) {
  return launch_bwd<float>(x, g, gamma, beta, dx, partial, dgb, m, c, eps,
                           relu, blocks, stages, stream);
}

extern "C" int hific_channel_norm_bwd_bf16(const void* x, const void* g,
                                           const void* gamma,
                                           const void* beta, void* dx,
                                           void* partial, void* dgb,
                                           int64_t m, int c, float eps,
                                           int relu, int blocks, int stages,
                                           void* stream) {
  return launch_bwd<__nv_bfloat16>(x, g, gamma, beta, dx, partial, dgb, m, c,
                                   eps, relu, blocks, stages, stream);
}
