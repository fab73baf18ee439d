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
// Forward design, for Hopper. Its first version (one warp per row, the row
// in registers) reached 71% of its bound in fp32 but 38-45% in bf16: at
// C = 60 in bf16 a row is 120 bytes, so 15 of 32 lanes loaded 8 bytes each
// and 17 idled (~7.7 KB of loads in flight per SM, where HBM needs ~15-20
// KB at its loaded latency); its bf16 loads were 8 bytes a lane; and it
// read gamma and beta as scalars, 16 bytes apart across a warp: at C = 960
// ~256 L1 wavefronts a row against 32 for the row's own bytes, which set
// the time of the few-row layers. Two paths now, chosen on the host
// (`ops/fused_norm.py:
// forward_plan`; the entry points reject a plan they cannot run with
// cudaErrorInvalidValue):
//  - rows in registers, where a row's bytes are a multiple of 16 (every
//    layer from C = 120 in bf16, from C = 60 in fp32): TPR lanes a row, the
//    fewest (a power of two up to 32) that hold its 16-byte chunks one each,
//    up to 8 chunks a lane at 32; one 16-byte load and store per chunk,
//    consecutive lanes on consecutive chunks; gamma and beta of a chunk in
//    one or two float4 loads into registers. Every row of the grid is
//    resident at once on the few-row shapes (C = 960 at M = 1536-4096: one
//    wave); on the large ones 19-32 registers let 64 warps sit on an SM,
//    ~32 KB of 16-byte loads in flight. Few rows of 8 x n bytes (C = 220 in
//    bf16 at M <= 8192) take 8-byte chunks the same way: latency-bound
//    launches where a detour through shared memory cost ~1 us;
//  - tiles through shared memory, for the other rows (C = 60 in bf16, odd
//    widths, a view off a 16-byte boundary): a unit (a warp, or the two
//    warps of a 64-thread row) walks tiles of `rows` consecutive rows,
//    copied as one flat span with 16-byte cp.async (rows * C * sizeof(T) a
//    multiple of 16) into its own ring of `stages` slots, and written back
//    from there with 16-byte stores; units synchronize only themselves
//    (__syncwarp or a named barrier), so one unit's loads, sums and stores
//    overlap another's. TPR threads reduce a row from shared memory, thread
//    t taking columns t, t + TPR, ... (4 threads of 15 at C = 60: no lane
//    idles, no bank conflicts), with gamma and beta in registers for all
//    its rows. The first span's head and the tail after the last whole
//    16-byte chunk go one element at a time, so a ragged last tile or a
//    base pointer off a 16-byte boundary stays in the same kernel.
// A block-wide ring (16 KB tiles, three __syncthreads a tile) and then the
// per-unit ring for every row were measured first: slower than the
// registers path wherever rows are 16 x n bytes (`scripts/norm_plans.py`;
// PERF.md §6). Both paths sum in a fixed order (each thread its values
// in order, then a butterfly over the row's lanes), with no atomics: two
// runs give the same bits, and a row the same bits whatever tile or block
// it falls in under one path. Two-pass formula (the mean, then the centred
// sum of squares), never E[x^2] - E[x]^2.
//
// Backward design, for Hopper. Its first version (one warp per row, like
// the forward's first) held a whole row of x and g plus its columns' sums in each
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

#include <atomic>
#include <cstdint>

namespace {

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

// ---------------------------------------------------------------------------
// Forward.

constexpr int kFwdThreads = 256;
constexpr int kFwdNv = 16;           // most columns of a row a thread takes
constexpr int kFwdMaxTpr = 64;       // kFwdNv * kFwdMaxTpr = kMaxChannels
constexpr int kFwdMaxStages = 4;
constexpr int kFwdMaxSmem = 96 * 1024;  // per block; two blocks per SM

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Waits until at most `pending` of this thread's cp.async groups are
// outstanding (0 <= pending < kFwdMaxStages).
__device__ __forceinline__ void cp_async_wait_at_most(int pending) {
  switch (pending) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    default: cp_async_wait<3>(); break;
  }
}

// The threads of a unit (kN of them, `lane` this one's index) copy n
// elements from device memory to shared memory; src and dst lie at the same
// offset from a 16-byte boundary. The first `head` elements (up to the
// boundary) and the tail after the last whole 16-byte chunk go one element
// at a time, the chunks between with cp.async.
template <int kN, typename T>
__device__ __forceinline__ void tile_in(T* dst, const T* __restrict__ src,
                                        int n, int head, int lane) {
  constexpr int kV = 16 / static_cast<int>(sizeof(T));
  const int nvec = (n - head) / kV;
  for (int i = lane; i < head; i += kN) dst[i] = src[i];
  for (int k = lane; k < nvec; k += kN)
    cp_async<16>(dst + head + k * kV, src + head + k * kV);
  for (int i = head + nvec * kV + lane; i < n; i += kN) dst[i] = src[i];
}

// The threads of a unit write n elements from shared memory to device
// memory in 16-byte stores between the head and the tail; where dst and src
// lie at different offsets from a 16-byte boundary (`congruent` false) each
// store gathers its elements from shared memory one by one.
template <int kN, typename T>
__device__ __forceinline__ void tile_out(T* __restrict__ dst, const T* src,
                                         int n, int head, bool congruent,
                                         int lane) {
  constexpr int kV = 16 / static_cast<int>(sizeof(T));
  const int nvec = (n - head) / kV;
  for (int i = lane; i < head; i += kN) dst[i] = src[i];
  for (int k = lane; k < nvec; k += kN) {
    const T* s = src + head + k * kV;
    uint4 w;
    if (congruent) {
      w = *reinterpret_cast<const uint4*>(s);
    } else {
      T* e = reinterpret_cast<T*>(&w);
#pragma unroll
      for (int q = 0; q < kV; ++q) e[q] = s[q];
    }
    *reinterpret_cast<uint4*>(dst + head + k * kV) = w;
  }
  for (int i = head + nvec * kV + lane; i < n; i += kN) dst[i] = src[i];
}

// A unit is the warp that holds a row (TPR <= 32) or the TPR / 32 warps
// that share one (TPR = 64). Units run independently: they synchronize
// only their own threads, with __syncwarp or a named barrier (ids 1-4).
template <int TPR>
struct Unit {
  static constexpr int kThreads = TPR > 32 ? TPR : 32;
  static constexpr int kPerBlock = kFwdThreads / kThreads;
  static constexpr int kWarps = kThreads / 32;

  __device__ static void sync() {
    if constexpr (kWarps == 1) {
      __syncwarp();
    } else {
      const int id = 1 + static_cast<int>(threadIdx.x) / kThreads;
      asm volatile("bar.sync %0, %1;\n" :: "r"(id), "n"(kThreads)
                   : "memory");
    }
  }

  // The sum of v over the TPR threads of this row, the same bits in each
  // (a butterfly within a warp; for two warps, each warp's sum through
  // `red`, this call's slot of two floats per warp pair, added in warp
  // order).
  __device__ static float row_sum(float v, float* red) {
    if constexpr (TPR <= 32) {
#pragma unroll
      for (int o = TPR / 2; o > 0; o >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, o);
      return v;
    } else {
      v = warp_sum(v);
      const int warp = static_cast<int>(threadIdx.x) >> 5;
      if ((threadIdx.x & 31) == 0) red[warp] = v;
      sync();
      const int first = warp / kWarps * kWarps;
      float s = red[first];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) s += red[first + w];
      return s;
    }
  }
};

// Unit u of the grid takes tiles u, u + (units in the grid), ... of `rows`
// rows each through its own ring of `stages` slots of dynamic shared memory
// (rows * C * sizeof(T) + 16 bytes each: the tile lies at x's offset from a
// 16-byte boundary). Each row of a tile is reduced by TPR threads; thread t
// of a row takes the columns t + TPR * j, j < kFwdNv, and writes its outputs
// over its inputs in the slot, which the unit then writes out as one span.
template <typename T, int TPR>
__global__ void __launch_bounds__(kFwdThreads, 2)
channel_norm_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                    const float* __restrict__ beta, T* __restrict__ y,
                    int64_t m, int c, int rows, int stages, float eps,
                    int relu) {
  using U = Unit<TPR>;
  extern __shared__ __align__(16) unsigned char fwd_smem[];
  __shared__ float red[2][kFwdThreads / 32];
  constexpr int kRpp = U::kThreads / TPR;  // rows a unit reduces at a time
  const int unit = static_cast<int>(threadIdx.x) / U::kThreads;
  const int lane = static_cast<int>(threadIdx.x) % U::kThreads;
  const int t = lane % TPR;
  const int rg = lane / TPR;
  const int64_t units = static_cast<int64_t>(gridDim.x) * U::kPerBlock;
  const int64_t uid = static_cast<int64_t>(blockIdx.x) * U::kPerBlock + unit;
  const int64_t tiles = (m + rows - 1) / rows;
  const int64_t n_it = uid < tiles ? (tiles - uid + units - 1) / units : 0;
  const int slot_bytes = rows * c * static_cast<int>(sizeof(T)) + 16;
  unsigned char* const ring = fwd_smem + unit * stages * slot_bytes;
  const int x_off = static_cast<int>(reinterpret_cast<uintptr_t>(x) & 15);
  const int y_off = static_cast<int>(reinterpret_cast<uintptr_t>(y) & 15);
  const int x_head = ((16 - x_off) & 15) / static_cast<int>(sizeof(T));
  const int y_head = ((16 - y_off) & 15) / static_cast<int>(sizeof(T));

  float gam[kFwdNv], bet[kFwdNv];
#pragma unroll
  for (int j = 0; j < kFwdNv; ++j) {
    const int col = t + TPR * j;
    gam[j] = col < c ? __ldg(gamma + col) : 0.f;
    bet[j] = col < c ? __ldg(beta + col) : 0.f;
  }

  // Issues the copies of iteration it's tile into its slot (none past the
  // unit's last tile) and closes a cp.async group either way.
  int slot_in = 0;
  auto fetch = [&](int64_t it) {
    if (it < n_it) {
      const int64_t row0 = (uid + it * units) * rows;
      const int n = static_cast<int>(m - row0 < rows ? m - row0 : rows) * c;
      tile_in<U::kThreads>(
          reinterpret_cast<T*>(ring + slot_in * slot_bytes + x_off),
          x + row0 * c, n, x_head < n ? x_head : n, lane);
    }
    cp_async_commit();
    slot_in = slot_in + 1 == stages ? 0 : slot_in + 1;
  };

  for (int s = 0; s < stages - 1; ++s) fetch(s);
  const int passes = (rows + kRpp - 1) / kRpp;
  int slot = 0;
  for (int64_t it = 0; it < n_it; ++it) {
    U::sync();  // the slot that fetch() refills has been written out
    fetch(it + stages - 1);
    cp_async_wait_at_most(stages - 1);
    U::sync();  // every thread's copies of this tile have landed
    const int64_t row0 = (uid + it * units) * rows;
    const int nrows = static_cast<int>(m - row0 < rows ? m - row0 : rows);
    T* const tile = reinterpret_cast<T*>(ring + slot * slot_bytes + x_off);
    for (int p = 0; p < passes; ++p) {
      const int r = rg + p * kRpp;
      const bool live = r < nrows;  // the same for the TPR threads of a row
      T* const row = tile + r * c;
      float v[kFwdNv];
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kFwdNv; ++j) {
        const int col = t + TPR * j;
        v[j] = live && col < c ? to_f32(row[col]) : 0.f;
        sum += v[j];
      }
      const float mean = U::row_sum(sum, red[0]) / static_cast<float>(c);
      float sq = 0.f;
#pragma unroll
      for (int j = 0; j < kFwdNv; ++j) {
        const int col = t + TPR * j;
        if (live && col < c) {
          v[j] -= mean;
          sq += v[j] * v[j];
        }
      }
      const float r_std = rsqrtf(
          U::row_sum(sq, red[1]) / static_cast<float>(c - 1) + eps);
#pragma unroll
      for (int j = 0; j < kFwdNv; ++j) {
        const int col = t + TPR * j;
        if (live && col < c) {
          float o = v[j] * r_std * gam[j] + bet[j];
          if (relu) o = fmaxf(o, 0.f);
          put(row + col, o);
        }
      }
    }
    U::sync();  // the tile's outputs are in its slot
    tile_out<U::kThreads>(y + row0 * c, tile, nrows * c,
                          y_head < nrows * c ? y_head : nrows * c,
                          x_off == y_off, lane);
    slot = slot + 1 == stages ? 0 : slot + 1;
  }
}

// V bytes of a row (V = 16 or 8, aligned) <-> V / sizeof(T) floats.
template <int V>
__device__ __forceinline__ void load_chunk(const float* p, float* v) {
  if constexpr (V == 16) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x; v[1] = t.y;
  }
}

template <int V>
__device__ __forceinline__ void load_chunk(const __nv_bfloat16* p, float* v) {
  constexpr int kWords = V / 4;
  unsigned w[kWords];
  if constexpr (V == 16) {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    w[0] = t.x; w[1] = t.y; w[2] = t.z; w[3] = t.w;
  } else {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    w[0] = t.x; w[1] = t.y;
  }
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

template <int V>
__device__ __forceinline__ void store_chunk(float* p, const float* v) {
  if constexpr (V == 16)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}

template <int V>
__device__ __forceinline__ void store_chunk(__nv_bfloat16* p, const float* v) {
  constexpr int kWords = V / 4;
  unsigned w[kWords];
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const unsigned*>(&h);
  }
  if constexpr (V == 16)
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  else
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
}

// K consecutive floats of gamma or beta (K = 2, 4 or 8, aligned to
// min(K * 4, 16) bytes) in K / 2 or K / 4 vector loads.
template <int K>
__device__ __forceinline__ void load_params(const float* p, float* v) {
  if constexpr (K == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = t.x; v[1] = t.y;
  } else {
#pragma unroll
    for (int i = 0; i < K / 4; ++i) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(p) + i);
      v[4 * i] = t.x; v[4 * i + 1] = t.y; v[4 * i + 2] = t.z;
      v[4 * i + 3] = t.w;
    }
  }
}

// Rows straight to registers, for rows whose bytes are a multiple of V and
// pointers aligned to V: TPR lanes of a warp per row (kFwdThreads / TPR rows
// a block, one row a lane group, every row in the grid at once); lane t owns
// the V-byte chunks t + TPR * j, j < NV, loaded and stored as one
// transaction each. The gamma and beta of a chunk's columns come into
// registers once, in vector loads: as scalars (a lane's columns lie 32
// bytes apart in bf16) they cost eight times the L1 wavefronts of the row's
// own bytes and set the time of the C = 960 layers.
template <typename T, int V, int TPR, int NV>
__global__ void __launch_bounds__(kFwdThreads)
channel_norm_rows_kernel(const T* __restrict__ x,
                         const float* __restrict__ gamma,
                         const float* __restrict__ beta, T* __restrict__ y,
                         int64_t m, int c, float eps, int relu) {
  constexpr int kW = V / static_cast<int>(sizeof(T));  // elements a chunk
  const int t = static_cast<int>(threadIdx.x) % TPR;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (kFwdThreads / TPR) +
                      static_cast<int>(threadIdx.x) / TPR;
  const bool live = row < m;  // the same for the TPR lanes of a row
  const int chunks = c / kW;
  const T* const xr = x + row * c;
  T* const yr = y + row * c;

  float v[NV][kW];
  float sum[1] = {0.f};
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int q = t + TPR * j;
    if (live && q < chunks) {
      load_chunk<V>(xr + q * kW, v[j]);
#pragma unroll
      for (int k = 0; k < kW; ++k) sum[0] += v[j][k];
    } else {
#pragma unroll
      for (int k = 0; k < kW; ++k) v[j][k] = 0.f;
    }
  }
  RowSum<TPR>::sum(sum, nullptr);
  const float mean = sum[0] / static_cast<float>(c);
  float sq[1] = {0.f};
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int q = t + TPR * j;
    if (live && q < chunks) {
#pragma unroll
      for (int k = 0; k < kW; ++k) {
        v[j][k] -= mean;
        sq[0] += v[j][k] * v[j][k];
      }
    }
  }
  RowSum<TPR>::sum(sq, nullptr);
  const float r_std = rsqrtf(sq[0] / static_cast<float>(c - 1) + eps);
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int q = t + TPR * j;
    if (live && q < chunks) {
      float o[kW], ga[kW], be[kW];
      load_params<kW>(gamma + q * kW, ga);
      load_params<kW>(beta + q * kW, be);
#pragma unroll
      for (int k = 0; k < kW; ++k) {
        o[k] = v[j][k] * r_std * ga[k] + be[k];
        if (relu) o[k] = fmaxf(o[k], 0.f);
      }
      store_chunk<V>(yr + q * kW, o);
    }
  }
}

template <typename T>
cudaError_t set_fwd_smem_limit() {
  const void* fns[] = {
      reinterpret_cast<const void*>(channel_norm_kernel<T, 1>),
      reinterpret_cast<const void*>(channel_norm_kernel<T, 2>),
      reinterpret_cast<const void*>(channel_norm_kernel<T, 4>),
      reinterpret_cast<const void*>(channel_norm_kernel<T, 8>),
      reinterpret_cast<const void*>(channel_norm_kernel<T, 16>),
      reinterpret_cast<const void*>(channel_norm_kernel<T, 32>),
      reinterpret_cast<const void*>(channel_norm_kernel<T, 64>)};
  for (const void* fn : fns) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kFwdMaxSmem);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// Lets every forward variant take up to kFwdMaxSmem of dynamic shared
// memory on the current device: once per device, at its first launch (the
// callers make that launch outside any CUDA-graph capture).
cudaError_t prepare_fwd() {
  static std::atomic<unsigned long long> ready{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (ready.load() & bit) return cudaSuccess;
  err = set_fwd_smem_limit<float>();
  if (err == cudaSuccess) err = set_fwd_smem_limit<__nv_bfloat16>();
  if (err == cudaSuccess) ready.fetch_or(bit);
  return err;
}

template <typename T, int TPR>
void launch_one(const T* x, const float* gamma, const float* beta, T* y,
                int64_t m, int c, int rows, int stages, int blocks,
                float eps, int relu, cudaStream_t stream) {
  const int smem = Unit<TPR>::kPerBlock * stages *
                   (rows * c * static_cast<int>(sizeof(T)) + 16);
  channel_norm_kernel<T, TPR><<<blocks, kFwdThreads, smem, stream>>>(
      x, gamma, beta, y, m, c, rows, stages, eps, relu);
}

template <typename T, int V, int TPR, int NV>
void launch_rows_one(const T* x, const float* gamma, const float* beta, T* y,
                     int64_t m, int c, int blocks, float eps, int relu,
                     cudaStream_t stream) {
  channel_norm_rows_kernel<T, V, TPR, NV><<<blocks, kFwdThreads, 0, stream>>>(
      x, gamma, beta, y, m, c, eps, relu);
}

// Rows in registers: chunks of V = 16 bytes where the row's bytes are a
// multiple of 16 and x, y, gamma and beta are 16-byte aligned, else of 8
// where they allow that (gamma and beta aligned to min(16, 4 * V /
// sizeof(T)) bytes); tpr lanes a row (a power of two, 1 to 32; more than
// one chunk a lane only at 32), each lane at most 8 chunks and 32 values
// (NV the fewest of 1, 2, 4, 8 that hold its chunks); the grid covers every
// row (blocks * 256 / tpr >= m).
template <typename T>
int launch_rows(const T* x, const float* g, const float* b, T* y, int64_t m,
                int c, float eps, int relu, int tpr, int rows, int blocks,
                cudaStream_t s) {
  const int row_bytes = c * static_cast<int>(sizeof(T));
  const uintptr_t data = reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(y);
  const uintptr_t params = reinterpret_cast<uintptr_t>(g) |
                           reinterpret_cast<uintptr_t>(b);
  auto fits = [&](int v) {
    const int param_bytes = 4 * v / static_cast<int>(sizeof(T));
    return row_bytes % v == 0 && data % v == 0 &&
           params % (param_bytes < 16 ? param_bytes : 16) == 0;
  };
  const int v = fits(16) ? 16 : fits(8) ? 8 : 0;
  const int chunks = v ? row_bytes / v : 0;
  const int nv = v ? (chunks + tpr - 1) / tpr : 0;
  const int most = 32 / (v ? v / static_cast<int>(sizeof(T)) : 1);
  if (v == 0 || tpr > 32 || rows != kFwdThreads / tpr ||
      nv > (most < 8 ? most : 8) || (tpr < 32 && nv > 1) ||
      static_cast<int64_t>(blocks) * rows < m)
    return static_cast<int>(cudaErrorInvalidValue);
#define HIFIC_ROWS(V, TPR, NV) \
  launch_rows_one<T, V, TPR, NV>(x, g, b, y, m, c, blocks, eps, relu, s)
#define HIFIC_ROWS_V(V)                                  \
  switch (tpr * 16 + (nv <= 1 ? 1 : nv <= 2 ? 2 : nv <= 4 ? 4 : 8)) { \
    case 1 * 16 + 1: HIFIC_ROWS(V, 1, 1); break;         \
    case 2 * 16 + 1: HIFIC_ROWS(V, 2, 1); break;         \
    case 4 * 16 + 1: HIFIC_ROWS(V, 4, 1); break;         \
    case 8 * 16 + 1: HIFIC_ROWS(V, 8, 1); break;         \
    case 16 * 16 + 1: HIFIC_ROWS(V, 16, 1); break;       \
    case 32 * 16 + 1: HIFIC_ROWS(V, 32, 1); break;       \
    case 32 * 16 + 2: HIFIC_ROWS(V, 32, 2); break;       \
    case 32 * 16 + 4: HIFIC_ROWS(V, 32, 4); break;       \
    default: HIFIC_ROWS(V, 32, 8); break;                \
  }
  if (v == 16) {
    HIFIC_ROWS_V(16)
  } else {
    HIFIC_ROWS_V(8)
  }
#undef HIFIC_ROWS_V
#undef HIFIC_ROWS
  return static_cast<int>(cudaGetLastError());
}

// The plan. via_smem 0: rows in registers (launch_rows). via_smem 1: tiles
// through shared memory: tpr threads per row (a power of two, 1 to 64,
// holding the row with at most kFwdNv columns each), `rows` rows per unit's
// tile (their bytes a multiple of 16), `stages` ring slots per unit (1 to
// 4, the block's rings within kFwdMaxSmem) and at most `blocks` blocks
// (fewer where there are fewer tiles than units).
template <typename T>
int launch(const void* xp, const void* gp, const void* bp, void* yp,
           int64_t m, int c, float eps, int relu, int via_smem, int tpr,
           int rows, int stages, int blocks, void* stream_ptr) {
  const int64_t tile_bytes = static_cast<int64_t>(rows) * c * sizeof(T);
  const int units = kFwdThreads / (tpr > 32 ? tpr : 32);  // per block
  if (c < 2 || c > kMaxChannels || m < 0 || tpr < 1 || tpr > kFwdMaxTpr ||
      (tpr & (tpr - 1)) != 0 || rows < 1 || blocks < 1 ||
      (via_smem != 0 && via_smem != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (via_smem &&
      ((c + tpr - 1) / tpr > kFwdNv || tile_bytes % 16 != 0 || stages < 1 ||
       stages > kFwdMaxStages ||
       units * stages * (tile_bytes + 16) > kFwdMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  const T* x = static_cast<const T*>(xp);
  T* y = static_cast<T*>(yp);
  const float* g = static_cast<const float*>(gp);
  const float* b = static_cast<const float*>(bp);
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  if (m == 0) return static_cast<int>(cudaGetLastError());
  if (!via_smem)
    return launch_rows(x, g, b, y, m, c, eps, relu, tpr, rows, blocks, s);
  const cudaError_t ready = prepare_fwd();
  if (ready != cudaSuccess) return static_cast<int>(ready);
  const int64_t tiles = (m + rows - 1) / rows;
  const int64_t needed = (tiles + units - 1) / units;
  if (needed < blocks) blocks = static_cast<int>(needed);
#define HIFIC_FWD(TPR) \
  launch_one<T, TPR>(x, g, b, y, m, c, rows, stages, blocks, eps, relu, s)
  switch (tpr) {
    case 1: HIFIC_FWD(1); break;
    case 2: HIFIC_FWD(2); break;
    case 4: HIFIC_FWD(4); break;
    case 8: HIFIC_FWD(8); break;
    case 16: HIFIC_FWD(16); break;
    case 32: HIFIC_FWD(32); break;
    default: HIFIC_FWD(64); break;
  }
#undef HIFIC_FWD
  return static_cast<int>(cudaGetLastError());
}

__global__ void empty_kernel() {}

}  // namespace

extern "C" int hific_channel_norm_f32(const void* x, const void* gamma,
                                      const void* beta, void* y, int64_t m,
                                      int c, float eps, int relu,
                                      int via_smem, int tpr, int rows,
                                      int stages, int blocks, void* stream) {
  return launch<float>(x, gamma, beta, y, m, c, eps, relu, via_smem, tpr,
                       rows, stages, blocks, stream);
}

extern "C" int hific_channel_norm_bf16(const void* x, const void* gamma,
                                       const void* beta, void* y, int64_t m,
                                       int c, float eps, int relu,
                                       int via_smem, int tpr, int rows,
                                       int stages, int blocks, void* stream) {
  return launch<__nv_bfloat16>(x, gamma, beta, y, m, c, eps, relu, via_smem,
                               tpr, rows, stages, blocks, stream);
}

// An empty kernel of the given grid, to time what a launch alone costs.
extern "C" int hific_empty_kernel(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
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
