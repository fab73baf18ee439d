// The device rANS coders of the codec path, for Hopper (sm_90a).
//
// rans_encode replaces the JAX package's XLA scan
// hific_tpu/entropy/device_encode.py:encode_scan (with _push and
// _push_overflow); rans_decode replaces
// hific_tpu/entropy/device_decode.py:decode_scan (with _renorm, _pop_nibble
// and _decode_overflow). Both write and read bit for bit the v1 stream of
// the host coder (entropy/coding.py, entropy/csrc/rans.cc): one 64-bit rANS
// lane per channel, positions in row-major order, a shared tail of 32-bit
// words that lanes spill into (encode) or refill from (decode) in lane order.
//
// What bounds them: a chain of dependent steps per position. In decode the
// table gather's address depends on the head, and a refill's tail word on a
// block-wide prefix; in encode each push depends on the last through the
// head and the spill cursor. The work is serial over positions and latency-
// bound, far above what its bytes would need (a few bytes per symbol).
//
// Design: one thread block per stream and one thread per lane (lanes <=
// 1024). Heads are native uint64 and encode divides natively (u64 / u32):
// the uint32-pair emulation of the JAX scans exists only because the TPU
// lacks 64-bit integers. The lane-order prefix of a spill or refill event is
// __ballot_sync + __popc within each warp, then the warp totals through
// shared memory, double-buffered so that each event costs one
// __syncthreads; every thread keeps the same cursor. The escape paths run
// only where __syncthreads_or says that a lane of the position escapes;
// decode's marker rounds loop on __syncthreads_or, and the widest payload
// is a block reduction. A kernel reads an index outside the tables as row 0
// and counts it, so that the caller can raise; it never reads outside its
// arrays.
//
// Built by plain nvcc (native_build.py) and bound with ctypes
// (entropy/device_rans.py); the entry points return cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLanes = 1024;
constexpr int kMaxWarps = kMaxLanes / 32;
constexpr uint64_t kRansL = 1ull << 31;      // heads live in [2^31, 2^63)
constexpr int kOverflowWidth = 4;
constexpr uint32_t kMaxOverflow = (1u << kOverflowWidth) - 1u;
constexpr uint64_t kXMaxEscape = 1ull << 59;  // ((2^31 >> 4) << 32) * 1

// Exclusive lane-order prefix of `pred` over the block, and its total. The
// warp totals alternate between two shared slots, so the one
// __syncthreads here also orders this call's writes after every thread's
// reads of the call before last.
struct BlockPrefix {
  uint32_t (*slots)[kMaxWarps];
  int parity;

  __device__ __forceinline__ uint32_t operator()(bool pred, uint32_t& total) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const unsigned ballot = __ballot_sync(0xffffffffu, pred);
    uint32_t* slot = slots[parity];
    parity ^= 1;
    if (lane == 0) slot[warp] = __popc(ballot);
    __syncthreads();
    uint32_t before = 0, sum = 0;
    const int warps = blockDim.x >> 5;
    for (int w = 0; w < warps; ++w) {
      const uint32_t c = slot[w];
      before += w < warp ? c : 0u;
      sum += c;
    }
    total = sum;
    return before + __popc(ballot & ((1u << lane) - 1u));
  }
};

// Block-wide maxima of a and b (two slot rows, one __syncthreads).
__device__ __forceinline__ void block_max2(uint32_t a, uint32_t b,
                                           uint32_t (*slots)[kMaxWarps],
                                           uint32_t& max_a, uint32_t& max_b) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  a = __reduce_max_sync(0xffffffffu, a);
  b = __reduce_max_sync(0xffffffffu, b);
  if (lane == 0) {
    slots[0][warp] = a;
    slots[1][warp] = b;
  }
  __syncthreads();
  max_a = max_b = 0;
  const int warps = blockDim.x >> 5;
  for (int w = 0; w < warps; ++w) {
    max_a = max(max_a, slots[0][w]);
    max_b = max(max_b, slots[1][w]);
  }
}

__global__ void __launch_bounds__(kMaxLanes) rans_encode_kernel(
    const int32_t* __restrict__ sym, const int32_t* __restrict__ idx,
    int64_t n_pos, int lanes, const int32_t* __restrict__ cdf, int max_len,
    const int32_t* __restrict__ cdf_length,
    const int32_t* __restrict__ cdf_offset, int n_rows, int precision,
    uint32_t* __restrict__ heads, uint32_t* __restrict__ spill,
    int64_t spill_cap, uint32_t* __restrict__ lens, int64_t lens_cap,
    uint32_t* __restrict__ counts) {
  __shared__ uint32_t prefix_slots[2][kMaxWarps];
  __shared__ uint32_t max_slots[2][kMaxWarps];
  const int t = threadIdx.x;
  const bool live = t < lanes;
  BlockPrefix prefix{prefix_slots, 0};
  uint64_t h = kRansL;
  uint32_t s_cur = 0, e_cur = 0, bad = 0;

  // One push event's spill phase: the lanes in `sp` store their low words
  // in lane order at the cursor (dropped past the capacity, still counted)
  // and shift their heads down; the event's count goes to `lens`.
  auto spill_phase = [&](bool sp) {
    uint32_t total;
    const uint32_t k = prefix(sp, total);
    if (sp) {
      const uint64_t pos = uint64_t(s_cur) + k;
      if (pos < uint64_t(spill_cap)) spill[pos] = uint32_t(h);
      h >>= 32;
    }
    if (t == 0 && int64_t(e_cur) < lens_cap) lens[e_cur] = total;
    s_cur += total;
    ++e_cur;
  };
  // 4-bit identity-CDF push (freq 1) on the escaping lanes.
  auto push_escape = [&](bool of, uint32_t v) {
    spill_phase(of && h >= kXMaxEscape);
    if (of) h = (h << kOverflowWidth) + v;
  };

  const int32_t* sym_at = sym + t;
  const int32_t* idx_at = idx + t;
  int32_t s_next = 0, r_next = 0;
  if (live && n_pos > 0) {
    s_next = sym_at[(n_pos - 1) * lanes];
    r_next = idx_at[(n_pos - 1) * lanes];
  }
  for (int64_t i = n_pos - 1; i >= 0; --i) {
    int32_t s = s_next, r = r_next;
    if (live && i > 0) {  // the next position's loads, ahead of the chain
      s_next = sym_at[(i - 1) * lanes];
      r_next = idx_at[(i - 1) * lanes];
    }
    if (r < 0 || r >= n_rows) {
      bad += live;
      r = 0;
    }
    // coding.py:_prepare in int32, as the JAX package computes it.
    const int32_t max_value = cdf_length[r] - 2;
    const int32_t value0 = int32_t(uint32_t(s) - uint32_t(cdf_offset[r]));
    const bool lower = value0 < 0, upper = value0 >= max_value;
    const bool of = live && (lower || upper);
    uint32_t payload = 0;
    if (lower) payload = uint32_t(-2 * int64_t(value0) - 1);
    if (upper) payload = uint32_t(2 * (int64_t(value0) - max_value));
    const int32_t value = (lower || upper) ? max_value : value0;
    const int32_t* row = cdf + int64_t(r) * max_len;
    const uint32_t start = uint32_t(row[value]);
    const uint32_t freq = uint32_t(row[value + 1]) - start;
    const uint32_t width =
        (of && payload) ? (32u - __clz(payload) + 3u) / 4u : 0u;

    if (__syncthreads_or(of)) {
      // Escape rounds in reverse of decode's order: nibbles high to low,
      // then width markers last to first.
      uint32_t max_w, n_marker;
      block_max2(width, width / 15u, max_slots, max_w, n_marker);
      n_marker += 1;
      const int iw = int(width);
      const uint32_t last_marker =
          uint32_t(min(max(iw - 15 * (int(n_marker) - 1), 0), 15));
      for (int j = int(max_w) - 1; j >= 0; --j) {
        uint32_t v = last_marker;
        if (width > 0) {
          v = (payload >> (4u * min(uint32_t(j), width - 1u))) & kMaxOverflow;
        }
        push_escape(of, v);
      }
      for (int k = int(n_marker) - 1; k >= 0; --k) {
        push_escape(of, uint32_t(min(max(iw - 15 * k, 0), 15)));
      }
    }
    // The position's symbol: h = (h / f) << precision + h % f + start.
    spill_phase(live && h >= (uint64_t(freq) << (63 - precision)));
    if (live) {
      const uint64_t q = h / freq;
      h = (q << precision) + (h - q * freq) + start;
    }
  }
  if (live) {
    heads[t] = uint32_t(h >> 32);
    heads[lanes + t] = uint32_t(h);
  }
  if (t == 0) {
    counts[0] = s_cur;
    counts[1] = e_cur;
  }
  if (bad) atomicAdd(&counts[2], bad);
}

__global__ void __launch_bounds__(kMaxLanes) rans_decode_kernel(
    const uint32_t* __restrict__ stream, int64_t stream_len,
    const int32_t* __restrict__ idx, int64_t n_pos, int lanes,
    const int2* __restrict__ t_pair, const int32_t* __restrict__ maxv,
    const int32_t* __restrict__ offs, int n_rows, int precision,
    int32_t* __restrict__ out, uint32_t* __restrict__ bad_count) {
  __shared__ uint32_t prefix_slots[2][kMaxWarps];
  __shared__ uint32_t max_slots[2][kMaxWarps];
  const int t = threadIdx.x;
  const bool live = t < lanes;
  BlockPrefix prefix{prefix_slots, 0};
  const uint32_t* tail = stream + 2 * int64_t(lanes);
  const int64_t tail_len = stream_len - 2 * int64_t(lanes);
  uint64_t h = live ? (uint64_t(stream[t]) << 32) | stream[lanes + t] : kRansL;
  uint64_t cursor = 0;
  uint32_t bad = 0;

  // Lanes of `mask` whose head fell below 2^31 take one tail word each, in
  // lane order; reads clamp to the tail's last word (0 from an empty tail),
  // as the JAX scan's do, so padding past the stream is never needed.
  auto renorm = [&](bool mask) {
    const bool pred = mask && h < kRansL;
    uint32_t total;
    const uint32_t k = prefix(pred, total);
    if (pred) {
      uint32_t word = 0;
      if (tail_len > 0) {
        const uint64_t at = cursor + k;
        word = tail[at < uint64_t(tail_len) ? at : uint64_t(tail_len - 1)];
      }
      h = (h << 32) | word;
    }
    cursor += total;
  };
  // 4-bit identity-CDF pop on `mask` lanes: cf = h & 15; h >>= 4.
  auto pop_nibble = [&](bool mask) -> uint32_t {
    const uint32_t cf = uint32_t(h) & kMaxOverflow;
    if (mask) h >>= kOverflowWidth;
    renorm(mask);
    return mask ? cf : 0u;
  };

  const uint32_t cf_mask = (1u << precision) - 1u;
  const int32_t* idx_at = idx + t;
  int32_t r_next = (live && n_pos > 0) ? idx_at[0] : 0;
  for (int64_t i = 0; i < n_pos; ++i) {
    int32_t r = r_next;
    if (live && i + 1 < n_pos) r_next = idx_at[(i + 1) * lanes];
    if (r < 0 || r >= n_rows) {
      bad += live;
      r = 0;
    }
    const int32_t maxv_r = maxv[r], offs_r = offs[r];
    int32_t val = 0;
    if (live) {
      const uint32_t cf = uint32_t(h) & cf_mask;
      const int2 pr = t_pair[(int64_t(r) << precision) | cf];
      const uint32_t sf = uint32_t(pr.x);
      val = pr.y;
      // h = freq * (h >> precision) + (cf - start)
      h = uint64_t(sf & 0xFFFFu) * (h >> precision) + (cf - (sf >> 16));
    }
    renorm(live);

    const bool of = live && val == maxv_r;
    if (__syncthreads_or(of)) {
      // Width markers while any lane reads 15, then nibble rounds up to the
      // widest payload; every escaping lane pops in every round.
      uint32_t v = pop_nibble(of), widths = v;
      while (__syncthreads_or(of && v == kMaxOverflow)) {
        v = pop_nibble(of);
        widths += v;
      }
      uint32_t max_w, unused;
      block_max2(of ? widths : 0u, 0u, max_slots, max_w, unused);
      uint32_t ov = 0;
      for (uint32_t j = 0; j < max_w; ++j) {
        v = pop_nibble(of);
        if (of && widths > j) ov |= v << min(j * kOverflowWidth, 31u);
      }
      if (of) {  // the non-negative payload back to a signed value
        const uint32_t half = ov >> 1;
        val = int32_t((ov & 1u) ? 0u - half - 1u : half + uint32_t(maxv_r));
      }
    }
    if (live) out[i * lanes + t] = int32_t(uint32_t(val) + uint32_t(offs_r));
  }
  if (bad) atomicAdd(bad_count, bad);
}

int threads_for(int lanes) { return (lanes + 31) / 32 * 32; }

}  // namespace

extern "C" {

int hific_rans_encode(const int32_t* sym, const int32_t* idx, int64_t n_pos,
                      int lanes, const int32_t* cdf, int max_len,
                      const int32_t* cdf_length, const int32_t* cdf_offset,
                      int n_rows, int precision, uint32_t* heads,
                      uint32_t* spill, int64_t spill_cap, uint32_t* lens,
                      int64_t lens_cap, uint32_t* counts, void* stream) {
  if (lanes < 1 || lanes > kMaxLanes || n_pos < 0 || n_rows < 1 ||
      precision < 1 || precision > 16) {
    return int(cudaErrorInvalidValue);
  }
  rans_encode_kernel<<<1, threads_for(lanes), 0,
                       static_cast<cudaStream_t>(stream)>>>(
      sym, idx, n_pos, lanes, cdf, max_len, cdf_length, cdf_offset, n_rows,
      precision, heads, spill, spill_cap, lens, lens_cap, counts);
  return int(cudaGetLastError());
}

int hific_rans_decode(const uint32_t* stream_words, int64_t stream_len,
                      const int32_t* idx, int64_t n_pos, int lanes,
                      const int32_t* t_pair, const int32_t* maxv,
                      const int32_t* offs, int n_rows, int precision,
                      int32_t* out, uint32_t* bad, void* stream) {
  if (lanes < 1 || lanes > kMaxLanes || n_pos < 0 || n_rows < 1 ||
      precision < 1 || precision > 16 || stream_len < 2 * int64_t(lanes) ||
      reinterpret_cast<uintptr_t>(t_pair) % alignof(int2) != 0) {
    return int(cudaErrorInvalidValue);
  }
  rans_decode_kernel<<<1, threads_for(lanes), 0,
                       static_cast<cudaStream_t>(stream)>>>(
      stream_words, stream_len, idx, n_pos, lanes,
      reinterpret_cast<const int2*>(t_pair), maxv, offs, n_rows, precision,
      out, bad);
  return int(cudaGetLastError());
}

}  // extern "C"
