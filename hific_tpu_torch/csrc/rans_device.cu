// The device rANS coders of the codec path, for Hopper (sm_90a).
//
// rans_encode replaces the JAX package's XLA scan
// hific_tpu/entropy/device_encode.py:encode_scan (with _push and
// _push_overflow) and its host flatten, assemble_stream; rans_decode
// replaces hific_tpu/entropy/device_decode.py:decode_scan (with _renorm,
// _pop_nibble and _decode_overflow). Both write and read bit for bit the v1
// stream of the host coder (entropy/coding.py, entropy/csrc/rans.cc): one
// 64-bit rANS lane per channel, positions in row-major order, a shared tail
// of 32-bit words that lanes spill into (encode) or refill from (decode) in
// lane order, the encoder's chunks newest first.
//
// Each entry point codes a batch of streams in one call, each stream with
// its own positions, lanes, tables and buffers, described by an array of
// descriptors (EncodeStream, DecodeStream) that the caller places on the
// device.
//
// What bounds them: a chain of dependent steps per position, serial over
// positions; their bytes (a few a symbol) would take microseconds. A warp
// waits out the latency of every instruction its next one depends on, and
// there are few warps to hide it, so the design shortens the chain and
// keeps every load off it.
//
// Encode is lane-parallel. A lane's head depends only on its own symbols:
// how many push events a position has is fixed by its symbols (one, or
// max_w + n_marker + 1 with escapes), and a block-wide prefix would only
// decide where a spilled word goes. So it runs in four grids:
//   plan     one warp per position: max_w and n_marker from the symbols
//            and the rows' lengths and offsets;
//   lanes    one warp per block, one thread per lane, no block barrier:
//            each thread walks its lane from the last position to the
//            first. Its inputs come into shared memory by cp.async a group
//            of positions ahead, and a position's push data is built over
//            the four iterations before its push (inputs, row meta, CDF
//            entries from the rows in shared memory, the frequency's
//            reciprocal), each stage using what the one before loaded an
//            iteration earlier. The push divides exactly through a float64
//            reciprocal and one correction a step (push_head). Per event
//            and warp it records the spill ballot and the warp's word
//            cursor, and stores its spilled words in the warp's ring;
//   offsets  one block per stream: an exclusive scan of the ballots' counts
//            in the tail's order (newest event first, warps ascending)
//            gives each (event, warp) chunk its place; the event counts
//            go to `lens`;
//   scatter  one warp per (event, warp) chunk: its words to the tail in
//            their final order, lane order kept within the chunk.
// The stream comes out whole: [heads hi | heads lo | tail].
//
// Decode cannot leave lock-step (a lane's next symbol is the low bits of
// its refilled head, and the refilled word's place depends on every earlier
// lane's refills), so it keeps one block per stream and one thread per lane
// and shortens each position's chain: the rows' 16-bit CDFs and a bucket
// index (cf >> shift -> the first candidate symbol, then a binary search)
// in shared memory instead of a gather from a 32 MiB (start|freq, value)
// table; a ring of tail words in shared memory refilled ahead of the cursor
// with cp.async; index rows loaded three positions ahead; one __syncthreads
// a position, the warps' counts and the any-escape flag summed by one warp
// reduction. Escape rounds stay block-wide and rare.
//
// Both kernels come in two variants: the tables in shared memory (every
// table of the batch fits, the rule) or read from device memory.
//
// A kernel reads an index outside the tables as row 0 and counts it, so
// that the caller can raise; it never reads outside its arrays. Writes past
// a stream's capacities are dropped but counted: the true demand is
// reported.
//
// Built by plain nvcc (native_build.py) and bound with ctypes
// (entropy/device_rans.py); the entry points return cudaGetLastError().

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLanes = 1024;
constexpr int kMaxWarps = kMaxLanes / 32;
constexpr uint64_t kRansL = 1ull << 31;      // heads live in [2^31, 2^63)
constexpr int kOverflowWidth = 4;
constexpr uint32_t kMaxOverflow = (1u << kOverflowWidth) - 1u;
constexpr uint64_t kXMaxEscape = 1ull << 59;  // ((2^31 >> 4) << 32) * 1
// A payload is below 2^32: at most 8 nibble rounds and 1 marker round.
constexpr int kMaxEventsPerPosition = 10;
// Dynamic shared memory a block may use on sm_90 (227 KB).
constexpr int kMaxSharedBytes = 232448;
// Decode's ring of tail words: kRing words, refilled kChunk at a time.
constexpr int kRing = 4096;
constexpr int kChunk = 512;

// One stream of an encode batch (every field 8 bytes: the caller packs them
// as int64). Tables: the blob of entropy/rans_tables.py; the encoder reads
// its first `table_words` words (row meta, then the 16-bit CDF area at word
// `cdf_word`).
struct EncodeStream {
  const int32_t* sym;      // [P, L]
  const int32_t* idx;      // [P, L]
  const uint32_t* table;
  uint32_t* plan;          // scratch [P]: max_w | n_marker << 8
  uint2* events;           // scratch [10 P, W]: (spill ballot, warp cursor)
  uint32_t* base;          // scratch [10 P, W]: the chunk's place in the tail
  uint32_t* words;         // scratch [W, ring]: each warp's spilled words
  uint32_t* stream;        // out [2 L + spill_cap]
  uint32_t* lens;          // out [lens_cap]
  uint32_t* counts;        // out [3]: spill words, events, bad indices
  int64_t n_pos, lanes, n_rows, table_words, cdf_word, spill_cap, lens_cap,
      ring, block_base;
};
static_assert(sizeof(EncodeStream) == 19 * 8, "EncodeStream is 19 int64");

// One stream of a decode batch. The blob in full: row meta, 16-bit CDFs at
// `cdf_word`, 16-bit buckets at `bucket_word`, (1 << (precision - shift)) + 1
// per row.
struct DecodeStream {
  const uint32_t* stream;  // [head_hi (L) | head_lo (L) | tail]
  const int32_t* idx;      // [P, L]
  const uint32_t* table;
  int32_t* out;            // [P, L]
  uint32_t* bad;           // [1]
  int64_t stream_len, n_pos, lanes, n_rows, table_words, cdf_word,
      bucket_word, bucket_shift;
};
static_assert(sizeof(DecodeStream) == 13 * 8, "DecodeStream is 13 int64");

__host__ __device__ __forceinline__ int warps_of(int64_t lanes) {
  return int((lanes + 31) / 32);
}

// coding.py:_prepare in int32, as the JAX package computes it: the value
// pushed with the row's CDF, the escape flag and the non-negative payload.
struct Prepared {
  int32_t value;
  bool of;
  uint32_t payload, width;
};

__device__ __forceinline__ Prepared prepare(int32_t s, int4 meta, bool live) {
  Prepared p;
  const int32_t max_value = meta.y - 2;
  const int32_t value0 = int32_t(uint32_t(s) - uint32_t(meta.z));
  const bool lower = value0 < 0, upper = value0 >= max_value;
  p.of = live && (lower || upper);
  p.payload = 0;
  if (lower) p.payload = uint32_t(-2 * int64_t(value0) - 1);
  if (upper) p.payload = uint32_t(2 * (int64_t(value0) - max_value));
  p.value = (lower || upper) ? max_value : value0;
  p.width = (p.of && p.payload) ? (32u - __clz(p.payload) + 3u) / 4u : 0u;
  return p;
}

// Where a block reads its table: with kShared, the block first copies the
// table's first `words` words to `smem` (blobs are padded to 4 words and
// 16-byte aligned), so the compiler emits shared-memory loads; else the
// table in device memory. The launch takes the shared variant when every
// table of the batch fits.
template <bool kShared>
__device__ __forceinline__ const uint32_t* stage_table(const uint32_t* table,
                                                       int64_t words,
                                                       uint32_t* smem) {
  if (!kShared) return table;
  const uint4* src = reinterpret_cast<const uint4*>(table);
  uint4* dst = reinterpret_cast<uint4*>(smem);
  for (int64_t i = threadIdx.x; i < words / 4; i += blockDim.x) dst[i] = src[i];
  __syncthreads();
  return smem;
}

__device__ __forceinline__ void cp_async4(uint32_t* dst, const uint32_t* src) {
  const unsigned addr = unsigned(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(addr),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ------------------------------------------------------------- encode ---

__global__ void __launch_bounds__(256) rans_encode_plan(
    const EncodeStream* __restrict__ streams) {
  const EncodeStream& d = streams[blockIdx.y];
  const int64_t i = int64_t(blockIdx.x) * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (i >= d.n_pos) return;
  const int lanes = int(d.lanes), n_rows = int(d.n_rows);
  const int4* meta = reinterpret_cast<const int4*>(d.table);
  uint32_t max_w = 0, max_k = 0, bad = 0;
  bool any = false;
  for (int l = lane; l < lanes; l += 32) {
    const int32_t s = d.sym[i * lanes + l];
    int32_t r = d.idx[i * lanes + l];
    if (r < 0 || r >= n_rows) {
      ++bad;
      r = 0;
    }
    const Prepared p = prepare(s, meta[r], true);
    if (p.of) {
      any = true;
      max_w = max(max_w, p.width);
      max_k = max(max_k, p.width / 15u);
    }
  }
  max_w = __reduce_max_sync(0xffffffffu, max_w);
  max_k = __reduce_max_sync(0xffffffffu, max_k);
  bad = __reduce_add_sync(0xffffffffu, bad);
  any = __any_sync(0xffffffffu, any);
  if (lane == 0) {
    d.plan[i] = any ? max_w | (max_k + 1u) << 8 : 0u;
    if (bad) atomicAdd(&d.counts[2], bad);
  }
}

// 1 / f rounded to nearest, on the card and on a host alike.
__host__ __device__ __forceinline__ double reciprocal(uint32_t f) {
#ifdef __CUDA_ARCH__
  return __drcp_rn(double(f));
#else
  return 1.0 / double(f);
#endif
}

// One step of the exact division by f in [1, 2^16): q = floor(x / f) for
// x < f * 2^32, given x as a double (exact: x < 2^48) and rcp = 1 / f
// rounded to nearest. x * rcp is x / f times (1 + e) with |e| <= 2^-52, off
// by less than 2^-19 from x / f < 2^32. Where f divides x it may come out
// one low; otherwise x / f lies at least 1 / f >= 2^-16 from either integer
// and the truncation is exact. The caller's remainder test (r >= f: one
// more) makes it exact for every f and x.
__host__ __device__ __forceinline__ uint32_t quotient_estimate(double x,
                                                               double rcp) {
  return uint32_t(x * rcp);
}

// h = (h / f) << precision + h % f + start, exactly, for h < f << (63 -
// precision): the high word (< f * 2^31) divided first, then the remainder
// and the low word. No branches.
__host__ __device__ __forceinline__ uint64_t push_head(uint64_t h,
                                                       uint32_t start,
                                                       uint32_t f, double rcp,
                                                       int precision) {
  const uint32_t hi = uint32_t(h >> 32), lo = uint32_t(h);
  uint32_t q1 = quotient_estimate(double(hi), rcp);
  uint32_t r1 = hi - q1 * f;
  const bool fix1 = r1 >= f;
  q1 += fix1;
  r1 -= fix1 ? f : 0u;
  // r1 * 2^32 + lo < 2^48: the fma is exact.
  uint32_t q2 =
      quotient_estimate(fma(double(r1), 4294967296.0, double(lo)), rcp);
  uint64_t r2 = ((uint64_t(r1) << 32) | lo) - uint64_t(q2) * f;
  const bool fix2 = r2 >= f;
  q2 += fix2;
  r2 -= fix2 ? f : 0u;
  return ((uint64_t(q1) << 32 | q2) << precision) + r2 + start;
}

// Positions a warp stages ahead of its walk, per stage (two stages), and
// the shared words they take before the table.
constexpr int kGroup = 16;
constexpr int kStagedWords = 2 * kGroup * 3 * 32;
// The lane walk builds a position's push data over kLead iterations before
// the one that pushes it (read, row meta, CDF entries, reciprocal), each
// stage using what the stage before loaded an iteration earlier.
constexpr int kLead = 4;
static_assert(kGroup >= kLead, "the walk's first reads lie in one group");

template <bool kShared>
__global__ void __launch_bounds__(32) rans_encode_lanes(
    const EncodeStream* __restrict__ streams, int n_streams, int precision) {
  extern __shared__ uint4 dynamic_smem[];
  int s = 0;
  while (s + 1 < n_streams && int64_t(blockIdx.x) >= streams[s + 1].block_base)
    ++s;
  const EncodeStream& d = streams[s];
  const int w = int(blockIdx.x - d.block_base);
  const int lane = threadIdx.x;
  const int lanes = int(d.lanes), n_rows = int(d.n_rows);
  const int n_warps = warps_of(lanes);
  const int l = w * 32 + lane;
  const bool live = l < lanes;
  // Staged inputs: [stage][position][sym, idx, plan][lane], each lane
  // copying and reading its own.
  uint32_t* staged = reinterpret_cast<uint32_t*>(dynamic_smem);
  const uint32_t* table =
      stage_table<kShared>(d.table, d.table_words, staged + kStagedWords);
  const int4* meta = reinterpret_cast<const int4*>(table);
  const uint16_t* cdf = reinterpret_cast<const uint16_t*>(table + d.cdf_word);
  uint2* events = d.events + w;
  uint32_t* words = d.words + int64_t(w) * d.ring;
  const uint32_t ring = uint32_t(d.ring);
  const unsigned below = (1u << lane) - 1u;
  const int n_pos = int(d.n_pos);
  const int64_t column = live ? l : 0;
  const int32_t* sym = d.sym;
  const int32_t* idx = d.idx;
  const uint32_t* plan = d.plan;

  // Walk step j codes position n_pos - 1 - j. Group g (steps g * kGroup on)
  // goes to stage g & 1.
  auto stage_group = [&](int g) {
    uint32_t* dst = staged + (g & 1) * kGroup * 3 * 32 + lane;
    for (int k = 0; k < kGroup; ++k) {
      const int i = n_pos - 1 - (g * kGroup + k);
      if (i < 0) break;
      const int64_t at = int64_t(i) * lanes + column;
      cp_async4(dst + (3 * k) * 32, reinterpret_cast<const uint32_t*>(sym + at));
      cp_async4(dst + (3 * k + 1) * 32,
                reinterpret_cast<const uint32_t*>(idx + at));
      cp_async4(dst + (3 * k + 2) * 32, plan + i);
    }
    cp_async_commit();
  };

  // The stages' registers, named by the stage that fills them.
  uint32_t a_sym, a_idx, a_plan;  // read: step j + 4
  uint32_t b_sym, b_plan;         // row meta: step j + 3
  int4 b_meta;
  Prepared c_p;                   // CDF entries: step j + 2
  uint32_t c_plan, c_start, c_next;
  Prepared d_p;                   // reciprocal: step j + 1
  uint32_t d_plan, d_start, d_freq;
  double d_rcp;
  auto read = [&](int j) {  // the step's staged inputs (clamped to the last)
    j = min(j, n_pos - 1);
    const uint32_t* src =
        staged + ((j / kGroup) & 1) * kGroup * 3 * 32 + 3 * (j % kGroup) * 32 +
        lane;
    a_sym = src[0];
    a_idx = src[32];
    a_plan = src[64];
  };
  auto row_meta = [&]() {
    int32_t r = int32_t(a_idx);
    if (r < 0 || r >= n_rows) r = 0;  // counted by the plan
    b_meta = meta[r];
    b_sym = a_sym;
    b_plan = a_plan;
  };
  auto entries = [&]() {
    c_p = prepare(int32_t(b_sym), b_meta, live);
    c_start = cdf[b_meta.x + c_p.value];
    c_next = cdf[b_meta.x + c_p.value + 1];
    c_plan = b_plan;
  };
  auto recip = [&]() {
    d_p = c_p;
    d_plan = c_plan;
    d_start = c_start;
    d_freq = (c_next - c_start) & 0xFFFFu;
    d_rcp = reciprocal(d_freq);
  };

  uint64_t h = kRansL;
  uint32_t e = 0, cursor = 0, slot = 0;
  // One push event's spill: the lanes in `sp` store their low words in the
  // warp's ring in lane order and shift their heads down.
  auto event = [&](bool sp) {
    const unsigned ballot = __ballot_sync(0xffffffffu, sp);
    if (lane == 0) *events = make_uint2(ballot, cursor);
    events += n_warps;
    uint32_t at = slot + __popc(ballot & below);
    at = at >= ring ? at - ring : at;
    if (sp) words[at] = uint32_t(h);
    h = sp ? h >> 32 : h;
    const uint32_t n = __popc(ballot);
    cursor += n;
    slot += n;
    slot = slot >= ring ? slot - ring : slot;
    ++e;
  };
  // 4-bit identity-CDF push (freq 1) on the escaping lanes.
  auto push_escape = [&](bool of, uint32_t v) {
    event(of && h >= kXMaxEscape);
    if (of) h = (h << kOverflowWidth) + v;
  };

  stage_group(0);
  stage_group(1);
  cp_async_wait<1>();
  if (n_pos > 0) {
    read(0);
    row_meta();
    read(1);
    entries();
    row_meta();
    read(2);
    recip();
    entries();
    row_meta();
    read(3);
  }
  for (int j = 0; j < n_pos; ++j) {
    const uint32_t n_marker = d_plan >> 8;
    if (n_marker) {
      // Escape rounds in reverse of decode's order: nibbles high to low,
      // then width markers last to first.
      const int max_w = int(d_plan & 0xFFu);
      const int iw = int(d_p.width);
      const uint32_t last_marker =
          uint32_t(min(max(iw - 15 * (int(n_marker) - 1), 0), 15));
      for (int k = max_w - 1; k >= 0; --k) {
        uint32_t v = last_marker;
        if (d_p.width > 0) {
          v = (d_p.payload >> (4u * min(uint32_t(k), d_p.width - 1u))) &
              kMaxOverflow;
        }
        push_escape(d_p.of, v);
      }
      for (int k = int(n_marker) - 1; k >= 0; --k) {
        push_escape(d_p.of, uint32_t(min(max(iw - 15 * k, 0), 15)));
      }
    }
    // The position's symbol: h = (h / f) << precision + h % f + start.
    event(live && h >= (uint64_t(d_freq) << (63 - precision)));
    const uint64_t pushed = push_head(h, d_start, d_freq, d_rcp, precision);
    h = live ? pushed : h;
    // The next steps' stages, in the same block as the push above.
    recip();
    entries();
    row_meta();
    if ((j + kLead) % kGroup == 0 && j + kLead < n_pos) {
      stage_group((j + kLead) / kGroup + 1);
      cp_async_wait<1>();
    }
    read(j + kLead);
  }
  cp_async_wait<0>();
  if (live) {
    d.stream[l] = uint32_t(h >> 32);
    d.stream[lanes + l] = uint32_t(h);
  }
  if (w == 0 && lane == 0) d.counts[1] = e;
}

// Exclusive block-wide prefix of v (in thread order) and its total.
__device__ __forceinline__ uint32_t block_exclusive_scan(uint32_t v,
                                                         uint32_t* slots,
                                                         uint32_t& total) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint32_t x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) slots[warp] = x;
  __syncthreads();
  uint32_t before = 0;
  total = 0;
  for (int k = 0; k < int(blockDim.x >> 5); ++k) {
    before += k < warp ? slots[k] : 0u;
    total += slots[k];
  }
  return before + x - v;
}

__global__ void __launch_bounds__(1024) rans_encode_offsets(
    const EncodeStream* __restrict__ streams) {
  __shared__ uint32_t slots[kMaxWarps];
  const EncodeStream& d = streams[blockIdx.x];
  const int n_warps = warps_of(d.lanes);
  const uint32_t n_events = d.counts[1];
  const int64_t n = int64_t(n_events) * n_warps;
  const int64_t per = (n + blockDim.x - 1) / blockDim.x;
  const int64_t q0 = min(n, per * threadIdx.x), q1 = min(n, q0 + per);
  // Entry q of the tail's order: event n_events - 1 - q / W, warp q % W.
  auto entry = [&](int64_t q) {
    return (int64_t(n_events) - 1 - q / n_warps) * n_warps + q % n_warps;
  };
  uint32_t sum = 0;
  for (int64_t q = q0; q < q1; ++q) sum += __popc(d.events[entry(q)].x);
  uint32_t total;
  uint32_t at = block_exclusive_scan(sum, slots, total);
  for (int64_t q = q0; q < q1; ++q) {
    const int64_t k = entry(q);
    d.base[k] = at;
    at += __popc(d.events[k].x);
  }
  const int64_t n_lens = min(int64_t(n_events), d.lens_cap);
  for (int64_t e = threadIdx.x; e < n_lens; e += blockDim.x) {
    uint32_t c = 0;
    for (int w = 0; w < n_warps; ++w) c += __popc(d.events[e * n_warps + w].x);
    d.lens[e] = c;
  }
  if (threadIdx.x == 0) d.counts[0] = total;
}

__global__ void __launch_bounds__(256) rans_encode_scatter(
    const EncodeStream* __restrict__ streams) {
  const EncodeStream& d = streams[blockIdx.y];
  const int n_warps = warps_of(d.lanes);
  const int64_t n = int64_t(d.counts[1]) * n_warps;
  const int lane = threadIdx.x & 31;
  const int64_t stride = int64_t(gridDim.x) * (blockDim.x >> 5);
  uint32_t* tail = d.stream + 2 * d.lanes;
  const uint32_t ring = uint32_t(d.ring);
  for (int64_t k = (int64_t(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
       k < n; k += stride) {
    const uint2 ev = d.events[k];
    if (lane < __popc(ev.x)) {
      const int64_t at = int64_t(d.base[k]) + lane;
      if (at < d.spill_cap) {
        tail[at] = d.words[int64_t(k % n_warps) * d.ring +
                           (ev.y + uint32_t(lane)) % ring];
      }
    }
  }
}

// ------------------------------------------------------------- decode ---

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

template <bool kShared>
__global__ void __launch_bounds__(kMaxLanes) rans_decode_kernel(
    const DecodeStream* __restrict__ streams, int precision) {
  extern __shared__ uint4 dynamic_smem[];
  __shared__ uint32_t prefix_slots[2][kMaxWarps];
  __shared__ uint32_t max_slots[2][kMaxWarps];
  uint32_t* ring = reinterpret_cast<uint32_t*>(dynamic_smem);
  const DecodeStream& d = streams[blockIdx.x];
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int lanes = int(d.lanes), n_rows = int(d.n_rows);
  const bool live = t < lanes;
  const uint32_t* table =
      stage_table<kShared>(d.table, d.table_words, ring + kRing);
  const int4* meta = reinterpret_cast<const int4*>(table);
  const uint16_t* cdf = reinterpret_cast<const uint16_t*>(table + d.cdf_word);
  const uint16_t* buckets =
      reinterpret_cast<const uint16_t*>(table + d.bucket_word);
  const int shift = int(d.bucket_shift);
  const uint32_t* tail = d.stream + 2 * int64_t(lanes);
  const uint32_t tail_len = uint32_t(d.stream_len - 2 * int64_t(lanes));
  const int n_pos = int(d.n_pos);
  const int32_t* idx_at = d.idx + (live ? t : 0);
  int32_t* out_at = d.out + t;
  const int warps = blockDim.x >> 5;
  const unsigned below = (1u << lane) - 1u;

  // The ring holds tail words [issued - kRing, issued); the copies of those
  // below `ready` have landed. A step that frees a chunk's slots first waits
  // for its thread's earlier copies (issued at least a chunk of words ago),
  // so after the next barrier every word below `ready` is in place.
  uint32_t issued = 0, ready = 0, cursor = 0;
  auto issue = [&](uint32_t consumed) {  // slots below `consumed` are free
    if (issued < tail_len && issued + kChunk <= consumed + kRing) {
      cp_async_wait<0>();
      ready = issued;
      do {
        for (int j = t; j < kChunk; j += blockDim.x) {
          const uint32_t at = issued + j;
          if (at < tail_len) cp_async4(&ring[at & (kRing - 1)], tail + at);
        }
        issued += kChunk;
      } while (issued < tail_len && issued + kChunk <= consumed + kRing);
      cp_async_commit();
    }
  };
  issue(0);
  cp_async_wait<0>();
  __syncthreads();
  ready = issued;

  uint64_t h = live ? (uint64_t(d.stream[t]) << 32) | d.stream[lanes + t]
                    : kRansL;
  int parity = 0;

  // Lanes of `mask` whose head fell below 2^31 take one tail word each, in
  // lane order; reads clamp to the tail's last word (0 from an empty tail),
  // as the JAX scan's do. Each warp's slot word holds its count and, from
  // bit 22, whether a lane raised `flag`; one reduction over the slots gives
  // the block's count (bits 0-10), the count of the warps before this one
  // (bits 11-21) and the raised flags (bits 22 on). Returns whether any lane
  // of the block raised `flag`. One __syncthreads; the slot rows alternate,
  // so it also orders this step's writes after the reads of the step
  // before.
  auto renorm = [&](bool mask, bool flag) -> bool {
    const bool pred = mask && h < kRansL;
    const unsigned ballot = __ballot_sync(0xffffffffu, pred);
    const bool any_flag = __any_sync(0xffffffffu, flag);
    // Every lane of the warp stores the same word: no branch.
    prefix_slots[parity][warp] =
        __popc(ballot) | (any_flag ? 1u << 22 : 0u);
    __syncthreads();
    const uint32_t c = lane < warps ? prefix_slots[parity][lane] : 0u;
    parity ^= 1;
    const uint32_t sums = __reduce_add_sync(
        0xffffffffu, c + (lane < warp ? (c & 0x7FFu) << 11 : 0u));
    uint32_t at = cursor + ((sums >> 11) & 0x7FFu) + __popc(ballot & below);
    at = at < tail_len ? at : tail_len - 1;
    uint32_t word = ring[at & (kRing - 1)];
    if (pred && at >= ready && tail_len > 0) word = tail[at];  // rare
    word = tail_len > 0 ? word : 0u;
    h = pred ? (h << 32) | word : h;
    issue(cursor);
    cursor += sums & 0x7FFu;
    return (sums >> 22) != 0;
  };
  // 4-bit identity-CDF pop on `mask` lanes: cf = h & 15; h >>= 4. Returns
  // whether any of them read 15 (another width marker follows).
  auto pop_nibble = [&](bool mask, uint32_t& cf) -> bool {
    cf = uint32_t(h) & kMaxOverflow;
    if (mask) h >>= kOverflowWidth;
    const bool more = renorm(mask, mask && cf == kMaxOverflow);
    if (!mask) cf = 0;
    return more;
  };

  const uint32_t cf_mask = (1u << precision) - 1u;
  uint32_t bad = 0;
  // Rows are loaded three positions ahead into one of three registers,
  // their meta one ahead. The loop is unrolled by three so that a load
  // lands in the register its row is read from three positions later, with
  // no register move that would wait for it.
  auto load_row = [&](int i) {
    return idx_at[int64_t(min(i, n_pos - 1)) * lanes];
  };
  auto row_meta = [&](int32_t r, int i) {
    if (r < 0 || r >= n_rows) {
      bad += live && i < n_pos;
      r = 0;
    }
    return meta[r];
  };
  int4 m_next = int4{};
  int32_t q0 = 0, q1 = 0, q2 = 0;
  if (n_pos > 0) {
    m_next = row_meta(load_row(0), 0);
    q0 = load_row(1);
    q1 = load_row(2);
    q2 = load_row(3);
  }
  auto position = [&](int i, int32_t& q) {
    const int4 m = m_next;
    m_next = row_meta(q, i + 1);
    q = load_row(i + 4);
    const int32_t maxv_r = m.y - 2;
    int32_t val = 0;
    if (live) {
      // The last symbol whose CDF start is <= cf, among the bucket's
      // candidates [lo, hi]: a binary search.
      const uint32_t cf = uint32_t(h) & cf_mask;
      const uint16_t* bk = buckets + m.w + (cf >> shift);
      const uint16_t* row16 = cdf + m.x;
      uint32_t lo = bk[0], hi = bk[1];
      while (lo < hi) {
        const uint32_t mid = (lo + hi + 1) >> 1;
        if (row16[mid] <= cf) {
          lo = mid;
        } else {
          hi = mid - 1;
        }
      }
      const uint32_t start = row16[lo];
      const uint32_t freq = (uint32_t(row16[lo + 1]) - start) & 0xFFFFu;
      val = int32_t(lo);
      // h = freq * (h >> precision) + (cf - start)
      h = uint64_t(freq) * (h >> precision) + (cf - start);
    }
    const bool of = live && val == maxv_r;
    if (renorm(live, of)) {
      // Width markers while any lane reads 15, then nibble rounds up to the
      // widest payload; every escaping lane pops in every round.
      uint32_t v;
      bool more = pop_nibble(of, v);
      uint32_t widths = v;
      while (more) {
        more = pop_nibble(of, v);
        widths += v;
      }
      uint32_t max_w, unused;
      block_max2(of ? widths : 0u, 0u, max_slots, max_w, unused);
      uint32_t ov = 0;
      for (uint32_t j = 0; j < max_w; ++j) {
        pop_nibble(of, v);
        if (of && widths > j) ov |= v << min(j * kOverflowWidth, 31u);
      }
      if (of) {  // the non-negative payload back to a signed value
        const uint32_t half = ov >> 1;
        val = int32_t((ov & 1u) ? 0u - half - 1u : half + uint32_t(maxv_r));
      }
    }
    if (live) *out_at = int32_t(uint32_t(val) + uint32_t(m.z));
    out_at += lanes;
  };
  int i = 0;
  for (; i + 3 <= n_pos; i += 3) {
    position(i, q0);
    position(i + 1, q1);
    position(i + 2, q2);
  }
  if (i < n_pos) position(i, q0);
  if (i + 1 < n_pos) position(i + 1, q1);
  cp_async_wait<0>();
  if (bad) atomicAdd(d.bad, bad);
}

// The largest of a batch's tables in words, or -1 if one does not fit in
// `budget` words (the batch then reads its tables from device memory).
int64_t table_smem_words(int64_t words, int64_t budget, int64_t current) {
  if (current < 0 || words > budget) return -1;
  return words > current ? words : current;
}

}  // namespace

extern "C" {

// host and dev: the same array of n_streams EncodeStream, in host memory
// (read here to size the grids) and on the device (read by the kernels).
int hific_rans_encode(const void* host_streams, const void* dev_streams,
                      int n_streams, int precision, void* stream) {
  const auto* host = static_cast<const EncodeStream*>(host_streams);
  const auto* dev = static_cast<const EncodeStream*>(dev_streams);
  if (n_streams < 1 || precision < 1 || precision > 16) {
    return int(cudaErrorInvalidValue);
  }
  int64_t max_pos = 0, max_entries = 0, smem_words = 0, blocks = 0;
  const int64_t budget = kMaxSharedBytes / 4 - kStagedWords;
  for (int s = 0; s < n_streams; ++s) {
    const EncodeStream& d = host[s];
    if (d.lanes < 1 || d.lanes > kMaxLanes || d.n_pos < 0 ||
        d.n_pos >= (1ll << 31) || d.n_rows < 1 || d.spill_cap < 1 ||
        d.lens_cap < 1 || d.ring < d.spill_cap + 32 ||
        d.ring > 0xFFFFFFFFll || d.block_base != blocks ||
        d.table_words % 4 != 0 ||
        reinterpret_cast<uintptr_t>(d.table) % 16 != 0) {
      return int(cudaErrorInvalidValue);
    }
    blocks += warps_of(d.lanes);
    max_pos = d.n_pos > max_pos ? d.n_pos : max_pos;
    const int64_t entries = d.n_pos * warps_of(d.lanes);
    max_entries = entries > max_entries ? entries : max_entries;
    smem_words = table_smem_words(d.table_words, budget, smem_words);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (max_pos > 0) {
    const int64_t plan_blocks = (max_pos + 7) / 8;
    if (plan_blocks > 0x7FFFFFFF || n_streams > 65535) {
      return int(cudaErrorInvalidValue);
    }
    rans_encode_plan<<<dim3(unsigned(plan_blocks), n_streams), 256, 0, s>>>(
        dev);
  }
  const bool shared = smem_words >= 0;
  const size_t smem = size_t(kStagedWords + (shared ? smem_words : 0)) * 4;
  auto lanes_kernel =
      shared ? rans_encode_lanes<true> : rans_encode_lanes<false>;
  cudaError_t err = cudaFuncSetAttribute(
      lanes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  lanes_kernel<<<unsigned(blocks), 32, smem, s>>>(dev, n_streams, precision);
  rans_encode_offsets<<<n_streams, 1024, 0, s>>>(dev);
  // About one event per position: chunks past the grid take another turn.
  const int64_t scatter_blocks = (max_entries + 7) / 8;
  const unsigned grid = unsigned(
      scatter_blocks < 1 ? 1 : scatter_blocks > 4096 ? 4096 : scatter_blocks);
  rans_encode_scatter<<<dim3(grid, n_streams), 256, 0, s>>>(dev);
  return int(cudaGetLastError());
}

// host and dev: the same array of n_streams DecodeStream, as above.
int hific_rans_decode(const void* host_streams, const void* dev_streams,
                      int n_streams, int precision, void* stream) {
  const auto* host = static_cast<const DecodeStream*>(host_streams);
  const auto* dev = static_cast<const DecodeStream*>(dev_streams);
  if (n_streams < 1 || precision < 1 || precision > 16) {
    return int(cudaErrorInvalidValue);
  }
  int64_t max_lanes = 0, smem_words = 0;
  const int64_t budget =
      (kMaxSharedBytes - int64_t(sizeof(uint32_t)) * 4 * kMaxWarps) / 4 -
      kRing;
  for (int s = 0; s < n_streams; ++s) {
    const DecodeStream& d = host[s];
    if (d.lanes < 1 || d.lanes > kMaxLanes || d.n_pos < 0 || d.n_rows < 1 ||
        d.stream_len < 2 * d.lanes || d.stream_len >= (1ll << 31) ||
        d.n_pos >= (1ll << 31) || d.bucket_shift < 0 ||
        d.bucket_shift > precision || d.table_words % 4 != 0 ||
        reinterpret_cast<uintptr_t>(d.table) % 16 != 0) {
      return int(cudaErrorInvalidValue);
    }
    max_lanes = d.lanes > max_lanes ? d.lanes : max_lanes;
    smem_words = table_smem_words(d.table_words, budget, smem_words);
  }
  const int threads = warps_of(max_lanes) * 32;
  const bool shared = smem_words >= 0;
  const size_t smem = size_t(kRing + (shared ? smem_words : 0)) * 4;
  auto decode_kernel =
      shared ? rans_decode_kernel<true> : rans_decode_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  decode_kernel<<<n_streams, threads, smem,
                  static_cast<cudaStream_t>(stream)>>>(dev, precision);
  return int(cudaGetLastError());
}

}  // extern "C"
