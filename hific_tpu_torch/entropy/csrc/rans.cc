// Native rANS indexed coder (lane-parallel semantics, serial execution).
//
// This package's own copy of the JAX package's entropy/csrc/rans.cc. It
// implements exactly the bitstream of entropy/coding.py (vectorized path):
// per position, every lane pushes/pops one symbol against its indexed CDF
// row; out-of-range values emit the row's overflow code plus width-marker /
// nibble rounds in which ALL overflow lanes of the position participate.
// Spill chunks are emitted newest-first on flatten, matching the Python
// Message layout, so streams are interchangeable between the numpy and
// native paths, and with the JAX package's coder (tests/test_torch_entropy.py).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr uint64_t kRansL = 1ull << 31;
constexpr int kOverflowWidth = 4;
constexpr int64_t kMaxOverflow = (1 << kOverflowWidth) - 1;

struct Encoder {
  std::vector<uint64_t> head;
  std::vector<uint32_t> spill;        // spilled words, oldest first
  std::vector<uint32_t> chunk_len;    // words per push event

  explicit Encoder(int64_t lanes) : head(lanes, kRansL) {}

  // Push one symbol on a subset of lanes. starts/freqs are per-participating
  // lane; `lane_ids` maps to absolute lane indices (in increasing order).
  void push(const int64_t* lane_ids, int64_t n, const uint64_t* starts,
            const uint64_t* freqs, int precision) {
    uint32_t spilled = 0;
    for (int64_t i = 0; i < n; ++i) {
      uint64_t& h = head[lane_ids[i]];
      uint64_t x_max = ((kRansL >> precision) << 32) * freqs[i];
      if (h >= x_max) {
        spill.push_back(static_cast<uint32_t>(h));
        h >>= 32;
        ++spilled;
      }
    }
    if (spilled) chunk_len.push_back(spilled);
    for (int64_t i = 0; i < n; ++i) {
      uint64_t& h = head[lane_ids[i]];
      uint64_t f = freqs[i];
      h = ((h / f) << precision) + (h % f) + starts[i];
    }
  }

  int64_t flatten(uint32_t* out, int64_t cap) const {
    int64_t lanes = static_cast<int64_t>(head.size());
    int64_t total = 2 * lanes + static_cast<int64_t>(spill.size());
    if (total > cap) return -total;  // caller re-allocates
    for (int64_t i = 0; i < lanes; ++i)
      out[i] = static_cast<uint32_t>(head[i] >> 32);
    for (int64_t i = 0; i < lanes; ++i)
      out[lanes + i] = static_cast<uint32_t>(head[i]);
    // Stack chunks newest-first, lane order preserved within a chunk.
    int64_t pos = 2 * lanes;
    int64_t chunk_start = static_cast<int64_t>(spill.size());
    for (int64_t c = static_cast<int64_t>(chunk_len.size()) - 1; c >= 0; --c) {
      chunk_start -= chunk_len[c];
      std::memcpy(out + pos, spill.data() + chunk_start,
                  chunk_len[c] * sizeof(uint32_t));
      pos += chunk_len[c];
    }
    return total;
  }
};

struct Decoder {
  std::vector<uint64_t> head;
  const uint32_t* tail;
  int64_t tail_len;
  int64_t cursor = 0;

  Decoder(const uint32_t* stream, int64_t stream_len, int64_t lanes)
      : head(lanes), tail(stream + 2 * lanes), tail_len(stream_len - 2 * lanes) {
    for (int64_t i = 0; i < lanes; ++i)
      head[i] = (static_cast<uint64_t>(stream[i]) << 32) |
                static_cast<uint64_t>(stream[lanes + i]);
  }

  // Pop on a subset of lanes; cf_out receives cumulative frequencies. The
  // caller then supplies starts/freqs via complete().
  void peek(const int64_t* lane_ids, int64_t n, int precision,
            uint64_t* cf_out) const {
    uint64_t mask = (1ull << precision) - 1;
    for (int64_t i = 0; i < n; ++i) cf_out[i] = head[lane_ids[i]] & mask;
  }

  void complete(const int64_t* lane_ids, int64_t n, const uint64_t* cf,
                const uint64_t* starts, const uint64_t* freqs, int precision) {
    for (int64_t i = 0; i < n; ++i) {
      uint64_t& h = head[lane_ids[i]];
      h = freqs[i] * (h >> precision) + cf[i] - starts[i];
      if (h < kRansL) {
        h = (h << 32) | static_cast<uint64_t>(tail[cursor++]);
      }
    }
  }
};

struct Tables {
  const uint32_t* cdf;        // [n_rows, max_len]
  const int32_t* cdf_length;  // [n_rows]
  const int32_t* cdf_offset;  // [n_rows]
  int64_t max_len;
};

inline int64_t nibble_widths(uint64_t overflow) {
  int64_t w = 0;
  while (overflow >> (w * kOverflowWidth)) ++w;
  return w;
}

}  // namespace

extern "C" {

// symbols/indices: int32 [n_pos, n_lanes] (lane layout pre-applied).
// Returns number of uint32 words written, or negative required capacity.
int64_t rans_encode_indexed(const int32_t* symbols, const int32_t* indices,
                            int64_t n_pos, int64_t n_lanes,
                            const uint32_t* cdf, const int32_t* cdf_length,
                            const int32_t* cdf_offset, int64_t max_len,
                            int precision, uint32_t* out, int64_t out_cap) {
  Tables t{cdf, cdf_length, cdf_offset, max_len};
  Encoder enc(n_lanes);

  std::vector<int64_t> all_lanes(n_lanes);
  for (int64_t l = 0; l < n_lanes; ++l) all_lanes[l] = l;
  std::vector<uint64_t> starts(n_lanes), freqs(n_lanes);
  std::vector<int64_t> of_lanes;
  std::vector<uint64_t> of_overflow, of_vals;
  std::vector<int64_t> of_widths_v;

  // LIFO: walk positions backward; within a position push overflow payload
  // (reversed rounds) before the symbols.
  for (int64_t p = n_pos - 1; p >= 0; --p) {
    const int32_t* sym = symbols + p * n_lanes;
    const int32_t* idx = indices + p * n_lanes;

    of_lanes.clear();
    of_overflow.clear();
    of_widths_v.clear();
    for (int64_t l = 0; l < n_lanes; ++l) {
      int32_t r = idx[l];
      int64_t max_value = static_cast<int64_t>(cdf_length[r]) - 2;
      int64_t value = static_cast<int64_t>(sym[l]) - cdf_offset[r];
      int64_t overflow = 0;
      if (value < 0) {
        overflow = -2 * value - 1;
        value = max_value;
      } else if (value >= max_value) {
        overflow = 2 * (value - max_value);
        value = max_value;
      }
      const uint32_t* row = t.cdf + r * t.max_len;
      starts[l] = row[value];
      freqs[l] = row[value + 1] - row[value];
      if (value == max_value) {
        of_lanes.push_back(l);
        of_overflow.push_back(static_cast<uint64_t>(overflow));
        of_widths_v.push_back(nibble_widths(overflow));
      }
    }

    if (!of_lanes.empty()) {
      int64_t n_of = static_cast<int64_t>(of_lanes.size());
      // Width-marker rounds (generation order), then nibble rounds; push all
      // rounds reversed. Rounds are rebuilt here exactly as in coding.py.
      std::vector<std::vector<uint64_t>> rounds;
      std::vector<int64_t> rem(of_widths_v);
      while (true) {
        std::vector<uint64_t> m(n_of);
        bool any15 = false, any_rem = false;
        for (int64_t i = 0; i < n_of; ++i) {
          int64_t mi = rem[i] < kMaxOverflow ? rem[i] : kMaxOverflow;
          m[i] = static_cast<uint64_t>(mi);
          rem[i] -= mi;
          if (mi >= kMaxOverflow) any15 = true;
          if (rem[i] > 0) any_rem = true;
        }
        rounds.push_back(m);
        if (!any_rem && !any15) break;
      }
      std::vector<uint64_t> val = rounds.back();
      int64_t max_w = 0;
      for (int64_t i = 0; i < n_of; ++i)
        if (of_widths_v[i] > max_w) max_w = of_widths_v[i];
      for (int64_t j = 0; j < max_w; ++j) {
        for (int64_t i = 0; i < n_of; ++i) {
          if (of_widths_v[i] > j)
            val[i] = (of_overflow[i] >> (j * kOverflowWidth)) & kMaxOverflow;
        }
        rounds.push_back(val);
      }
      std::vector<uint64_t> ones(n_of, 1);
      for (int64_t rix = static_cast<int64_t>(rounds.size()) - 1; rix >= 0;
           --rix) {
        enc.push(of_lanes.data(), n_of, rounds[rix].data(), ones.data(),
                 kOverflowWidth);
      }
    }

    enc.push(all_lanes.data(), n_lanes, starts.data(), freqs.data(),
             precision);
  }
  return enc.flatten(out, out_cap);
}

// inverse: int32 [n_rows, 1 << precision] cumulative-frequency -> symbol.
void rans_decode_indexed(const uint32_t* stream, int64_t stream_len,
                         const int32_t* indices, int64_t n_pos,
                         int64_t n_lanes, const uint32_t* cdf,
                         const int32_t* cdf_length, const int32_t* cdf_offset,
                         int64_t max_len, const int32_t* inverse,
                         int precision, int32_t* out_symbols) {
  Decoder dec(stream, stream_len, n_lanes);
  int64_t inv_stride = 1ll << precision;

  std::vector<int64_t> all_lanes(n_lanes);
  for (int64_t l = 0; l < n_lanes; ++l) all_lanes[l] = l;
  std::vector<uint64_t> cf(n_lanes), starts(n_lanes), freqs(n_lanes);
  std::vector<int64_t> values(n_lanes);
  std::vector<int64_t> of_lanes;

  for (int64_t p = 0; p < n_pos; ++p) {
    const int32_t* idx = indices + p * n_lanes;
    int32_t* out = out_symbols + p * n_lanes;

    dec.peek(all_lanes.data(), n_lanes, precision, cf.data());
    for (int64_t l = 0; l < n_lanes; ++l) {
      int32_t r = idx[l];
      int64_t v = inverse[r * inv_stride + static_cast<int64_t>(cf[l])];
      values[l] = v;
      const uint32_t* row = cdf + r * max_len;
      starts[l] = row[v];
      freqs[l] = row[v + 1] - row[v];
    }
    dec.complete(all_lanes.data(), n_lanes, cf.data(), starts.data(),
                 freqs.data(), precision);

    of_lanes.clear();
    for (int64_t l = 0; l < n_lanes; ++l) {
      if (values[l] == static_cast<int64_t>(cdf_length[idx[l]]) - 2)
        of_lanes.push_back(l);
    }
    if (!of_lanes.empty()) {
      int64_t n_of = static_cast<int64_t>(of_lanes.size());
      std::vector<uint64_t> val(n_of), ones(n_of, 1);
      std::vector<int64_t> widths(n_of);

      auto pop_of = [&](std::vector<uint64_t>& v) {
        dec.peek(of_lanes.data(), n_of, kOverflowWidth, v.data());
        dec.complete(of_lanes.data(), n_of, v.data(), v.data(), ones.data(),
                     kOverflowWidth);
      };

      pop_of(val);
      for (int64_t i = 0; i < n_of; ++i) widths[i] = val[i];
      bool any15 = false;
      for (int64_t i = 0; i < n_of; ++i) any15 |= (val[i] == kMaxOverflow);
      while (any15) {
        pop_of(val);
        any15 = false;
        for (int64_t i = 0; i < n_of; ++i) {
          widths[i] += val[i];
          any15 |= (val[i] == kMaxOverflow);
        }
      }
      std::vector<uint64_t> overflow(n_of, 0);
      int64_t max_w = 0;
      for (int64_t i = 0; i < n_of; ++i)
        if (widths[i] > max_w) max_w = widths[i];
      for (int64_t j = 0; j < max_w; ++j) {
        pop_of(val);
        for (int64_t i = 0; i < n_of; ++i) {
          if (widths[i] > j) overflow[i] |= val[i] << (j * kOverflowWidth);
        }
      }
      for (int64_t i = 0; i < n_of; ++i) {
        int64_t l = of_lanes[i];
        int64_t ov = static_cast<int64_t>(overflow[i]);
        int64_t v = ov >> 1;
        if (ov & 1) {
          v = -v - 1;
        } else {
          v += static_cast<int64_t>(cdf_length[idx[l]]) - 2;
        }
        values[l] = v;
      }
    }
    for (int64_t l = 0; l < n_lanes; ++l) {
      out[l] = static_cast<int32_t>(values[l] + cdf_offset[idx[l]]);
    }
  }
}

}  // extern "C"
