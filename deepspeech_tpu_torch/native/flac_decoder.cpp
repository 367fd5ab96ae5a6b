// Minimal FLAC decoder (C++17, no dependencies).
//
// The reference pipeline shells out to sox to convert LibriSpeech FLAC to
// wav (reference data/librispeech.py:45); this decoder takes its place, so
// the dataset tooling needs no sox or audio codec library. A copy of the
// JAX package's native/flac_decoder.cpp.
// Supports the full mandatory decoder feature set: constant / verbatim /
// fixed / LPC subframes, rice + rice2 residual partitions (incl. escape
// codes), wasted bits, all stereo decorrelation modes, 8..32-bit depths.
// CRCs are not verified (local trusted files).
//
// C ABI (ctypes): flac_probe() for metadata, flac_decode() for samples.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

struct BitReader {
  const uint8_t* data;
  size_t size;
  size_t byte_pos = 0;
  int bit_pos = 0;  // bits consumed of current byte (0..7)
  bool error = false;

  bool at_end() const { return byte_pos >= size; }

  void align() {
    if (bit_pos) {
      bit_pos = 0;
      ++byte_pos;
    }
  }

  uint64_t read_bits(int n) {  // n <= 57
    uint64_t v = 0;
    while (n > 0) {
      if (byte_pos >= size) {
        error = true;
        return 0;
      }
      int avail = 8 - bit_pos;
      int take = n < avail ? n : avail;
      int shift = avail - take;
      uint8_t mask = static_cast<uint8_t>((1u << take) - 1u);
      v = (v << take) | ((data[byte_pos] >> shift) & mask);
      bit_pos += take;
      if (bit_pos == 8) {
        bit_pos = 0;
        ++byte_pos;
      }
      n -= take;
    }
    return v;
  }

  int64_t read_signed(int n) {
    uint64_t v = read_bits(n);
    if (n == 0) return 0;
    uint64_t sign = 1ull << (n - 1);
    return (v & sign) ? static_cast<int64_t>(v) - (1ll << n)
                      : static_cast<int64_t>(v);
  }

  uint32_t read_unary() {
    uint32_t q = 0;
    while (!error) {
      if (read_bits(1)) return q;
      ++q;
      if (q > 1u << 24) {  // corrupt stream guard
        error = true;
        return 0;
      }
    }
    return 0;
  }
};

struct StreamInfo {
  uint32_t sample_rate = 0;
  uint32_t channels = 0;
  uint32_t bits = 0;
  uint64_t total_samples = 0;
  size_t frames_offset = 0;  // byte offset where audio frames start
};

bool read_file(const char* path, std::vector<uint8_t>* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (n <= 0) {
    std::fclose(f);
    return false;
  }
  out->resize(static_cast<size_t>(n));
  size_t got = std::fread(out->data(), 1, out->size(), f);
  std::fclose(f);
  return got == out->size();
}

bool parse_stream_info(const std::vector<uint8_t>& buf, StreamInfo* info) {
  if (buf.size() < 42 || std::memcmp(buf.data(), "fLaC", 4) != 0) return false;
  size_t pos = 4;
  bool last = false;
  bool have_info = false;
  while (!last && pos + 4 <= buf.size()) {
    uint8_t header = buf[pos];
    last = header & 0x80;
    uint8_t type = header & 0x7F;
    uint32_t length = (buf[pos + 1] << 16) | (buf[pos + 2] << 8) | buf[pos + 3];
    pos += 4;
    if (type == 0 && length >= 34 && pos + 34 <= buf.size()) {
      BitReader br{buf.data() + pos, 34};
      br.read_bits(16);  // min block size
      br.read_bits(16);  // max block size
      br.read_bits(24);  // min frame size
      br.read_bits(24);  // max frame size
      info->sample_rate = static_cast<uint32_t>(br.read_bits(20));
      info->channels = static_cast<uint32_t>(br.read_bits(3)) + 1;
      info->bits = static_cast<uint32_t>(br.read_bits(5)) + 1;
      info->total_samples = br.read_bits(36);
      have_info = true;
    }
    pos += length;
  }
  info->frames_offset = pos;
  return have_info && pos < buf.size();
}

// Decode one subframe into ch[0..block_size); bps includes the side-channel
// +1 adjustment. Returns false on parse error.
bool decode_subframe(BitReader* br, int32_t* ch, uint32_t block_size,
                     int bps) {
  if (br->read_bits(1) != 0) return false;  // mandatory zero pad bit
  uint32_t type = static_cast<uint32_t>(br->read_bits(6));
  int wasted = 0;
  if (br->read_bits(1)) wasted = static_cast<int>(br->read_unary()) + 1;
  int eff_bps = bps - wasted;
  if (eff_bps <= 0 || eff_bps > 33) return false;

  int order = 0;
  bool is_lpc = false;
  if (type == 0) {  // constant
    int64_t v = br->read_signed(eff_bps);
    for (uint32_t i = 0; i < block_size; ++i)
      ch[i] = static_cast<int32_t>(v);
    order = -1;
  } else if (type == 1) {  // verbatim
    for (uint32_t i = 0; i < block_size; ++i)
      ch[i] = static_cast<int32_t>(br->read_signed(eff_bps));
    order = -1;
  } else if ((type & 0x38) == 0x08 && (type & 0x07) <= 4) {  // fixed
    order = type & 0x07;
  } else if (type & 0x20) {  // LPC
    order = static_cast<int>(type & 0x1F) + 1;
    is_lpc = true;
  } else {
    return false;
  }

  std::vector<int32_t> coefs;
  int shift = 0;
  if (order >= 0) {
    for (int i = 0; i < order; ++i)
      ch[i] = static_cast<int32_t>(br->read_signed(eff_bps));
    if (is_lpc) {
      int precision = static_cast<int>(br->read_bits(4)) + 1;
      if (precision >= 16 && precision != 16) { /* 0b1111 invalid */ }
      if (precision == 16) return false;  // 0b1111 is invalid per spec
      shift = static_cast<int>(br->read_signed(5));
      if (shift < 0) return false;
      coefs.resize(order);
      for (int i = 0; i < order; ++i)
        coefs[i] = static_cast<int32_t>(br->read_signed(precision));
    }
    // residual
    uint32_t method = static_cast<uint32_t>(br->read_bits(2));
    if (method > 1) return false;
    int param_bits = method == 0 ? 4 : 5;
    uint32_t escape = method == 0 ? 0xF : 0x1F;
    uint32_t part_order = static_cast<uint32_t>(br->read_bits(4));
    uint32_t partitions = 1u << part_order;
    if (block_size % partitions) return false;
    uint32_t idx = order;
    for (uint32_t p = 0; p < partitions; ++p) {
      uint32_t count = block_size >> part_order;
      if (p == 0) count -= order;
      uint32_t param = static_cast<uint32_t>(br->read_bits(param_bits));
      if (param == escape) {
        int raw_bits = static_cast<int>(br->read_bits(5));
        for (uint32_t i = 0; i < count; ++i)
          ch[idx++] = static_cast<int32_t>(
              raw_bits ? br->read_signed(raw_bits) : 0);
      } else {
        for (uint32_t i = 0; i < count; ++i) {
          uint32_t q = br->read_unary();
          uint64_t r = param ? br->read_bits(param) : 0;
          uint64_t u = (static_cast<uint64_t>(q) << param) | r;
          ch[idx++] = static_cast<int32_t>(
              (u & 1) ? -static_cast<int64_t>(u >> 1) - 1
                      : static_cast<int64_t>(u >> 1));
        }
      }
      if (br->error) return false;
    }
    // prediction
    if (is_lpc) {
      for (uint32_t i = order; i < block_size; ++i) {
        int64_t acc = 0;
        for (int j = 0; j < order; ++j)
          acc += static_cast<int64_t>(coefs[j]) * ch[i - 1 - j];
        ch[i] = static_cast<int32_t>(ch[i] + (acc >> shift));
      }
    } else {
      switch (order) {
        case 0:
          break;
        case 1:
          for (uint32_t i = 1; i < block_size; ++i) ch[i] += ch[i - 1];
          break;
        case 2:
          for (uint32_t i = 2; i < block_size; ++i)
            ch[i] += 2 * ch[i - 1] - ch[i - 2];
          break;
        case 3:
          for (uint32_t i = 3; i < block_size; ++i)
            ch[i] += 3 * ch[i - 1] - 3 * ch[i - 2] + ch[i - 3];
          break;
        case 4:
          for (uint32_t i = 4; i < block_size; ++i)
            ch[i] += 4 * ch[i - 1] - 6 * ch[i - 2] + 4 * ch[i - 3] - ch[i - 4];
          break;
        default:
          return false;
      }
    }
  }
  if (wasted) {
    for (uint32_t i = 0; i < block_size; ++i)
      ch[i] = static_cast<int32_t>(static_cast<uint32_t>(ch[i]) << wasted);
  }
  return !br->error;
}

// Decodes all frames; appends interleaved samples. Returns samples written
// per channel, or -1 on error.
int64_t decode_frames(const std::vector<uint8_t>& buf, const StreamInfo& info,
                      int32_t* out, int64_t capacity_per_chan) {
  BitReader br{buf.data(), buf.size()};
  br.byte_pos = info.frames_offset;
  int64_t written = 0;
  std::vector<std::vector<int32_t>> chans(info.channels);

  while (br.byte_pos < br.size && !br.error) {
    // frame sync
    uint32_t sync = static_cast<uint32_t>(br.read_bits(14));
    if (br.error) break;  // clean EOF
    if (sync != 0x3FFE) return written ? written : -1;
    br.read_bits(1);  // reserved
    br.read_bits(1);  // blocking strategy
    uint32_t bs_code = static_cast<uint32_t>(br.read_bits(4));
    uint32_t sr_code = static_cast<uint32_t>(br.read_bits(4));
    uint32_t ch_code = static_cast<uint32_t>(br.read_bits(4));
    uint32_t ss_code = static_cast<uint32_t>(br.read_bits(3));
    br.read_bits(1);  // reserved
    // UTF-8 coded frame/sample number: skip by leading-ones count
    uint32_t first = static_cast<uint32_t>(br.read_bits(8));
    int extra = 0;
    for (uint32_t m = 0x80; first & m; m >>= 1) ++extra;
    if (extra) --extra;  // N leading ones -> N-1 continuation bytes
    for (int i = 0; i < extra; ++i) br.read_bits(8);

    uint32_t block_size;
    switch (bs_code) {
      case 1: block_size = 192; break;
      case 2: case 3: case 4: case 5:
        block_size = 576u << (bs_code - 2); break;
      case 6: block_size = static_cast<uint32_t>(br.read_bits(8)) + 1; break;
      case 7: block_size = static_cast<uint32_t>(br.read_bits(16)) + 1; break;
      default:
        if (bs_code >= 8) block_size = 256u << (bs_code - 8);
        else return -1;  // 0 reserved
    }
    if (sr_code == 12) br.read_bits(8);
    else if (sr_code == 13 || sr_code == 14) br.read_bits(16);

    int bps;
    switch (ss_code) {
      case 0: bps = static_cast<int>(info.bits); break;
      case 1: bps = 8; break;
      case 2: bps = 12; break;
      case 4: bps = 16; break;
      case 5: bps = 20; break;
      case 6: bps = 24; break;
      case 7: bps = 32; break;
      default: return -1;
    }
    br.read_bits(8);  // CRC-8

    uint32_t n_chan = ch_code < 8 ? ch_code + 1 : 2;
    if (n_chan != info.channels) return -1;
    for (auto& c : chans) {
      if (c.size() < block_size) c.resize(block_size);
    }
    for (uint32_t c = 0; c < n_chan; ++c) {
      int sub_bps = bps;
      if ((ch_code == 8 && c == 1) || (ch_code == 9 && c == 0) ||
          (ch_code == 10 && c == 1))
        sub_bps += 1;  // side channel carries one extra bit
      if (!decode_subframe(&br, chans[c].data(), block_size, sub_bps))
        return written ? written : -1;
    }
    br.align();
    br.read_bits(16);  // frame CRC-16

    // stereo decorrelation
    if (ch_code == 8) {  // left/side
      for (uint32_t i = 0; i < block_size; ++i)
        chans[1][i] = chans[0][i] - chans[1][i];
    } else if (ch_code == 9) {  // right/side
      for (uint32_t i = 0; i < block_size; ++i)
        chans[0][i] = chans[1][i] + chans[0][i];
    } else if (ch_code == 10) {  // mid/side
      for (uint32_t i = 0; i < block_size; ++i) {
        int64_t side = chans[1][i];
        int64_t mid = (static_cast<int64_t>(chans[0][i]) << 1) | (side & 1);
        chans[0][i] = static_cast<int32_t>((mid + side) >> 1);
        chans[1][i] = static_cast<int32_t>((mid - side) >> 1);
      }
    }

    if (written + block_size > static_cast<uint64_t>(capacity_per_chan))
      return -1;
    for (uint32_t i = 0; i < block_size; ++i)
      for (uint32_t c = 0; c < n_chan; ++c)
        out[(written + i) * n_chan + c] = chans[c][i];
    written += block_size;
    if (info.total_samples && written >= static_cast<int64_t>(info.total_samples))
      break;
  }
  return written;
}

}  // namespace

extern "C" {

// Fills sample_rate/channels/bits/total_samples from STREAMINFO.
// Returns 0 on success, -1 on error.
int32_t flac_probe(const char* path, int32_t* sample_rate, int32_t* channels,
                   int32_t* bits, int64_t* total_samples) {
  std::vector<uint8_t> buf;
  StreamInfo info;
  if (!read_file(path, &buf) || !parse_stream_info(buf, &info)) return -1;
  *sample_rate = static_cast<int32_t>(info.sample_rate);
  *channels = static_cast<int32_t>(info.channels);
  *bits = static_cast<int32_t>(info.bits);
  *total_samples = static_cast<int64_t>(info.total_samples);
  return 0;
}

// Decodes into caller-allocated interleaved int32 buffer with room for
// capacity_per_chan * channels samples. Returns samples-per-channel decoded,
// or -1 on error.
int64_t flac_decode(const char* path, int32_t* out,
                    int64_t capacity_per_chan) {
  std::vector<uint8_t> buf;
  StreamInfo info;
  if (!read_file(path, &buf) || !parse_stream_info(buf, &info)) return -1;
  return decode_frames(buf, info, out, capacity_per_chan);
}

}  // extern "C"
