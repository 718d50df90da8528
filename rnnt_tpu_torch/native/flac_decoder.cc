// FLAC decoder — native data-loader component of rnnt_tpu_torch (a copy of
// rnnt_tpu/native/flac_decoder.cc).
//
// Role parity: the reference's only audio-codec dependency was soundfile's
// FLAC path for LibriSpeech (utils/data/librispeech.py:6-16).  This is a
// from-scratch implementation of the FLAC bitstream (constant/verbatim/
// fixed/LPC subframes, Rice-coded residual partitions, all stereo
// decorrelation modes), exposed as a C ABI consumed via ctypes
// (rnnt_tpu_torch/native/flac.py).  Decoding is integer-exact per the spec.
//
// Build: see rnnt_tpu_torch/native/build.py (g++, at first use)

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

class BitReader {
 public:
  BitReader(const uint8_t* data, size_t size) : data_(data), size_(size) {}

  bool ReadBit(uint32_t* out) {
    if (byte_ >= size_) return false;
    *out = (data_[byte_] >> (7 - bit_)) & 1u;
    if (++bit_ == 8) { bit_ = 0; ++byte_; }
    return true;
  }

  bool ReadBits(int n, uint64_t* out) {  // n <= 57
    uint64_t v = 0;
    for (int i = 0; i < n; ++i) {
      uint32_t b;
      if (!ReadBit(&b)) return false;
      v = (v << 1) | b;
    }
    *out = v;
    return true;
  }

  bool ReadSigned(int n, int64_t* out) {
    uint64_t v;
    if (!ReadBits(n, &v)) return false;
    // two's complement sign extension
    if (n > 0 && (v >> (n - 1)) & 1u) v |= ~((1ull << n) - 1);
    *out = static_cast<int64_t>(v);
    return true;
  }

  bool ReadUnary(uint64_t* out) {
    uint64_t q = 0;
    uint32_t b;
    for (;;) {
      if (!ReadBit(&b)) return false;
      if (b) break;
      ++q;
    }
    *out = q;
    return true;
  }

  void AlignToByte() {
    if (bit_) { bit_ = 0; ++byte_; }
  }

  size_t byte_pos() const { return byte_; }
  void SeekByte(size_t pos) { byte_ = pos; bit_ = 0; }
  bool AtEnd() const { return byte_ >= size_; }

 private:
  const uint8_t* data_;
  size_t size_;
  size_t byte_ = 0;
  int bit_ = 0;
};

// UTF-8-style coded number (frame header sample/frame index).
bool ReadUtf8(BitReader* br, uint64_t* out) {
  uint64_t b0;
  if (!br->ReadBits(8, &b0)) return false;
  int extra = 0;
  uint64_t v = 0;
  if ((b0 & 0x80) == 0) { *out = b0; return true; }
  else if ((b0 & 0xE0) == 0xC0) { v = b0 & 0x1F; extra = 1; }
  else if ((b0 & 0xF0) == 0xE0) { v = b0 & 0x0F; extra = 2; }
  else if ((b0 & 0xF8) == 0xF0) { v = b0 & 0x07; extra = 3; }
  else if ((b0 & 0xFC) == 0xF8) { v = b0 & 0x03; extra = 4; }
  else if ((b0 & 0xFE) == 0xFC) { v = b0 & 0x01; extra = 5; }
  else if (b0 == 0xFE) { v = 0; extra = 6; }
  else return false;
  for (int i = 0; i < extra; ++i) {
    uint64_t b;
    if (!br->ReadBits(8, &b)) return false;
    if ((b & 0xC0) != 0x80) return false;
    v = (v << 6) | (b & 0x3F);
  }
  *out = v;
  return true;
}

// Rice/escape residual for one subframe.
bool ReadResidual(BitReader* br, int blocksize, int pred_order,
                  std::vector<int64_t>* resid) {
  uint64_t method;
  if (!br->ReadBits(2, &method)) return false;
  if (method > 1) return false;  // 0: 4-bit rice, 1: 5-bit rice
  const int plen = method == 0 ? 4 : 5;
  const uint64_t escape = method == 0 ? 0xF : 0x1F;
  uint64_t part_order;
  if (!br->ReadBits(4, &part_order)) return false;
  const int parts = 1 << part_order;
  if (blocksize % parts != 0) return false;
  resid->resize(blocksize - pred_order);
  int idx = 0;
  for (int p = 0; p < parts; ++p) {
    int count = blocksize >> part_order;
    if (p == 0) count -= pred_order;
    if (count < 0) return false;
    uint64_t rparam;
    if (!br->ReadBits(plen, &rparam)) return false;
    if (rparam == escape) {
      uint64_t rawbits;
      if (!br->ReadBits(5, &rawbits)) return false;
      for (int i = 0; i < count; ++i) {
        int64_t v = 0;
        if (rawbits > 0) {
          if (!br->ReadSigned(static_cast<int>(rawbits), &v)) return false;
        }
        (*resid)[idx++] = v;
      }
    } else {
      for (int i = 0; i < count; ++i) {
        uint64_t q, r = 0;
        if (!br->ReadUnary(&q)) return false;
        if (rparam > 0 && !br->ReadBits(static_cast<int>(rparam), &r))
          return false;
        uint64_t u = (q << rparam) | r;
        // zigzag decode
        (*resid)[idx++] = (u >> 1) ^ -static_cast<int64_t>(u & 1);
      }
    }
  }
  return true;
}

bool ReadSubframe(BitReader* br, int blocksize, int bps,
                  std::vector<int64_t>* out) {
  uint64_t pad, type_code, wasted_flag;
  if (!br->ReadBits(1, &pad) || pad != 0) return false;
  if (!br->ReadBits(6, &type_code)) return false;
  if (!br->ReadBits(1, &wasted_flag)) return false;
  int wasted = 0;
  if (wasted_flag) {
    uint64_t q;
    if (!br->ReadUnary(&q)) return false;
    wasted = static_cast<int>(q) + 1;
  }
  const int ebps = bps - wasted;
  out->assign(blocksize, 0);

  if (type_code == 0) {  // CONSTANT
    int64_t v;
    if (!br->ReadSigned(ebps, &v)) return false;
    for (int i = 0; i < blocksize; ++i) (*out)[i] = v;
  } else if (type_code == 1) {  // VERBATIM
    for (int i = 0; i < blocksize; ++i)
      if (!br->ReadSigned(ebps, &(*out)[i])) return false;
  } else if (type_code >= 8 && type_code <= 12) {  // FIXED order 0-4
    const int order = static_cast<int>(type_code) - 8;
    for (int i = 0; i < order; ++i)
      if (!br->ReadSigned(ebps, &(*out)[i])) return false;
    std::vector<int64_t> resid;
    if (!ReadResidual(br, blocksize, order, &resid)) return false;
    for (int i = order; i < blocksize; ++i) {
      const int64_t* s = out->data() + i;
      int64_t pred = 0;
      switch (order) {
        case 0: pred = 0; break;
        case 1: pred = s[-1]; break;
        case 2: pred = 2 * s[-1] - s[-2]; break;
        case 3: pred = 3 * s[-1] - 3 * s[-2] + s[-3]; break;
        case 4: pred = 4 * s[-1] - 6 * s[-2] + 4 * s[-3] - s[-4]; break;
      }
      (*out)[i] = pred + resid[i - order];
    }
  } else if (type_code >= 32) {  // LPC, order 1-32
    const int order = static_cast<int>(type_code) - 31;
    for (int i = 0; i < order; ++i)
      if (!br->ReadSigned(ebps, &(*out)[i])) return false;
    uint64_t prec_code;
    if (!br->ReadBits(4, &prec_code)) return false;
    if (prec_code == 0xF) return false;
    const int precision = static_cast<int>(prec_code) + 1;
    int64_t shift;
    if (!br->ReadSigned(5, &shift)) return false;
    if (shift < 0) return false;
    std::vector<int64_t> coef(order);
    for (int i = 0; i < order; ++i)
      if (!br->ReadSigned(precision, &coef[i])) return false;
    std::vector<int64_t> resid;
    if (!ReadResidual(br, blocksize, order, &resid)) return false;
    for (int i = order; i < blocksize; ++i) {
      int64_t acc = 0;
      for (int j = 0; j < order; ++j) acc += coef[j] * (*out)[i - 1 - j];
      (*out)[i] = (acc >> shift) + resid[i - order];
    }
  } else {
    return false;  // reserved
  }
  if (wasted > 0)
    for (int i = 0; i < blocksize; ++i) (*out)[i] <<= wasted;
  return true;
}

struct StreamInfo {
  int sample_rate = 0;
  int channels = 0;
  int bps = 0;
  uint64_t total_samples = 0;
};

const int kBlockSizes[16] = {0, 192, 576, 1152, 2304, 4608, -1, -2,
                             256, 512, 1024, 2048, 4096, 8192, 16384, 32768};
const int kSampleRates[12] = {0, 88200, 176400, 192000, 8000, 16000, 22050,
                              24000, 32000, 44100, 48000, 96000};

}  // namespace

extern "C" {

// Decodes a FLAC file into interleaved int32 samples.
// Returns 0 on success; caller frees *samples with flac_free().
int flac_decode_file(const char* path, int32_t** samples, int64_t* n_samples,
                     int* sample_rate, int* channels, int* bits) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  fseek(f, 0, SEEK_END);
  long fsize = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf(fsize);
  if (fread(buf.data(), 1, fsize, f) != static_cast<size_t>(fsize)) {
    fclose(f);
    return 2;
  }
  fclose(f);

  if (fsize < 8 || memcmp(buf.data(), "fLaC", 4) != 0) return 3;
  BitReader br(buf.data(), buf.size());
  br.SeekByte(4);

  StreamInfo si;
  bool last = false;
  while (!last) {
    uint64_t flag_type, len;
    if (!br.ReadBits(1, &flag_type)) return 4;
    last = flag_type;
    if (!br.ReadBits(7, &flag_type)) return 4;
    if (!br.ReadBits(24, &len)) return 4;
    if (flag_type == 0) {  // STREAMINFO
      uint64_t v;
      br.ReadBits(16, &v);  // min blocksize
      br.ReadBits(16, &v);  // max blocksize
      br.ReadBits(24, &v);  // min frame size
      br.ReadBits(24, &v);  // max frame size
      br.ReadBits(20, &v); si.sample_rate = static_cast<int>(v);
      br.ReadBits(3, &v); si.channels = static_cast<int>(v) + 1;
      br.ReadBits(5, &v); si.bps = static_cast<int>(v) + 1;
      br.ReadBits(36, &v); si.total_samples = v;
      br.SeekByte(br.byte_pos() + 16);  // MD5
    } else {
      br.SeekByte(br.byte_pos() + len);
    }
  }
  if (si.sample_rate == 0 || si.channels == 0) return 5;

  std::vector<int32_t> pcm;
  if (si.total_samples > 0)
    pcm.reserve(si.total_samples * si.channels);

  std::vector<std::vector<int64_t>> ch(si.channels);

  while (!br.AtEnd()) {
    // frame sync
    uint64_t sync;
    br.AlignToByte();
    if (!br.ReadBits(14, &sync)) break;
    if (sync != 0x3FFE) break;  // end or junk
    uint64_t rsv, bs_strategy;
    if (!br.ReadBits(1, &rsv) || !br.ReadBits(1, &bs_strategy)) return 6;
    uint64_t bs_code, sr_code, ch_code, ss_code;
    if (!br.ReadBits(4, &bs_code) || !br.ReadBits(4, &sr_code) ||
        !br.ReadBits(4, &ch_code) || !br.ReadBits(3, &ss_code) ||
        !br.ReadBits(1, &rsv))
      return 6;
    uint64_t coded_num;
    if (!ReadUtf8(&br, &coded_num)) return 7;

    int blocksize;
    if (bs_code == 6) {
      uint64_t v; if (!br.ReadBits(8, &v)) return 8;
      blocksize = static_cast<int>(v) + 1;
    } else if (bs_code == 7) {
      uint64_t v; if (!br.ReadBits(16, &v)) return 8;
      blocksize = static_cast<int>(v) + 1;
    } else if (bs_code == 0) {
      return 8;
    } else {
      blocksize = kBlockSizes[bs_code];
    }

    if (sr_code == 12) { uint64_t v; br.ReadBits(8, &v); }
    else if (sr_code == 13 || sr_code == 14) { uint64_t v; br.ReadBits(16, &v); }
    else if (sr_code == 15) return 9;

    int bps = si.bps;
    switch (ss_code) {
      case 0: break;
      case 1: bps = 8; break;
      case 2: bps = 12; break;
      case 4: bps = 16; break;
      case 5: bps = 20; break;
      case 6: bps = 24; break;
      case 7: bps = 32; break;
      default: return 10;
    }

    uint64_t crc8;
    if (!br.ReadBits(8, &crc8)) return 11;

    int nch = si.channels;
    int assignment = static_cast<int>(ch_code);
    if (assignment < 8) {
      nch = assignment + 1;
      for (int c = 0; c < nch; ++c)
        if (!ReadSubframe(&br, blocksize, bps, &ch[c])) return 12;
    } else if (assignment == 8) {  // left-side
      if (!ReadSubframe(&br, blocksize, bps, &ch[0])) return 12;
      if (!ReadSubframe(&br, blocksize, bps + 1, &ch[1])) return 12;
      for (int i = 0; i < blocksize; ++i) ch[1][i] = ch[0][i] - ch[1][i];
      nch = 2;
    } else if (assignment == 9) {  // right-side
      if (!ReadSubframe(&br, blocksize, bps + 1, &ch[0])) return 12;
      if (!ReadSubframe(&br, blocksize, bps, &ch[1])) return 12;
      for (int i = 0; i < blocksize; ++i) ch[0][i] = ch[0][i] + ch[1][i];
      nch = 2;
    } else if (assignment == 10) {  // mid-side
      if (!ReadSubframe(&br, blocksize, bps, &ch[0])) return 12;
      if (!ReadSubframe(&br, blocksize, bps + 1, &ch[1])) return 12;
      for (int i = 0; i < blocksize; ++i) {
        int64_t mid = ch[0][i], side = ch[1][i];
        mid = (mid << 1) | (side & 1);
        ch[0][i] = (mid + side) >> 1;
        ch[1][i] = (mid - side) >> 1;
      }
      nch = 2;
    } else {
      return 12;
    }

    br.AlignToByte();
    uint64_t crc16;
    if (!br.ReadBits(16, &crc16)) return 13;

    for (int i = 0; i < blocksize; ++i)
      for (int c = 0; c < nch; ++c)
        pcm.push_back(static_cast<int32_t>(ch[c][i]));
  }

  *n_samples = static_cast<int64_t>(pcm.size()) / si.channels;
  *sample_rate = si.sample_rate;
  *channels = si.channels;
  *bits = si.bps;
  int32_t* out = static_cast<int32_t*>(malloc(pcm.size() * sizeof(int32_t)));
  memcpy(out, pcm.data(), pcm.size() * sizeof(int32_t));
  *samples = out;
  return 0;
}

void flac_free(int32_t* samples) { free(samples); }

}  // extern "C"
