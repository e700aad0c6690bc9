// ssrio — native audio IO for ssr_eval_tpu.
//
// Fast host-edge codecs feeding the TPU pipeline (SURVEY §2.3: IO stays
// C++-backed at the edge).  Replaces the pure-Python fallback in
// ssr_eval_tpu/io/flac_py.py with the same stream semantics:
//   - FLAC subset decoder: CONSTANT / VERBATIM / FIXED(0..4) / LPC
//     subframes, Rice/Rice2 partitioned residuals, wasted bits, all four
//     stereo channel assignments.
//   - FLAC encoder: per-frame fixed-predictor search (orders 0..4) with
//     single-partition Rice coding — real compression, valid CRCs.
//   - WAV (RIFF) PCM16/24/32 + float32 reader, PCM16/float writer.
//
// C ABI (ctypes-friendly); no globals, thread-safe.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <atomic>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------
// Bit reader
// ---------------------------------------------------------------------
struct BitReader {
  const uint8_t* buf;
  size_t size;
  size_t pos = 0;     // byte position
  uint64_t acc = 0;
  int nbits = 0;
  bool fail = false;

  BitReader(const uint8_t* b, size_t s, size_t start = 0) : buf(b), size(s), pos(start) {}

  inline void fill(int need) {
    while (nbits < need) {
      if (pos >= size) { fail = true; acc <<= 8; nbits += 8; continue; }
      acc = (acc << 8) | buf[pos++];
      nbits += 8;
    }
  }
  inline uint32_t read(int n) {
    if (n == 0) return 0;
    fill(n);
    nbits -= n;
    uint32_t v = (uint32_t)((acc >> nbits) & ((n == 32) ? 0xFFFFFFFFull : ((1ull << n) - 1)));
    acc &= (1ull << nbits) - 1;
    return v;
  }
  inline int64_t read_signed(int n) {
    int64_t v = read(n);
    if (v >= (1ll << (n - 1))) v -= (1ll << n);
    return v;
  }
  inline uint32_t read_unary() {
    uint32_t q = 0;
    while (!fail && read(1) == 0) q++;
    return q;
  }
  inline void align() {
    int drop = nbits % 8;
    if (drop) read(drop);
  }
  inline size_t byte_position() const { return pos - nbits / 8; }
  uint64_t read_utf8() {
    uint32_t b0 = read(8);
    if (b0 < 0x80) return b0;
    int n = 0;
    for (uint32_t m = 0x80; b0 & m; m >>= 1) n++;
    uint64_t v = b0 & ((1u << (7 - n)) - 1);
    for (int i = 0; i < n - 1; i++) v = (v << 6) | (read(8) & 0x3F);
    return v;
  }
};

// ---------------------------------------------------------------------
// Bit writer
// ---------------------------------------------------------------------
struct BitWriter {
  std::vector<uint8_t> out;
  uint64_t acc = 0;
  int nbits = 0;

  inline void write(uint64_t val, int n) {
    while (n > 32) {  // split very wide writes
      write(val >> 32, n - 32);
      n = 32;
      val &= 0xFFFFFFFFull;
    }
    acc = (acc << n) | (val & ((n == 64) ? ~0ull : ((1ull << n) - 1)));
    nbits += n;
    while (nbits >= 8) {
      nbits -= 8;
      out.push_back((uint8_t)((acc >> nbits) & 0xFF));
    }
    acc &= (1ull << nbits) - 1;
  }
  inline void align() { if (nbits) write(0, 8 - nbits); }
};

// ---------------------------------------------------------------------
// CRCs (FLAC: CRC-8 poly 0x07, CRC-16 poly 0x8005)
// ---------------------------------------------------------------------
uint8_t crc8(const uint8_t* d, size_t n) {
  uint8_t crc = 0;
  for (size_t i = 0; i < n; i++) {
    crc ^= d[i];
    for (int b = 0; b < 8; b++)
      crc = (crc & 0x80) ? (uint8_t)((crc << 1) ^ 0x07) : (uint8_t)(crc << 1);
  }
  return crc;
}
uint16_t crc16(const uint8_t* d, size_t n) {
  uint16_t crc = 0;
  for (size_t i = 0; i < n; i++) {
    crc ^= (uint16_t)d[i] << 8;
    for (int b = 0; b < 8; b++)
      crc = (crc & 0x8000) ? (uint16_t)((crc << 1) ^ 0x8005) : (uint16_t)(crc << 1);
  }
  return crc;
}

// ---------------------------------------------------------------------
// FLAC decode
// ---------------------------------------------------------------------
static const int SR_TABLE[12] = {0, 88200, 176400, 192000, 8000, 16000,
                                 22050, 24000, 32000, 44100, 48000, 96000};
static const int SS_TABLE[8] = {0, 8, 12, 0, 16, 20, 24, 32};
static const int FIXED_ORDER_COEFFS[5][4] = {
    {}, {1}, {2, -1}, {3, -3, 1}, {4, -6, 4, -1}};

bool decode_residual(BitReader& br, int block_size, int order,
                     std::vector<int64_t>& res) {
  int method = br.read(2);
  if (method > 1) return false;
  int plen = method == 0 ? 4 : 5;
  uint32_t escape = (1u << plen) - 1;
  int porder = br.read(4);
  int n_part = 1 << porder;
  res.resize(block_size - order);
  size_t idx = 0;
  for (int p = 0; p < n_part; p++) {
    int count = (block_size >> porder) - (p == 0 ? order : 0);
    uint32_t param = br.read(plen);
    if (param == escape) {
      int raw = br.read(5);
      for (int i = 0; i < count; i++)
        res[idx++] = raw ? br.read_signed(raw) : 0;
    } else {
      for (int i = 0; i < count; i++) {
        uint64_t q = br.read_unary();
        uint64_t r = param ? br.read(param) : 0;
        uint64_t u = (q << param) | r;
        res[idx++] = (int64_t)(u >> 1) ^ -(int64_t)(u & 1);
      }
    }
    if (br.fail) return false;
  }
  return true;
}

bool decode_subframe(BitReader& br, int block_size, int bps,
                     std::vector<int64_t>& x) {
  if (br.read(1) != 0) return false;
  int stype = br.read(6);
  int wasted = 0;
  if (br.read(1)) wasted = br.read_unary() + 1;
  int ebps = bps - wasted;
  x.resize(block_size);
  if (stype == 0) {  // CONSTANT
    int64_t v = br.read_signed(ebps);
    for (int i = 0; i < block_size; i++) x[i] = v;
  } else if (stype == 1) {  // VERBATIM
    for (int i = 0; i < block_size; i++) x[i] = br.read_signed(ebps);
  } else if (stype >= 8 && stype <= 12) {  // FIXED
    int order = stype & 7;
    for (int i = 0; i < order; i++) x[i] = br.read_signed(ebps);
    std::vector<int64_t> res;
    if (!decode_residual(br, block_size, order, res)) return false;
    for (int i = order; i < block_size; i++) {
      int64_t acc = res[i - order];
      for (int j = 0; j < order; j++)
        acc += FIXED_ORDER_COEFFS[order][j] * x[i - 1 - j];
      x[i] = acc;
    }
  } else if (stype >= 32) {  // LPC
    int order = (stype & 0x1F) + 1;
    for (int i = 0; i < order; i++) x[i] = br.read_signed(ebps);
    int precision = br.read(4) + 1;
    int shift = (int)br.read_signed(5);
    std::vector<int64_t> coefs(order);
    for (int i = 0; i < order; i++) coefs[i] = br.read_signed(precision);
    std::vector<int64_t> res;
    if (!decode_residual(br, block_size, order, res)) return false;
    for (int i = order; i < block_size; i++) {
      int64_t acc = 0;
      for (int j = 0; j < order; j++) acc += coefs[j] * x[i - 1 - j];
      x[i] = res[i - order] + (acc >> shift);
    }
  } else {
    return false;
  }
  if (wasted)
    for (int i = 0; i < block_size; i++) x[i] <<= wasted;
  return !br.fail;
}

int decode_flac_ints(const uint8_t* buf, size_t size, std::vector<int32_t>& pcm,
                     int64_t* n_samples, int* n_channels, int* sample_rate,
                     int* bits) {
  if (size < 8 || memcmp(buf, "fLaC", 4) != 0) return -1;
  size_t pos = 4;
  int sr = 0, channels = 0, bps = 0;
  bool last = false;
  while (!last && pos + 4 <= size) {
    uint8_t hdr = buf[pos];
    last = hdr & 0x80;
    int btype = hdr & 0x7F;
    uint32_t blen = (buf[pos + 1] << 16) | (buf[pos + 2] << 8) | buf[pos + 3];
    if (btype == 0 && blen >= 34) {
      BitReader br(buf + pos + 4, blen);
      br.read(16); br.read(16); br.read(24); br.read(24);
      sr = br.read(20);
      channels = br.read(3) + 1;
      bps = br.read(5) + 1;
    }
    pos += 4 + blen;
  }
  if (sr == 0 || channels == 0) return -2;

  pcm.clear();
  pcm.reserve(1 << 20);
  BitReader br(buf, size, pos);
  std::vector<std::vector<int64_t>> subs(channels);
  int64_t total = 0;
  while (br.byte_position() + 2 < size) {
    uint32_t sync = br.read(14);
    if (sync != 0x3FFE) break;
    br.read(1);
    br.read(1);
    int bs_code = br.read(4);
    int sr_code = br.read(4);
    int ch_code = br.read(4);
    int ss_code = br.read(3);
    br.read(1);
    br.read_utf8();
    int block_size;
    if (bs_code == 1) block_size = 192;
    else if (bs_code >= 2 && bs_code <= 5) block_size = 576 << (bs_code - 2);
    else if (bs_code == 6) block_size = br.read(8) + 1;
    else if (bs_code == 7) block_size = br.read(16) + 1;
    else if (bs_code >= 8) block_size = 256 << (bs_code - 8);
    else return -3;
    if (sr_code == 12) br.read(8);
    else if (sr_code == 13 || sr_code == 14) br.read(16);
    int fbps = SS_TABLE[ss_code] ? SS_TABLE[ss_code] : bps;
    br.read(8);  // header crc
    int n_ch = channels;
    if (ch_code < 8) {
      n_ch = ch_code + 1;
      for (int c = 0; c < n_ch; c++)
        if (!decode_subframe(br, block_size, fbps, subs[c])) return -4;
    } else if (ch_code == 8) {  // left/side
      if (!decode_subframe(br, block_size, fbps, subs[0])) return -4;
      if (!decode_subframe(br, block_size, fbps + 1, subs[1])) return -4;
      for (int i = 0; i < block_size; i++) subs[1][i] = subs[0][i] - subs[1][i];
      n_ch = 2;
    } else if (ch_code == 9) {  // right/side
      if (!decode_subframe(br, block_size, fbps + 1, subs[0])) return -4;
      if (!decode_subframe(br, block_size, fbps, subs[1])) return -4;
      for (int i = 0; i < block_size; i++) subs[0][i] = subs[1][i] + subs[0][i];
      n_ch = 2;
    } else if (ch_code == 10) {  // mid/side
      if (!decode_subframe(br, block_size, fbps, subs[0])) return -4;
      if (!decode_subframe(br, block_size, fbps + 1, subs[1])) return -4;
      for (int i = 0; i < block_size; i++) {
        int64_t mid = (subs[0][i] << 1) | (subs[1][i] & 1);
        int64_t side = subs[1][i];
        subs[0][i] = (mid + side) >> 1;
        subs[1][i] = (mid - side) >> 1;
      }
      n_ch = 2;
    } else {
      return -5;
    }
    br.align();
    br.read(16);  // frame crc
    if (br.fail) return -6;
    size_t base = pcm.size();
    pcm.resize(base + (size_t)block_size * n_ch);
    for (int i = 0; i < block_size; i++)
      for (int c = 0; c < n_ch; c++)
        pcm[base + (size_t)i * n_ch + c] = (int32_t)subs[c][i];
    total += block_size;
  }
  *n_samples = total;
  *n_channels = channels;
  *sample_rate = sr;
  *bits = bps;
  return 0;
}

int decode_flac_buf(const uint8_t* buf, size_t size, float** out, int64_t* n_samples,
                    int* n_channels, int* sample_rate) {
  std::vector<int32_t> pcm;
  int bps = 0;
  int rc = decode_flac_ints(buf, size, pcm, n_samples, n_channels, sample_rate, &bps);
  if (rc != 0) return rc;
  float* mem = (float*)malloc(pcm.size() * sizeof(float));
  if (!mem) return -7;
  float scale = 1.0f / (float)(1ll << (bps - 1));
  for (size_t i = 0; i < pcm.size(); i++) mem[i] = (float)pcm[i] * scale;
  *out = mem;
  return 0;
}

// ---------------------------------------------------------------------
// FLAC encode (fixed predictors + single-partition Rice)
// ---------------------------------------------------------------------
void write_utf8(BitWriter& bw, uint64_t v) {
  if (v < 0x80) { bw.write(v, 8); return; }
  int nbytes = 2;
  while (v >= (1ull << (6 * (nbytes - 1) + (7 - nbytes)))) nbytes++;
  bw.write(((0xFFu << (8 - nbytes)) & 0xFF) | (uint32_t)(v >> (6 * (nbytes - 1))), 8);
  for (int i = nbytes - 2; i >= 0; i--)
    bw.write(0x80 | ((v >> (6 * i)) & 0x3F), 8);
}

int best_rice_param(const std::vector<int64_t>& res, uint64_t* bits_out) {
  uint64_t sum = 0;
  for (int64_t r : res) sum += (uint64_t)((r << 1) ^ (r >> 63));
  int best_p = 0;
  uint64_t best_bits = ~0ull;
  for (int p = 0; p < 15; p++) {
    uint64_t bits = 0;
    for (int64_t r : res) {
      uint64_t u = (uint64_t)((r << 1) ^ (r >> 63));
      bits += (u >> p) + 1 + p;
      if (bits > best_bits) break;
    }
    if (bits < best_bits) { best_bits = bits; best_p = p; }
  }
  *bits_out = best_bits;
  return best_p;
}

void write_rice(BitWriter& bw, const std::vector<int64_t>& res, int p) {
  for (int64_t r : res) {
    uint64_t u = (uint64_t)((r << 1) ^ (r >> 63));
    uint64_t q = u >> p;
    for (uint64_t i = 0; i < q; i++) bw.write(0, 1);
    bw.write(1, 1);
    if (p) bw.write(u & ((1ull << p) - 1), p);
  }
}

int encode_flac_buf(const float* data, int64_t n, int channels, int sr, int bps,
                    std::vector<uint8_t>& stream) {
  const int block_size = 4096;
  int64_t clip_hi = (1ll << (bps - 1)) - 1, clip_lo = -(1ll << (bps - 1));
  BitWriter hdr;
  hdr.write(0x664C6143, 32);
  hdr.write(0x80, 8);
  hdr.write(34, 24);
  hdr.write(block_size, 16);
  hdr.write(block_size, 16);
  hdr.write(0, 24);
  hdr.write(0, 24);
  hdr.write(sr, 20);
  hdr.write(channels - 1, 3);
  hdr.write(bps - 1, 5);
  hdr.write((uint64_t)n & ((1ull << 36) - 1), 36);
  for (int i = 0; i < 16; i++) hdr.write(0, 8);
  stream = hdr.out;

  int ss_code;
  switch (bps) {
    case 8: ss_code = 1; break;
    case 12: ss_code = 2; break;
    case 16: ss_code = 4; break;
    case 20: ss_code = 5; break;
    case 24: ss_code = 6; break;
    default: return -1;
  }

  int64_t n_frames = (n + block_size - 1) / block_size;
  std::vector<int64_t> chan(block_size), res;
  std::vector<int64_t> diffs[5];
  for (int64_t fi = 0; fi < n_frames; fi++) {
    int bs = (int)std::min<int64_t>(block_size, n - fi * block_size);
    BitWriter fw;
    fw.write(0x3FFE, 14);
    fw.write(0, 2);
    fw.write(7, 4);   // 16-bit block size follows
    fw.write(0, 4);   // sr from streaminfo
    fw.write(channels - 1, 4);
    fw.write(ss_code, 3);
    fw.write(0, 1);
    write_utf8(fw, (uint64_t)fi);
    fw.write(bs - 1, 16);
    fw.align();
    std::vector<uint8_t> head = fw.out;
    head.push_back(crc8(head.data(), head.size()));

    BitWriter bw;
    for (int c = 0; c < channels; c++) {
      for (int i = 0; i < bs; i++) {
        double v = (double)data[(fi * block_size + i) * channels + c] *
                   (double)(1ll << (bps - 1));
        int64_t q = (int64_t)nearbyint(v);  // half-even, matches np.round
        chan[i] = q > clip_hi ? clip_hi : (q < clip_lo ? clip_lo : q);
      }
      // fixed-predictor search: order 0..min(4, bs-1)
      int max_order = bs > 4 ? 4 : (bs > 1 ? bs - 1 : 0);
      diffs[0].assign(chan.begin(), chan.begin() + bs);
      uint64_t best_bits = ~0ull;
      int best_order = 0, best_param = 0;
      for (int o = 0; o <= max_order; o++) {
        if (o > 0) {
          diffs[o].resize(bs - o);
          for (int i = 0; i < bs - o; i++)
            diffs[o][i] = diffs[o - 1][i + 1] - diffs[o - 1][i];
        }
        uint64_t bits;
        int p = best_rice_param(diffs[o], &bits);
        bits += o * bps;
        if (bits < best_bits) { best_bits = bits; best_order = o; best_param = p; }
      }
      if (best_param >= 15) {
        // Degenerate (full-scale noise): VERBATIM subframe is always safe.
        bw.write(0, 1);
        bw.write(1, 6);
        bw.write(0, 1);
        for (int i = 0; i < bs; i++)
          bw.write((uint64_t)chan[i] & ((1ull << bps) - 1), bps);
      } else {
        int o = best_order;
        bw.write(0, 1);
        bw.write(8 | o, 6);
        bw.write(0, 1);
        for (int i = 0; i < o; i++)
          bw.write((uint64_t)chan[i] & ((1ull << bps) - 1), bps);
        bw.write(0, 2);   // rice method 0
        bw.write(0, 4);   // partition order 0
        bw.write(best_param, 4);
        write_rice(bw, diffs[o], best_param);
      }
    }
    bw.align();
    std::vector<uint8_t> frame = head;
    frame.insert(frame.end(), bw.out.begin(), bw.out.end());
    uint16_t crc = crc16(frame.data(), frame.size());
    frame.push_back(crc >> 8);
    frame.push_back(crc & 0xFF);
    stream.insert(stream.end(), frame.begin(), frame.end());
  }
  return 0;
}

bool read_file(const char* path, std::vector<uint8_t>& buf) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long sz = ftell(f);
  fseek(f, 0, SEEK_SET);
  buf.resize(sz);
  size_t rd = fread(buf.data(), 1, sz, f);
  fclose(f);
  return rd == (size_t)sz;
}

// ---------------------------------------------------------------------
// WAV decode (RIFF/WAVE), semantics mirrored from the Python reader
// (ssr_eval_tpu/io/audio.py read_wav / read_wav_i16): PCM 8/16/24/32 +
// IEEE float 32/64, WAVE_FORMAT_EXTENSIBLE mapped like the Python path,
// interleaved output truncated to whole frames, chunk sizes padded to
// even offsets.  16-bit PCM returns the raw int16 block (kind 0, a
// straight memcpy — the engine ships it to the device unconverted);
// everything else converts to float32 in [-1, 1] (kind 1).
int decode_wav_buf(const uint8_t* buf, size_t size, void** out,
                   int64_t* n_samples, int* n_channels, int* sample_rate,
                   int* kind) {
  if (size < 12 || memcmp(buf, "RIFF", 4) != 0 || memcmp(buf + 8, "WAVE", 4) != 0)
    return -1;
  size_t pos = 12;
  bool have_fmt = false;
  const uint8_t* data = nullptr;
  size_t data_size = 0;
  uint32_t audio_fmt = 0, n_ch = 0, sr = 0, bits = 0;
  while (pos + 8 <= size) {
    const uint8_t* cid = buf + pos;
    uint32_t csize = (uint32_t)buf[pos + 4] | ((uint32_t)buf[pos + 5] << 8) |
                     ((uint32_t)buf[pos + 6] << 16) | ((uint32_t)buf[pos + 7] << 24);
    size_t body = pos + 8;
    size_t avail = size > body ? size - body : 0;
    size_t blen = csize < avail ? csize : avail;  // tolerate truncation
    if (memcmp(cid, "fmt ", 4) == 0 && blen >= 16) {
      audio_fmt = (uint32_t)buf[body] | ((uint32_t)buf[body + 1] << 8);
      n_ch = (uint32_t)buf[body + 2] | ((uint32_t)buf[body + 3] << 8);
      sr = (uint32_t)buf[body + 4] | ((uint32_t)buf[body + 5] << 8) |
           ((uint32_t)buf[body + 6] << 16) | ((uint32_t)buf[body + 7] << 24);
      bits = (uint32_t)buf[body + 14] | ((uint32_t)buf[body + 15] << 8);
      have_fmt = true;
    } else if (memcmp(cid, "data", 4) == 0) {
      data = buf + body;
      data_size = blen;
    }
    pos += 8 + csize + (csize & 1);
  }
  if (!have_fmt || data == nullptr || n_ch == 0) return -2;
  if (audio_fmt == 0xFFFE) audio_fmt = (bits != 32) ? 1 : 3;
  *n_channels = (int)n_ch;
  *sample_rate = (int)sr;
  if (audio_fmt == 1 && bits == 16) {
    size_t n_vals = data_size / 2;
    size_t n_frames = n_vals / n_ch;
    int16_t* mem = (int16_t*)malloc(n_frames * n_ch * sizeof(int16_t));
    if (!mem) return -7;
    memcpy(mem, data, n_frames * n_ch * sizeof(int16_t));
    *out = mem;
    *n_samples = (int64_t)n_frames;
    *kind = 0;
    return 0;
  }
  size_t bytes_per = 0;
  if (audio_fmt == 1) {
    if (bits == 8) bytes_per = 1;
    else if (bits == 24) bytes_per = 3;
    else if (bits == 32) bytes_per = 4;
    else return -3;
  } else if (audio_fmt == 3) {
    if (bits == 32) bytes_per = 4;
    else if (bits == 64) bytes_per = 8;
    else return -3;
  } else {
    return -3;
  }
  size_t n_vals = data_size / bytes_per;
  size_t n_frames = n_vals / n_ch;
  n_vals = n_frames * n_ch;
  float* mem = (float*)malloc(n_vals * sizeof(float));
  if (!mem) return -7;
  if (audio_fmt == 1 && bits == 8) {
    for (size_t i = 0; i < n_vals; i++)
      mem[i] = ((float)data[i] - 128.0f) / 128.0f;
  } else if (audio_fmt == 1 && bits == 24) {
    for (size_t i = 0; i < n_vals; i++) {
      const uint8_t* p = data + 3 * i;
      int32_t v = (int32_t)p[0] | ((int32_t)p[1] << 8) | ((int32_t)p[2] << 16);
      if (v >= (1 << 23)) v -= (1 << 24);
      mem[i] = (float)v / 8388608.0f;
    }
  } else if (audio_fmt == 1 && bits == 32) {
    for (size_t i = 0; i < n_vals; i++) {
      int32_t v;
      memcpy(&v, data + 4 * i, 4);
      mem[i] = (float)((double)v / 2147483648.0);
    }
  } else if (audio_fmt == 3 && bits == 32) {
    memcpy(mem, data, n_vals * sizeof(float));
  } else {  // float64
    for (size_t i = 0; i < n_vals; i++) {
      double v;
      memcpy(&v, data + 8 * i, 8);
      mem[i] = (float)v;
    }
  }
  *out = mem;
  *n_samples = (int64_t)n_frames;
  *kind = 1;
  return 0;
}

}  // namespace

extern "C" {

int ssrio_decode_flac(const char* path, float** out, int64_t* n_samples,
                      int* n_channels, int* sample_rate) {
  std::vector<uint8_t> buf;
  if (!read_file(path, buf)) return -100;
  return decode_flac_buf(buf.data(), buf.size(), out, n_samples, n_channels,
                         sample_rate);
}

// 16-bit fast path: raw PCM without the float round trip (halves the
// wire bytes host->device and skips the harness's requantization check).
// Returns -8 when the stream is not 16-bit; callers fall back to floats.
int ssrio_decode_flac_i16(const char* path, int16_t** out, int64_t* n_samples,
                          int* n_channels, int* sample_rate) {
  std::vector<uint8_t> buf;
  if (!read_file(path, buf)) return -100;
  std::vector<int32_t> pcm;
  int bps = 0;
  int rc = decode_flac_ints(buf.data(), buf.size(), pcm, n_samples, n_channels,
                            sample_rate, &bps);
  if (rc != 0) return rc;
  if (bps != 16) return -8;
  int16_t* mem = (int16_t*)malloc(pcm.size() * sizeof(int16_t));
  if (!mem) return -7;
  for (size_t i = 0; i < pcm.size(); i++) mem[i] = (int16_t)pcm[i];
  *out = mem;
  return 0;
}

int ssrio_encode_flac(const char* path, const float* data, int64_t n_samples,
                      int n_channels, int sample_rate, int bps) {
  std::vector<uint8_t> stream;
  int rc = encode_flac_buf(data, n_samples, n_channels, sample_rate, bps, stream);
  if (rc != 0) return rc;
  FILE* f = fopen(path, "wb");
  if (!f) return -101;
  fwrite(stream.data(), 1, stream.size(), f);
  fclose(f);
  return 0;
}

// Batched parallel decode: n_files FLAC or WAV files (sniffed by magic
// bytes per file) across C++ worker threads (no Python/GIL on the hot
// path — one ctypes call decodes a whole engine batch).  Per file i:
//   kinds[i] =  0 -> outs[i] is int16*  (16-bit fast path)
//   kinds[i] =  1 -> outs[i] is float*  (non-16-bit streams)
//   kinds[i] <  0 -> decode error rc, outs[i] = NULL (-101: container
//                    not recognized)
// Caller frees each non-NULL outs[i] with ssrio_free.
int ssrio_decode_batch(const char** paths, int n_files, int n_threads,
                       void** outs, int64_t* n_samples, int* channels,
                       int* srs, int* kinds) {
  if (n_files <= 0) return 0;
  if (n_threads <= 0) n_threads = (int)std::thread::hardware_concurrency();
  if (n_threads <= 0) n_threads = 1;
  if (n_threads > n_files) n_threads = n_files;

  std::atomic<int> next(0);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n_files) return;
      outs[i] = nullptr;
      n_samples[i] = 0;
      channels[i] = 0;
      srs[i] = 0;
      std::vector<uint8_t> buf;
      if (!read_file(paths[i], buf)) { kinds[i] = -100; continue; }
      if (buf.size() >= 4 && memcmp(buf.data(), "RIFF", 4) == 0) {
        int rc = decode_wav_buf(buf.data(), buf.size(), &outs[i],
                                &n_samples[i], &channels[i], &srs[i],
                                &kinds[i]);
        if (rc != 0) kinds[i] = rc;
        continue;
      }
      if (buf.size() < 4 || memcmp(buf.data(), "fLaC", 4) != 0) {
        kinds[i] = -101;
        continue;
      }
      std::vector<int32_t> pcm;
      int bps = 0;
      int rc = decode_flac_ints(buf.data(), buf.size(), pcm, &n_samples[i],
                                &channels[i], &srs[i], &bps);
      if (rc != 0) { kinds[i] = rc; continue; }
      if (bps == 16) {
        int16_t* mem = (int16_t*)malloc(pcm.size() * sizeof(int16_t));
        if (!mem) { kinds[i] = -7; continue; }
        for (size_t j = 0; j < pcm.size(); j++) mem[j] = (int16_t)pcm[j];
        outs[i] = mem;
        kinds[i] = 0;
      } else {
        float* mem = (float*)malloc(pcm.size() * sizeof(float));
        if (!mem) { kinds[i] = -7; continue; }
        float scale = 1.0f / (float)(1ll << (bps - 1));
        for (size_t j = 0; j < pcm.size(); j++) mem[j] = (float)pcm[j] * scale;
        outs[i] = mem;
        kinds[i] = 1;
      }
    }
  };
  std::vector<std::thread> pool;
  for (int t = 0; t < n_threads; t++) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return 0;
}

void ssrio_free(void* p) { free(p); }

// Capability probe: present iff ssrio_decode_batch sniffs and decodes
// RIFF/WAVE containers (older builds were FLAC-only; the Python side
// keys batch routing off this symbol so a stale .so keeps working).
int ssrio_batch_wav_supported() { return 1; }

const char* ssrio_version() { return "ssrio 0.2.0"; }

}  // extern "C"
