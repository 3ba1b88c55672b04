// The port's host image codec: a baseline-JPEG decoder and encoder and the
// PNG row unfilter, with a plain C interface for ctypes
// (supervised_dispnet_tpu_torch/utils/native.py builds it with g++).
//
// The decoder gives what libjpeg-turbo gives with its defaults (what
// cv2.imread and PIL decode with): the islow integer IDCT of jidctint.c with
// its range-limit table, fancy upsampling (jdsample.c: h2v1, h2v2, h1v2, box
// where libjpeg uses it), and jdcolor.c's YCbCr->RGB tables. It takes
// SOF0/SOF1, 8-bit samples, 1 or 3 components, any integer sampling ratio,
// interleaved or single-component scans and restart intervals. Progressive,
// arithmetic, lossless, hierarchical, 12-bit, CMYK / Adobe-RGB and truncated
// or corrupt files fail with a message.
//
// The encoder writes what libjpeg-turbo writes with jpeg_set_defaults and
// jpeg_set_quality (cv2.imwrite's defaults): a JFIF APP0, the Annex K tables
// scaled by quality, 4:2:0 with jcsample.c's alternating-bias h2v2 average,
// jccolor.c's RGB->YCbCr tables, the islow FDCT of jfdctint.c, libjpeg-turbo's
// reciprocal quantization and the standard Huffman tables.
//
// Every entry is reentrant and touches no Python object, so ctypes calls run
// side by side on threads with the interpreter lock released.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// shared tables
// ---------------------------------------------------------------------------

const int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

constexpr int CONST_BITS = 13;
constexpr int PASS1_BITS = 2;
constexpr int32_t FIX_0_298631336 = 2446;
constexpr int32_t FIX_0_390180644 = 3196;
constexpr int32_t FIX_0_541196100 = 4433;
constexpr int32_t FIX_0_765366865 = 6270;
constexpr int32_t FIX_0_899976223 = 7373;
constexpr int32_t FIX_1_175875602 = 9633;
constexpr int32_t FIX_1_501321110 = 12299;
constexpr int32_t FIX_1_847759065 = 15137;
constexpr int32_t FIX_1_961570560 = 16069;
constexpr int32_t FIX_2_053119869 = 16819;
constexpr int32_t FIX_2_562915447 = 20995;
constexpr int32_t FIX_3_072711026 = 25172;

inline int32_t descale(int32_t x, int n) { return (x + (int32_t(1) << (n - 1))) >> n; }

struct Error {
  std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw Error{msg}; }

// ---------------------------------------------------------------------------
// JPEG decoding
// ---------------------------------------------------------------------------

struct HuffTable {
  bool present = false;
  uint8_t bits[17] = {0};
  uint8_t vals[256] = {0};
  int32_t maxcode[18];
  int32_t valoffset[18];
  // 9-bit lookahead: (length << 8) | symbol, 0 when the code is longer
  uint16_t look[1 << 9];

  void build() {
    int huffsize[257];
    uint32_t huffcode[257];
    int p = 0;
    for (int l = 1; l <= 16; l++) {
      for (int i = 0; i < bits[l]; i++) huffsize[p++] = l;
    }
    huffsize[p] = 0;
    uint32_t code = 0;
    int si = huffsize[0];
    p = 0;
    while (huffsize[p]) {
      while (huffsize[p] == si) huffcode[p++] = code++;
      if (code >= (uint32_t(1) << si)) fail("corrupt JPEG: bad Huffman table");
      code <<= 1;
      si++;
    }
    p = 0;
    for (int l = 1; l <= 16; l++) {
      if (bits[l]) {
        valoffset[l] = p - int32_t(huffcode[p]);
        p += bits[l];
        maxcode[l] = int32_t(huffcode[p - 1]);
      } else {
        maxcode[l] = -1;
      }
    }
    maxcode[17] = 0x7FFFFFFF;
    std::memset(look, 0, sizeof(look));
    p = 0;
    for (int l = 1; l <= 9; l++) {
      for (int i = 0; i < bits[l]; i++, p++) {
        int lookbits = int(huffcode[p]) << (9 - l);
        for (int c = 0; c < (1 << (9 - l)); c++)
          look[lookbits + c] = uint16_t((l << 8) | vals[p]);
      }
    }
  }
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;
  int bw = 0, bh = 0;  // blocks across and down the component's plane
  int dw = 0, dh = 0;  // libjpeg's downsampled_width / downsampled_height
  int dc_pred = 0;
  std::vector<uint8_t> plane;  // (bh * 8) x (bw * 8) samples
};

class BitReader {
 public:
  BitReader(const uint8_t* p, const uint8_t* end) : p_(p), end_(end) {}

  // Next 16 bits without consuming them; padding past a marker reads zeros.
  inline uint32_t peek16() {
    if (nbits_ < 16) fill();
    return uint32_t(acc_ >> 48);
  }
  inline void skip(int n) {
    if (n > nbits_ - pad_) overrun_ = true;
    acc_ <<= n;
    nbits_ -= n;
    if (pad_ > nbits_) pad_ = nbits_;
  }
  inline int get(int n) {
    if (n == 0) return 0;
    if (nbits_ < n) fill();
    int v = int(acc_ >> (64 - n));
    skip(n);
    return v;
  }
  bool overrun() const { return overrun_; }
  // Whether the bits ran out at a marker inside the file (else at its end).
  bool at_marker() const { return marker_; }

  // Drop the bits left and stop at the next marker: returns its code, and
  // leaves the reader just past it. Fails when the data ends first.
  int next_marker() {
    acc_ = 0;
    nbits_ = pad_ = 0;
    if (!marker_) {
      // skip whatever entropy bytes the bit buffer had not reached
      while (p_ < end_) {
        if (*p_ == 0xFF && p_ + 1 < end_ && p_[1] != 0x00 && p_[1] != 0xFF) break;
        p_++;
      }
    }
    while (p_ < end_ && *p_ == 0xFF) p_++;
    if (p_ >= end_) fail("truncated JPEG: the data ends inside a scan");
    marker_ = false;
    return *p_++;
  }
  const uint8_t* pos() const { return p_; }

 private:
  void fill() {
    while (nbits_ <= 56) {
      uint32_t b = 0;
      if (!marker_ && p_ < end_) {
        b = *p_;
        if (b == 0xFF) {
          const uint8_t* q = p_ + 1;
          while (q < end_ && *q == 0xFF) q++;
          if (q < end_ && *q == 0x00) {
            p_ = q + 1;  // a stuffed 0xFF
          } else {
            p_ = q - 1;  // a marker (or the end): point at its last 0xFF
            marker_ = true;
            b = 0;
            pad_ += 8;
          }
        } else {
          p_++;
        }
      } else {
        pad_ += 8;  // past a marker or the end: zeros, counted as padding
      }
      acc_ |= uint64_t(b) << (56 - nbits_);
      nbits_ += 8;
    }
  }

  const uint8_t* p_;
  const uint8_t* end_;
  uint64_t acc_ = 0;
  int nbits_ = 0;
  int pad_ = 0;
  bool marker_ = false;
  bool overrun_ = false;
};

inline int decode_huff(BitReader& br, const HuffTable& t) {
  uint32_t look = br.peek16();
  uint16_t e = t.look[look >> 7];
  if (e) {
    br.skip(e >> 8);
    return e & 0xFF;
  }
  int l = 10;
  int32_t code = int32_t(look >> (16 - l));
  while (code > t.maxcode[l]) {
    l++;
    if (l > 16) fail("corrupt JPEG data: bad Huffman code");
    code = int32_t(look >> (16 - l));
  }
  br.skip(l);
  return t.vals[(code + t.valoffset[l]) & 0xFF];
}

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

// libjpeg's IDCT range limit (jdmaster.c prepare_range_limit_table), indexed
// by the descaled value & 1023: clamps to 0..255 after the +128 level shift
// and wraps values beyond +-512 as libjpeg's table does.
struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int v = 0; v < 1024; v++) {
      int s = v < 512 ? v : v - 1024;
      int x = s + 128;
      t[v] = uint8_t(x < 0 ? 0 : (x > 255 ? 255 : x));
    }
  }
};

// jidctint.c jpeg_idct_islow: coefficients in natural order, quantization
// table in natural order; writes an 8x8 block at out with row stride.
void idct_islow(const int16_t* coef, const uint16_t* q, uint8_t* out, int stride,
                const uint8_t* range) {
  int32_t ws[64];
  for (int c = 0; c < 8; c++) {
    const int16_t* in = coef + c;
    const uint16_t* qp = q + c;
    int32_t* w = ws + c;
    if (in[8] == 0 && in[16] == 0 && in[24] == 0 && in[32] == 0 && in[40] == 0 &&
        in[48] == 0 && in[56] == 0) {
      int32_t dc = (int32_t(in[0]) * qp[0]) << PASS1_BITS;
      for (int r = 0; r < 8; r++) w[8 * r] = dc;
      continue;
    }
    int32_t z2 = int32_t(in[16]) * qp[16];
    int32_t z3 = int32_t(in[48]) * qp[48];
    int32_t z1 = (z2 + z3) * FIX_0_541196100;
    int32_t tmp2 = z1 + z3 * (-FIX_1_847759065);
    int32_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = int32_t(in[0]) * qp[0];
    z3 = int32_t(in[32]) * qp[32];
    int32_t tmp0 = (z2 + z3) * (1 << CONST_BITS);
    int32_t tmp1 = (z2 - z3) * (1 << CONST_BITS);
    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = int32_t(in[56]) * qp[56];
    tmp1 = int32_t(in[40]) * qp[40];
    tmp2 = int32_t(in[24]) * qp[24];
    tmp3 = int32_t(in[8]) * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int32_t z4 = tmp1 + tmp3;
    int32_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 = tmp0 * FIX_0_298631336;
    tmp1 = tmp1 * FIX_2_053119869;
    tmp2 = tmp2 * FIX_3_072711026;
    tmp3 = tmp3 * FIX_1_501321110;
    z1 = z1 * (-FIX_0_899976223);
    z2 = z2 * (-FIX_2_562915447);
    z3 = z3 * (-FIX_1_961570560);
    z4 = z4 * (-FIX_0_390180644);
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int S = CONST_BITS - PASS1_BITS;
    w[0] = descale(tmp10 + tmp3, S);
    w[56] = descale(tmp10 - tmp3, S);
    w[8] = descale(tmp11 + tmp2, S);
    w[48] = descale(tmp11 - tmp2, S);
    w[16] = descale(tmp12 + tmp1, S);
    w[40] = descale(tmp12 - tmp1, S);
    w[24] = descale(tmp13 + tmp0, S);
    w[32] = descale(tmp13 - tmp0, S);
  }
  constexpr int S2 = CONST_BITS + PASS1_BITS + 3;
  for (int r = 0; r < 8; r++) {
    const int32_t* w = ws + 8 * r;
    uint8_t* o = out + r * stride;
    if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 && w[6] == 0 &&
        w[7] == 0) {
      uint8_t dc = range[descale(w[0], PASS1_BITS + 3) & 1023];
      for (int c = 0; c < 8; c++) o[c] = dc;
      continue;
    }
    int32_t z2 = w[2], z3 = w[6];
    int32_t z1 = (z2 + z3) * FIX_0_541196100;
    int32_t tmp2 = z1 + z3 * (-FIX_1_847759065);
    int32_t tmp3 = z1 + z2 * FIX_0_765366865;
    int32_t tmp0 = (w[0] + w[4]) * (1 << CONST_BITS);
    int32_t tmp1 = (w[0] - w[4]) * (1 << CONST_BITS);
    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int32_t z4 = tmp1 + tmp3;
    int32_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 = tmp0 * FIX_0_298631336;
    tmp1 = tmp1 * FIX_2_053119869;
    tmp2 = tmp2 * FIX_3_072711026;
    tmp3 = tmp3 * FIX_1_501321110;
    z1 = z1 * (-FIX_0_899976223);
    z2 = z2 * (-FIX_2_562915447);
    z3 = z3 * (-FIX_1_961570560);
    z4 = z4 * (-FIX_0_390180644);
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    o[0] = range[descale(tmp10 + tmp3, S2) & 1023];
    o[7] = range[descale(tmp10 - tmp3, S2) & 1023];
    o[1] = range[descale(tmp11 + tmp2, S2) & 1023];
    o[6] = range[descale(tmp11 - tmp2, S2) & 1023];
    o[2] = range[descale(tmp12 + tmp1, S2) & 1023];
    o[5] = range[descale(tmp12 - tmp1, S2) & 1023];
    o[3] = range[descale(tmp13 + tmp0, S2) & 1023];
    o[4] = range[descale(tmp13 - tmp0, S2) & 1023];
  }
}

struct Jpeg {
  int width = 0, height = 0, ncomp = 0;
  int hmax = 1, vmax = 1;
  int restart = 0;
  bool frame = false, adobe = false;
  int adobe_transform = -1;
  uint16_t qt[4][64];
  bool qt_present[4] = {false, false, false, false};
  HuffTable dc[4], ac[4];
  Component comp[3];
  int scans = 0;
};

inline int u16(const uint8_t* p) { return (p[0] << 8) | p[1]; }

void read_frame(Jpeg& j, const uint8_t* s, int len) {
  if (j.frame) fail("JPEG with more than one frame header");
  if (len < 6) fail("corrupt JPEG frame header");
  int precision = s[0];
  j.height = u16(s + 1);
  j.width = u16(s + 3);
  j.ncomp = s[5];
  if (precision != 8)
    fail(std::to_string(precision) + "-bit JPEGs are not supported (8-bit only)");
  if (j.height == 0) fail("JPEGs whose height comes in a DNL marker are not supported");
  if (j.width == 0) fail("corrupt JPEG: width 0");
  if (j.ncomp == 4) fail("CMYK JPEGs are not supported");
  if (j.ncomp != 1 && j.ncomp != 3)
    fail("JPEGs with " + std::to_string(j.ncomp) + " components are not supported");
  if (len < 6 + 3 * j.ncomp) fail("corrupt JPEG frame header");
  for (int c = 0; c < j.ncomp; c++) {
    Component& k = j.comp[c];
    k.id = s[6 + 3 * c];
    k.h = s[7 + 3 * c] >> 4;
    k.v = s[7 + 3 * c] & 15;
    k.tq = s[8 + 3 * c];
    if (k.h < 1 || k.h > 4 || k.v < 1 || k.v > 4 || k.tq > 3)
      fail("corrupt JPEG: bad sampling factors or table index");
    if (k.h > j.hmax) j.hmax = k.h;
    if (k.v > j.vmax) j.vmax = k.v;
  }
  for (int c = 0; c < j.ncomp; c++) {
    Component& k = j.comp[c];
    if (j.hmax % k.h || j.vmax % k.v)
      fail("JPEGs with non-integral sampling ratios are not supported");
    k.dw = (j.width * k.h + j.hmax - 1) / j.hmax;
    k.dh = (j.height * k.v + j.vmax - 1) / j.vmax;
    int mcux = (j.width + 8 * j.hmax - 1) / (8 * j.hmax);
    int mcuy = (j.height + 8 * j.vmax - 1) / (8 * j.vmax);
    k.bw = mcux * k.h;
    k.bh = mcuy * k.v;
    k.plane.assign(size_t(k.bw) * 8 * size_t(k.bh) * 8, 0);
  }
  j.frame = true;
}

void read_dqt(Jpeg& j, const uint8_t* s, int len) {
  int pos = 0;
  while (pos < len) {
    int pq = s[pos] >> 4, tq = s[pos] & 15;
    pos++;
    if (tq > 3 || pq > 1) fail("corrupt JPEG: bad quantization table");
    int n = pq ? 128 : 64;
    if (pos + n > len) fail("corrupt JPEG: short quantization table");
    for (int i = 0; i < 64; i++)
      j.qt[tq][kNatural[i]] = uint16_t(pq ? u16(s + pos + 2 * i) : s[pos + i]);
    j.qt_present[tq] = true;
    pos += n;
  }
}

void read_dht(Jpeg& j, const uint8_t* s, int len) {
  int pos = 0;
  while (pos < len) {
    if (pos + 17 > len) fail("corrupt JPEG: short Huffman table");
    int tc = s[pos] >> 4, th = s[pos] & 15;
    if (tc > 1 || th > 3) fail("corrupt JPEG: bad Huffman table index");
    HuffTable& t = tc ? j.ac[th] : j.dc[th];
    int count = 0;
    t.bits[0] = 0;
    for (int l = 1; l <= 16; l++) {
      t.bits[l] = s[pos + l];
      count += t.bits[l];
    }
    pos += 17;
    if (count > 256 || pos + count > len) fail("corrupt JPEG: bad Huffman table");
    std::memset(t.vals, 0, sizeof(t.vals));
    std::memcpy(t.vals, s + pos, size_t(count));
    pos += count;
    t.build();
    t.present = true;
  }
}

void decode_block(BitReader& br, Component& k, const Jpeg& j, int16_t* blk) {
  std::memset(blk, 0, 64 * sizeof(int16_t));
  const HuffTable& dct = j.dc[k.td];
  const HuffTable& act = j.ac[k.ta];
  int s = decode_huff(br, dct);
  if (s) {
    if (s > 16) fail("corrupt JPEG data: bad DC difference");
    int r = br.get(s);
    s = extend(r, s);
  }
  k.dc_pred += s;
  blk[0] = int16_t(k.dc_pred);
  for (int i = 1; i < 64; i++) {
    int rs = decode_huff(br, act);
    int r = rs >> 4;
    s = rs & 15;
    if (s) {
      i += r;
      if (i > 63) fail("corrupt JPEG data: coefficient index out of range");
      int v = br.get(s);
      blk[kNatural[i]] = int16_t(extend(v, s));
    } else {
      if (r != 15) break;
      i += 15;
    }
  }
}

[[noreturn]] void scan_overrun(const BitReader& br) {
  if (br.at_marker()) fail("corrupt JPEG data: premature end of a data segment");
  fail("truncated JPEG: the data ends inside a scan");
}

// Decode one scan whose header is at s[0..len); p/end are the data after it.
// Returns the pointer just past the marker that ends the scan, and that
// marker's code in *marker_out.
const uint8_t* decode_scan(Jpeg& j, const uint8_t* s, int len, const uint8_t* p,
                           const uint8_t* end, const RangeLimit& rl, int* marker_out) {
  if (!j.frame) fail("corrupt JPEG: scan before the frame header");
  int ns = s[0];
  if (ns < 1 || ns > j.ncomp || len < 1 + 2 * ns + 3) fail("corrupt JPEG scan header");
  Component* sc[3];
  for (int i = 0; i < ns; i++) {
    int id = s[1 + 2 * i];
    Component* found = nullptr;
    for (int c = 0; c < j.ncomp; c++)
      if (j.comp[c].id == id) found = &j.comp[c];
    if (!found) fail("corrupt JPEG: scan names an unknown component");
    found->td = s[2 + 2 * i] >> 4;
    found->ta = s[2 + 2 * i] & 15;
    if (found->td > 3 || found->ta > 3 || !j.dc[found->td].present ||
        !j.ac[found->ta].present)
      fail("corrupt JPEG: scan uses an undefined Huffman table");
    if (!j.qt_present[found->tq]) fail("corrupt JPEG: undefined quantization table");
    sc[i] = found;
  }
  int ss = s[1 + 2 * ns], se = s[2 + 2 * ns], ahal = s[3 + 2 * ns];
  if (ss != 0 || se != 63 || ahal != 0) fail("corrupt JPEG: not a sequential scan");

  int mcux, mcuy;
  if (ns == 1) {
    // a single-component scan: one block an MCU, over the component's own size
    mcux = (sc[0]->dw + 7) / 8;
    mcuy = (sc[0]->dh + 7) / 8;
  } else {
    mcux = (j.width + 8 * j.hmax - 1) / (8 * j.hmax);
    mcuy = (j.height + 8 * j.vmax - 1) / (8 * j.vmax);
  }
  for (int i = 0; i < ns; i++) sc[i]->dc_pred = 0;
  BitReader br(p, end);
  int16_t blk[64];
  long total = long(mcux) * mcuy;
  int rst_expected = 0;
  try {
  for (long m = 0; m < total; m++) {
    if (j.restart && m > 0 && m % j.restart == 0) {
      if (br.overrun()) scan_overrun(br);
      int marker = br.next_marker();
      if (marker != 0xD0 + rst_expected)
        fail("corrupt JPEG data: missing restart marker");
      rst_expected = (rst_expected + 1) & 7;
      br = BitReader(br.pos(), end);
      for (int i = 0; i < ns; i++) sc[i]->dc_pred = 0;
    }
    int mx = int(m % mcux), my = int(m / mcux);
    for (int i = 0; i < ns; i++) {
      Component& k = *sc[i];
      int bh = ns == 1 ? 1 : k.v, bw = ns == 1 ? 1 : k.h;
      const int stride = k.bw * 8;
      for (int by = 0; by < bh; by++) {
        for (int bx = 0; bx < bw; bx++) {
          decode_block(br, k, j, blk);
          int row = (my * bh + by) * 8, col = (mx * bw + bx) * 8;
          idct_islow(blk, j.qt[k.tq], k.plane.data() + size_t(row) * stride + col, stride,
                     rl.t);
        }
      }
    }
  }
  } catch (const Error&) {
    if (br.overrun()) scan_overrun(br);
    throw;
  }
  if (br.overrun()) scan_overrun(br);
  *marker_out = br.next_marker();
  return br.pos();
}

// --- upsampling and colour (jdsample.c, jdcolor.c) ---

// The component's samples at full resolution for rows [0, H): into out
// (H x W), by the method libjpeg-turbo picks for the ratio.
void upsample(const Jpeg& j, const Component& k, uint8_t* out) {
  const int W = j.width, H = j.height;
  const int rh = j.hmax / k.h, rv = j.vmax / k.v;
  const int stride = k.bw * 8;
  const uint8_t* pl = k.plane.data();
  auto row = [&](int y) {  // a row of the plane, the edge rows repeated
    if (y < 0) y = 0;
    if (y > k.dh - 1) y = k.dh - 1;
    return pl + size_t(y) * stride;
  };
  std::vector<uint8_t> wide;
  if (rh == 1 && rv == 1) {
    for (int y = 0; y < H; y++) std::memcpy(out + size_t(y) * W, row(y), size_t(W));
  } else if (rh == 2 && rv == 1 && k.dw > 2) {  // h2v1_fancy_upsample
    wide.resize(size_t(2) * k.dw);
    for (int y = 0; y < H; y++) {
      const uint8_t* in = row(y);
      uint8_t* o = wide.data();
      int dw = k.dw;
      o[0] = in[0];
      o[1] = uint8_t((in[0] * 3 + in[1] + 2) >> 2);
      for (int x = 1; x < dw - 1; x++) {
        int v = in[x] * 3;
        o[2 * x] = uint8_t((v + in[x - 1] + 1) >> 2);
        o[2 * x + 1] = uint8_t((v + in[x + 1] + 2) >> 2);
      }
      o[2 * dw - 2] = uint8_t((in[dw - 1] * 3 + in[dw - 2] + 1) >> 2);
      o[2 * dw - 1] = in[dw - 1];
      std::memcpy(out + size_t(y) * W, o, size_t(W));
    }
  } else if (rh == 1 && rv == 2) {  // h1v2_fancy_upsample
    for (int y = 0; y < H; y++) {
      int iy = y >> 1;
      const uint8_t* near = row(iy);
      const uint8_t* far = (y & 1) ? row(iy + 1) : row(iy - 1);
      int bias = (y & 1) ? 2 : 1;
      uint8_t* o = out + size_t(y) * W;
      for (int x = 0; x < W; x++) o[x] = uint8_t((near[x] * 3 + far[x] + bias) >> 2);
    }
  } else if (rh == 2 && rv == 2 && k.dw > 2) {  // h2v2_fancy_upsample
    wide.resize(size_t(2) * k.dw);
    std::vector<int> sum(size_t(k.dw));
    for (int y = 0; y < H; y++) {
      int iy = y >> 1;
      const uint8_t* near = row(iy);
      const uint8_t* far = (y & 1) ? row(iy + 1) : row(iy - 1);
      int dw = k.dw;
      for (int x = 0; x < dw; x++) sum[x] = near[x] * 3 + far[x];
      uint8_t* o = wide.data();
      o[0] = uint8_t((sum[0] * 4 + 8) >> 4);
      o[1] = uint8_t((sum[0] * 3 + sum[1] + 7) >> 4);
      for (int x = 1; x < dw - 1; x++) {
        o[2 * x] = uint8_t((sum[x] * 3 + sum[x - 1] + 8) >> 4);
        o[2 * x + 1] = uint8_t((sum[x] * 3 + sum[x + 1] + 7) >> 4);
      }
      o[2 * dw - 2] = uint8_t((sum[dw - 1] * 3 + sum[dw - 2] + 8) >> 4);
      o[2 * dw - 1] = uint8_t((sum[dw - 1] * 4 + 7) >> 4);
      std::memcpy(out + size_t(y) * W, o, size_t(W));
    }
  } else {  // h2v1_upsample, h2v2_upsample, int_upsample: replication
    for (int y = 0; y < H; y++) {
      const uint8_t* in = pl + size_t(y / rv) * stride;
      uint8_t* o = out + size_t(y) * W;
      for (int x = 0; x < W; x++) o[x] = in[x / rh];
    }
  }
}

struct YccTables {
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256];
  YccTables() {
    constexpr int SCALEBITS = 16;
    constexpr int32_t ONE_HALF = int32_t(1) << (SCALEBITS - 1);
    auto fix = [](double x) { return int32_t(x * (1 << SCALEBITS) + 0.5); };
    for (int i = 0, x = -128; i < 256; i++, x++) {
      cr_r[i] = int((fix(1.40200) * x + ONE_HALF) >> SCALEBITS);
      cb_b[i] = int((fix(1.77200) * x + ONE_HALF) >> SCALEBITS);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + ONE_HALF;
    }
  }
};

inline uint8_t clamp255(int v) { return uint8_t(v < 0 ? 0 : (v > 255 ? 255 : v)); }

void decode(const uint8_t* data, size_t n, Jpeg& j, bool header_only) {
  static const RangeLimit rl;
  if (n < 2 || data[0] != 0xFF || data[1] != 0xD8) fail("not a JPEG file");
  const uint8_t* p = data + 2;
  const uint8_t* end = data + n;
  int marker = -1;
  for (;;) {
    if (marker < 0) {
      // find the next marker: 0xFF (fill 0xFFs) code
      if (p >= end) fail("truncated JPEG: no end-of-image marker");
      if (*p != 0xFF) fail("corrupt JPEG: expected a marker");
      while (p < end && *p == 0xFF) p++;
      if (p >= end) fail("truncated JPEG: no end-of-image marker");
      marker = *p++;
    }
    int m = marker;
    marker = -1;
    if (m == 0xD9) break;  // EOI
    if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;  // TEM, a stray RST
    if (p + 2 > end) fail("truncated JPEG: a marker segment is cut off");
    int len = u16(p);
    if (len < 2 || p + len > end) fail("truncated JPEG: a marker segment is cut off");
    const uint8_t* s = p + 2;
    int slen = len - 2;
    p += len;
    switch (m) {
      case 0xC0:
      case 0xC1:
        read_frame(j, s, slen);
        if (header_only) return;
        break;
      case 0xC2:
      case 0xC6:
      case 0xCA:
      case 0xCE:
        fail("progressive JPEGs are not supported (baseline only)");
      case 0xC3:
      case 0xC7:
      case 0xCB:
      case 0xCF:
        fail("lossless JPEGs are not supported (baseline only)");
      case 0xC5:
        fail("hierarchical JPEGs are not supported (baseline only)");
      case 0xC8:
        fail("corrupt JPEG: reserved frame marker");
      case 0xC9:
      case 0xCD:
        fail("arithmetic-coded JPEGs are not supported (baseline only)");
      case 0xC4:
        read_dht(j, s, slen);
        break;
      case 0xCC:
        fail("arithmetic-coded JPEGs are not supported (baseline only)");
      case 0xDB:
        read_dqt(j, s, slen);
        break;
      case 0xDD:
        if (slen < 2) fail("corrupt JPEG restart interval");
        j.restart = u16(s);
        break;
      case 0xDA: {
        p = decode_scan(j, s, slen, p, end, rl, &marker);
        j.scans++;
        break;
      }
      case 0xEE:
        if (slen >= 12 && std::memcmp(s, "Adobe", 5) == 0) {
          j.adobe = true;
          j.adobe_transform = s[11];
        }
        break;
      default:
        break;  // APPn, COM, DNL, ...: skipped
    }
  }
  if (!j.frame) fail("corrupt JPEG: no frame header");
  if (header_only) return;
  if (j.scans == 0) fail("truncated JPEG: no scan");
}

// The decoded planes upsampled and converted to (H x W x 3) RGB.
void to_rgb(const Jpeg& j, uint8_t* rgb) {
  static const YccTables yt;
  if (j.ncomp == 3) {
    // jdapimin.c default_decompress_parms: an Adobe transform 0, or component
    // ids 'R','G','B' without JFIF / Adobe, mean RGB, which is not converted
    bool rgb_ids = j.comp[0].id == 'R' && j.comp[1].id == 'G' && j.comp[2].id == 'B';
    if ((j.adobe && j.adobe_transform == 0) || (!j.adobe && rgb_ids))
      fail("Adobe RGB JPEGs are not supported (YCbCr only)");
  }
  const int W = j.width, H = j.height;
  const size_t N = size_t(W) * H;
  if (j.ncomp == 1) {
    std::vector<uint8_t> g(N);
    upsample(j, j.comp[0], g.data());
    for (size_t i = 0; i < N; i++) rgb[3 * i] = rgb[3 * i + 1] = rgb[3 * i + 2] = g[i];
    return;
  }
  std::vector<uint8_t> y(N), cb(N), cr(N);
  upsample(j, j.comp[0], y.data());
  upsample(j, j.comp[1], cb.data());
  upsample(j, j.comp[2], cr.data());
  for (size_t i = 0; i < N; i++) {
    int Y = y[i], b = cb[i], r = cr[i];
    rgb[3 * i] = clamp255(Y + yt.cr_r[r]);
    rgb[3 * i + 1] = clamp255(Y + int((yt.cb_g[b] + yt.cr_g[r]) >> 16));
    rgb[3 * i + 2] = clamp255(Y + yt.cb_b[b]);
  }
}

// ---------------------------------------------------------------------------
// JPEG encoding
// ---------------------------------------------------------------------------

const uint8_t kStdLumaQ[64] = {16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,
                               58, 60, 55, 14, 13,  16,  24,  40,  57, 69, 56, 14, 17,
                               22, 29, 51, 87, 80,  62,  18,  22,  37, 56, 68, 109, 103,
                               77, 24, 35, 55, 64,  81,  104, 113, 92, 49, 64, 78,  87,
                               103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const uint8_t kStdChromaQ[64] = {17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99,
                                 99, 99, 99, 24, 26, 56, 99, 99, 99, 99, 99, 47, 66,
                                 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
                                 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
                                 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

const uint8_t kDcLumaBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51,
    0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1,
    0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18,
    0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
    0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57,
    0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92,
    0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7,
    0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
    0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8,
    0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07,
    0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09,
    0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25,
    0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38,
    0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56,
    0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5,
    0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba,
    0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6,
    0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct EncTable {
  uint32_t code[256];
  uint8_t size[256];
  EncTable(const uint8_t* bits, const uint8_t* vals) {
    std::memset(size, 0, sizeof(size));
    uint32_t c = 0;
    int p = 0;
    for (int l = 1; l <= 16; l++) {
      for (int i = 0; i < bits[l]; i++, p++) {
        code[vals[p]] = c++;
        size[vals[p]] = uint8_t(l);
      }
      c <<= 1;
    }
  }
};

class BitWriter {
 public:
  explicit BitWriter(std::vector<uint8_t>& out) : out_(out) {}
  inline void put(uint32_t code, int size) {
    acc_ = (acc_ << size) | (code & ((uint32_t(1) << size) - 1));
    nbits_ += size;
    while (nbits_ >= 8) {
      nbits_ -= 8;
      uint8_t b = uint8_t(acc_ >> nbits_);
      out_.push_back(b);
      if (b == 0xFF) out_.push_back(0);
    }
  }
  void flush() {  // jchuff.c flush_bits: the last byte filled with ones
    if (nbits_) put(0x7F, 8 - nbits_);
  }

 private:
  std::vector<uint8_t>& out_;
  uint64_t acc_ = 0;
  int nbits_ = 0;
};

inline int nbits_of(int v) {
  int n = 0;
  while (v) {
    n++;
    v >>= 1;
  }
  return n;
}

void encode_block(BitWriter& bw, const int16_t* blk, int& last_dc, const EncTable& dct,
                  const EncTable& act) {
  int diff = blk[0] - last_dc;
  last_dc = blk[0];
  int t = diff < 0 ? -diff : diff;
  int n = nbits_of(t);
  bw.put(dct.code[n], dct.size[n]);
  if (n) bw.put(uint32_t(diff < 0 ? diff - 1 : diff), n);
  int run = 0;
  for (int k = 1; k < 64; k++) {
    int v = blk[kNatural[k]];
    if (v == 0) {
      run++;
      continue;
    }
    while (run > 15) {
      bw.put(act.code[0xF0], act.size[0xF0]);
      run -= 16;
    }
    t = v < 0 ? -v : v;
    n = nbits_of(t);
    int sym = (run << 4) + n;
    bw.put(act.code[sym], act.size[sym]);
    bw.put(uint32_t(v < 0 ? v - 1 : v), n);
    run = 0;
  }
  if (run > 0) bw.put(act.code[0], act.size[0]);
}

// jfdctint.c jpeg_fdct_islow on level-shifted samples, in place.
void fdct_islow(int32_t* d) {
  for (int r = 0; r < 8; r++) {
    int32_t* p = d + 8 * r;
    int32_t tmp0 = p[0] + p[7], tmp7 = p[0] - p[7];
    int32_t tmp1 = p[1] + p[6], tmp6 = p[1] - p[6];
    int32_t tmp2 = p[2] + p[5], tmp5 = p[2] - p[5];
    int32_t tmp3 = p[3] + p[4], tmp4 = p[3] - p[4];
    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = (tmp10 + tmp11) * (1 << PASS1_BITS);
    p[4] = (tmp10 - tmp11) * (1 << PASS1_BITS);
    int32_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
    constexpr int S = CONST_BITS - PASS1_BITS;
    p[2] = descale(z1 + tmp13 * FIX_0_765366865, S);
    p[6] = descale(z1 + tmp12 * (-FIX_1_847759065), S);
    z1 = tmp4 + tmp7;
    int32_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int32_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp4 *= FIX_0_298631336;
    tmp5 *= FIX_2_053119869;
    tmp6 *= FIX_3_072711026;
    tmp7 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    p[7] = descale(tmp4 + z1 + z3, S);
    p[5] = descale(tmp5 + z2 + z4, S);
    p[3] = descale(tmp6 + z2 + z3, S);
    p[1] = descale(tmp7 + z1 + z4, S);
  }
  for (int c = 0; c < 8; c++) {
    int32_t* p = d + c;
    int32_t tmp0 = p[0] + p[56], tmp7 = p[0] - p[56];
    int32_t tmp1 = p[8] + p[48], tmp6 = p[8] - p[48];
    int32_t tmp2 = p[16] + p[40], tmp5 = p[16] - p[40];
    int32_t tmp3 = p[24] + p[32], tmp4 = p[24] - p[32];
    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = descale(tmp10 + tmp11, PASS1_BITS);
    p[32] = descale(tmp10 - tmp11, PASS1_BITS);
    int32_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
    constexpr int S = CONST_BITS + PASS1_BITS;
    p[16] = descale(z1 + tmp13 * FIX_0_765366865, S);
    p[48] = descale(z1 + tmp12 * (-FIX_1_847759065), S);
    z1 = tmp4 + tmp7;
    int32_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int32_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp4 *= FIX_0_298631336;
    tmp5 *= FIX_2_053119869;
    tmp6 *= FIX_3_072711026;
    tmp7 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    p[56] = descale(tmp4 + z1 + z3, S);
    p[40] = descale(tmp5 + z2 + z4, S);
    p[24] = descale(tmp6 + z2 + z3, S);
    p[8] = descale(tmp7 + z1 + z4, S);
  }
}

// libjpeg-turbo jcdctmgr.c compute_reciprocal / quantize for a 16-bit DCTELEM.
struct Divisor {
  uint32_t recip, corr;
  int shift;
};

Divisor reciprocal(uint32_t divisor) {
  int b = 0;
  while ((uint32_t(1) << (b + 1)) <= divisor) b++;  // flss(divisor) - 1
  int r = 16 + b;
  uint32_t fq = (uint32_t(1) << r) / divisor;
  uint32_t fr = (uint32_t(1) << r) % divisor;
  uint32_t c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    r--;
  } else if (fr <= divisor / 2) {
    c++;
  } else {
    fq++;
  }
  return Divisor{fq, c, r};
}

inline int16_t quantize(int32_t x, const Divisor& d) {
  bool neg = x < 0;
  uint32_t t = uint32_t(neg ? -x : x);
  uint32_t q = uint32_t((uint64_t(t + d.corr) * d.recip) >> d.shift) & 0xFFFF;
  return int16_t(neg ? -int32_t(q) : int32_t(q));
}

void emit_marker(std::vector<uint8_t>& o, int m) {
  o.push_back(0xFF);
  o.push_back(uint8_t(m));
}
void emit16(std::vector<uint8_t>& o, int v) {
  o.push_back(uint8_t(v >> 8));
  o.push_back(uint8_t(v & 0xFF));
}
void emit_dht(std::vector<uint8_t>& o, int index, const uint8_t* bits, const uint8_t* vals) {
  int count = 0;
  for (int l = 1; l <= 16; l++) count += bits[l];
  emit_marker(o, 0xC4);
  emit16(o, 2 + 1 + 16 + count);
  o.push_back(uint8_t(index));
  for (int l = 1; l <= 16; l++) o.push_back(bits[l]);
  for (int i = 0; i < count; i++) o.push_back(vals[i]);
}

std::vector<uint8_t> encode(const uint8_t* rgb, int H, int W, int quality) {
  if (H < 1 || W < 1 || H > 65535 || W > 65535) fail("JPEG dimensions must be 1..65535");
  if (quality < 1) quality = 1;
  if (quality > 100) quality = 100;
  int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;  // jpeg_quality_scaling
  uint16_t qt[2][64];
  for (int t = 0; t < 2; t++) {
    const uint8_t* base = t ? kStdChromaQ : kStdLumaQ;
    for (int i = 0; i < 64; i++) {
      long v = (long(base[i]) * scale + 50) / 100;
      if (v <= 0) v = 1;
      if (v > 255) v = 255;  // force_baseline
      qt[t][i] = uint16_t(v);
    }
  }
  Divisor div[2][64];
  for (int t = 0; t < 2; t++)
    for (int i = 0; i < 64; i++) div[t][i] = reciprocal(uint32_t(qt[t][i]) << 3);

  // jccolor.c rgb_ycc_convert
  constexpr int SCALEBITS = 16;
  constexpr int32_t ONE_HALF = int32_t(1) << (SCALEBITS - 1);
  constexpr int32_t CBCR_OFFSET = int32_t(128) << SCALEBITS;
  auto fix = [](double x) { return int32_t(x * (1 << SCALEBITS) + 0.5); };
  int32_t tab[8][256];
  for (int i = 0; i < 256; i++) {
    tab[0][i] = fix(0.29900) * i;
    tab[1][i] = fix(0.58700) * i;
    tab[2][i] = fix(0.11400) * i + ONE_HALF;
    tab[3][i] = -fix(0.16874) * i;
    tab[4][i] = -fix(0.33126) * i;
    tab[5][i] = fix(0.50000) * i + CBCR_OFFSET + ONE_HALF - 1;  // B=>Cb, R=>Cr
    tab[6][i] = -fix(0.41869) * i;
    tab[7][i] = -fix(0.08131) * i;
  }
  // Geometry of 4:2:0 (jcmaster.c): Y 2x2, Cb and Cr 1x1.
  const int ybw = (W + 7) / 8, ybh = (H + 7) / 8;      // Y width/height in blocks
  const int cbw = (W + 15) / 16, cbh = (H + 15) / 16;  // chroma in blocks = MCUs
  const int mcux = cbw, mcuy = cbh;
  // Y plane: the image edge-replicated to (mcuy * 16) x (ybw * 8)
  const int yw = ybw * 8, yh = mcuy * 16;
  std::vector<uint8_t> Y(size_t(yw) * yh), Cb, Cr;
  // colour-converted full-resolution chroma, edge-replicated to
  // (rows padded to even) x (cbw * 16) for the h2v2 average
  const int fw = cbw * 16, fh = (H + 1) / 2 * 2;
  std::vector<uint8_t> cbf(size_t(fw) * fh), crf(size_t(fw) * fh);
  for (int y = 0; y < H; y++) {
    const uint8_t* in = rgb + size_t(y) * W * 3;
    uint8_t* yo = Y.data() + size_t(y) * yw;
    uint8_t* bo = cbf.data() + size_t(y) * fw;
    uint8_t* ro = crf.data() + size_t(y) * fw;
    for (int x = 0; x < W; x++) {
      int r = in[3 * x], g = in[3 * x + 1], b = in[3 * x + 2];
      yo[x] = uint8_t((tab[0][r] + tab[1][g] + tab[2][b]) >> SCALEBITS);
      bo[x] = uint8_t((tab[3][r] + tab[4][g] + tab[5][b]) >> SCALEBITS);
      ro[x] = uint8_t((tab[5][r] + tab[6][g] + tab[7][b]) >> SCALEBITS);
    }
    for (int x = W; x < yw; x++) yo[x] = yo[W - 1];
    for (int x = W; x < fw; x++) {
      bo[x] = bo[W - 1];
      ro[x] = ro[W - 1];
    }
  }
  for (int y = H; y < yh; y++) std::memcpy(Y.data() + size_t(y) * yw, Y.data() + size_t(H - 1) * yw, size_t(yw));
  for (int y = H; y < fh; y++) {
    std::memcpy(cbf.data() + size_t(y) * fw, cbf.data() + size_t(H - 1) * fw, size_t(fw));
    std::memcpy(crf.data() + size_t(y) * fw, crf.data() + size_t(H - 1) * fw, size_t(fw));
  }
  // jcsample.c h2v2_downsample (bias 1, 2, 1, 2, ... along each row), then
  // the rows below the data repeated to whole blocks
  const int cw = cbw * 8, ch = cbh * 8, crows = fh / 2;
  Cb.resize(size_t(cw) * ch);
  Cr.resize(size_t(cw) * ch);
  for (int pass = 0; pass < 2; pass++) {
    const std::vector<uint8_t>& f = pass ? crf : cbf;
    std::vector<uint8_t>& o = pass ? Cr : Cb;
    for (int y = 0; y < crows; y++) {
      const uint8_t* a = f.data() + size_t(2 * y) * fw;
      const uint8_t* b = a + fw;
      uint8_t* op = o.data() + size_t(y) * cw;
      int bias = 1;
      for (int x = 0; x < cw; x++) {
        op[x] = uint8_t((a[2 * x] + a[2 * x + 1] + b[2 * x] + b[2 * x + 1] + bias) >> 2);
        bias ^= 3;
      }
    }
    for (int y = crows; y < ch; y++)
      std::memcpy(o.data() + size_t(y) * cw, o.data() + size_t(crows - 1) * cw, size_t(cw));
  }

  std::vector<uint8_t> out;
  out.reserve(size_t(W) * H + 1024);
  emit_marker(out, 0xD8);
  // JFIF APP0: version 1.01, no units, density 1:1, no thumbnail
  const uint8_t app0[] = {0xFF, 0xE0, 0x00, 0x10, 'J', 'F', 'I', 'F', 0x00,
                          0x01, 0x01, 0x00, 0x00, 0x01, 0x00, 0x01, 0x00, 0x00};
  out.insert(out.end(), app0, app0 + sizeof(app0));
  for (int t = 0; t < 2; t++) {
    emit_marker(out, 0xDB);
    emit16(out, 67);
    out.push_back(uint8_t(t));
    for (int i = 0; i < 64; i++) out.push_back(uint8_t(qt[t][kNatural[i]]));
  }
  emit_marker(out, 0xC0);
  emit16(out, 17);
  out.push_back(8);
  emit16(out, H);
  emit16(out, W);
  out.push_back(3);
  const uint8_t comps[9] = {1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1};
  out.insert(out.end(), comps, comps + 9);
  emit_dht(out, 0x00, kDcLumaBits, kDcVals);
  emit_dht(out, 0x10, kAcLumaBits, kAcLumaVals);
  emit_dht(out, 0x01, kDcChromaBits, kDcVals);
  emit_dht(out, 0x11, kAcChromaBits, kAcChromaVals);
  const uint8_t sos[] = {0xFF, 0xDA, 0x00, 0x0C, 0x03, 0x01, 0x00, 0x02,
                         0x11, 0x03, 0x11, 0x00, 0x3F, 0x00};
  out.insert(out.end(), sos, sos + sizeof(sos));

  static const EncTable dc_l(kDcLumaBits, kDcVals), ac_l(kAcLumaBits, kAcLumaVals);
  static const EncTable dc_c(kDcChromaBits, kDcVals), ac_c(kAcChromaBits, kAcChromaVals);
  BitWriter bw(out);
  int last_dc[3] = {0, 0, 0};
  int32_t ws[64];
  auto fdct_block = [&](const uint8_t* src, int stride, const Divisor* d, int16_t* blk) {
    for (int r = 0; r < 8; r++)
      for (int c = 0; c < 8; c++) ws[8 * r + c] = int32_t(src[r * stride + c]) - 128;
    fdct_islow(ws);
    for (int i = 0; i < 64; i++) blk[i] = quantize(int16_t(ws[i]), d[i]);
  };
  int16_t yb[4][64], cb[64], cr[64];
  for (int my = 0; my < mcuy; my++) {
    for (int mx = 0; mx < mcux; mx++) {
      // jccoefct.c compress_data: blocks past the image's last block column
      // or row are dummies, AC zero, DC copied from the block before
      for (int by = 0; by < 2; by++) {
        int row = my * 2 + by;
        for (int bx = 0; bx < 2; bx++) {
          int col = mx * 2 + bx;
          int16_t* blk = yb[by * 2 + bx];
          if (row < ybh && col < ybw) {
            fdct_block(Y.data() + size_t(row) * 8 * yw + col * 8, yw, div[0], blk);
          } else {
            std::memset(blk, 0, sizeof(yb[0]));
            blk[0] = row < ybh ? yb[by * 2 + bx - 1][0] : yb[by * 2 - 1][0];
          }
        }
      }
      fdct_block(Cb.data() + size_t(my) * 8 * cw + mx * 8, cw, div[1], cb);
      fdct_block(Cr.data() + size_t(my) * 8 * cw + mx * 8, cw, div[1], cr);
      for (int b = 0; b < 4; b++) encode_block(bw, yb[b], last_dc[0], dc_l, ac_l);
      encode_block(bw, cb, last_dc[1], dc_c, ac_c);
      encode_block(bw, cr, last_dc[2], dc_c, ac_c);
    }
  }
  bw.flush();
  emit_marker(out, 0xD9);
  return out;
}

void set_error(char* err, int errlen, const std::string& msg) {
  if (err && errlen > 0) std::snprintf(err, size_t(errlen), "%s", msg.c_str());
}

}  // namespace

extern "C" {

// Height, width and components of a JPEG (from its frame header). Returns 0,
// or 1 with a message in err.
int jpeg_header(const uint8_t* data, long n, int* height, int* width, int* comps, char* err,
                int errlen) {
  try {
    Jpeg j;
    decode(data, size_t(n), j, true);
    *height = j.height;
    *width = j.width;
    *comps = j.ncomp;
    return 0;
  } catch (const Error& e) {
    set_error(err, errlen, e.msg);
  } catch (const std::bad_alloc&) {
    set_error(err, errlen, "out of memory");
  }
  return 1;
}

// Decode into rgb, (height x width x 3) uint8 as jpeg_header gave them.
int jpeg_decode(const uint8_t* data, long n, uint8_t* rgb, int height, int width, char* err,
                int errlen) {
  try {
    Jpeg j;
    decode(data, size_t(n), j, false);
    if (j.height != height || j.width != width) fail("the output has another shape");
    to_rgb(j, rgb);
    return 0;
  } catch (const Error& e) {
    set_error(err, errlen, e.msg);
  } catch (const std::bad_alloc&) {
    set_error(err, errlen, "out of memory");
  }
  return 1;
}

// Encode (height x width x 3) RGB at quality into out (capacity cap bytes).
// Returns the file's size; its negative when cap is too small (nothing
// written); 0 with a message in err on failure.
long jpeg_encode(const uint8_t* rgb, int height, int width, int quality, uint8_t* out, long cap,
                 char* err, int errlen) {
  try {
    std::vector<uint8_t> buf = encode(rgb, height, width, quality);
    long size = long(buf.size());
    if (size > cap) return -size;
    std::memcpy(out, buf.data(), buf.size());
    return size;
  } catch (const Error& e) {
    set_error(err, errlen, e.msg);
  } catch (const std::bad_alloc&) {
    set_error(err, errlen, "out of memory");
  }
  return 0;
}

// Undo the PNG row filters: raw holds height rows of (1 filter byte +
// rowbytes), out gets height x rowbytes; bpp bytes a pixel. Returns 0, or 1
// for an unknown filter type.
int png_unfilter(const uint8_t* raw, int height, long rowbytes, int bpp, uint8_t* out) {
  const uint8_t* prev = nullptr;
  for (int y = 0; y < height; y++) {
    const uint8_t* in = raw + size_t(y) * size_t(rowbytes + 1);
    uint8_t* o = out + size_t(y) * size_t(rowbytes);
    int f = in[0];
    in++;
    switch (f) {
      case 0:
        std::memcpy(o, in, size_t(rowbytes));
        break;
      case 1:
        for (long x = 0; x < rowbytes; x++)
          o[x] = uint8_t(in[x] + (x >= bpp ? o[x - bpp] : 0));
        break;
      case 2:
        for (long x = 0; x < rowbytes; x++) o[x] = uint8_t(in[x] + (prev ? prev[x] : 0));
        break;
      case 3:
        for (long x = 0; x < rowbytes; x++) {
          int a = x >= bpp ? o[x - bpp] : 0, b = prev ? prev[x] : 0;
          o[x] = uint8_t(in[x] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (long x = 0; x < rowbytes; x++) {
          int a = x >= bpp ? o[x - bpp] : 0, b = prev ? prev[x] : 0;
          int c = (x >= bpp && prev) ? prev[x - bpp] : 0;
          int p = a + b - c;
          int pa = p > a ? p - a : a - p, pb = p > b ? p - b : b - p,
              pc = p > c ? p - c : c - p;
          int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          o[x] = uint8_t(in[x] + pred);
        }
        break;
      default:
        return 1;
    }
    prev = o;
  }
  return 0;
}

}  // extern "C"
