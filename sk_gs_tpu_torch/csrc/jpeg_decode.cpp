// Baseline JPEG decoder on the host, with a plain C interface (loaded with
// ctypes by sk_gs_tpu_torch/utils/jpeg.py; built by cuda_build.HostLibrary
// with c++ -O2, no -ffast-math).
//
// It gives the bytes that libjpeg (libjpeg-turbo, API 6.2, its defaults:
// JDCT_ISLOW, fancy upsampling on) gives Pillow, so that the port loads a
// JPEG frame exactly as the JAX package's loaders do
// (sk_gs_tpu/data/dnerf.py:load_image, np.asarray of the Pillow image):
// [H, W, 3] RGB of a 3-component file, [H, W] of a greyscale one. It
// carries libjpeg's own integer arithmetic:
//   - the Huffman decode of jdhuff.c (a 64-bit bit buffer, an 8-bit
//     look-ahead table, canonical codes to 16 bits; a marker met inside the
//     entropy data is read as zero bits, as libjpeg does);
//   - the islow IDCT of jidctint.c (13-bit constants, its zero-AC
//     shortcuts, its range-limit table indexed with RANGE_MASK, which wraps
//     at 1024 and is no plain clamp);
//   - the upsampling of jdsample.c: fancy (triangle) h2v1 and h2v2 where
//     the component is wider than 2 samples, fancy h1v2, box otherwise;
//     the context row above the first row and below the last real row is
//     that row itself (jdmainct.c); the merged upsampler is off when fancy
//     upsampling is on (jdmaster.c:use_merged_upsample);
//   - the fixed-point YCbCr -> RGB tables of jdcolor.c.
// It reads baseline and extended sequential Huffman files at 8 bits (SOF0,
// SOF1): several DHT / DQT segments, 8- and 16-bit quantisation tables,
// interleaved and non-interleaved scans, restart intervals, partial MCUs
// at odd sizes. Progressive, arithmetic-coded, lossless, hierarchical and
// 12-bit files, and files of other than 1 or 3 components, are refused.
//
// All state lives in one Decoder on the caller's stack: no globals but
// constant tables, so that many files decode at once on a thread pool
// (ctypes releases the interpreter lock for the call).

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct DecodeError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const std::string& why) { throw DecodeError(why); }

// zigzag position -> natural position; 16 extra entries guard a run past
// the block's end (jutils.c:jpeg_natural_order)
const int kNaturalOrder[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct HuffSpec {
  bool defined = false;
  uint8_t bits[17] = {};
  uint8_t vals[256] = {};
};

// jdhuff.c:jpeg_make_d_derived_tbl
struct HuffTable {
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
  uint8_t look_nbits[256];
  uint8_t look_sym[256];

  void derive(const HuffSpec& spec, bool is_dc) {
    if (!spec.defined) fail("a scan uses an undefined Huffman table");
    int huffsize[257];
    uint32_t huffcode[257];
    int p = 0;
    for (int l = 1; l <= 16; l++) {
      int i = spec.bits[l];
      if (p + i > 256) fail("bad Huffman table");
      while (i--) huffsize[p++] = l;
    }
    huffsize[p] = 0;
    const int nsymbols = p;
    uint32_t code = 0;
    int si = huffsize[0];
    p = 0;
    while (huffsize[p]) {
      while (huffsize[p] == si) huffcode[p++] = code++;
      if (code >= (1u << si)) fail("bad Huffman table");
      code <<= 1;
      si++;
    }
    p = 0;
    for (int l = 1; l <= 16; l++) {
      if (spec.bits[l]) {
        valoffset[l] = p - static_cast<int32_t>(huffcode[p]);
        p += spec.bits[l];
        maxcode[l] = static_cast<int32_t>(huffcode[p - 1]);
      } else {
        maxcode[l] = -1;
      }
    }
    valoffset[17] = 0;
    maxcode[17] = 0xFFFFF;
    std::memset(look_nbits, 0, sizeof(look_nbits));
    std::memset(look_sym, 0, sizeof(look_sym));
    p = 0;
    for (int l = 1; l <= 8; l++) {
      for (int i = 1; i <= spec.bits[l]; i++, p++) {
        int lookbits = static_cast<int>(huffcode[p]) << (8 - l);
        for (int ctr = 1 << (8 - l); ctr > 0; ctr--, lookbits++) {
          look_nbits[lookbits] = static_cast<uint8_t>(l);
          look_sym[lookbits] = spec.vals[p];
        }
      }
    }
    std::memcpy(vals, spec.vals, sizeof(vals));
    if (is_dc) {
      for (int i = 0; i < nsymbols; i++)
        if (spec.vals[i] > 15) fail("bad Huffman table");
    }
  }
};

// The entropy-coded data of one scan: FF 00 is a data byte FF; a marker
// stops the reader, which then feeds zero bits (jdhuff.c:
// jpeg_fill_bit_buffer); the end of the file inside a scan is a truncation.
struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;
  int nbits = 0;
  bool at_marker = false;
  bool past_end = false;

  BitReader(const uint8_t* p_, const uint8_t* end_) : p(p_), end(end_) {}

  void fill() {
    while (nbits <= 56) {
      uint32_t c = 0;
      if (!at_marker && !past_end) {
        if (p >= end) {
          past_end = true;
        } else if (*p != 0xFF) {
          c = *p++;
        } else {
          const uint8_t* q = p + 1;
          while (q < end && *q == 0xFF) q++;
          if (q >= end) {
            past_end = true;
          } else if (*q == 0) {
            c = 0xFF;
            p = q + 1;
          } else {
            at_marker = true;  // p stays on an FF before the marker code
            p = q - 1;
          }
        }
      }
      buf |= static_cast<uint64_t>(c) << (56 - nbits);
      nbits += 8;
    }
  }

  uint32_t get(int s) {  // 1 <= s <= 16
    if (nbits < s) fill();
    const uint32_t v = static_cast<uint32_t>(buf >> (64 - s));
    buf <<= s;
    nbits -= s;
    return v;
  }

  int decode(const HuffTable& h) {
    if (nbits < 16) fill();
    const uint32_t peek = static_cast<uint32_t>(buf >> 56);
    const int nb = h.look_nbits[peek];
    if (nb) {
      buf <<= nb;
      nbits -= nb;
      return h.look_sym[peek];
    }
    const uint32_t code16 = static_cast<uint32_t>(buf >> 48);
    for (int l = 9; l <= 16; l++) {
      const int32_t code = static_cast<int32_t>(code16 >> (16 - l));
      if (code <= h.maxcode[l]) {
        buf <<= l;
        nbits -= l;
        return h.vals[(code + h.valoffset[l]) & 0xFF];
      }
    }
    fail("corrupt data: a bad Huffman code");
  }
};

inline int huff_extend(int x, int s) {
  return x < (1 << (s - 1)) ? x + (-(1 << s) + 1) : x;
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;               // the current scan's table selectors
  int dw = 0, dh = 0;               // samples (jdinput.c downsampled_*)
  int wib = 0, hib = 0;             // blocks holding samples
  int bw = 0, bh = 0;               // blocks allocated (whole MCUs)
  bool quant_latched = false;
  bool scanned = false;
  int16_t quant[64] = {};           // natural order, as ISLOW_MULT_TYPE
  std::vector<int16_t> coef;        // [bh][bw][64] natural order
};

// jidctint.c:jpeg_idct_islow
constexpr int CONST_BITS = 13;
constexpr int PASS1_BITS = 2;
constexpr int64_t FIX_0_298631336 = 2446;
constexpr int64_t FIX_0_390180644 = 3196;
constexpr int64_t FIX_0_541196100 = 4433;
constexpr int64_t FIX_0_765366865 = 6270;
constexpr int64_t FIX_0_899976223 = 7373;
constexpr int64_t FIX_1_175875602 = 9633;
constexpr int64_t FIX_1_501321110 = 12299;
constexpr int64_t FIX_1_847759065 = 15137;
constexpr int64_t FIX_1_961570560 = 16069;
constexpr int64_t FIX_2_053119869 = 16819;
constexpr int64_t FIX_2_562915447 = 20995;
constexpr int64_t FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) {
  return (x + (int64_t{1} << (n - 1))) >> n;
}

// jdmaster.c:prepare_range_limit_table seen from the IDCT
// (sample_range_limit + CENTERJSAMPLE), indexed by x & RANGE_MASK (1023)
inline uint8_t idct_limit(int64_t x) {
  const int v = static_cast<int>(x) & 1023;
  if (v < 128) return static_cast<uint8_t>(v + 128);
  if (v < 512) return 255;
  if (v < 896) return 0;
  return static_cast<uint8_t>(v - 896);
}

void idct_islow(const int16_t* in, const int16_t* quant, uint8_t* out,
                int stride) {
  int ws[64];
  for (int c = 0; c < 8; c++) {
    const int16_t* ip = in + c;
    const int16_t* qp = quant + c;
    int* wp = ws + c;
    if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 &&
        ip[40] == 0 && ip[48] == 0 && ip[56] == 0) {
      const int dc = (ip[0] * qp[0]) * (1 << PASS1_BITS);
      for (int r = 0; r < 8; r++) wp[8 * r] = dc;
      continue;
    }
    int64_t z2 = ip[16] * qp[16];
    int64_t z3 = ip[48] * qp[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = ip[0] * qp[0];
    z3 = ip[32] * qp[32];
    int64_t tmp0 = (z2 + z3) * (int64_t{1} << CONST_BITS);
    int64_t tmp1 = (z2 - z3) * (int64_t{1} << CONST_BITS);
    const int64_t tmp10 = tmp0 + tmp3;
    const int64_t tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2;
    const int64_t tmp12 = tmp1 - tmp2;

    tmp0 = ip[56] * qp[56];
    tmp1 = ip[40] * qp[40];
    tmp2 = ip[24] * qp[24];
    tmp3 = ip[8] * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 = tmp0 * FIX_0_298631336;
    tmp1 = tmp1 * FIX_2_053119869;
    tmp2 = tmp2 * FIX_3_072711026;
    tmp3 = tmp3 * FIX_1_501321110;
    z1 = z1 * -FIX_0_899976223;
    z2 = z2 * -FIX_2_562915447;
    z3 = z3 * -FIX_1_961570560;
    z4 = z4 * -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;

    const int n = CONST_BITS - PASS1_BITS;
    wp[0] = static_cast<int>(descale(tmp10 + tmp3, n));
    wp[56] = static_cast<int>(descale(tmp10 - tmp3, n));
    wp[8] = static_cast<int>(descale(tmp11 + tmp2, n));
    wp[48] = static_cast<int>(descale(tmp11 - tmp2, n));
    wp[16] = static_cast<int>(descale(tmp12 + tmp1, n));
    wp[40] = static_cast<int>(descale(tmp12 - tmp1, n));
    wp[24] = static_cast<int>(descale(tmp13 + tmp0, n));
    wp[32] = static_cast<int>(descale(tmp13 - tmp0, n));
  }
  for (int r = 0; r < 8; r++) {
    const int* wp = ws + 8 * r;
    uint8_t* op = out + static_cast<ptrdiff_t>(r) * stride;
    if (wp[1] == 0 && wp[2] == 0 && wp[3] == 0 && wp[4] == 0 && wp[5] == 0 &&
        wp[6] == 0 && wp[7] == 0) {
      const uint8_t dc = idct_limit(descale(wp[0], PASS1_BITS + 3));
      for (int c = 0; c < 8; c++) op[c] = dc;
      continue;
    }
    int64_t z2 = wp[2];
    int64_t z3 = wp[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = (int64_t{wp[0]} + wp[4]) * (int64_t{1} << CONST_BITS);
    int64_t tmp1 = (int64_t{wp[0]} - wp[4]) * (int64_t{1} << CONST_BITS);
    const int64_t tmp10 = tmp0 + tmp3;
    const int64_t tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2;
    const int64_t tmp12 = tmp1 - tmp2;

    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 = tmp0 * FIX_0_298631336;
    tmp1 = tmp1 * FIX_2_053119869;
    tmp2 = tmp2 * FIX_3_072711026;
    tmp3 = tmp3 * FIX_1_501321110;
    z1 = z1 * -FIX_0_899976223;
    z2 = z2 * -FIX_2_562915447;
    z3 = z3 * -FIX_1_961570560;
    z4 = z4 * -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;

    const int n = CONST_BITS + PASS1_BITS + 3;
    op[0] = idct_limit(descale(tmp10 + tmp3, n));
    op[7] = idct_limit(descale(tmp10 - tmp3, n));
    op[1] = idct_limit(descale(tmp11 + tmp2, n));
    op[6] = idct_limit(descale(tmp11 - tmp2, n));
    op[2] = idct_limit(descale(tmp12 + tmp1, n));
    op[5] = idct_limit(descale(tmp12 - tmp1, n));
    op[3] = idct_limit(descale(tmp13 + tmp0, n));
    op[4] = idct_limit(descale(tmp13 - tmp0, n));
  }
}

inline uint8_t clamp255(int x) {
  return static_cast<uint8_t>(x < 0 ? 0 : (x > 255 ? 255 : x));
}

class Decoder {
 public:
  Decoder(const uint8_t* data, size_t n) : data_(data), n_(n) {}

  // Reads the markers up to the frame header; the image's size.
  void read_info(int* h, int* w, int* c) {
    parse(true);
    *h = height_;
    *w = width_;
    *c = ncomp_;
  }

  void decode(uint8_t* out, size_t out_size) {
    parse(false);
    const size_t need = static_cast<size_t>(height_) * width_ * ncomp_;
    if (out_size != need) fail("output buffer of the wrong size");
    for (int ci = 0; ci < ncomp_; ci++)
      if (!comp_[ci].scanned) fail("a component has no scan");
    std::vector<std::vector<uint8_t>> full(ncomp_);
    for (int ci = 0; ci < ncomp_; ci++) full[ci] = upsampled(comp_[ci]);
    const size_t npix = static_cast<size_t>(height_) * width_;
    if (ncomp_ == 1) {
      std::memcpy(out, full[0].data(), npix);
    } else if (rgb_) {
      for (size_t i = 0; i < npix; i++)
        for (int ci = 0; ci < 3; ci++) out[3 * i + ci] = full[ci][i];
    } else {
      ycc_to_rgb(full[0].data(), full[1].data(), full[2].data(), out, npix);
    }
  }

 private:
  const uint8_t* data_;
  size_t n_;
  size_t pos_ = 0;
  int width_ = 0, height_ = 0, ncomp_ = 0;
  int maxh_ = 1, maxv_ = 1;
  int mcux_ = 0, mcuy_ = 0;  // MCUs of an interleaved scan
  bool frame_ = false;
  bool jfif_ = false, adobe_ = false, rgb_ = false;
  int adobe_transform_ = -1;
  int restart_interval_ = 0;
  Component comp_[4];
  uint16_t quant_[4][64] = {};
  bool quant_defined_[4] = {};
  HuffSpec dc_spec_[4], ac_spec_[4];

  int byte_at(size_t i) const {
    if (i >= n_) fail("truncated file");
    return data_[i];
  }
  int u16_at(size_t i) const { return (byte_at(i) << 8) | byte_at(i + 1); }

  // The next marker at or after pos_ (jdmarker.c:next_marker: bytes that
  // are no marker are skipped, FF fill bytes too); pos_ then follows it.
  int next_marker() {
    for (;;) {
      while (byte_at(pos_) != 0xFF) pos_++;
      while (byte_at(pos_) == 0xFF) pos_++;
      const int m = byte_at(pos_);
      pos_++;
      if (m != 0) return m;
    }
  }

  void parse(bool header_only) {
    if (n_ < 2 || data_[0] != 0xFF || data_[1] != 0xD8)
      fail("not a JPEG file (no start-of-image marker)");
    pos_ = 2;
    for (;;) {
      const int m = next_marker();
      if (m == 0xD9) {  // EOI
        if (!frame_) fail("no frame header before the end of the image");
        if (header_only) fail("no scan in the file");
        return;
      }
      if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;  // TEM, RSTn
      const size_t len = static_cast<size_t>(u16_at(pos_));
      if (len < 2) fail("bad marker length");
      const size_t body = pos_ + 2, next = pos_ + len;
      if (next > n_) fail("truncated file");
      switch (m) {
        case 0xC0:
        case 0xC1:
          read_frame(body, len - 2);
          if (header_only) return;
          break;
        case 0xC2:
        case 0xC6:
        case 0xCA:
        case 0xCE:
          fail("progressive JPEG is not supported (baseline only)");
        case 0xC3:
        case 0xC7:
        case 0xCB:
        case 0xCF:
          fail("lossless JPEG is not supported (baseline only)");
        case 0xC5:
          fail("hierarchical JPEG is not supported (baseline only)");
        case 0xC9:
        case 0xCC:
        case 0xCD:
          fail("arithmetic-coded JPEG is not supported (baseline only)");
        case 0xC4:
          read_dht(body, len - 2);
          break;
        case 0xDB:
          read_dqt(body, len - 2);
          break;
        case 0xDD:
          if (len != 4) fail("bad restart interval segment");
          restart_interval_ = u16_at(body);
          break;
        case 0xDC:
          fail("a DNL marker (image height in the scan) is not supported");
        case 0xE0:
          if (len - 2 >= 14 && std::memcmp(data_ + body, "JFIF\0", 5) == 0)
            jfif_ = true;
          break;
        case 0xEE:
          if (len - 2 >= 12 && std::memcmp(data_ + body, "Adobe", 5) == 0) {
            adobe_ = true;
            adobe_transform_ = data_[body + 11];
          }
          break;
        case 0xDA:
          if (!frame_) fail("a scan before the frame header");
          if (header_only) fail("a scan before the frame header");
          pos_ = next;
          read_scan(body, len - 2);
          continue;  // pos_ is left at the marker after the scan
        default:
          break;  // APPn, COM and others: skipped
      }
      pos_ = next;
    }
  }

  void read_frame(size_t p, size_t len) {
    if (frame_) fail("two frame headers");
    if (len < 6) fail("bad frame header");
    const int precision = byte_at(p);
    if (precision != 8)
      fail(std::to_string(precision) +
           "-bit JPEG is not supported (8-bit only)");
    height_ = u16_at(p + 1);
    width_ = u16_at(p + 3);
    ncomp_ = byte_at(p + 5);
    if (height_ == 0) fail("a DNL marker (image height in the scan) is not "
                           "supported");
    if (width_ == 0) fail("empty image");
    if (ncomp_ == 4)
      fail("CMYK/YCCK JPEG is not supported (greyscale or 3 components)");
    if (ncomp_ != 1 && ncomp_ != 3)
      fail(std::to_string(ncomp_) +
           "-component JPEG is not supported (greyscale or 3 components)");
    if (len != static_cast<size_t>(6 + 3 * ncomp_)) fail("bad frame header");
    for (int ci = 0; ci < ncomp_; ci++) {
      Component& c = comp_[ci];
      c.id = byte_at(p + 6 + 3 * ci);
      c.h = byte_at(p + 7 + 3 * ci) >> 4;
      c.v = byte_at(p + 7 + 3 * ci) & 15;
      c.tq = byte_at(p + 8 + 3 * ci);
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4)
        fail("bad sampling factors");
      if (c.tq > 3) fail("bad quantisation table selector");
      maxh_ = std::max(maxh_, c.h);
      maxv_ = std::max(maxv_, c.v);
    }
    mcux_ = (width_ + 8 * maxh_ - 1) / (8 * maxh_);
    mcuy_ = (height_ + 8 * maxv_ - 1) / (8 * maxv_);
    for (int ci = 0; ci < ncomp_; ci++) {
      Component& c = comp_[ci];
      if (maxh_ % c.h || maxv_ % c.v)
        fail("non-integral sampling factors are not supported");
      c.dw = (width_ * c.h + maxh_ - 1) / maxh_;
      c.dh = (height_ * c.v + maxv_ - 1) / maxv_;
      c.wib = (c.dw + 7) / 8;
      c.hib = (c.dh + 7) / 8;
      c.bw = mcux_ * c.h;
      c.bh = mcuy_ * c.v;
    }
    // jdapimin.c:default_decompress_parms
    if (ncomp_ == 3) {
      if (jfif_) {
        rgb_ = false;
      } else if (adobe_) {
        rgb_ = adobe_transform_ == 0;
      } else {
        rgb_ = comp_[0].id == 82 && comp_[1].id == 71 && comp_[2].id == 66;
      }
    }
    frame_ = true;
  }

  void read_dqt(size_t p, size_t len) {
    const size_t end = p + len;
    while (p < end) {
      const int pq = byte_at(p) >> 4, tq = byte_at(p) & 15;
      p++;
      if (tq > 3 || pq > 1) fail("bad quantisation table");
      for (int k = 0; k < 64; k++) {
        const int q = pq ? u16_at(p + 2 * k) : byte_at(p + k);
        quant_[tq][kNaturalOrder[k]] = static_cast<uint16_t>(q);
      }
      p += pq ? 128 : 64;
      quant_defined_[tq] = true;
    }
    if (p != end) fail("bad quantisation table segment");
  }

  void read_dht(size_t p, size_t len) {
    const size_t end = p + len;
    while (p < end) {
      const int tc = byte_at(p) >> 4, th = byte_at(p) & 15;
      p++;
      if (tc > 1 || th > 3) fail("bad Huffman table");
      HuffSpec& s = tc ? ac_spec_[th] : dc_spec_[th];
      int count = 0;
      s.bits[0] = 0;
      for (int l = 1; l <= 16; l++) {
        s.bits[l] = static_cast<uint8_t>(byte_at(p + l - 1));
        count += s.bits[l];
      }
      p += 16;
      if (count > 256) fail("bad Huffman table");
      std::memset(s.vals, 0, sizeof(s.vals));
      for (int i = 0; i < count; i++)
        s.vals[i] = static_cast<uint8_t>(byte_at(p + i));
      p += count;
      s.defined = true;
    }
    if (p != end) fail("bad Huffman table segment");
  }

  void read_scan(size_t p, size_t len) {
    const int ns = byte_at(p);
    if (ns < 1 || ns > 4 || len != static_cast<size_t>(4 + 2 * ns))
      fail("bad scan header");
    Component* sc[4];
    for (int i = 0; i < ns; i++) {
      const int id = byte_at(p + 1 + 2 * i);
      const int t = byte_at(p + 2 + 2 * i);
      Component* found = nullptr;
      for (int ci = 0; ci < ncomp_; ci++)
        if (comp_[ci].id == id) found = &comp_[ci];
      if (!found) fail("a scan names an unknown component");
      for (int j = 0; j < i; j++)
        if (sc[j] == found) fail("a scan names a component twice");
      found->td = t >> 4;
      found->ta = t & 15;
      if (found->td > 3 || found->ta > 3) fail("bad Huffman table selector");
      sc[i] = found;
    }
    // the tables in force at the scan's start; a component's quantisation
    // table is latched at its first scan (jdinput.c:latch_quant_tables)
    HuffTable dc[4], ac[4];
    for (int i = 0; i < ns; i++) {
      Component& c = *sc[i];
      dc[i].derive(dc_spec_[c.td], true);
      ac[i].derive(ac_spec_[c.ta], false);
      if (!c.quant_latched) {
        if (!quant_defined_[c.tq]) fail("a scan uses an undefined "
                                        "quantisation table");
        for (int k = 0; k < 64; k++)
          c.quant[k] = static_cast<int16_t>(quant_[c.tq][k]);
        c.quant_latched = true;
      }
      if (c.coef.empty())
        c.coef.assign(static_cast<size_t>(c.bw) * c.bh * 64, 0);
      c.scanned = true;
    }

    BitReader br(data_ + pos_, data_ + n_);
    int pred[4] = {0, 0, 0, 0};
    int restarts_to_go = restart_interval_;
    int next_rst = 0;
    int blocks_per_mcu = 0;
    for (int i = 0; i < ns; i++) blocks_per_mcu += sc[i]->h * sc[i]->v;
    if (ns > 1 && blocks_per_mcu > 10) fail("too many blocks in an MCU");
    const int mcus_x = ns == 1 ? sc[0]->wib : mcux_;
    const int mcus_y = ns == 1 ? sc[0]->hib : mcuy_;

    auto block = [&](int i, int bx, int by) {
      Component& c = *sc[i];
      int16_t* b = &c.coef[(static_cast<size_t>(by) * c.bw + bx) * 64];
      const int s0 = br.decode(dc[i]);
      const int diff = s0 ? huff_extend(static_cast<int>(br.get(s0)), s0) : 0;
      pred[i] += diff;
      b[0] = static_cast<int16_t>(pred[i]);
      for (int k = 1; k < 64; k++) {
        int s = br.decode(ac[i]);
        const int r = s >> 4;
        s &= 15;
        if (s) {
          k += r;
          b[kNaturalOrder[k]] = static_cast<int16_t>(
              huff_extend(static_cast<int>(br.get(s)), s));
        } else {
          if (r != 15) break;
          k += 15;
        }
      }
    };

    for (int my = 0; my < mcus_y; my++) {
      for (int mx = 0; mx < mcus_x; mx++) {
        if (restart_interval_) {
          if (restarts_to_go == 0) {
            restart(br, next_rst);
            next_rst = (next_rst + 1) & 7;
            for (int i = 0; i < 4; i++) pred[i] = 0;
            restarts_to_go = restart_interval_;
          }
          restarts_to_go--;
        }
        if (ns == 1) {
          block(0, mx, my);
        } else {
          for (int i = 0; i < ns; i++)
            for (int y = 0; y < sc[i]->v; y++)
              for (int x = 0; x < sc[i]->h; x++)
                block(i, mx * sc[i]->h + x, my * sc[i]->v + y);
        }
        if (br.past_end) fail("truncated file (the scan's data ends early)");
      }
    }
    pos_ = static_cast<size_t>(br.p - data_);
  }

  // jdhuff.c:process_restart + jdmarker.c:read_restart_marker: the bits
  // left in the buffer are dropped, the marker must be the next RSTn.
  void restart(BitReader& br, int expected) {
    br.buf = 0;
    br.nbits = 0;
    pos_ = static_cast<size_t>(br.p - data_);
    const int m = next_marker();
    if (m != 0xD0 + expected) fail("corrupt data: a missing restart marker");
    br.p = data_ + pos_;
    br.at_marker = false;
  }

  // One component's samples upsampled to [height_, width_] (jdsample.c).
  std::vector<uint8_t> upsampled(const Component& c) const {
    const int pw = c.wib * 8, ph = c.hib * 8;
    std::vector<uint8_t> plane(static_cast<size_t>(pw) * ph);
    for (int by = 0; by < c.hib; by++)
      for (int bx = 0; bx < c.wib; bx++)
        idct_islow(&c.coef[(static_cast<size_t>(by) * c.bw + bx) * 64],
                   c.quant, &plane[static_cast<size_t>(by) * 8 * pw + bx * 8],
                   pw);
    const int hx = maxh_ / c.h, vy = maxv_ / c.v;
    const int W = width_, H = height_, dw = c.dw, dh = c.dh;
    std::vector<uint8_t> out(static_cast<size_t>(W) * H);
    // the context rows: above the first row and below the last real row,
    // that row itself (jdmainct.c)
    auto row = [&](int r) {
      r = std::min(std::max(r, 0), dh - 1);
      return plane.data() + static_cast<size_t>(r) * pw;
    };
    std::vector<uint8_t> wide(static_cast<size_t>(2) * dw + 2);
    for (int yo = 0; yo < H; yo++) {
      uint8_t* op = out.data() + static_cast<size_t>(yo) * W;
      if (hx == 1 && vy == 1) {
        std::memcpy(op, row(yo), W);
      } else if (hx == 2 && vy == 1 && dw > 2) {  // h2v1_fancy_upsample
        const uint8_t* ip = row(yo);
        uint8_t* w = wide.data();
        w[0] = ip[0];
        w[1] = static_cast<uint8_t>((ip[0] * 3 + ip[1] + 2) >> 2);
        for (int i = 1; i < dw - 1; i++) {
          const int x3 = ip[i] * 3;
          w[2 * i] = static_cast<uint8_t>((x3 + ip[i - 1] + 1) >> 2);
          w[2 * i + 1] = static_cast<uint8_t>((x3 + ip[i + 1] + 2) >> 2);
        }
        w[2 * dw - 2] =
            static_cast<uint8_t>((ip[dw - 1] * 3 + ip[dw - 2] + 1) >> 2);
        w[2 * dw - 1] = ip[dw - 1];
        std::memcpy(op, w, W);
      } else if (hx == 1 && vy == 2) {  // h1v2_fancy_upsample
        const int r = yo >> 1, below = yo & 1;
        const uint8_t* i0 = row(r);
        const uint8_t* i1 = row(below ? r + 1 : r - 1);
        const int bias = below ? 2 : 1;
        for (int x = 0; x < W; x++)
          op[x] = static_cast<uint8_t>((i0[x] * 3 + i1[x] + bias) >> 2);
      } else if (hx == 2 && vy == 2 && dw > 2) {  // h2v2_fancy_upsample
        const int r = yo >> 1, below = yo & 1;
        const uint8_t* i0 = row(r);
        const uint8_t* i1 = row(below ? r + 1 : r - 1);
        uint8_t* w = wide.data();
        int this_sum = i0[0] * 3 + i1[0];
        int next_sum = i0[1] * 3 + i1[1];
        w[0] = static_cast<uint8_t>((this_sum * 4 + 8) >> 4);
        w[1] = static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
        int last_sum = this_sum;
        this_sum = next_sum;
        for (int i = 1; i < dw - 1; i++) {
          next_sum = i0[i + 1] * 3 + i1[i + 1];
          w[2 * i] = static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
          w[2 * i + 1] =
              static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
          last_sum = this_sum;
          this_sum = next_sum;
        }
        w[2 * dw - 2] =
            static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
        w[2 * dw - 1] = static_cast<uint8_t>((this_sum * 4 + 7) >> 4);
        std::memcpy(op, w, W);
      } else {  // box: h2v1_upsample, h2v2_upsample, int_upsample
        const uint8_t* ip = row(yo / vy);
        for (int x = 0; x < W; x++) op[x] = ip[x / hx];
      }
    }
    return out;
  }

  // jdcolor.c:build_ycc_rgb_table + ycc_rgb_convert
  static void ycc_to_rgb(const uint8_t* y, const uint8_t* cb,
                         const uint8_t* cr, uint8_t* out, size_t npix) {
    constexpr int SCALEBITS = 16;
    constexpr int64_t ONE_HALF = int64_t{1} << (SCALEBITS - 1);
    auto fix = [](double x) {
      return static_cast<int64_t>(x * (1L << SCALEBITS) + 0.5);
    };
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    for (int i = 0; i < 256; i++) {
      const int64_t x = i - 128;
      cr_r[i] = static_cast<int>((fix(1.40200) * x + ONE_HALF) >> SCALEBITS);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + ONE_HALF) >> SCALEBITS);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + ONE_HALF;
    }
    for (size_t i = 0; i < npix; i++) {
      const int yy = y[i], b = cb[i], r = cr[i];
      out[3 * i] = clamp255(yy + cr_r[r]);
      out[3 * i + 1] = clamp255(
          yy + static_cast<int>((cb_g[b] + cr_g[r]) >> SCALEBITS));
      out[3 * i + 2] = clamp255(yy + cb_b[b]);
    }
  }
};

void set_error(char* err, int errlen, const char* what) {
  if (err && errlen > 0) {
    std::strncpy(err, what, static_cast<size_t>(errlen) - 1);
    err[errlen - 1] = '\0';
  }
}

}  // namespace

extern "C" {

// The image's height, width and components (1 or 3); 0, or 1 with the
// reason in ``err``.
int sk_jpeg_info(const uint8_t* data, size_t n, int* height, int* width,
                 int* channels, char* err, int errlen) {
  try {
    Decoder(data, n).read_info(height, width, channels);
    return 0;
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return 1;
  }
}

// Decodes into ``out`` [height, width, channels] uint8 (its size in
// ``out_size``); 0, or 1 with the reason in ``err``.
int sk_jpeg_decode(const uint8_t* data, size_t n, uint8_t* out,
                   size_t out_size, char* err, int errlen) {
  try {
    Decoder(data, n).decode(out, out_size);
    return 0;
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return 1;
  }
}

}  // extern "C"
