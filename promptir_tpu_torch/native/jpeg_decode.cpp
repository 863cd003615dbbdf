// Baseline JPEG decoder with a plain C interface, bound by
// promptir_tpu_torch/utils/jpeg.py through ctypes.
//
// Its output equals libjpeg's (and libjpeg-turbo's, which PIL bundles) with
// the default decompression settings, bit for bit:
//   * baseline (SOF0) and extended (SOF1) sequential Huffman, 8-bit samples,
//     interleaved or non-interleaved scans, restart intervals;
//   * 1 or 3 components; chroma at 4:4:4, 4:2:2 (h2v1) or 4:2:0 (h2v2);
//   * jidctint.c's ISLOW integer IDCT with its range-limit table;
//   * jdsample.c's fancy (triangle) upsampling, its edge handling and its
//     fall-back to replication where the chroma is 2 samples wide or less;
//   * jdcolor.c's fixed-point YCbCr -> RGB, its colour-space guess from the
//     JFIF / Adobe markers and the component ids; gray replicated to RGB.
// Progressive, arithmetic-coded, lossless, hierarchical, 12-bit and
// 4-component (CMYK / YCCK) files are refused with a message naming the
// feature. Truncated entropy data decodes as zeros, as libjpeg does. A
// Huffman table that libjpeg refuses (a code that does not fit its length,
// a DC symbol above 15) is refused when a scan uses it, as libjpeg does,
// and an image of more pixels than PIL opens is refused at its frame.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

const int kZigzag[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    // as libjpeg's jpeg_natural_order: a corrupt run past 63 lands on 63
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Error {
  std::string msg;
};

// PIL raises DecompressionBombError past twice Image.MAX_IMAGE_PIXELS
const int64_t kMaxPixels = 2 * int64_t(89478485);

struct Huffman {
  bool defined = false;
  bool bad = false;       // refused by jdhuff.c's jpeg_make_d_derived_tbl
  uint8_t look_len[256];  // code length of an 8-bit prefix, 0: longer
  uint8_t look_val[256];
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
};

struct Component {
  int id, h, v, tq;
  int dc_table = 0, ac_table = 0, pred = 0;
  int width, height;    // downsampled size in samples
  int bw, bh;           // blocks allocated (whole MCUs)
  std::vector<uint8_t> plane;  // bw*8 x bh*8 samples
  bool quant_latched = false;
  int32_t quant[64];    // natural order, latched at the first scan
};

struct Bits {
  const uint8_t* d;
  size_t n, pos;
  uint64_t buf = 0;
  int cnt = 0;
  bool hit_marker = false;

  void fill() {
    while (cnt <= 56) {
      uint32_t b = 0;
      if (!hit_marker && pos < n) {
        b = d[pos];
        if (b == 0xFF) {
          uint8_t nx = pos + 1 < n ? d[pos + 1] : 0xD9;
          if (nx == 0x00) {
            pos += 2;
          } else {  // a marker ends the data: zeros from here on
            hit_marker = true;
            b = 0;
          }
        } else {
          ++pos;
        }
      }
      buf |= uint64_t(b) << (56 - cnt);
      cnt += 8;
    }
  }
  int peek(int k) {
    if (cnt < k) fill();
    return int(buf >> (64 - k));
  }
  void skip(int k) {
    buf <<= k;
    cnt -= k;
  }
  int get(int k) {
    if (k == 0) return 0;
    int v = peek(k);
    skip(k);
    return v;
  }
  void reset() {
    buf = 0;
    cnt = 0;
  }
};

int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

int decode_symbol(Bits& b, const Huffman& h) {
  int look = b.peek(8);
  if (int len = h.look_len[look]) {
    b.skip(len);
    return h.look_val[look];
  }
  for (int l = 9; l <= 16; ++l) {
    int code = b.peek(l);
    if (code <= h.maxcode[l]) {
      b.skip(l);
      return h.vals[(h.valoffset[l] + code) & 0xFF];
    }
  }
  b.skip(16);  // corrupt data: libjpeg warns and returns 0
  return 0;
}

// jidctint.c (libjpeg 6b / libjpeg-turbo), 8-bit samples
const int kConstBits = 13, kPass1Bits = 2;
const int32_t F0_298 = 2446, F0_390 = 3196, F0_541 = 4433, F0_765 = 6270,
              F0_899 = 7373, F1_175 = 9633, F1_501 = 12299, F1_847 = 15137,
              F1_961 = 16069, F2_053 = 16819, F2_562 = 20995, F3_072 = 25172;

inline int32_t descale(int64_t x, int n) {
  return int32_t((x + (int64_t(1) << (n - 1))) >> n);
}

// the post-IDCT range limit: index (value & 1023) of the centred output
inline uint8_t idct_limit(int32_t x) {
  int i = x & 1023;
  if (i < 128) return uint8_t(i + 128);
  if (i < 512) return 255;
  if (i < 896) return 0;
  return uint8_t(i - 896);
}

void idct_islow(const int16_t* coef, const int32_t* q, uint8_t* out,
                int stride) {
  int32_t ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* in = coef + c;
    const int32_t* qc = q + c;
    int32_t* w = ws + c;
    if (!in[8] && !in[16] && !in[24] && !in[32] && !in[40] && !in[48] &&
        !in[56]) {
      int32_t dc = (int32_t(in[0]) * qc[0]) * (1 << kPass1Bits);
      for (int r = 0; r < 8; ++r) w[8 * r] = dc;
      continue;
    }
    int64_t z2 = int64_t(in[16]) * qc[16], z3 = int64_t(in[48]) * qc[48];
    int64_t z1 = (z2 + z3) * F0_541;
    int64_t tmp2 = z1 + z3 * -F1_847, tmp3 = z1 + z2 * F0_765;
    z2 = int64_t(in[0]) * qc[0];
    z3 = int64_t(in[32]) * qc[32];
    int64_t tmp0 = (z2 + z3) * (1 << kConstBits);
    int64_t tmp1 = (z2 - z3) * (1 << kConstBits);
    int64_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3, t11 = tmp1 + tmp2,
            t12 = tmp1 - tmp2;
    tmp0 = int64_t(in[56]) * qc[56];
    tmp1 = int64_t(in[40]) * qc[40];
    tmp2 = int64_t(in[24]) * qc[24];
    tmp3 = int64_t(in[8]) * qc[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F1_175;
    tmp0 *= F0_298;
    tmp1 *= F2_053;
    tmp2 *= F3_072;
    tmp3 *= F1_501;
    z1 *= -F0_899;
    z2 *= -F2_562;
    z3 = z3 * -F1_961 + z5;
    z4 = z4 * -F0_390 + z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int n = kConstBits - kPass1Bits;
    w[0] = descale(t10 + tmp3, n);
    w[56] = descale(t10 - tmp3, n);
    w[8] = descale(t11 + tmp2, n);
    w[48] = descale(t11 - tmp2, n);
    w[16] = descale(t12 + tmp1, n);
    w[40] = descale(t12 - tmp1, n);
    w[24] = descale(t13 + tmp0, n);
    w[32] = descale(t13 - tmp0, n);
  }
  for (int r = 0; r < 8; ++r) {
    const int32_t* w = ws + 8 * r;
    uint8_t* o = out + r * stride;
    if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
      uint8_t v = idct_limit(descale(w[0], kPass1Bits + 3));
      for (int c = 0; c < 8; ++c) o[c] = v;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * F0_541;
    int64_t tmp2 = z1 + z3 * -F1_847, tmp3 = z1 + z2 * F0_765;
    int64_t tmp0 = (int64_t(w[0]) + w[4]) * (1 << kConstBits);
    int64_t tmp1 = (int64_t(w[0]) - w[4]) * (1 << kConstBits);
    int64_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3, t11 = tmp1 + tmp2,
            t12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F1_175;
    tmp0 *= F0_298;
    tmp1 *= F2_053;
    tmp2 *= F3_072;
    tmp3 *= F1_501;
    z1 *= -F0_899;
    z2 *= -F2_562;
    z3 = z3 * -F1_961 + z5;
    z4 = z4 * -F0_390 + z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int n = kConstBits + kPass1Bits + 3;
    o[0] = idct_limit(descale(t10 + tmp3, n));
    o[7] = idct_limit(descale(t10 - tmp3, n));
    o[1] = idct_limit(descale(t11 + tmp2, n));
    o[6] = idct_limit(descale(t11 - tmp2, n));
    o[2] = idct_limit(descale(t12 + tmp1, n));
    o[5] = idct_limit(descale(t12 - tmp1, n));
    o[3] = idct_limit(descale(t13 + tmp0, n));
    o[4] = idct_limit(descale(t13 - tmp0, n));
  }
}

class Decoder {
 public:
  Decoder(const uint8_t* d, size_t n) : d_(d), n_(n) {}

  // Parse up to the first scan: the size and the component count.
  void header(int* w, int* h) {
    if (n_ < 4 || d_[0] != 0xFF || d_[1] != 0xD8) throw Error{"not a JPEG"};
    pos_ = 2;
    while (!frame_seen_) segment();
    *w = width_;
    *h = height_;
  }

  void decode(uint8_t* rgb) {
    int w, h;
    header(&w, &h);
    for (auto& c : comps_) {
      c.bw = mcux_ * (ncomp_ == 1 ? 1 : c.h);
      c.bh = mcuy_ * (ncomp_ == 1 ? 1 : c.v);
      c.plane.assign(size_t(c.bw) * 8 * c.bh * 8, 0);
    }
    while (!eoi_ && pos_ < n_) segment();
    if (scans_ == 0) throw Error{"no scan"};
    convert(rgb);
  }

 private:
  const uint8_t* d_;
  size_t n_, pos_ = 0;
  bool frame_seen_ = false, eoi_ = false;
  bool jfif_ = false, adobe_ = false;
  int adobe_transform_ = -1;
  int width_ = 0, height_ = 0, ncomp_ = 0, hmax_ = 1, vmax_ = 1;
  int mcux_ = 0, mcuy_ = 0, restart_ = 0, scans_ = 0;
  std::vector<Component> comps_;
  int32_t qt_[4][64];
  bool qt_defined_[4] = {false, false, false, false};
  Huffman dc_[4], ac_[4];

  int u8() {
    if (pos_ >= n_) throw Error{"truncated file"};
    return d_[pos_++];
  }
  int u16() {
    int hi = u8();
    return (hi << 8) | u8();
  }

  void segment() {
    int b = u8();
    if (b != 0xFF) throw Error{"expected a marker"};
    int m;
    do m = u8();
    while (m == 0xFF);
    if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) return;
    if (m == 0xD9) {
      eoi_ = true;
      return;
    }
    size_t len = size_t(u16());
    if (len < 2 || pos_ + len - 2 > n_) throw Error{"truncated segment"};
    size_t end = pos_ + len - 2;
    switch (m) {
      case 0xC0: case 0xC1: frame(end); break;
      case 0xC2: case 0xC6: throw Error{"progressive JPEG is not supported"};
      case 0xC3: case 0xC7: throw Error{"lossless JPEG is not supported"};
      case 0xC5: throw Error{"hierarchical JPEG is not supported"};
      case 0xC9: case 0xCA: case 0xCB: case 0xCD: case 0xCE: case 0xCF:
        throw Error{"arithmetic-coded JPEG is not supported"};
      case 0xC4: huffman(end); break;
      case 0xCC: throw Error{"arithmetic-coded JPEG is not supported"};
      case 0xDB: quant(end); break;
      case 0xDD: restart_ = u16(); break;
      case 0xDA: scan(end); return;  // scan() moves pos_ itself
      case 0xE0:
        if (len >= 7 && !memcmp(d_ + pos_, "JFIF\0", 5)) jfif_ = true;
        break;
      case 0xEE:
        if (len >= 14 && !memcmp(d_ + pos_, "Adobe", 5)) {
          adobe_ = true;
          adobe_transform_ = d_[pos_ + 11];
        }
        break;
      case 0xDC: throw Error{"DNL marker is not supported"};
      default: break;  // APPn, COM and the rest: skipped
    }
    pos_ = end;
  }

  void frame(size_t end) {
    if (frame_seen_) throw Error{"more than one frame"};
    int precision = u8();
    if (precision != 8)
      throw Error{std::to_string(precision) + "-bit samples are not supported"};
    height_ = u16();
    width_ = u16();
    ncomp_ = u8();
    if (height_ == 0 || width_ == 0) throw Error{"empty image (or DNL height)"};
    if (int64_t(width_) * height_ > kMaxPixels)
      throw Error{std::to_string(width_) + "x" + std::to_string(height_) +
                  " pixels exceed the limit of " + std::to_string(kMaxPixels)};
    if (ncomp_ == 4) throw Error{"CMYK/YCCK JPEG is not supported"};
    if (ncomp_ != 1 && ncomp_ != 3)
      throw Error{std::to_string(ncomp_) + " components are not supported"};
    if (pos_ + 3 * size_t(ncomp_) > end) throw Error{"truncated frame header"};
    comps_.resize(ncomp_);
    for (auto& c : comps_) {
      c.id = u8();
      int hv = u8();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = u8() & 3;
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4)
        throw Error{"bad sampling factors"};
      hmax_ = std::max(hmax_, c.h);
      vmax_ = std::max(vmax_, c.v);
    }
    for (auto& c : comps_) {
      int rh = hmax_ / c.h, rv = vmax_ / c.v;
      bool ok = hmax_ % c.h == 0 && vmax_ % c.v == 0 &&
                ((rh == 1 && rv == 1) || (rh == 2 && rv == 1) ||
                 (rh == 2 && rv == 2));
      if (ncomp_ == 3 && (!ok || (&c == &comps_[0] && (rh != 1 || rv != 1)))) {
        char buf[96];
        snprintf(buf, sizeof buf,
                 "chroma subsampling %dx%d,%dx%d,%dx%d is not supported",
                 comps_[0].h, comps_[0].v, comps_[1].h, comps_[1].v,
                 comps_[2].h, comps_[2].v);
        throw Error{buf};
      }
      c.width = (width_ * c.h + hmax_ - 1) / hmax_;
      c.height = (height_ * c.v + vmax_ - 1) / vmax_;
    }
    if (ncomp_ == 1) {  // one component: non-interleaved, 8x8 MCUs
      comps_[0].width = width_;
      comps_[0].height = height_;
      mcux_ = (width_ + 7) / 8;
      mcuy_ = (height_ + 7) / 8;
    } else {
      mcux_ = (width_ + 8 * hmax_ - 1) / (8 * hmax_);
      mcuy_ = (height_ + 8 * vmax_ - 1) / (8 * vmax_);
    }
    frame_seen_ = true;
  }

  void quant(size_t end) {
    while (pos_ < end) {
      int pq = u8();
      int t = pq & 15, prec = pq >> 4;
      if (t > 3) throw Error{"bad quantization table"};
      for (int k = 0; k < 64; ++k)
        qt_[t][kZigzag[k]] = prec ? u16() : u8();
      qt_defined_[t] = true;
    }
  }

  void huffman(size_t end) {
    while (pos_ < end) {
      int tc = u8();
      int cls = tc >> 4, t = tc & 15;
      if (cls > 1 || t > 3) throw Error{"bad Huffman table"};
      if (pos_ + 16 > end) throw Error{"bad Huffman table"};
      int counts[17] = {0};
      int total = 0;
      for (int l = 1; l <= 16; ++l) total += counts[l] = u8();
      if (total > 256 || pos_ + total > end) throw Error{"bad Huffman table"};
      Huffman& h = cls ? ac_[t] : dc_[t];
      h.bad = false;
      for (int i = 0; i < total; ++i) {
        h.vals[i] = uint8_t(u8());
        if (!cls && h.vals[i] > 15) h.bad = true;
      }
      memset(h.look_len, 0, sizeof h.look_len);
      int code = 0, p = 0;
      for (int l = 1; l <= 16 && !h.bad; ++l) {
        h.valoffset[l] = p - code;
        for (int i = 0; i < counts[l]; ++i, ++p, ++code) {
          if (code >= (1 << l) - 1) {  // past its length, or all ones
            h.bad = true;
            break;
          }
          if (l <= 8) {
            int shift = 8 - l;
            for (int j = 0; j < (1 << shift); ++j) {
              h.look_len[(code << shift) | j] = uint8_t(l);
              h.look_val[(code << shift) | j] = h.vals[p];
            }
          }
        }
        h.maxcode[l] = counts[l] ? code - 1 : -1;
        code <<= 1;
      }
      h.maxcode[17] = 0x7FFFFFFF;
      h.defined = true;
    }
  }

  void decode_block(Bits& b, Component& c, int bx, int by) {
    const Huffman& dc = dc_[c.dc_table];
    const Huffman& ac = ac_[c.ac_table];
    int16_t coef[64] = {0};
    int s = decode_symbol(b, dc);
    int diff = s ? extend(b.get(s), s) : 0;
    c.pred += diff;
    coef[0] = int16_t(c.pred);
    for (int k = 1; k < 64; ++k) {
      int rs = decode_symbol(b, ac);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        coef[kZigzag[k]] = int16_t(extend(b.get(s), s));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
    size_t stride = size_t(c.bw) * 8;
    idct_islow(coef, c.quant, c.plane.data() + size_t(by) * 8 * stride + bx * 8,
               int(stride));
  }

  void scan(size_t header_end) {
    if (!frame_seen_) throw Error{"scan before frame"};
    int ns = u8();
    if (ns < 1 || ns > ncomp_) throw Error{"bad scan header"};
    std::vector<Component*> sc;
    for (int i = 0; i < ns; ++i) {
      int id = u8(), tables = u8();
      Component* c = nullptr;
      for (auto& x : comps_)
        if (x.id == id) c = &x;
      if (!c) throw Error{"scan names an unknown component"};
      c->dc_table = (tables >> 4) & 3;
      c->ac_table = tables & 3;
      if (!dc_[c->dc_table].defined || !ac_[c->ac_table].defined)
        throw Error{"scan uses an undefined Huffman table"};
      if (dc_[c->dc_table].bad || ac_[c->ac_table].bad)
        throw Error{"bad Huffman table"};
      if (!c->quant_latched) {
        if (!qt_defined_[c->tq]) throw Error{"undefined quantization table"};
        memcpy(c->quant, qt_[c->tq], sizeof c->quant);
        c->quant_latched = true;
      }
      c->pred = 0;
      sc.push_back(c);
    }
    int ss = u8(), se = u8(), ahal = u8();
    if (ss != 0 || se != 63 || ahal != 0)
      throw Error{"progressive JPEG is not supported"};
    pos_ = header_end;
    Bits b{d_, n_, pos_};
    int units_x, units_y;
    if (ns == 1) {
      units_x = (sc[0]->width + 7) / 8;
      units_y = (sc[0]->height + 7) / 8;
    } else {
      units_x = mcux_;
      units_y = mcuy_;
    }
    int todo = restart_;
    for (int my = 0; my < units_y; ++my) {
      for (int mx = 0; mx < units_x; ++mx) {
        if (restart_ && todo == 0) {
          restart_marker(b);
          for (auto* c : sc) c->pred = 0;
          todo = restart_;
        }
        if (ns == 1) {
          decode_block(b, *sc[0], mx, my);
        } else {
          for (auto* c : sc)
            for (int v = 0; v < c->v; ++v)
              for (int h = 0; h < c->h; ++h)
                decode_block(b, *c, mx * c->h + h, my * c->v + v);
        }
        if (restart_) --todo;
      }
    }
    // to the marker that ends the scan
    pos_ = b.pos;
    while (pos_ + 1 < n_ &&
           !(d_[pos_] == 0xFF && d_[pos_ + 1] != 0 &&
             !(d_[pos_ + 1] >= 0xD0 && d_[pos_ + 1] <= 0xD7)))
      ++pos_;
    if (pos_ + 1 >= n_) eoi_ = true;  // truncated: no marker after the data
    ++scans_;
  }

  void restart_marker(Bits& b) {
    b.reset();
    size_t p = b.pos;
    while (p < n_ && d_[p] == 0xFF) ++p;
    if (p >= n_ || d_[p] < 0xD0 || d_[p] > 0xD7 || d_[p - 1] != 0xFF)
      throw Error{"corrupt data: missing restart marker"};
    b.pos = p + 1;
    b.hit_marker = false;
  }

  // one component's samples upsampled to the image size, as libjpeg's
  // jdsample.c does it with do_fancy_upsampling on
  std::vector<uint8_t> upsample(const Component& c) const {
    const int W = width_, H = height_;
    const int rh = ncomp_ == 1 ? 1 : hmax_ / c.h;
    const int rv = ncomp_ == 1 ? 1 : vmax_ / c.v;
    const size_t stride = size_t(c.bw) * 8;
    const uint8_t* p = c.plane.data();
    std::vector<uint8_t> out(size_t(W) * H);
    const int dw = c.width, dh = c.height;
    auto at = [&](int y, int x) { return int(p[size_t(y) * stride + x]); };
    if (rh == 1 && rv == 1) {
      for (int y = 0; y < H; ++y) memcpy(&out[size_t(y) * W], p + y * stride, W);
    } else if (dw <= 2) {  // jdsample.c: plain replication
      for (int y = 0; y < H; ++y)
        for (int x = 0; x < W; ++x) out[size_t(y) * W + x] = uint8_t(at(y / rv, x / rh));
    } else if (rv == 1) {  // h2v1_fancy_upsample
      for (int y = 0; y < H; ++y) {
        uint8_t* o = &out[size_t(y) * W];
        for (int x = 0; x < W; ++x) {
          int c0 = x >> 1;
          int v = at(y, c0) * 3;
          if (x & 1) {
            int nx = std::min(c0 + 1, dw - 1);
            o[x] = uint8_t((v + at(y, nx) + 2) >> 2);
          } else {
            int px = std::max(c0 - 1, 0);
            o[x] = uint8_t((v + at(y, px) + 1) >> 2);
          }
        }
      }
    } else {  // h2v2_fancy_upsample
      std::vector<int> cs(dw);
      for (int y = 0; y < H; ++y) {
        int r = y >> 1;
        int r2 = (y & 1) ? std::min(r + 1, dh - 1) : std::max(r - 1, 0);
        for (int x = 0; x < dw; ++x) cs[x] = at(r, x) * 3 + at(r2, x);
        uint8_t* o = &out[size_t(y) * W];
        for (int x = 0; x < W; ++x) {
          int c0 = x >> 1;
          if (x & 1)
            o[x] = uint8_t((cs[c0] * 3 + cs[std::min(c0 + 1, dw - 1)] + 7) >> 4);
          else
            o[x] = uint8_t((cs[c0] * 3 + cs[std::max(c0 - 1, 0)] + 8) >> 4);
        }
      }
    }
    return out;
  }

  void convert(uint8_t* rgb) const {
    const size_t np = size_t(width_) * height_;
    if (ncomp_ == 1) {
      std::vector<uint8_t> g = upsample(comps_[0]);
      for (size_t i = 0; i < np; ++i) rgb[3 * i] = rgb[3 * i + 1] = rgb[3 * i + 2] = g[i];
      return;
    }
    std::vector<uint8_t> a = upsample(comps_[0]), b = upsample(comps_[1]),
                         c = upsample(comps_[2]);
    bool is_rgb;
    if (jfif_) {
      is_rgb = false;
    } else if (adobe_) {
      is_rgb = adobe_transform_ == 0;
    } else {
      is_rgb = comps_[0].id == 'R' && comps_[1].id == 'G' && comps_[2].id == 'B';
    }
    if (is_rgb) {
      for (size_t i = 0; i < np; ++i) {
        rgb[3 * i] = a[i];
        rgb[3 * i + 1] = b[i];
        rgb[3 * i + 2] = c[i];
      }
      return;
    }
    // jdcolor.c: build_ycc_rgb_table and ycc_rgb_convert
    const int kScale = 16;
    const int64_t kHalf = int64_t(1) << (kScale - 1);
    auto fix = [](double x) { return int64_t(x * 65536.0 + 0.5); };
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    for (int i = 0; i < 256; ++i) {
      int64_t x = i - 128;
      cr_r[i] = int((fix(1.40200) * x + kHalf) >> kScale);
      cb_b[i] = int((fix(1.77200) * x + kHalf) >> kScale);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + kHalf;
    }
    auto clamp = [](int v) { return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v); };
    for (size_t i = 0; i < np; ++i) {
      int y = a[i], cb = b[i], cr = c[i];
      rgb[3 * i] = clamp(y + cr_r[cr]);
      rgb[3 * i + 1] = clamp(y + int((cb_g[cb] + cr_g[cr]) >> kScale));
      rgb[3 * i + 2] = clamp(y + cb_b[cb]);
    }
  }
};

void set_error(char* err, int errlen, const std::string& msg) {
  if (err && errlen > 0) {
    snprintf(err, size_t(errlen), "%s", msg.c_str());
  }
}

}  // namespace

extern "C" {

// The image's width and height. Returns 0, or -1 with a message in `err`.
int jpeg_header(const uint8_t* data, size_t n, int* width, int* height,
                char* err, int errlen) {
  try {
    Decoder(data, n).header(width, height);
    return 0;
  } catch (const Error& e) {
    set_error(err, errlen, e.msg);
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
  }
  return -1;
}

// Decode into `rgb`, height x width x 3 bytes (the sizes jpeg_header gave).
// Returns 0, or -1 with a message in `err`.
int jpeg_decode_rgb(const uint8_t* data, size_t n, uint8_t* rgb, char* err,
                    int errlen) {
  try {
    Decoder(data, n).decode(rgb);
    return 0;
  } catch (const Error& e) {
    set_error(err, errlen, e.msg);
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
  }
  return -1;
}

}  // extern "C"
