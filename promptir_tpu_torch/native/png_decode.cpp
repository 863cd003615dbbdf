// PNG -> HWC uint8 RGB for the port's loader and codecs.
//
// The port's own copy of the JAX package's native PNG reader
// (native/png_decode.cpp): walk the chunks, join the IDAT payloads, inflate
// them with zlib, undo the five row filters and expand to RGB. Its scope
// is that of utils/png.py's plain decoder, which it must equal bit for bit:
// 8-bit gray, gray+alpha, palette, RGB and RGBA, non-interlaced; gray is
// replicated, a palette index looked up (an index past the PLTE reads as 0,
// as PIL reads it), alpha dropped. Everything else is refused with the
// plain decoder's message, in its order of checks, written to `err`; the
// caller prefixes the file's name. The inflate repeats CPython's
// zlib.decompress (all input at once, Z_FINISH, every byte of the stream
// inflated even past what the image needs) so that a corrupt stream fails
// here where it fails there, with the same message.
//
// Two calls: png_open parses, checks and inflates (every refusal happens
// here, and the inflated rows are held in a context), png_finish unfilters
// and expands into the caller's h*w*3 buffer, png_free releases the
// context. Every length read from the file is checked against the buffer
// before it is used, and the inflated rows are grown as the stream gives
// them, so a header that claims more pixels than the data holds allocates
// nothing for them. Called through ctypes, which releases the GIL.

#include <zlib.h>

#include <climits>
#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

constexpr uint32_t kMaxSide = 1u << 20;  // utils/png.py:MAX_SIDE
constexpr uint8_t kSig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};

struct Png {
  uint32_t w = 0, h = 0;
  int ctype = 0, bpp = 0;
  uint8_t palette[256 * 3] = {};  // a missing entry reads as 0
  std::vector<uint8_t> raw;       // h rows of [filter byte | w * bpp bytes]
};

uint32_t be32(const uint8_t *p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

int fail(char *err, int err_len, const char *fmt, ...) {
  va_list ap;
  va_start(ap, fmt);
  std::vsnprintf(err, size_t(err_len), fmt, ap);
  va_end(ap);
  return 1;
}

// (name, samples a pixel) of a color type; bpp 0 for an unknown one
const char *color_type(int ctype, int *bpp) {
  switch (ctype) {
    case 0: *bpp = 1; return "gray";
    case 2: *bpp = 3; return "RGB";
    case 3: *bpp = 1; return "palette";
    case 4: *bpp = 2; return "gray+alpha";
    case 6: *bpp = 4; return "RGBA";
    default: *bpp = 0; return "";
  }
}

// CPython's zlib_error: "Error <code> while decompressing data: <message>"
int zlib_fail(char *err, int err_len, int code, const char *msg) {
  if (msg == nullptr) {
    if (code == Z_BUF_ERROR) msg = "incomplete or truncated stream";
    if (code == Z_STREAM_ERROR) msg = "inconsistent stream state";
    if (code == Z_DATA_ERROR) msg = "invalid input data";
  }
  if (msg == nullptr)
    return fail(err, err_len, "corrupt PNG image data: Error %d while "
                "decompressing data", code);
  return fail(err, err_len, "corrupt PNG image data: Error %d while "
              "decompressing data: %.200s", code, msg);
}

// Inflate `src` as zlib.decompress does; the first `need` bytes go to
// png->raw, the rest is inflated and dropped. Sets *total to the bytes the
// stream held.
int inflate_rows(const std::vector<uint8_t> &src, uint64_t need, Png *png,
                 uint64_t *total, char *err, int err_len) {
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  int rc = inflateInit(&zs);
  if (rc != Z_OK) return zlib_fail(err, err_len, rc, zs.msg);
  static thread_local uint8_t scratch[1 << 16];
  png->raw.resize(size_t(need < (uint64_t(1) << 16) ? need : (1 << 16)));
  const uint8_t *in = src.data();
  uint64_t in_left = src.size();
  uint64_t got = 0;
  do {
    zs.next_in = const_cast<uint8_t *>(in);
    zs.avail_in = uInt(in_left < UINT_MAX ? in_left : UINT_MAX);
    in += zs.avail_in;
    in_left -= zs.avail_in;
    const int flush = in_left == 0 ? Z_FINISH : Z_NO_FLUSH;
    do {
      if (got < need) {
        if (got == png->raw.size()) {
          uint64_t grown = 2 * uint64_t(png->raw.size());
          png->raw.resize(size_t(grown < need ? grown : need));
        }
        uint64_t room = png->raw.size() - got;
        zs.next_out = png->raw.data() + got;
        zs.avail_out = uInt(room < UINT_MAX ? room : UINT_MAX);
      } else {
        zs.next_out = scratch;
        zs.avail_out = sizeof(scratch);
      }
      const uInt before = zs.avail_out;
      rc = inflate(&zs, flush);
      got += before - zs.avail_out;
      if (rc != Z_OK && rc != Z_BUF_ERROR && rc != Z_STREAM_END) {
        inflateEnd(&zs);
        return zlib_fail(err, err_len, rc, zs.msg);
      }
    } while (zs.avail_out == 0);
  } while (rc != Z_STREAM_END && in_left != 0);
  inflateEnd(&zs);
  if (rc != Z_STREAM_END) return zlib_fail(err, err_len, rc, zs.msg);
  *total = got;
  return 0;
}

int parse(const uint8_t *buf, uint64_t len, Png *png, char *err,
          int err_len) {
  if (len < 8 || std::memcmp(buf, kSig, 8) != 0)
    return fail(err, err_len, "not PNG");
  const uint8_t *ihdr = nullptr;
  uint32_t ihdr_len = 0;
  const uint8_t *plte = nullptr;
  uint32_t plte_len = 0;
  bool saw_plte = false, saw_idat = false, saw_iend = false;
  std::vector<uint8_t> idat;
  uint64_t off = 8;
  while (off + 12 <= len) {
    const uint32_t n = be32(buf + off);
    const uint8_t *type = buf + off + 4;
    if (off + 12 + uint64_t(n) > len) break;
    const uint8_t *payload = buf + off + 8;
    if (!std::memcmp(type, "IHDR", 4)) {
      ihdr = payload;
      ihdr_len = n;
    } else if (!std::memcmp(type, "PLTE", 4)) {
      plte = payload;
      plte_len = n;
      saw_plte = true;
    } else if (!std::memcmp(type, "IDAT", 4)) {
      idat.insert(idat.end(), payload, payload + n);
      saw_idat = true;
    } else if (!std::memcmp(type, "IEND", 4)) {
      saw_iend = true;
      break;
    }
    off += 12 + uint64_t(n);
  }
  if (!saw_iend) return fail(err, err_len, "truncated PNG (no IEND chunk)");
  if (ihdr == nullptr || ihdr_len != 13 || !saw_idat)
    return fail(err, err_len, "PNG without a header or image data");
  const uint32_t w = be32(ihdr), h = be32(ihdr + 4);
  const int depth = ihdr[8], ctype = ihdr[9], interlace = ihdr[12];
  int bpp = 0;
  const char *kind = color_type(ctype, &bpp);
  if (bpp == 0) return fail(err, err_len, "unknown PNG color type %d", ctype);
  if (depth != 8)
    return fail(err, err_len, "%d-bit %s PNG is not supported (8-bit "
                "samples only)", depth, kind);
  if (interlace) return fail(err, err_len, "interlaced (Adam7) PNG is not "
                             "supported");
  if (!(0 < w && w <= kMaxSide && 0 < h && h <= kMaxSide))
    return fail(err, err_len, "PNG size %ux%u out of range", w, h);
  const uint64_t stride = uint64_t(w) * bpp;
  const uint64_t need = uint64_t(h) * (stride + 1);
  uint64_t total = 0;
  if (inflate_rows(idat, need, png, &total, err, err_len)) return 1;
  if (total < need) return fail(err, err_len, "PNG image data too short");
  int fmax = 0;
  for (uint64_t y = 0; y < h; ++y) {
    const int f = png->raw[size_t(y * (stride + 1))];
    fmax = f > fmax ? f : fmax;
  }
  if (fmax > 4) return fail(err, err_len, "unknown PNG row filter %d", fmax);
  if (ctype == 3) {
    if (!saw_plte)
      return fail(err, err_len, "palette PNG without a PLTE chunk");
    const uint32_t entries = plte_len / 3 < 256 ? plte_len / 3 : 256;
    std::memcpy(png->palette, plte, size_t(entries) * 3);
  }
  png->w = w;
  png->h = h;
  png->ctype = ctype;
  png->bpp = bpp;
  return 0;
}

inline int paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = p > a ? p - a : a - p;
  const int pb = p > b ? p - b : b - p;
  const int pc = p > c ? p - c : c - p;
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

// Undo the row filters in place; every filter byte is known to be <= 4.
void unfilter(Png *png) {
  const int64_t h = png->h, stride = int64_t(png->w) * png->bpp;
  const int bpp = png->bpp;
  std::vector<uint8_t> zero(size_t(stride), 0);
  const uint8_t *prev = zero.data();
  for (int64_t y = 0; y < h; ++y) {
    uint8_t *row = png->raw.data() + y * (stride + 1);
    uint8_t *cur = row + 1;
    switch (row[0]) {
      case 1:  // Sub
        for (int64_t i = bpp; i < stride; ++i) cur[i] += cur[i - bpp];
        break;
      case 2:  // Up
        for (int64_t i = 0; i < stride; ++i) cur[i] += prev[i];
        break;
      case 3:  // Average
        for (int64_t i = 0; i < bpp; ++i) cur[i] += prev[i] >> 1;
        for (int64_t i = bpp; i < stride; ++i)
          cur[i] += uint8_t((int(cur[i - bpp]) + int(prev[i])) >> 1);
        break;
      case 4:  // Paeth
        for (int64_t i = 0; i < bpp; ++i) cur[i] += prev[i];
        for (int64_t i = bpp; i < stride; ++i)
          cur[i] += uint8_t(paeth(cur[i - bpp], prev[i], prev[i - bpp]));
        break;
      default:  // None
        break;
    }
    prev = cur;
  }
}

void expand(const Png &png, uint8_t *out) {
  const int64_t h = png.h, w = png.w, stride = w * png.bpp;
  for (int64_t y = 0; y < h; ++y) {
    const uint8_t *src = png.raw.data() + y * (stride + 1) + 1;
    uint8_t *dst = out + y * w * 3;
    switch (png.ctype) {
      case 0:  // gray
      case 4:  // gray+alpha
        for (int64_t x = 0; x < w; ++x) {
          const uint8_t g = src[x * png.bpp];
          dst[3 * x] = dst[3 * x + 1] = dst[3 * x + 2] = g;
        }
        break;
      case 2:  // RGB
        std::memcpy(dst, src, size_t(w * 3));
        break;
      case 3:  // palette
        for (int64_t x = 0; x < w; ++x)
          std::memcpy(dst + 3 * x, png.palette + 3 * src[x], 3);
        break;
      default:  // RGBA
        for (int64_t x = 0; x < w; ++x) std::memcpy(dst + 3 * x, src + 4 * x, 3);
        break;
    }
  }
}

}  // namespace

extern "C" {

// Parse, check and inflate; on success *ctx holds the image (release it
// with png_free) and *w, *h its size. Returns nonzero with the reason in
// err otherwise.
int png_open(const uint8_t *buf, int64_t len, void **ctx, int32_t *w,
             int32_t *h, char *err, int err_len) {
  *ctx = nullptr;
  if (len < 0) return fail(err, err_len, "not PNG");
  Png *png = new Png;
  if (parse(buf, uint64_t(len), png, err, err_len)) {
    delete png;
    return 1;
  }
  *ctx = png;
  *w = int32_t(png->w);
  *h = int32_t(png->h);
  return 0;
}

// Unfilter and expand an opened image into out (h * w * 3 bytes).
void png_finish(void *ctx, uint8_t *out) {
  Png *png = static_cast<Png *>(ctx);
  unfilter(png);
  expand(*png, out);
}

void png_free(void *ctx) { delete static_cast<Png *>(ctx); }

}  // extern "C"
