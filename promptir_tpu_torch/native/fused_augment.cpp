// Fused host-side sample preparation for the port's training loader.
//
// The port's own copy of the JAX package's native/fused_augment.cpp, which
// the JAX loader runs by default (PromptTrainDataset(use_native=None)):
// crop -> dihedral -> uint8-domain Gaussian noise -> float32 in one pass
// over the uint8 pixels. The noise comes from xoshiro256++ seeded by
// splitmix64, paired through Box-Muller, so the samples equal the JAX
// package's native samples bit for bit (not its numpy path's, whose noise
// is PCG64's ziggurat). The code below is the JAX source's; it is built
// with the JAX Makefile's flags (-O3 -march=native -std=c++17), which
// decide whether `v + g.next() * sigma` contracts into an FMA, so that the
// same compiler on the same host gives the same pixels
// (promptir_tpu_torch/data/native.py).

#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

struct Xoshiro256pp {
  uint64_t s[4];

  static uint64_t splitmix64(uint64_t &x) {
    uint64_t z = (x += 0x9e3779b97f4a7c15ULL);
    z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
    z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
    return z ^ (z >> 31);
  }

  explicit Xoshiro256pp(uint64_t seed) {
    uint64_t x = seed;
    for (int i = 0; i < 4; ++i) s[i] = splitmix64(x);
  }

  static uint64_t rotl(uint64_t v, int k) {
    return (v << k) | (v >> (64 - k));
  }

  uint64_t next() {
    uint64_t result = rotl(s[0] + s[3], 23) + s[0];
    uint64_t t = s[1] << 17;
    s[2] ^= s[0];
    s[3] ^= s[1];
    s[1] ^= s[2];
    s[0] ^= s[3];
    s[2] ^= t;
    s[3] = rotl(s[3], 45);
    return result;
  }

  // uniform in (0, 1]
  double uniform() {
    return ((next() >> 11) + 1.0) * (1.0 / 9007199254740992.0);
  }
};

// Box–Muller pair generator
struct Gauss {
  Xoshiro256pp rng;
  bool have_spare = false;
  double spare = 0.0;

  explicit Gauss(uint64_t seed) : rng(seed) {}

  double next() {
    if (have_spare) {
      have_spare = false;
      return spare;
    }
    double u1 = rng.uniform();
    double u2 = rng.uniform();
    double r = std::sqrt(-2.0 * std::log(u1));
    double a = 6.283185307179586 * u2;
    spare = r * std::sin(a);
    have_spare = true;
    return r * std::cos(a);
  }
};

// dihedral source-coordinate mapping: output (i, j) of a (p x p) patch
// reads input (si, sj). Matches data/augment.py:dihedral /
// the reference's numpy flipud/rot90 modes exactly.
inline void dihedral_src(int mode, int p, int i, int j, int &si, int &sj) {
  switch (mode) {
    case 0: si = i;           sj = j;           break;
    case 1: si = p - 1 - i;   sj = j;           break;  // flipud
    case 2: si = j;           sj = p - 1 - i;   break;  // rot90
    case 3: si = j;           sj = i;           break;  // rot90+flipud
    case 4: si = p - 1 - i;   sj = p - 1 - j;   break;  // rot180
    case 5: si = i;           sj = p - 1 - j;   break;  // rot180+flipud
    case 6: si = p - 1 - j;   sj = i;           break;  // rot270
    case 7: si = p - 1 - j;   sj = p - 1 - i;   break;  // rot270+flipud
    default: si = i; sj = j; break;
  }
}

}  // namespace

extern "C" {

// Denoise-task sample: crop a (patch x patch) window at (ci, cj) from an
// HxWx3 uint8 image, apply dihedral `mode`, synthesize uint8-domain
// Gaussian noise (clip(img + N(0,1)*sigma, 0, 255) cast to uint8), and
// emit float32 [0,1] HWC `degraded` and `clean`.
void prepare_denoise_sample(const uint8_t *img, int h, int w, int ci,
                            int cj, int patch, int mode, float sigma,
                            uint64_t seed, float *degraded, float *clean) {
  (void)h;
  Gauss g(seed);
  for (int i = 0; i < patch; ++i) {
    for (int j = 0; j < patch; ++j) {
      int si, sj;
      dihedral_src(mode, patch, i, j, si, sj);
      const uint8_t *px = img + (((ci + si) * (size_t)w) + (cj + sj)) * 3;
      float *dd = degraded + ((i * (size_t)patch) + j) * 3;
      float *cc = clean + ((i * (size_t)patch) + j) * 3;
      for (int c = 0; c < 3; ++c) {
        float v = (float)px[c];
        cc[c] = v / 255.0f;
        double noisy = v + g.next() * sigma;
        if (noisy < 0.0) noisy = 0.0;
        if (noisy > 255.0) noisy = 255.0;
        dd[c] = (float)((uint8_t)noisy) / 255.0f;
      }
    }
  }
}

// Paired-task sample (rain/haze): aligned crop + shared dihedral on two
// images, float32 [0,1] outputs.
void prepare_paired_sample(const uint8_t *degraded_img,
                           const uint8_t *clean_img, int h, int w, int ci,
                           int cj, int patch, int mode, float *degraded,
                           float *clean) {
  (void)h;
  for (int i = 0; i < patch; ++i) {
    for (int j = 0; j < patch; ++j) {
      int si, sj;
      dihedral_src(mode, patch, i, j, si, sj);
      size_t off = (((ci + si) * (size_t)w) + (cj + sj)) * 3;
      size_t oo = ((i * (size_t)patch) + j) * 3;
      for (int c = 0; c < 3; ++c) {
        degraded[oo + c] = (float)degraded_img[off + c] / 255.0f;
        clean[oo + c] = (float)clean_img[off + c] / 255.0f;
      }
    }
  }
}

}  // extern "C"
