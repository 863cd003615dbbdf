// Decoder level-1 entry seam: pixel-shuffle x2 of the up2_1 conv output,
// placed beside the encoder skip.
//   out[b, 2h+i, 2w+j, cc]     = y[b, h, w, 4 cc + 2 i + j]   (cc < c)
//   out[b, 2h+i, 2w+j, c + cc] = skip[b, 2h+i, 2w+j, cc]
// y carries torch's pixel-shuffle channel order (cc * 4 + 2 i + j).
//
// Replaces promptir_tpu/ops/pallas/seam.py:222 shuffle_concat_pad (body
// _kernel). Pure data movement, bit-exact.
//
// Bound on the H100: bytes (no arithmetic). It reads y and skip once and
// writes out once. One thread moves one output value; consecutive threads
// write consecutive channels, so the writes and the skip reads are
// coalesced and the strided y reads of one pixel fall in one 4c-value row.
// Dropped TPU workarounds: the W+2 / 128-lane padding of the output, the f32
// shift and the permutation-matmul lane moves.
#include "common.cuh"

namespace {
using namespace pk;

template <class T>
__global__ void __launch_bounds__(kThreads) seam_kernel(const T* __restrict__ y,
                                                       const T* __restrict__ skip,
                                                       T* __restrict__ out, int H, int W, int c,
                                                       long long total) {
  const int c2 = 2 * c, hc = H / 2, wc = W / 2;
  for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x; e < total;
       e += (long long)gridDim.x * kThreads) {
    const int ch = (int)(e % c2);
    const long long pix = e / c2;
    if (ch < c) {
      const int xw = (int)(pix % W);
      const long long r = pix / W;
      const int yh = (int)(r % H);
      const long long b = r / H;
      const int i = yh & 1, j = xw & 1;
      out[e] = y[((b * hc + (yh >> 1)) * wc + (xw >> 1)) * (4 * c) + ch * 4 + 2 * i + j];
    } else {
      out[e] = skip[pix * c + (ch - c)];
    }
  }
}

template <class T>
int launch(const void* y, const void* skip, void* out, int B, int H, int W, int c,
           cudaStream_t stream) {
  const long long total = (long long)B * H * W * 2 * c;
  const long long want = (total + kThreads - 1) / kThreads;
  const int blocks = (int)(want < 132LL * 64 ? want : 132LL * 64);
  seam_kernel<T><<<blocks, kThreads, 0, stream>>>(static_cast<const T*>(y),
                                                  static_cast<const T*>(skip),
                                                  static_cast<T*>(out), H, W, c, total);
  return cudaGetLastError();
}

}  // namespace

// Returns the CUDA error code of the launch (0 on success).
extern "C" int seam_launch(int dtype, const void* y, const void* skip, void* out, int B, int H,
                           int W, int c, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) return launch<__nv_bfloat16>(y, skip, out, B, H, W, c, s);
  if (dtype == kF32) return launch<float>(y, skip, out, B, H, W, c, s);
  return cudaErrorInvalidValue;
}

// Message of a CUDA error code returned by any launcher of this library.
extern "C" const char* pk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
