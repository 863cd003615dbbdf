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
// writes out once. One block takes a run of up to kSeamW pixels of one row
// of y and the two output rows they feed: it copies the run's y rows (4c
// values a pixel, contiguous) into shared memory in 16-byte loads, then
// each thread writes one 16-byte piece of an output row, which is
// contiguous over the run's 2 x run output pixels: the shuffle half
// gathered from shared memory, the skip half a 16-byte copy. Index
// arithmetic is 32-bit inside a row; each row's base offset is 64-bit.
// Dropped TPU workarounds: the W+2 / 128-lane padding of the output, the f32
// shift and the permutation-matmul lane moves.
#include "common.cuh"

namespace {
using namespace pk;

constexpr int kSeamW = 32;            // pixels of y a block, at most
constexpr int kSeamSmem = 48 * 1024;  // bytes of y a block stages, at most

template <class T>
__global__ void __launch_bounds__(kThreads) seam_kernel(const T* __restrict__ y,
                                                       const T* __restrict__ skip,
                                                       T* __restrict__ out, int H, int W, int c,
                                                       int run) {
  constexpr int V = 16 / sizeof(T);  // values a 16-byte piece
  extern __shared__ float4 smem4[];
  T* ys = reinterpret_cast<T*>(smem4);
  const int hc = H / 2, wc = W / 2, b = blockIdx.z, h = blockIdx.y, w0 = blockIdx.x * run;
  const int nw = min(run, wc - w0), c4 = 4 * c, cv = c / V, rowv = 2 * cv;
  // the run's y rows: nw * 4c contiguous values
  const uint4* src = reinterpret_cast<const uint4*>(y + ((long long)(b * hc + h) * wc + w0) * c4);
  for (int e = threadIdx.x; e < nw * c4 / V; e += kThreads)
    reinterpret_cast<uint4*>(ys)[e] = src[e];
  __syncthreads();
  // output rows 2h and 2h + 1, pixels 2 w0 .. 2 (w0 + nw) - 1: 2 nw * 2c
  // values each, contiguous in `out`; their skip rows likewise in `skip`
  const int per_row = 2 * nw * rowv;
  for (int e = threadIdx.x; e < 2 * per_row; e += kThreads) {
    const int i = e >= per_row, r = e - i * per_row, px = r / rowv, piece = r - px * rowv;
    const long long row = (long long)(b * H + 2 * h + i) * W + 2 * w0;  // first pixel
    uint4* dst = reinterpret_cast<uint4*>(out + (row + px) * 2 * c) + piece;
    if (piece < cv) {
      const T* yp = ys + (px >> 1) * c4 + piece * V * 4 + 2 * i + (px & 1);
      uint4 u;
      T* v = reinterpret_cast<T*>(&u);
#pragma unroll
      for (int k = 0; k < V; ++k) v[k] = yp[4 * k];
      *dst = u;
    } else {
      *dst = reinterpret_cast<const uint4*>(skip + (row + px) * c)[piece - cv];
    }
  }
}

template <class T>
int launch(const void* y, const void* skip, void* out, int B, int H, int W, int c,
           cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  if (c % V) return cudaErrorInvalidValue;
  int run = kSeamSmem / (4 * c * (int)sizeof(T));
  run = run < kSeamW ? run : kSeamW;
  if (run < 1) return cudaErrorInvalidValue;
  const int wc = W / 2;
  const size_t smem = (size_t)run * 4 * c * sizeof(T);
  seam_kernel<T><<<dim3((wc + run - 1) / run, H / 2, B), kThreads, smem, stream>>>(
      static_cast<const T*>(y), static_cast<const T*>(skip), static_cast<T*>(out), H, W, c, run);
  return cudaGetLastError();
}

}  // namespace

// Returns the CUDA error code of the launch (0 on success). c must be a
// multiple of 8 (bf16) or 4 (fp32) and the tensors 16-byte aligned
// (ops/cuda/seam.py checks both).
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
