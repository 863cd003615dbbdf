// MDTA apply: x2 = x + W_proj (attn v), the second pass of x + MDTA(LN(x)),
// run after the stats pass (mdta_stats.cu) and the softmax over its Gram
// (ops/cuda/mdta.py:attn_from_stats).
//
// Replaces promptir_tpu/ops/pallas/mdta.py:252 fused_ln_mdta (body
// _kernel_b). The TPU kernel takes a row stripe of v and x and the
// block-diagonal (C x C) attention padded to 128 lanes; here a block takes
// the (heads, d, d) attention of one image. Rounding points as _kernel_b:
// attn enters rounded to T, attn v is rounded to T; the products are fp32.
//
// Bound on the H100. Per pixel the function reads v and x and writes x2:
// 3C stored values; it does dC + C^2 MACs (2dC + 2C^2 operations), d = C /
// heads. In bf16 at 989 TFLOP/s and 3.35 TB/s (295 operations a byte) the
// minimal traffic is the bound while (d + C) / 3 < 295, i.e. at every
// promptir shape (d + C <= 880) and the operations only for one head at
// C = 704 (d + C = 1408); chip_smoke.py prints which for every shape.
//
// The float32 route (mdta_apply_kernel) runs attn_apply_project of
// mdta_apply.cuh, the code of block_tail.cu's tail_a steps 1-2, on 16 * MP
// pixels: SIMT products (common.cuh:gemm_tile). The bf16 route
// (mdta_apply_tc_kernel, its own code: tail_a keeps attn_apply_project_tc)
// is built for a bytes-bound function whose blocks each wait on a chain of
// latencies: v, x and the first W_proj pieces go in flight together in the
// prologue; attn is read in fp32 and rounded to bf16 as it is staged (no
// separate rounding launch); attn v runs on the tensor cores for all heads
// staged at once where they fit; W_proj streams in 64-deep pieces through a
// 3-stage cp.async ring with one barrier a piece; x2 leaves in 16-byte
// stores. To fill the card at the deep training shapes, the plan
// (ops/cuda/mdta.py:apply_plan) takes 64 or 32 pixels a block and splits
// the C outputs over blocks, each recomputing attn v for its pixels (2dC
// operations a pixel, cheap beside the bytes).
//
// Dropped TPU workarounds: the 128-lane padding of C and of the attention
// matrix (the masked off-head blocks cost the MXU a C x C product where
// the heads need d x d).
#include "mdta_apply.cuh"

namespace {
using namespace pk;

struct ApplyArgs {
  const void* v;      // (B, H, W, C) T
  const void* x;      // (B, H, W, C) T
  const void* attn;   // (B, heads, d, d) fp32
  const void* wproj;  // (C, C) T (out, in)
  void* x2;           // (B, H, W, C) T
  int B, HW, C, heads;
};

// One block: PT = 16 * MP consecutive pixels of one image. Shared memory,
// in order: av (C x PT fp32) and the two product staging tiles; the byte
// count is ops/cuda/mdta.py:ln_mdta_smem.
template <class T, int MP>
__global__ void __launch_bounds__(kThreads) mdta_apply_kernel(ApplyArgs a) {
  constexpr int PT = 16 * MP;
  extern __shared__ float4 smem4[];
  const int b = blockIdx.y;
  const long long pix0 = (long long)b * a.HW + (long long)blockIdx.x * PT;
  const int np = min(PT, a.HW - (int)blockIdx.x * PT);
  float* av = reinterpret_cast<float*>(smem4);
  float* As = av + a.C * PT;
  float* Ws = As + kTileK * kLd;
  attn_apply_project<T, MP, false>(static_cast<const T*>(a.v), static_cast<const T*>(a.x),
                                   static_cast<const float*>(a.attn),
                                   static_cast<const T*>(a.wproj),
                                   static_cast<T*>(a.x2), b, a.C, a.heads, pix0, np, av,
                                   nullptr, As, Ws);
}

// ---------------------------------------------------------- the bf16 route

constexpr int kKP = 64;           // k depth of one streamed W_proj piece
constexpr int kLdP = tc_ld(kKP);  // its row stride
constexpr int kNS = 3;            // stages of the W_proj ring
constexpr int kAttnBatch = 8;     // attn loads a thread keeps in flight

struct ApplyTcArgs {
  const bf16* v;       // (B, H, W, C)
  const bf16* x;       // (B, H, W, C)
  const float* attn;   // (B, heads, d, d) fp32, rounded to bf16 as it is staged
  const bf16* wproj;   // (C, C) (out, in)
  bf16* x2;            // (B, H, W, C)
  int B, HW, C, heads, ncol, ha, ar, nslots, wres;
};

// The W_proj product's warps: 2 x 4 warps of (PT / 32) x NT m16n8 tiles,
// NPC = 32 NT output columns a pass (>= the block's ncol).
template <int PT, int NT>
struct ApplyShape {
  static constexpr int WM = 2, WN = 4, MT = PT / 32, NPC = WN * 8 * NT;
  static_assert(PT % 32 == 0, "32 pixels a warp row");
};

// Row stride of the resident W_proj: C rounded up to a 64-deep piece, + 8.
__host__ __device__ inline int apply_ldw(int C) { return (C + kKP - 1) / kKP * kKP + 8; }

// Shared memory of one block, in the order it is carved (each piece a
// multiple of 16 bytes): v (PT x tc_ld(C) bf16; two buffers when wres),
// attn v (PT x tc_ld(C)), x then x2 of the block's columns (PT x (ncol + 8)
// bf16; two buffers when wres), a slab of attn (ar rows of ha heads, ha x ar
// x tc_ld(d) bf16, zero-padded to d16 = d rounded up to 16 rows and
// columns), then W_proj's rows of the block: resident (NPC x apply_ldw(C)
// bf16, wres) or the ring (kNS x NPC x kLdP bf16).
template <int PT, int NT>
__host__ __device__ inline int apply_tc_bytes(int C, int heads, int ncol, int ha, int ar,
                                              int wres) {
  constexpr int NPC = ApplyShape<PT, NT>::NPC;
  return (2 + wres) * PT * tc_ld(C) * 2 + (1 + wres) * PT * (ncol + 8) * 2 +
         ha * ar * tc_ld(C / heads) * 2 +
         (wres ? NPC * apply_ldw(C) * 2 : kNS * NPC * kLdP * 2);
}

// One block: output columns [ncol blockIdx.z, + ncol) of the PT-pixel tiles
// t = blockIdx.x, + nslots, ... of image blockIdx.y: persistent blocks,
// about one wave over the card (ops/cuda/mdta.py:apply_plan), so that what
// every tile of an image shares comes in once a block: attn, in fp32 and
// rounded to bf16 as it is staged (the JAX composition's rounding,
// promptir_tpu/ops/attention.py:81), when one slab holds all heads; W_proj's
// rows of the block, when resident (wres: up to C = 192, where they take
// less room than the ring). Each tile: v and its x columns by cp.async (16
// bytes a copy, 0 past the image); attn v of every head (the block
// recomputes all C of it, 2dC operations a pixel beside the 2 C ncol of
// W_proj) into AV rounded to bf16, warp tasks of 32 pixels by 16 channels of
// one head, a slab of attn at a time; W_proj from the resident rows with no
// barrier, or in 64-deep pieces through a 3-stage cp.async ring that runs on
// across tiles (one barrier a piece); x2 = x + W_proj av rounded into the x
// tile and stored 16 bytes a copy. With W_proj resident, v and x come in
// two buffers: the next tile's are in flight while this one computes. Every W_proj piece is whole: past C the
// weights are zero and the product reads AV's next row, or the x tile after
// the last (finite either way).
template <int PT, int NT>
__global__ void __launch_bounds__(kThreads) mdta_apply_tc_kernel(ApplyTcArgs a) {
  using S = ApplyShape<PT, NT>;
  extern __shared__ float4 smem4[];
  const int C = a.C, ldc = tc_ld(C), d = C / a.heads, d16 = (d + 15) / 16 * 16, lda = tc_ld(d);
  const int ncol = a.ncol, ldx = ncol + 8, b = blockIdx.y, n0 = blockIdx.z * ncol;
  const int tid = threadIdx.x, warp = tid >> 5, ldw = apply_ldw(C);
  const int nc = min(ncol, C - n0), ntiles = (a.HW + PT - 1) / PT, P = (C + kKP - 1) / kKP;
  const bool attn_once = a.ha == a.heads && a.ar == d16;
  const int nbuf = 1 + a.wres;  // v and x buffers
  bf16* Vs = reinterpret_cast<bf16*>(smem4);
  bf16* AV = Vs + nbuf * PT * ldc;
  bf16* Xs = AV + PT * ldc;
  bf16* At = Xs + nbuf * PT * ldx;
  bf16* Wb = At + a.ha * a.ar * lda;  // resident W_proj, or the ring

  int ip = 0;  // W_proj ring pieces issued: piece ip % P into slot ip % kNS
  const auto issue = [&]() {
    bf16* dst = Wb + (ip % kNS) * S::NPC * kLdP;
    const int k0 = (ip % P) * kKP;
    for (int e = tid; e < S::NPC * (kKP / 8); e += kThreads) {
      const int r = e >> 3, k = k0 + (e & 7) * 8;
      const bool ok = r < nc && k < C;
      cp_async16(dst + r * kLdP + (e & 7) * 8, ok ? a.wproj + (long long)(n0 + r) * C + k : a.wproj,
                 ok);
    }
    cp_async_commit();
    ++ip;
  };
  // stage attn rows [i0, i0 + ar) of heads [h0, h0 + ha), fp32 -> bf16,
  // kAttnBatch loads a thread in flight before any is converted and stored
  const auto stage_attn = [&](int h0, int i0) {
    const int ar = a.ar;
    const float* at = a.attn + (long long)(b * a.heads + h0) * d * d;
    const int n4 = a.ha * ar * (lda / 4);
    for (int e0 = 0; e0 < n4; e0 += kAttnBatch * kThreads) {
      float4 u[kAttnBatch];
#pragma unroll
      for (int k = 0; k < kAttnBatch; ++k) {
        const int e = e0 + k * kThreads + tid;
        const int j = (e % (lda / 4)) * 4, r = (e / (lda / 4)) % ar, hh = e / (lda / 4) / ar;
        const int i = i0 + r;
        u[k] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (e < n4 && i < d && j < d)
          u[k] = *reinterpret_cast<const float4*>(at + ((long long)hh * d + i) * d + j);
      }
#pragma unroll
      for (int k = 0; k < kAttnBatch; ++k) {
        const int e = e0 + k * kThreads + tid;
        if (e >= n4) break;
        const int j = (e % (lda / 4)) * 4, r = (e / (lda / 4)) % ar, hh = e / (lda / 4) / ar;
        bf16* dst = At + (hh * ar + r) * lda + j;
        *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(u[k].x, u[k].y);
        *reinterpret_cast<__nv_bfloat162*>(dst + 2) = __floats2bfloat162_rn(u[k].z, u[k].w);
      }
    }
  };

  if (a.wres) {
    for (int e = tid; e < S::NPC * (ldw / 8); e += kThreads) {
      const int r = e / (ldw / 8), k = (e % (ldw / 8)) * 8;
      const bool ok = r < nc && k < C;
      cp_async16(Wb + r * ldw + k, ok ? a.wproj + (long long)(n0 + r) * C + k : a.wproj, ok);
    }
    cp_async_commit();
  } else {
    for (int p = 0; p < kNS - 1; ++p) issue();
  }
  for (int e = tid; e < (nbuf + 1) * PT * (ldc - C); e += kThreads) {  // the padding columns
    const int m = e / (ldc - C), j = C + e % (ldc - C);
    Vs[m * ldc + j] = __float2bfloat16(0.f);  // every v buffer, then AV
  }
  for (int e = tid; e < nbuf * PT * (ldx - nc); e += kThreads)
    Xs[(e / (ldx - nc)) * ldx + nc + e % (ldx - nc)] = __float2bfloat16(0.f);
  if (attn_once) stage_attn(0, 0);
  // v and x of tile t into buffer buf, one cp.async group
  const auto issue_vx = [&](int t, int buf) {
    const long long p0 = (long long)b * a.HW + (long long)t * PT;
    const int n = min(PT, a.HW - t * PT);
    bf16* vb = Vs + buf * PT * ldc;
    bf16* xb = Xs + buf * PT * ldx;
    for (int e = tid; e < PT * (C / 8); e += kThreads) {
      const int m = e / (C / 8), q = e % (C / 8);
      const bool ok = m < n;
      cp_async16(vb + m * ldc + q * 8, ok ? a.v + (p0 + m) * C + q * 8 : a.v, ok);
    }
    for (int e = tid; e < PT * (nc / 8); e += kThreads) {
      const int m = e / (nc / 8), q = e % (nc / 8);
      const bool ok = m < n;
      cp_async16(xb + m * ldx + q * 8, ok ? a.x + (p0 + m) * C + n0 + q * 8 : a.x, ok);
    }
    cp_async_commit();
  };
  if (a.wres && blockIdx.x < ntiles) issue_vx(blockIdx.x, 0);

  const int wm = warp % S::WM, wn = warp / S::WM, ar = a.ar, ng = ar / 16, mg = PT / 32;
  const uint32_t A = smem_u32(AV + wm * 16 * S::MT * ldc + lane_a_off(ldc));
  const uint32_t R = smem_u32(Wb + wn * 8 * NT * (a.wres ? ldw : kLdP));
  const int ldb = a.wres ? ldw : kLdP;
  const uint32_t B2 = R + 2 * lane_b_off(ldb), B1 = R + 2 * lane_b1_off(ldb);
  for (int t = blockIdx.x, it = 0; t < ntiles; t += a.nslots, ++it) {
    const long long pix0 = (long long)b * a.HW + (long long)t * PT;
    const int np = min(PT, a.HW - t * PT), buf = a.wres ? it & 1 : 0;
    bf16* Vt = Vs + buf * PT * ldc;
    bf16* Xt = Xs + buf * PT * ldx;
    if (!a.wres) {
      issue_vx(t, 0);
      cp_async_wait_all();  // v and x, and the ring's pieces ahead
    } else if (t + a.nslots < ntiles) {
      issue_vx(t + a.nslots, buf ^ 1);  // the buffer the last tile freed
      cp_async_wait<1>();  // this tile's v and x (and, first, the resident rows)
    } else {
      cp_async_wait_all();
    }
    __syncthreads();

    // 1. av = attn v, rounded to bf16, a slab of attn's rows at a time
    for (int h0 = 0; h0 < a.heads; h0 += a.ha)
      for (int i0 = 0; i0 < d16; i0 += ar) {
        if (!attn_once) {
          if (h0 || i0) __syncthreads();  // the previous slab's tasks are done with At
          stage_attn(h0, i0);
          __syncthreads();
        }
        for (int tk = warp; tk < a.ha * ng * mg; tk += kThreads / 32) {
          const int hh = tk / (ng * mg), g = (tk / mg) % ng, mi = tk % mg, i = i0 + g * 16;
          if (i >= d) continue;
          float acc[2][2][4];
          zero_acc(acc);
          const uint32_t Av = smem_u32(Vt + mi * 32 * ldc + (h0 + hh) * d + lane_a_off(ldc));
          const uint32_t Ba = smem_u32(At + (hh * ar + g * 16) * lda);
          const uint32_t Ba2 = Ba + 2 * lane_b_off(lda), Ba1 = Ba + 2 * lane_b1_off(lda);
          for (int k = 0; k < d; k += 16)
            warp_mma_steps<2, 2, 1>(Av + 2 * k, 2 * ldc, Ba2 + 2 * k, Ba1 + 2 * k, 2 * lda, acc);
          for_each_acc(acc, [&](int r, int c, float v0, float v1) {
            if (i + c < d) store2(AV + (mi * 32 + r) * ldc + (h0 + hh) * d + i + c, v0, v1);
          });
        }
      }
    __syncthreads();  // every head's av is in AV

    // 2. x2 = x + W_proj av
    float acc[S::MT][NT][4];
    zero_acc(acc);
    if (a.wres) {
      for (int kp = 0; kp < P; ++kp)
        warp_mma_steps<S::MT, NT, kKP / 16>(A + kp * kKP * 2, ldc * 2, B2 + kp * kKP * 2,
                                            B1 + kp * kKP * 2, ldw * 2, acc);
    } else {
      for (int kp = 0; kp < P; ++kp) {
        cp_async_wait<kNS - 2>();
        __syncthreads();  // this piece landed; the last piece's slot is free
        const uint32_t slot = ((ip - (kNS - 1)) % kNS) * (S::NPC * kLdP * 2);
        issue();
        warp_mma_steps<S::MT, NT, kKP / 16>(A + kp * kKP * 2, ldc * 2, B2 + slot, B1 + slot,
                                            kLdP * 2, acc);
      }
    }
    const int m0 = wm * 16 * S::MT, c0 = wn * 8 * NT;
    for_each_acc(acc, [&](int r, int c, float v0, float v1) {
      const int m = m0 + r, n = c0 + c;
      if (n >= nc) return;
      const float2 xv = load2(Xt + m * ldx + n);
      store2(Xt + m * ldx + n, xv.x + v0, xv.y + v1);
    });
    __syncthreads();
    for (int e = tid; e < np * (nc / 8); e += kThreads) {
      const int m = e / (nc / 8), q = e % (nc / 8);
      *reinterpret_cast<uint4*>(a.x2 + (pix0 + m) * C + n0 + q * 8) =
          *reinterpret_cast<const uint4*>(Xt + m * ldx + q * 8);
    }
    __syncthreads();  // the tile's buffers are free for the next
  }
  cp_async_wait_all();  // no copy may outlive the block
}

template <int PT, int NT>
int launch_tc_at(const ApplyTcArgs& a, long long smem, cudaStream_t stream) {
  const int d16 = (a.C / a.heads + 15) / 16 * 16;
  if (smem != apply_tc_bytes<PT, NT>(a.C, a.heads, a.ncol, a.ha, a.ar, a.wres) || a.ncol % 8 ||
      a.ncol > ApplyShape<PT, NT>::NPC || a.ha < 1 || a.heads % a.ha || a.ar < 16 ||
      a.ar % 16 || a.ar > d16 || (a.ha > 1 && a.ar != d16) || a.nslots < 1 ||
      (a.wres != 0 && a.wres != 1))
    return cudaErrorInvalidValue;
  cudaError_t err = allow_smem_once<mdta_apply_tc_kernel<PT, NT>>();
  if (err != cudaSuccess) return err;
  const dim3 grid(a.nslots, a.B, (a.C + a.ncol - 1) / a.ncol);
  mdta_apply_tc_kernel<PT, NT><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

#define PK_APPLY(PT, NT) \
  if (pt == PT && nt == NT) return launch_tc_at<PT, NT>(a, smem, stream);

// The instantiations: 64 or 32 pixels, NT = ceil(ncol / 32) from 1 to 6.
int launch_tc(const ApplyTcArgs& a, int pt, long long smem, cudaStream_t stream) {
  const int nt = (a.ncol + 31) / 32;
  PK_APPLY(64, 1) PK_APPLY(64, 2) PK_APPLY(64, 3) PK_APPLY(64, 4) PK_APPLY(64, 5) PK_APPLY(64, 6)
  PK_APPLY(32, 1) PK_APPLY(32, 2) PK_APPLY(32, 3) PK_APPLY(32, 4) PK_APPLY(32, 5) PK_APPLY(32, 6)
  return cudaErrorInvalidValue;
}
#undef PK_APPLY

template <class T, int MP>
int launch(const ApplyArgs& a, size_t smem, cudaStream_t stream) {
  constexpr int PT = 16 * MP;
  cudaError_t err = allow_smem(mdta_apply_kernel<T, MP>, smem);
  if (err != cudaSuccess) return err;
  mdta_apply_kernel<T, MP><<<dim3((a.HW + PT - 1) / PT, a.B), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Returns the CUDA error code of the launch (0 on success) and
// cudaErrorInvalidValue for arguments no kernel takes. float32: `mp` is the
// pixel tile's 16-pixel groups (4 or 2) and `smem` its shared-memory bytes,
// both from ops/cuda/mdta.py (the wrapper checks the fit). bf16 (the plan
// of ops/cuda/mdta.py:apply_plan): `mp` is the block's pixels (64 or 32),
// `ncol` its output columns, `ha` and `ar` the heads and rows of attn
// staged at a time, `nslots` the blocks of an image and column block (each
// walking every nslots-th tile), `wres` 1 for W_proj resident in the block,
// and `smem` the bytes the kernel carves for them. attn is float32 in both.
extern "C" int ln_mdta_launch(int dtype, const void* v, const void* x, const void* attn,
                              const void* wproj, void* x2, int B, int H, int W, int C, int heads,
                              int mp, int ncol, int ha, int ar, int nslots, int wres,
                              long long smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    ApplyTcArgs a;
    a.v = static_cast<const bf16*>(v); a.x = static_cast<const bf16*>(x);
    a.attn = static_cast<const float*>(attn); a.wproj = static_cast<const bf16*>(wproj);
    a.x2 = static_cast<bf16*>(x2);
    a.B = B; a.HW = H * W; a.C = C; a.heads = heads; a.ncol = ncol; a.ha = ha; a.ar = ar;
    a.nslots = nslots; a.wres = wres;
    if (ncol < 8 || C % heads) return cudaErrorInvalidValue;
    return launch_tc(a, mp, smem, s);
  }
  ApplyArgs a;
  a.v = v; a.x = x; a.attn = attn; a.wproj = wproj; a.x2 = x2;
  a.B = B; a.HW = H * W; a.C = C; a.heads = heads;
  const size_t sm = static_cast<size_t>(smem);
  if (dtype == kF32 && mp == 4) return launch<float, 4>(a, sm, s);
  if (dtype == kF32 && mp == 2) return launch<float, 2>(a, sm, s);
  return cudaErrorInvalidValue;
}
