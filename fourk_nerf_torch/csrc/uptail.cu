// The fused x4 upsample tail of the SFTNet decoder for Hopper (sm_90a).
//
// Replaces the TPU kernel _uptail_kernel of the JAX reference package's
// ops/pallas_sr.py (pallas_call at pallas_sr.py:812). From the post-lrelu
// conv_up1 output x [H2, W2, 64] (bf16) it computes, at the output
// resolution H4 x W4 = 2 H2 x 2 W2,
//   z   = lrelu(conv3x3(nearest_up2(x)) + b_up2)      64 channels
//   h   = lrelu(conv3x3(z) + b_hr)                    64 channels
//   rgb = conv3x3(h) + b_last                          3 channels
// and writes only rgb: z and h never reach device memory. Operands are bf16,
// sums float32; x, z, h and rgb are rounded to bf16 where the TPU kernel
// rounds them (rgb too: it is stored as float32 holding bf16 values). Every
// conv sees SAME zero padding at the true frame edge: pixels outside
// [0,H4)x[0,W4) are zeroed after each stage, x outside [0,H2)x[0,W2) on load.
//
// conv3x3(nearest_up2(x)) is evaluated as the TPU kernel evaluates it, by
// phase: output pixel (2i+qy, 2j+qx) is a 2x2 conv of x around (i, j) with
// the summed-tap kernel kup[2qy+qx] (taps summed in float32, rounded to bf16
// once, by the packer), reading rows i+dy-(1-qy) and columns j+dx-(1-qx).
//
// Design. The TPU kernel works on the space-to-depth form (256-channel
// phase tensors, 128-lane layouts) and walks its tiles in order with a
// double-buffered DMA. Here one thread block computes one 16x32 tile of
// output pixels, directly at the output resolution:
//   - x window, 12x20 pixels of the 2x map (tile / 2 plus the conv_hr and
//     conv_last halos / 2 plus one for the phase conv), zero outside the
//     frame;
//   - z over the tile grown by 2 (20x36), h over the same flat array (only
//     its inner 18x34 is meaningful), rgb over the tile.
// Each is a flat pixel array in shared memory with 64 bf16 per pixel, so a
// 3x3 tap is a constant offset of the flat index and 16 consecutive flat
// pixels are one tensor-core operand (nvcuda::wmma, bf16 in, float32
// accumulate). Flat neighbours wrap across window rows only for pixels of a
// window's outer ring, which the next stage never reads for a pixel it
// keeps. h reuses the x window's space (x is dead once z exists): 94 KB for
// x / h, 94 KB for z, 8 KB of per-warp staging. Weights are read as wmma
// fragments from L2, each fragment reused over 3-4 pixel tiles.
//
// What bounds it on the H100: the convs' bf16 tensor-core work, 219,904 MAC
// per pixel of the 2x map; the bytes (x in, rgb out) are a tenth of that
// time. This first version is simple: one block per SM (shared memory), no
// staged weights, no wgmma / TMA pipeline, 128-byte pixel rows (bank
// conflicts on the operand loads), ~1.4x halo recompute of z.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int kF = 64;
constexpr int TH = 16, TW = 32;                  // output tile
constexpr int ZH = TH + 4, ZW = TW + 4;          // z window (halo 2): 20 x 36
constexpr int ZP = ZH * ZW;                      // 720 flat pixels
constexpr int XH = TH / 2 + 4, XW = TW / 2 + 4;  // x window, 2x map: 12 x 20
constexpr int XP = XH * XW;                      // 240
constexpr int PAD = 16;  // slack pixels before and after a flat array: a
                         // tile of 16 shifted by a tap over-reads <= 5
// Elements per pixel row: 64 keeps every operand pointer 32-byte aligned, as
// wmma documents.
constexpr int LD = 64;
constexpr int kWarps = 8, kThreads = 32 * kWarps;
constexpr size_t kBufBytes = (size_t)(PAD + ZP + PAD) * LD * 2;
constexpr size_t kSmem = 2 * kBufBytes + (size_t)kWarps * 256 * 4;
static_assert(kSmem <= 232448, "shared memory over the sm_90 limit");
static_assert(ZP % 16 == 0 && XP % 16 == 0 && XP <= ZP, "flat arrays");
static_assert(TH % 2 == 0 && TW % 2 == 0, "the tile starts on a 2x pixel");

// stage 1: tiles of 16 x-window pixels covering rows 1..XH-2, cols 1..XW-2
constexpr int S1_LO = (XW + 1) / 16 * 16;
constexpr int S1_HI = ((XH - 2) * XW + XW - 1 + 15) / 16 * 16;
constexpr int NM1 = (S1_HI - S1_LO) / 16;  // 13
constexpr int MT1 = 4;
// stage 2: tiles of 16 z-window pixels covering rows 1..ZH-2
constexpr int S2_LO = ZW / 16 * 16;
constexpr int S2_HI = ((ZH - 1) * ZW + 15) / 16 * 16;
constexpr int NM2 = (S2_HI - S2_LO) / 16;  // 41
constexpr int MT2 = 3;
// stage 3: tiles of 32 pixels covering rows 2..ZH-3, cols 2..ZW-3
constexpr int S3_LO = (2 * ZW + 2) / 32 * 32;
constexpr int S3_HI = ((ZH - 3) * ZW + ZW - 2 + 31) / 32 * 32;
constexpr int NM3 = (S3_HI - S3_LO) / 32;  // 19
static_assert(S1_LO - XW - 1 >= -PAD && S1_HI + XW + 1 <= ZP + PAD, "x reads");
static_assert(S2_LO - ZW - 1 >= -PAD && S2_HI + ZW + 1 <= ZP + PAD, "z reads");
static_assert(S3_LO - ZW - 1 >= -PAD && S3_HI + ZW + 1 <= ZP + PAD, "h reads");

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> AccFrag;

__device__ __forceinline__ float lrelu(float v) {
  return v >= 0.f ? v : 0.2f * v;
}

struct UptailArgs {
  const bf16* x;      // [H2, W2, 64]
  float* out;         // [2 H2, 2 W2, 3]
  const bf16* kup;    // [4 phases][4 taps][64][64]
  const bf16* khr;    // [9][64][64]
  const bf16* klast;  // [9][64][8], 3 live output channels
  const float* bias;  // [3][64]
  int H2, W2;
};

// acc[mt][nt] = sum over NTAPS taps and 4 input chunks of
// src[q0[mt] + shift[tap]] x w[tap]; 64 output channels as 4 tiles of 16.
template <int MT, int NTAPS>
__device__ __forceinline__ void conv64(AccFrag (&acc)[MT][4], const bf16* src,
                                       const bf16* w, const int (&shift)[NTAPS],
                                       const int (&q0)[MT]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) wmma::fill_fragment(acc[mt][nt], 0.f);
#pragma unroll
  for (int t = 0; t < NTAPS; ++t) {
#pragma unroll
    for (int c = 0; c < kF / 16; ++c) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        wmma::load_matrix_sync(b[nt], w + (size_t)(t * kF + 16 * c) * kF + 16 * nt,
                               kF);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (q0[mt] < 0) continue;
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, src + (q0[mt] + shift[t]) * LD + 16 * c, LD);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          wmma::mma_sync(acc[mt][nt], a, b[nt], acc[mt][nt]);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
uptail_kernel(const UptailArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  // flat pixel 0 of each array sits PAD pixels into its buffer
  bf16* bufA = reinterpret_cast<bf16*>(smem) + PAD * LD;              // x, then h
  bf16* bufZ = reinterpret_cast<bf16*>(smem + kBufBytes) + PAD * LD;  // z
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float* scr = reinterpret_cast<float*>(smem + 2 * kBufBytes) + warp * 256;

  const int H4 = 2 * p.H2, W4 = 2 * p.W2;
  const int Y0 = (int)blockIdx.y * TH, X0 = (int)blockIdx.x * TW;
  const int zy0 = Y0 - 2, zx0 = X0 - 2;            // z window origin
  const int xy0 = Y0 / 2 - 2, xx0 = X0 / 2 - 2;    // x window origin, 2x map
  auto z_inframe = [&](int q) {
    const int gy = zy0 + q / ZW, gx = zx0 + q % ZW;
    return gy >= 0 && gy < H4 && gx >= 0 && gx < W4;
  };

  // ---- x window, zero outside the frame -----------------------------------
  for (int i = tid; i < XP * (kF / 8); i += kThreads) {
    const int px = i / (kF / 8), part = i % (kF / 8);
    const int gy = xy0 + px / XW, gx = xx0 + px % XW;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (gy >= 0 && gy < p.H2 && gx >= 0 && gx < p.W2)
      v = __ldg(reinterpret_cast<const uint4*>(
                    p.x + ((size_t)gy * p.W2 + gx) * kF) + part);
    *reinterpret_cast<uint4*>(bufA + px * LD + 8 * part) = v;
  }
  __syncthreads();

  // ---- stage 1: z = lrelu(phase conv of x + b), scattered by phase --------
  {
    const int ph = warp % 4, qy = ph / 2, qx = ph % 2;
    int shift[4];
#pragma unroll
    for (int t = 0; t < 4; ++t)
      shift[t] = (t / 2 - (1 - qy)) * XW + (t % 2 - (1 - qx));
    for (int base = warp / 4; base < NM1; base += 2 * MT1) {
      int q0[MT1];
#pragma unroll
      for (int mt = 0; mt < MT1; ++mt) {
        const int m = base + 2 * mt;
        q0[mt] = m < NM1 ? S1_LO + 16 * m : -1;
      }
      AccFrag acc[MT1][4];
      conv64<MT1, 4>(acc, bufA, p.kup + (size_t)ph * 4 * kF * kF, shift, q0);
#pragma unroll
      for (int mt = 0; mt < MT1; ++mt) {
        if (q0[mt] < 0) continue;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          wmma::store_matrix_sync(scr, acc[mt][nt], 16, wmma::mem_row_major);
          __syncwarp();
          for (int e = lane; e < 256; e += 32) {
            const int px = q0[mt] + e / 16, n = 16 * nt + e % 16;
            const int r = px / XW, c = px % XW;
            if (r >= 1 && r <= XH - 2 && c >= 1 && c <= XW - 2) {
              const int q = (2 * (r - 1) + qy) * ZW + 2 * (c - 1) + qx;
              float v = lrelu(scr[e] + __ldg(p.bias + n));
              if (!z_inframe(q)) v = 0.f;
              bufZ[q * LD + n] = __float2bfloat16_rn(v);
            }
          }
          __syncwarp();
        }
      }
    }
  }
  __syncthreads();

  // ---- stage 2: h = lrelu(conv_hr(z) + b) into x's space ------------------
  {
    int shift[9];
#pragma unroll
    for (int t = 0; t < 9; ++t) shift[t] = (t / 3 - 1) * ZW + (t % 3 - 1);
    for (int base = warp; base < NM2; base += kWarps * MT2) {
      int q0[MT2];
#pragma unroll
      for (int mt = 0; mt < MT2; ++mt) {
        const int m = base + kWarps * mt;
        q0[mt] = m < NM2 ? S2_LO + 16 * m : -1;
      }
      AccFrag acc[MT2][4];
      conv64<MT2, 9>(acc, bufZ, p.khr, shift, q0);
#pragma unroll
      for (int mt = 0; mt < MT2; ++mt) {
        if (q0[mt] < 0) continue;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          wmma::store_matrix_sync(scr, acc[mt][nt], 16, wmma::mem_row_major);
          __syncwarp();
          for (int e = lane; e < 256; e += 32) {
            const int q = q0[mt] + e / 16, n = 16 * nt + e % 16;
            float v = lrelu(scr[e] + __ldg(p.bias + kF + n));
            if (q >= ZP || !z_inframe(q)) v = 0.f;
            bufA[q * LD + n] = __float2bfloat16_rn(v);
          }
          __syncwarp();
        }
      }
    }
  }
  __syncthreads();

  // ---- stage 3: rgb = conv_last(h) + b, rounded to bf16, stored -----------
  for (int m = warp; m < NM3; m += kWarps) {
    const int q0 = S3_LO + 32 * m;
    wmma::fragment<wmma::accumulator, 32, 8, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll 1
    for (int t = 0; t < 9; ++t) {
      const int shift = (t / 3 - 1) * ZW + (t % 3 - 1);
#pragma unroll
      for (int c = 0; c < kF / 16; ++c) {
        wmma::fragment<wmma::matrix_b, 32, 8, 16, bf16, wmma::row_major> b;
        wmma::fragment<wmma::matrix_a, 32, 8, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(b, p.klast + (size_t)(t * kF + 16 * c) * 8, 8);
        wmma::load_matrix_sync(a, bufA + (q0 + shift) * LD + 16 * c, LD);
        wmma::mma_sync(acc, a, b, acc);
      }
    }
    wmma::store_matrix_sync(scr, acc, 8, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 32 * 3; e += 32) {
      const int q = q0 + e / 3, ch = e % 3;
      const int zr = q / ZW, zc = q % ZW;
      const int gy = zy0 + zr, gx = zx0 + zc;
      if (zr >= 2 && zr < TH + 2 && zc >= 2 && zc < TW + 2 && gy < H4 &&
          gx < W4) {
        const float v = scr[(e / 3) * 8 + ch] + __ldg(p.bias + 2 * kF + ch);
        p.out[((size_t)gy * W4 + gx) * 3 + ch] =
            __bfloat162float(__float2bfloat16_rn(v));
      }
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" int uptail_launch(const void* x, void* out, const void* kup,
                             const void* khr, const void* klast,
                             const float* bias, int H2, int W2, void* stream) {
  UptailArgs args{static_cast<const bf16*>(x), static_cast<float*>(out),
                  static_cast<const bf16*>(kup), static_cast<const bf16*>(khr),
                  static_cast<const bf16*>(klast), bias, H2, W2};
  if (H2 == 0 || W2 == 0) return 0;
  cudaError_t e = cudaFuncSetAttribute(
      uptail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((2 * W2 + TW - 1) / TW, (2 * H2 + TH - 1) / TH);
  uptail_kernel<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      args);
  return (int)cudaGetLastError();
}

extern "C" const char* uptail_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
