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
// double-buffered DMA. Here one thread block of 8 warps computes one 16x28
// tile of output pixels, directly at the output resolution:
//   - x window, 12x18 pixels of the 2x map (tile / 2 plus the conv_hr and
//     conv_last halos / 2 plus one for the phase conv), zero outside the
//     frame;
//   - z over the tile grown by 2 (20x32), h over the same flat array (only
//     its inner 18x30 is meaningful), rgb over the tile.
// Each is a flat pixel array in shared memory with 64 bf16 (128 bytes) per
// pixel row, so a 3x3 tap is a constant offset of the flat index and 16
// consecutive flat pixels are the 16 rows of one tensor-core A operand
// (mma.sync m16n8k16, bf16 in, float32 accumulate). Flat neighbours wrap
// across window rows only for pixels of a window's outer ring, which the
// next stage never reads for a pixel it keeps. h reuses the x window's space
// (x is dead once z exists): 77 KB for x / h, 81 KB for z.
//
// The dense block's primitives (rdb_block.cuh): the 16-byte chunks of each
// pixel row are XOR-swizzled by the buffer row (rdbk::swz), so the 8 rows of
// an ldmatrix phase hit 8 bank groups; A is read by ldmatrix.x4; B comes
// from the host in mma fragment order (cuda_sr.pack_uptail_weights), one
// 16-byte word a lane per (tap, 16-channel chunk) step and 16 output
// channels, read through L1 and reused over a warp's M tiles. The float32
// sums start at the bias (from shared memory); lrelu, the frame mask and the
// bf16 rounding run on the C fragments in registers and store straight into
// the swizzled rows (stage 1 scatters each row to its phase's z pixel);
// conv_last writes rgb from the lanes that hold its channels 0-2. The tile's
// width makes every stage even over the 8 warps: stage 1 is 12 M tiles x 4
// phases (3 a warp and phase, two phases at a time so that L1 holds their
// weights), stage 2 36 M tiles (4 a warp, the last 4 split by
// output-channel halves), stage 3 32 (4 a warp).
//
// What bounds it on the H100: the convs' bf16 tensor-core work, 219,904 MAC
// per pixel of the 2x map; the bytes (x in, rgb out) are a tenth of that
// time. The tile recomputes a 1.47x halo of z and h; one block an SM (shared
// memory), the x window loaded before the tile's first mma.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "rdb_block.cuh"

namespace {

using rdbk::bfr;
using rdbk::ldmatrix_x4;
using rdbk::mma_bf16;
using rdbk::pack2;
using rdbk::swz;
typedef __nv_bfloat16 bf16;

constexpr int kF = 64, kRow = 2 * kF;            // channels, bytes a row
constexpr int TH = 16, TW = 28;                  // output tile
constexpr int ZH = TH + 4, ZW = TW + 4;          // z window (halo 2): 20 x 32
constexpr int ZP = ZH * ZW;                      // 640 flat pixels
constexpr int XH = TH / 2 + 4, XW = TW / 2 + 4;  // x window, 2x map: 12 x 18
constexpr int XP = XH * XW;                      // 216
constexpr int PAD = 4;  // rows before a flat array
constexpr int kWarps = 8, kThreads = 32 * kWarps;
static_assert(TH % 2 == 0 && TW % 2 == 0, "the tile starts on a 2x pixel");

// stage 1: M tiles of 16 x-window pixels covering rows 1..XH-2, cols 1..XW-2
constexpr int S1_LO = (XW + 1) / 16 * 16;
constexpr int S1_HI = ((XH - 2) * XW + XW - 1 + 15) / 16 * 16;
constexpr int NM1 = (S1_HI - S1_LO) / 16;  // 12, times 4 phases
constexpr int MT1 = NM1 / (kWarps / 2);    // 3 a warp and phase
// stage 2: M tiles of 16 z-window pixels covering rows 1..ZH-2, cols 1..ZW-2
constexpr int S2_LO = (ZW + 1) / 16 * 16;
constexpr int S2_HI = ((ZH - 2) * ZW + ZW - 1 + 15) / 16 * 16;
constexpr int NM2 = (S2_HI - S2_LO) / 16;  // 36
constexpr int MT2 = NM2 / kWarps;          // 4 a warp, then halves of 4 more
// stage 3: M tiles covering rows 2..ZH-3, cols 2..ZW-3
constexpr int S3_LO = (2 * ZW + 2) / 16 * 16;
constexpr int S3_HI = ((ZH - 3) * ZW + ZW - 2 + 15) / 16 * 16;
constexpr int NM3 = (S3_HI - S3_LO) / 16;  // 32
constexpr int MT3 = NM3 / kWarps;          // 4 a warp
static_assert(kWarps == 8 && NM1 == MT1 * (kWarps / 2),
              "stage 1 even over the warps, two phases a pass");
static_assert(NM2 == MT2 * kWarps + kWarps / 2, "stage 2: 4 halves left");
static_assert(NM3 == MT3 * kWarps, "stage 3 even over the warps");
static_assert(S1_LO - XW - 1 >= -PAD && S2_LO - ZW - 1 >= -PAD &&
              S3_LO - ZW - 1 >= -PAD, "reads before a flat array");

// Buffer rows, trimmed to what is read and written, so that the block
// (with the 1 KB the system keeps) fits the 164 KB shared-memory carveout
// and leaves 92 KB of L1 to the weights (3% faster than 166 KB).
constexpr int cmax(int a, int b) { return a > b ? a : b; }
// x / h: x read up to S1_HI + XW, h written below S2_HI, read to S3_HI + ZW
constexpr int NROWA = PAD + cmax(cmax(S1_HI + XW + 1, S2_HI), S3_HI + ZW + 1);
// z: written over the whole window, read up to S2_HI + ZW
constexpr int NROWZ = PAD + cmax(ZP, S2_HI + ZW + 1);
constexpr size_t kBiasOff = (size_t)(NROWA + NROWZ) * kRow;  // 3 x 64 biases
constexpr size_t kSmem = kBiasOff + 3 * kF * sizeof(float);
static_assert(kSmem + 1024 <= 164 * 1024, "the 164 KB carveout");
static_assert(PAD + XP <= NROWA, "x fits h's space");

// lrelu(v) = v >= 0 ? v : 0.2 v, as max(v, 0.2 v): two instructions
__device__ __forceinline__ float lrelu(float v) { return fmaxf(v, 0.2f * v); }

struct UptailArgs {
  const bf16* x;       // [H2, W2, 64]
  float* out;          // [2 H2, 2 W2, 3]
  const uint4* kup;    // 4 phases x 16 steps x 4 pairs x 32 lanes
  const uint4* khr;    // 36 steps x 4 pairs x 32 lanes
  const uint2* klast;  // 36 steps x 32 lanes (one n8 tile, 3 live columns)
  const float* bias;   // [3][64]
  int H2, W2;
};

// acc[mt][j] += the conv of M tile mt (this lane's A row at buffer row
// rowb[mt]) with NP pairs of output-channel tiles. Tap t is
// (t / TAPW, t % TAPW) at row offset sh0 + (t / TAPW) ROWW + t % TAPW; step
// i = 4 t + c reads input chunk c (16 channels). w: this lane's B word of
// step 0, first pair; step i, pair p at w[(4 i + p) * 32] (4 pairs a step).
template <int MT, int NP, int NTAP, int TAPW, int ROWW>
__device__ __forceinline__ void conv(float (&acc)[MT][2 * NP][4],
                                     uint32_t buf, const uint4* w, int sh0,
                                     const int (&rowb)[MT]) {
  const int sel = (threadIdx.x & 31) >> 4;
#pragma unroll 1
  for (int t = 0; t < NTAP; ++t) {
    const int sh = sh0 + (t / TAPW) * ROWW + t % TAPW;
#pragma unroll
    for (int c = 0; c < kF / 16; ++c) {
      uint4 b[NP];
#pragma unroll
      for (int p = 0; p < NP; ++p) b[p] = __ldg(w + ((4 * t + c) * 4 + p) * 32);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t a[4];
        ldmatrix_x4(buf + swz(rowb[mt] + sh, 2 * c + sel, kRow), a);
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          mma_bf16(acc[mt][2 * p], a, b[p].x, b[p].y);
          mma_bf16(acc[mt][2 * p + 1], a, b[p].z, b[p].w);
        }
      }
    }
  }
}

// Start every accumulator of NJ n8 tiles (channel chunks j0..j0+NJ-1) at
// its channel's bias (64 floats in shared memory): the float32 sum then
// holds the bias, and the epilogue has no addition to make.
template <int MT, int NJ>
__device__ __forceinline__ void init_bias(float (&acc)[MT][NJ][4],
                                          const float* bias, int j0) {
  const int tq = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const float2 b = reinterpret_cast<const float2*>(bias + 8 * (j0 + j))[tq];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      acc[mt][j][0] = acc[mt][j][2] = b.x;
      acc[mt][j][1] = acc[mt][j][3] = b.y;
    }
  }
}

// lrelu(acc) of NJ n8 tiles (channel chunks j0..j0+NJ-1), or zeros when
// !keep, as bf16 into chunk j0 + j of buffer row `row`: the C fragment's row
// half hr of this lane (g = lane / 4, tq = lane % 4).
template <int NJ>
__device__ __forceinline__ void store_rows(unsigned char* buf, int row,
                                           bool keep,
                                           const float (&acc)[NJ][4], int hr,
                                           int j0) {
  const int tq = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const float v0 = keep ? lrelu(acc[j][2 * hr]) : 0.f;
    const float v1 = keep ? lrelu(acc[j][2 * hr + 1]) : 0.f;
    *reinterpret_cast<uint32_t*>(buf + swz(row, j0 + j, kRow) + 4 * tq) =
        pack2(v0, v1);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
uptail_kernel(const UptailArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  // flat pixel q of an array sits at row PAD + q of its buffer
  unsigned char* bufA = smem;                        // x, then h
  unsigned char* bufZ = smem + (size_t)NROWA * kRow;  // z
  const uint32_t sA = (uint32_t)__cvta_generic_to_shared(bufA);
  const uint32_t sZ = (uint32_t)__cvta_generic_to_shared(bufZ);
  float* bias = reinterpret_cast<float*>(smem + kBiasOff);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2;  // C fragment row (and row + 8)

  const int H4 = 2 * p.H2, W4 = 2 * p.W2;
  const int Y0 = (int)blockIdx.y * TH, X0 = (int)blockIdx.x * TW;
  const int zy0 = Y0 - 2, zx0 = X0 - 2;            // z window origin
  const int xy0 = Y0 / 2 - 2, xx0 = X0 / 2 - 2;    // x window origin, 2x map
  auto z_inframe = [&](int zr, int zc) {
    const int gy = zy0 + zr, gx = zx0 + zc;
    return gy >= 0 && gy < H4 && gx >= 0 && gx < W4;
  };

  // ---- the biases and the x window, zero outside the frame -----------------
  if (tid < 3 * kF) bias[tid] = __ldg(p.bias + tid);
  for (int i = tid; i < XP * (kF / 8); i += kThreads) {
    const int px = i / (kF / 8), part = i % (kF / 8);
    const int gy = xy0 + px / XW, gx = xx0 + px % XW;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (gy >= 0 && gy < p.H2 && gx >= 0 && gx < p.W2)
      v = __ldg(reinterpret_cast<const uint4*>(
                    p.x + ((size_t)gy * p.W2 + gx) * kF) + part);
    *reinterpret_cast<uint4*>(bufA + swz(PAD + px, part, kRow)) = v;
  }
  __syncthreads();

  // ---- stage 1: z = lrelu(phase conv of x + b), scattered by phase --------
  // two phases a pass (warps 0-3 and 4-7, so the weights of two phases are
  // read at a time), MT1 M tiles a warp
  {
    const int m0 = (warp & 3) * MT1;  // this warp's first M tile
#pragma unroll 1
    for (int pass = 0; pass < 2; ++pass) {
      const int ph = 2 * pass + (warp >> 2), qy = ph >> 1, qx = ph & 1;
      int rowb[MT1];
#pragma unroll
      for (int mt = 0; mt < MT1; ++mt)
        rowb[mt] = PAD + S1_LO + 16 * (m0 + mt) + (lane & 15);
      float acc[MT1][8][4];
      init_bias(acc, bias, 0);
      conv<MT1, 4, 4, 2, XW>(acc, sA, p.kup + ph * (16 * 4 * 32) + lane,
                             -(1 - qy) * XW - (1 - qx), rowb);
#pragma unroll
      for (int mt = 0; mt < MT1; ++mt)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int px = S1_LO + 16 * (m0 + mt) + g + 8 * hr;
          const int r = px / XW, c = px % XW;
          if (r < 1 || r > XH - 2 || c < 1 || c > XW - 2) continue;
          const int zr = 2 * (r - 1) + qy, zc = 2 * (c - 1) + qx;
          store_rows<8>(bufZ, PAD + zr * ZW + zc, z_inframe(zr, zc), acc[mt],
                        hr, 0);
        }
    }
  }
  __syncthreads();

  // ---- stage 2: h = lrelu(conv_hr(z) + b) into x's space ------------------
  // M tiles warp + 8 mt, then half (32 channels) of one of the last four
  {
    int rowb[MT2];
#pragma unroll
    for (int mt = 0; mt < MT2; ++mt)
      rowb[mt] = PAD + S2_LO + 16 * (warp + kWarps * mt) + (lane & 15);
    const uint4* w = p.khr + lane;
    {
      float acc[MT2][8][4];
      init_bias(acc, bias + kF, 0);
      conv<MT2, 4, 9, 3, ZW>(acc, sZ, w, -ZW - 1, rowb);
#pragma unroll
      for (int mt = 0; mt < MT2; ++mt)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int q = S2_LO + 16 * (warp + kWarps * mt) + g + 8 * hr;
          store_rows<8>(bufA, PAD + q, z_inframe(q / ZW, q % ZW), acc[mt], hr,
                        0);
        }
    }
    const int m = MT2 * kWarps + (warp >> 1), half = warp & 1;
    const int rb[1] = {PAD + S2_LO + 16 * m + (lane & 15)};
    float acc[1][4][4];
    init_bias(acc, bias + kF, 4 * half);
    conv<1, 2, 9, 3, ZW>(acc, sZ, w + 2 * half * 32, -ZW - 1, rb);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int q = S2_LO + 16 * m + g + 8 * hr;
      store_rows<4>(bufA, PAD + q, z_inframe(q / ZW, q % ZW), acc[0], hr,
                    4 * half);
    }
  }
  __syncthreads();

  // ---- stage 3: rgb = conv_last(h) + b, rounded to bf16, stored -----------
  {
    const int sel = lane >> 4, tq = lane & 3;
    int rowb[MT3];
#pragma unroll
    for (int mt = 0; mt < MT3; ++mt)
      rowb[mt] = PAD + S3_LO + 16 * (warp + kWarps * mt) + (lane & 15);
    const float2 bl = reinterpret_cast<const float2*>(bias + 2 * kF)[tq];
    float acc[MT3][4];
#pragma unroll
    for (int mt = 0; mt < MT3; ++mt) {
      acc[mt][0] = acc[mt][2] = bl.x;
      acc[mt][1] = acc[mt][3] = bl.y;
    }
    const uint2* w = p.klast + lane;
#pragma unroll 1
    for (int t = 0; t < 9; ++t) {
      const int sh = (t / 3 - 1) * ZW + t % 3 - 1;
#pragma unroll
      for (int c = 0; c < kF / 16; ++c) {
        const uint2 b = __ldg(w + (4 * t + c) * 32);
#pragma unroll
        for (int mt = 0; mt < MT3; ++mt) {
          uint32_t a[4];
          ldmatrix_x4(sA + swz(rowb[mt] + sh, 2 * c + sel, kRow), a);
          mma_bf16(acc[mt], a, b.x, b.y);
        }
      }
    }
    if (tq < 2) {  // lanes holding channels 0-1 (tq 0) and 2 (tq 1)
#pragma unroll
      for (int mt = 0; mt < MT3; ++mt)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int q = S3_LO + 16 * (warp + kWarps * mt) + g + 8 * hr;
          const int zr = q / ZW, zc = q % ZW;
          const int gy = zy0 + zr, gx = zx0 + zc;
          if (zr < 2 || zr >= TH + 2 || zc < 2 || zc >= TW + 2 || gy >= H4 ||
              gx >= W4)
            continue;
          float* o = p.out + ((size_t)gy * W4 + gx) * 3 + 2 * tq;
          o[0] = bfr(acc[mt][2 * hr]);
          if (tq == 0) o[1] = bfr(acc[mt][2 * hr + 1]);
        }
    }
  }
}

}  // namespace

extern "C" int uptail_launch(const void* x, void* out, const void* kup,
                             const void* khr, const void* klast,
                             const float* bias, int H2, int W2, void* stream) {
  UptailArgs args{static_cast<const bf16*>(x), static_cast<float*>(out),
                  static_cast<const uint4*>(kup),
                  static_cast<const uint4*>(khr),
                  static_cast<const uint2*>(klast), bias, H2, W2};
  if (H2 == 0 || W2 == 0) return 0;
  cudaError_t e = cudaFuncSetAttribute(
      uptail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((2 * W2 + TW - 1) / TW, (2 * H2 + TH - 1) / TH);
  uptail_kernel<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      args);
  return (int)cudaGetLastError();
}

// MACs the kernel issues for an H2 x W2 input, halo and padding included:
// per tile, stage 1's 4 phases x NM1 M tiles x 4 taps, stage 2's NM2 x 9
// taps (64 x 64 channels each) and stage 3's NM3 x 9 taps of one n8 tile.
extern "C" long long uptail_issued_macs(int H2, int W2) {
  const long long tiles = (long long)((2 * W2 + TW - 1) / TW) *
                          ((2 * H2 + TH - 1) / TH);
  const long long per_tile = 16LL * kF * kF * (4 * NM1 * 4 + NM2 * 9) +
                             16LL * kF * 8 * NM3 * 9;
  return tiles * per_tile;
}

extern "C" const char* uptail_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
