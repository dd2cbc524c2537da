// The SFT residual dense block of the SFTNet decoder as device code for
// Hopper (sm_90a) on mma.sync: rrdb.cu runs it three blocks deep (a whole
// RRDB per launch), and uptail.cu takes its primitives (swz, ldmatrix_x4,
// mma_bf16, pack2, bfr). rdb.cu (one block per launch) takes its geometry
// (the tile, the halo-5 window, conv5's rows), its primitives and
// cond_frag, and runs the convs on wgmma with a window layout and a weight
// stream of its own.
//
// dense_block_tile computes one 8x16 output tile of one dense block from a
// halo-5 window (five 3x3 convs deep):
//   xc0 = SFT0(x, cond)
//   y_s = lrelu(conv3x3_s([xc0, y_1 .. y_{s-1}]) + b_s),  s = 1..4
//   y_4 <- SFT1(y_4, cond)
//   out = (conv3x3_5([xc0, y_1 .. y_4]) + b_5) * 0.2 + x
// and, with a tail, out <- SFT_rrdb(out, cond) * 0.2 + residual. The window
// is a flat [18*26] pixel array in shared memory, so a 3x3 tap is a constant
// offset in the flat index and 16 consecutive pixels form the 16 rows of
// one tensor-core A operand (mma.sync m16n8k16, bf16 in, float32
// accumulate). Flat neighbours wrap across window rows only for pixels of
// the outer ring, which the shrinking valid region (one ring per conv) never
// reads. xc0 (64 ch, 128-byte pixel rows) and the dense concat y_1..y_4
// (4 x 32 ch, 256-byte rows) stay in shared memory (~204 KB) for the whole
// block. Pixels outside the frame are zeroed after every stage, which is
// SAME padding. Storage between convs is bf16, sums are float32.
//
// Shared-memory layout. The 16-byte chunks (8 channels) of each pixel row
// are XOR-swizzled by the buffer row index (chunk ^ (row & 7)), so the 8
// rows that one ldmatrix phase reads hit 8 different bank groups while the
// rows keep their 128 / 256 bytes. The swizzle depends on the absolute row,
// not on the tile, so a tap is still a constant row offset. Accumulators
// go through bias, lrelu and the frame mask straight from registers (the
// mma.sync C layout) into the swizzled slab.
//
// Weights. The host packs each conv in fragment order (cuda_sr.py,
// pack_rdb_weights, RdbWeights.conv): per (tap, 16-channel chunk) step and
// per 16 output channels, 512 bytes in which lane l finds its two B
// fragments of two n8 tiles as one 16-byte word, read by each warp from L2
// through L1 (the eight warps read the same step at about the same time).
// Staging the weights in shared memory through a cp.async ring, one
// barrier per slab, measured slower on the H100 than these loads; rdb.cu's
// ring has a barrier per stage and no block-wide one (PERF.md).
//
// SFT. Each SFT is two 1x1 branches, [pixels, 32] x [32, 32] to a
// bf16-rounded hidden layer, then [pixels, 32] x [32, C], on the tensor
// cores as well: one warp takes 16 pixels, the condition is its A operand
// straight from device memory, and the hidden layer's C fragments are
// rounded into the A fragments of the second product without leaving the
// registers. The 12 SFT matrices come as bf16 B operands in the same
// fragment order (read through L1, 4 KB each).
//
// Where x comes from, where out goes and what the tail adds are template
// parameters (Src / Dst functors over global pixel coordinates), so the
// same code reads a bf16 frame or a float32 scratch region.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rdbk {

constexpr int kF = 64, kG = 32;
constexpr int TH = 8, TW = 16, HALO = 5;
constexpr int WH = TH + 2 * HALO, WW = TW + 2 * HALO;  // 18 x 26 window
constexpr int P = WH * WW;                             // 468 pixels
constexpr int PP = (P + 15) / 16 * 16;                 // 480
constexpr int MARG = 32;  // >= WW + 1 rows of zeros before and after
constexpr int NB = MARG + PP + MARG;                   // buffer rows
constexpr int kWarps = 8, kThreads = 32 * kWarps;
constexpr int kXRow = kF * 2, kDRow = 4 * kG * 2;      // row bytes
constexpr size_t kXc0Bytes = (size_t)NB * kXRow;
constexpr size_t kDenseBytes = (size_t)NB * kDRow;
constexpr size_t kSmem = kXc0Bytes + kDenseBytes;
static_assert(kSmem <= 232448, "shared memory over the sm_90 limit");
static_assert(MARG >= WW + 1 && MARG % 8 == 0, "margin");

// M tile m of a conv goes to warp m % kWarps: up to MT tiles a warp for
// conv1..4 (conv1 has 27), MT5 for conv5, which only needs the core rows;
// its float32 result is staged in xc0's space with rows of kF + 4 floats
constexpr int Q5_LO = (HALO * WW) / 16 * 16;
constexpr int Q5_HI = ((HALO + TH) * WW + 15) / 16 * 16;
constexpr int NM5 = (Q5_HI - Q5_LO) / 16;
constexpr int MT = 4, MT5 = 2;
constexpr int kStage = kF + 4;
static_assert(27 <= kWarps * MT && NM5 <= kWarps * MT5, "tiles per warp");
static_assert((size_t)NM5 * 16 * kStage * 4 <= kXc0Bytes, "conv5 staging");

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float lrelu(float v) {
  return v >= 0.f ? v : 0.2f * v;
}
__device__ __forceinline__ float bfr(float v) {  // round to bf16 and back
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack2(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// byte offset of 16-byte chunk `ch` of buffer row `r` (rows of `rb` bytes)
__device__ __forceinline__ int swz(int r, int ch, int rb) {
  return r * rb + ((ch ^ (r & 7)) << 4);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&a)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr)
      : "memory");
}

// d += a * b: m16n8k16, bf16 operands, float32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The condition of pixels a (C rows g) and b (rows g + 8) of an M tile as
// the A fragments of two k-steps of 16 channels; zero for a pixel off the
// frame (its flag false, its index then unused).
__device__ __forceinline__ void cond_frag(const bf16* cond, bool ina,
                                          size_t ga, bool inb, size_t gb,
                                          uint32_t (&ac)[2][4]) {
  const int tq = threadIdx.x & 3;
  const uint32_t* pa = reinterpret_cast<const uint32_t*>(cond) + ga * 16 + tq;
  const uint32_t* pb = reinterpret_cast<const uint32_t*>(cond) + gb * 16 + tq;
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    ac[kk][0] = ina ? __ldg(pa + 8 * kk) : 0u;
    ac[kk][1] = inb ? __ldg(pb + 8 * kk) : 0u;
    ac[kk][2] = ina ? __ldg(pa + 8 * kk + 4) : 0u;
    ac[kk][3] = inb ? __ldg(pb + 8 * kk + 4) : 0u;
  }
}

// SFT matrix m: [32 in, 64 out] as B words, k-step kk, pair p, lane l at
// uint4 index (kk * 4 + p) * 32 + l
constexpr int kSftMat = 256;

// The hidden layer bf16(lrelu(ac M + b)) of 32 channels, as the A
// fragments of the next product (C tile j is k-step j / 2, half j % 2).
__device__ __forceinline__ void sft_hidden(const uint32_t (&ac)[2][4],
                                           const uint4* M, const float* b,
                                           uint32_t (&ah)[2][4]) {
  const int lane = threadIdx.x & 31, tq = lane & 3;
  float h[4][4] = {};
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const uint4 w = __ldg(M + (kk * 4 + p) * 32 + lane);
      mma_bf16(h[2 * p], ac[kk], w.x, w.y);
      mma_bf16(h[2 * p + 1], ac[kk], w.z, w.w);
    }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float b0 = __ldg(b + 8 * j + 2 * tq), b1 = __ldg(b + 8 * j + 2 * tq + 1);
    ah[j >> 1][2 * (j & 1)] = pack2(lrelu(h[j][0] + b0), lrelu(h[j][1] + b1));
    ah[j >> 1][2 * (j & 1) + 1] =
        pack2(lrelu(h[j][2] + b0), lrelu(h[j][3] + b1));
  }
}

// o = ah M + b over NT tiles of 8 output channels
template <int NT>
__device__ __forceinline__ void sft_out(const uint32_t (&ah)[2][4],
                                        const uint4* M, const float* b,
                                        float (&o)[NT][4]) {
  const int lane = threadIdx.x & 31, tq = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    o[j][0] = o[j][2] = __ldg(b + 8 * j + 2 * tq);
    o[j][1] = o[j][3] = __ldg(b + 8 * j + 2 * tq + 1);
  }
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int p = 0; p < NT / 2; ++p) {
      const uint4 w = __ldg(M + (kk * 4 + p) * 32 + lane);
      mma_bf16(o[2 * p], ah[kk], w.x, w.y);
      mma_bf16(o[2 * p + 1], ah[kk], w.z, w.w);
    }
}

// scale and shift (NT x 8 channels, C layout) of the SFT whose four
// matrices start at `base`, for one 16-pixel M tile
template <int NT>
__device__ __forceinline__ void sft_mma(const uint32_t (&ac)[2][4],
                                        const uint4* sftk, const float* sftb,
                                        int base, float (&sc)[NT][4],
                                        float (&sh)[NT][4]) {
  uint32_t ah[2][4];
  sft_hidden(ac, sftk + base * kSftMat, sftb + base * 64, ah);
  sft_out<NT>(ah, sftk + (base + 1) * kSftMat, sftb + (base + 1) * 64, sc);
  sft_hidden(ac, sftk + (base + 2) * kSftMat, sftb + (base + 2) * 64, ah);
  sft_out<NT>(ah, sftk + (base + 3) * kSftMat, sftb + (base + 3) * 64, sh);
}

// Accumulate the 9 NCH steps of a conv into acc: step i = t NCH + c is tap
// t and input chunk c (16 channels; chunk c < 4 from xc0, c >= 4 from the
// dense concat), the chunks of a tap unrolled. rowb[mt] is the buffer row of
// this lane's A row for the M tile mt (-1: none). B of step i, output pair
// p (16 channels) is the 16-byte word bsrc[(i * NP + p) * 32 + lane].
template <int NP, int MTT, int NCH>
__device__ __forceinline__ void conv_steps(float (&acc)[MTT][2 * NP][4],
                                           uint32_t xs, uint32_t ds,
                                           const uint4* bsrc,
                                           const int (&rowb)[MTT]) {
  const int lane = threadIdx.x & 31;
  const int sel = lane >> 4;
  for (int t = 0; t < 9; ++t)
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    const int i = t * NCH + c;
    const int shift = (t / 3 - 1) * WW + (t % 3 - 1);
    uint4 b[NP];
#pragma unroll
    for (int p = 0; p < NP; ++p) b[p] = bsrc[(i * NP + p) * 32 + lane];
    const bool lo = c < 4;
    const uint32_t base = lo ? xs : ds;
    const int rb = lo ? kXRow : kDRow;
    const int ch = 2 * (lo ? c : c - 4) + sel;
#pragma unroll
    for (int mt = 0; mt < MTT; ++mt) {
      if (rowb[mt] < 0) continue;
      const int r = rowb[mt] + shift;
      uint32_t a[4];
      ldmatrix_x4(base + swz(r, ch, rb), a);
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        mma_bf16(acc[mt][2 * p], a, b[p].x, b[p].y);
        mma_bf16(acc[mt][2 * p + 1], a, b[p].z, b[p].w);
      }
    }
  }
}

// x, residual: float value of channel k at global pixel (gy, gx).
struct SrcBf16 {  // a [H, W, 64] bf16 frame
  const bf16* p;
  int W;
  __device__ __forceinline__ float operator()(int gy, int gx, int k) const {
    return __bfloat162float(p[((size_t)gy * W + gx) * kF + k]);
  }
};
struct SrcF32 {  // a [rows, cols, 64] float32 region with origin (y0, x0);
                 // zero outside it
  const float* p;
  int y0, x0, rows, cols;
  __device__ __forceinline__ float operator()(int gy, int gx, int k) const {
    const int i = gy - y0, j = gx - x0;
    if (i < 0 || i >= rows || j < 0 || j >= cols) return 0.f;
    return p[((size_t)i * cols + j) * kF + k];
  }
};
// out: store channel k of global pixel (gy, gx); owns() limits the pixels
// this call may write.
struct DstBf16 {  // a [H, W, 64] bf16 frame, pixels below (ylim, xlim)
  bf16* p;
  int W, ylim, xlim;
  __device__ __forceinline__ bool owns(int gy, int gx) const {
    return gy < ylim && gx < xlim;
  }
  __device__ __forceinline__ void operator()(int gy, int gx, int k,
                                             float v) const {
    p[((size_t)gy * W + gx) * kF + k] = __float2bfloat16_rn(v);
  }
};
struct DstF32 {  // a float32 region, values kept unrounded
  float* p;
  int y0, x0, rows, cols;
  __device__ __forceinline__ bool owns(int gy, int gx) const {
    const int i = gy - y0, j = gx - x0;
    return i >= 0 && i < rows && j >= 0 && j < cols;
  }
  __device__ __forceinline__ void operator()(int gy, int gx, int k,
                                             float v) const {
    p[((size_t)(gy - y0) * cols + (gx - x0)) * kF + k] = v;
  }
};

struct BlockWeights {
  const bf16* wconv;  // conv s (s = 0..4): 9 (64 + 32 s) / 16 steps of
                      // cout_s / 16 x 512 bytes, in fragment order
  const float* bias;  // [5][64]
  const bf16* sftk;   // 12 x [32][64] in fragment order: sft0 (0..3), sft1
                      // (4..7), tail (8..11), each (scale0, scale1, shift0,
                      // shift1)
  const float* sftb;  // [12][64]
};

constexpr int kTailNone = 0;   // out = block(x)
constexpr int kTailRound = 1;  // bf16(SFT(out) * 0.2) + residual
constexpr int kTailF32 = 2;    // SFT(out) * 0.2 + residual, all float32

// One 8x16 output tile with origin (ty0, tx0) in frame coordinates (any
// integers; pixels outside [0,H)x[0,W) are padding). All kThreads threads of
// the block must call it together with kSmem bytes of shared memory.
template <class Src, class Dst, class Res>
__device__ void dense_block_tile(unsigned char* smem, const Src& xsrc,
                                 const Dst& dst, const Res& res,
                                 const bf16* cond_p, const BlockWeights p,
                                 int H, int W, int ty0, int tx0, int tail) {
  unsigned char* dense = smem + kXc0Bytes;
  const uint32_t xs = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t ds = xs + (uint32_t)kXc0Bytes;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tq = lane & 3;  // mma.sync C layout
  const int r0 = ty0 - HALO, c0 = tx0 - HALO;  // window origin
  auto inframe = [&](int q) {
    const int gy = r0 + q / WW, gx = c0 + q % WW;
    return q < P && gy >= 0 && gy < H && gx >= 0 && gx < W;
  };


  // zeros everywhere: margins, ring garbage stays finite, out-of-frame = 0
  __syncthreads();  // a previous tile's readers are done with the buffers
  {
    uint4* z = reinterpret_cast<uint4*>(smem);
    const int n = (int)(kSmem / 16);
    for (int i = tid; i < n; i += kThreads) z[i] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();

  // ---- xc0 = SFT0(x, cond) over the whole window, 16 pixels a warp -------
  const uint4* sftk = reinterpret_cast<const uint4*>(p.sftk);
  auto gidx = [&](int q) {
    return (size_t)(r0 + q / WW) * W + (c0 + q % WW);
  };
  for (int m = warp; m < PP / 16; m += kWarps) {
    const int qa = 16 * m + g, qb = qa + 8;
    const bool ina = inframe(qa), inb = inframe(qb);
    uint32_t ac[2][4];
    cond_frag(cond_p, ina, gidx(qa), inb, gidx(qb), ac);
    float sc[8][4], sh[8][4];
    sft_mma<8>(ac, sftk, p.sftb, 0, sc, sh);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int q = hr ? qb : qa;
      if (!(hr ? inb : ina)) continue;
      const int gy = r0 + q / WW, gx = c0 + q % WW, r = MARG + q;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = 8 * j + 2 * tq;
        const float v0 = xsrc(gy, gx, n) * (sc[j][2 * hr] + 1.f) + sh[j][2 * hr];
        const float v1 =
            xsrc(gy, gx, n + 1) * (sc[j][2 * hr + 1] + 1.f) + sh[j][2 * hr + 1];
        *reinterpret_cast<uint32_t*>(smem + swz(r, j, kXRow) + 4 * tq) =
            pack2(v0, v1);
      }
    }
  }
  __syncthreads();

  // ---- conv1..conv4 (32 out channels each) into the dense concat ----------
  const uint4* wconv = reinterpret_cast<const uint4*>(p.wconv);
  for (int s = 0; s < 4; ++s) {
    const int cs = s + 1, cin = kF + kG * s, nch = cin / 16;
    const int q_lo = (cs * WW) / 16 * 16;
    const int q_hi = ((WH - cs) * WW + 15) / 16 * 16;
    const int nm = (q_hi - q_lo) / 16;  // 27, 23, 21, 17: <= kWarps * MT
    float bias[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bias[j][0] = __ldg(p.bias + s * 64 + 8 * j + 2 * tq);
      bias[j][1] = __ldg(p.bias + s * 64 + 8 * j + 2 * tq + 1);
    }
    int q0[MT], rowb[MT];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int m = warp + kWarps * mt;
      q0[mt] = m < nm ? q_lo + 16 * m : -1;
      rowb[mt] = q0[mt] < 0 ? -1 : MARG + q0[mt] + (lane & 15);
    }
    float acc[MT][4][4] = {};
    switch (s) {
      case 0: conv_steps<2, MT, 4>(acc, xs, ds, wconv, rowb); break;
      case 1: conv_steps<2, MT, 6>(acc, xs, ds, wconv, rowb); break;
      case 2: conv_steps<2, MT, 8>(acc, xs, ds, wconv, rowb); break;
      default: conv_steps<2, MT, 10>(acc, xs, ds, wconv, rowb); break;
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if (q0[mt] < 0) continue;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int q = q0[mt] + g + 8 * hr, r = MARG + q;
        const bool keep = inframe(q);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float v0 = keep ? lrelu(acc[mt][j][2 * hr] + bias[j][0]) : 0.f;
          const float v1 =
              keep ? lrelu(acc[mt][j][2 * hr + 1] + bias[j][1]) : 0.f;
          *reinterpret_cast<uint32_t*>(dense + swz(r, 4 * s + j, kDRow) +
                                       4 * tq) = pack2(v0, v1);
        }
      }
    }
    wconv += 9 * nch * 2 * 32;  // 9 nch steps of 2 pairs
    __syncthreads();
  }

  // ---- y4 <- SFT1(y4, cond) on the rows conv5 reads ------------------------
  {
    constexpr int lo = 4 * WW, hi = (WH - 4) * WW;  // 260 pixels, 17 M tiles
    for (int m = warp; 16 * m < hi - lo; m += kWarps) {
      const int qa = lo + 16 * m + g, qb = qa + 8;
      const bool ina = qa < hi && inframe(qa), inb = qb < hi && inframe(qb);
      uint32_t ac[2][4];
      cond_frag(cond_p, ina, gidx(qa), inb, gidx(qb), ac);
      float sc[4][4], sh[4][4];
      sft_mma<4>(ac, sftk, p.sftb, 4, sc, sh);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        if (!(hr ? inb : ina)) continue;
        const int r = MARG + (hr ? qb : qa);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t* y = reinterpret_cast<uint32_t*>(
              dense + swz(r, 12 + j, kDRow) + 4 * tq);
          const float2 f = unpack2(*y);
          *y = pack2(f.x * (sc[j][2 * hr] + 1.f) + sh[j][2 * hr],
                     f.y * (sc[j][2 * hr + 1] + 1.f) + sh[j][2 * hr + 1]);
        }
      }
    }
  }
  __syncthreads();

  // ---- conv5 (64 out channels) on the core rows, staged in xc0's space ----
  {
    int q0[MT5], rowb[MT5];
#pragma unroll
    for (int mt = 0; mt < MT5; ++mt) {
      const int m = warp + kWarps * mt;
      q0[mt] = m < NM5 ? Q5_LO + 16 * m : -1;
      rowb[mt] = q0[mt] < 0 ? -1 : MARG + q0[mt] + (lane & 15);
    }
    float acc[MT5][8][4] = {};
    constexpr int nch = (kF + 4 * kG) / 16;
    conv_steps<4, MT5, nch>(acc, xs, ds, wconv, rowb);
    __syncthreads();  // every warp is done reading xc0
    float* stage = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int mt = 0; mt < MT5; ++mt) {
      if (q0[mt] < 0) continue;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float* row = stage + (size_t)(q0[mt] - Q5_LO + g + 8 * hr) * kStage;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<float2*>(row + 8 * j + 2 * tq) =
              make_float2(acc[mt][j][2 * hr], acc[mt][j][2 * hr + 1]);
      }
    }
  }
  __syncthreads();

  // ---- residual (+ RRDB tail) and store: one warp per core row ------------
  const float* stage = reinterpret_cast<const float*>(smem);
  for (int i = warp; i < TH; i += kWarps) {
    const int gy = ty0 + i;
    int gx[2];
    bool ok[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      gx[hr] = tx0 + g + 8 * hr;
      ok[hr] = gy >= 0 && gy < H && gx[hr] >= 0 && gx[hr] < W &&
               dst.owns(gy, gx[hr]);
    }
    float sc[8][4], sh[8][4];
    if (tail) {
      uint32_t ac[2][4];
      cond_frag(cond_p, ok[0], (size_t)gy * W + gx[0], ok[1],
                (size_t)gy * W + gx[1], ac);
      sft_mma<8>(ac, sftk, p.sftb, 8, sc, sh);
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      if (!ok[hr]) continue;
      const int q = (HALO + i) * WW + HALO + g + 8 * hr;
      const float* row = stage + (size_t)(q - Q5_LO) * kStage;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = 8 * j + 2 * tq + e;
          float o = (row[n] + __ldg(p.bias + 4 * 64 + n)) * 0.2f +
                    xsrc(gy, gx[hr], n);
          if (tail) {
            const float v =
                (o * (sc[j][2 * hr + e] + 1.f) + sh[j][2 * hr + e]) * 0.2f;
            o = (tail == kTailRound ? bfr(v) : v) + res(gy, gx[hr], n);
          }
          dst(gy, gx[hr], n, o);
        }
      }
    }
  }
}

}  // namespace rdbk
