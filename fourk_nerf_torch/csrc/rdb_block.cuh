// The SFT residual dense block of the SFTNet decoder as device code for
// Hopper (sm_90a), shared by rdb.cu (one block per launch) and rrdb.cu (a
// whole RRDB per launch).
//
// dense_block_tile computes one 8x16 output tile of one dense block from a
// halo-5 window (five 3x3 convs deep):
//   xc0 = SFT0(x, cond)
//   y_s = lrelu(conv3x3_s([xc0, y_1 .. y_{s-1}]) + b_s),  s = 1..4
//   y_4 <- SFT1(y_4, cond)
//   out = (conv3x3_5([xc0, y_1 .. y_4]) + b_5) * 0.2 + x
// and, with a tail, out <- SFT_rrdb(out, cond) * 0.2 + residual. The window
// is a flat [18*26] pixel array in shared memory, so a 3x3 tap is a constant
// offset in the flat index and 16 consecutive pixels form one 16x16
// tensor-core operand (nvcuda::wmma, bf16 in, float32 accumulate). Flat
// neighbours wrap across window rows only for pixels of the outer ring,
// which the shrinking valid region (one ring per conv) never reads. xc0
// (64 ch) and the dense concat y_1..y_4 (4 x 32 ch) stay in shared memory
// (~204 KB) for the whole block. Pixels outside the frame are zeroed after
// every stage, which is SAME padding. Conv weights are read as wmma
// fragments from L2; the SFT 1x1 layers run on the FP32 pipes, one thread
// per pixel. Storage between convs is bf16, sums are float32.
//
// Where x comes from, where out goes and what the tail adds are template
// parameters (Src / Dst functors over global pixel coordinates), so the
// same code reads a bf16 frame or a float32 scratch region.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace rdbk {

using namespace nvcuda;

constexpr int kF = 64, kG = 32;
constexpr int TH = 8, TW = 16, HALO = 5;
constexpr int WH = TH + 2 * HALO, WW = TW + 2 * HALO;  // 18 x 26 window
constexpr int P = WH * WW;                             // 468 pixels
constexpr int PP = (P + 15) / 16 * 16;                 // 480
constexpr int MARG = 32;  // >= WW + 1 rows of zeros before and after
constexpr int NB = MARG + PP + MARG;                   // buffer rows
constexpr int kWarps = 8, kThreads = 32 * kWarps;
constexpr size_t kXc0Bytes = (size_t)NB * kF * 2;
constexpr size_t kDenseBytes = (size_t)NB * 4 * kG * 2;
constexpr size_t kScratchBytes = (size_t)kWarps * 256 * 4;
constexpr size_t kSmem = kXc0Bytes + kDenseBytes + kScratchBytes;
static_assert(kSmem <= 232448, "shared memory over the sm_90 limit");
static_assert(MARG >= WW + 1 && MARG % 16 == 0, "margin");

// conv5 only needs the core rows
constexpr int Q5_LO = (HALO * WW) / 16 * 16;
constexpr int Q5_HI = ((HALO + TH) * WW + 15) / 16 * 16;
constexpr int NM5 = (Q5_HI - Q5_LO) / 16;
constexpr int MT5 = 2;
static_assert(NM5 <= kWarps * MT5, "conv5 tiles per pass");
static_assert((size_t)NM5 * 16 * kF * 4 <= kXc0Bytes, "conv5 staging");

typedef __nv_bfloat16 bf16;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> AccFrag;

__device__ __forceinline__ float lrelu(float v) {
  return v >= 0.f ? v : 0.2f * v;
}
__device__ __forceinline__ float bfr(float v) {  // round to bf16 and back
  return __bfloat162float(__float2bfloat16_rn(v));
}

// h[j] = bf16(lrelu(b[j] + sum_i c[i] * M[i][j])), j < 32 (M row stride 64)
__device__ __forceinline__ void sft_hidden(const float (&c)[32],
                                           const float* M, const float* b,
                                           float (&h)[32]) {
#pragma unroll
  for (int j = 0; j < 32; ++j) h[j] = __ldg(b + j);
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const float4* row = reinterpret_cast<const float4*>(M + i * 64);
#pragma unroll
    for (int j4 = 0; j4 < 8; ++j4) {
      const float4 w = __ldg(row + j4);
      h[4 * j4] += c[i] * w.x;
      h[4 * j4 + 1] += c[i] * w.y;
      h[4 * j4 + 2] += c[i] * w.z;
      h[4 * j4 + 3] += c[i] * w.w;
    }
  }
#pragma unroll
  for (int j = 0; j < 32; ++j) h[j] = bfr(lrelu(h[j]));
}

// out[e] = b[k0+e] + sum_j h[j] * M[j][k0+e], e < 4
__device__ __forceinline__ float4 sft_out4(const float (&h)[32],
                                           const float* M, const float* b,
                                           int k0) {
  float4 o = __ldg(reinterpret_cast<const float4*>(b + k0));
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const float4 w = __ldg(reinterpret_cast<const float4*>(M + j * 64 + k0));
    o.x += h[j] * w.x;
    o.y += h[j] * w.y;
    o.z += h[j] * w.z;
    o.w += h[j] * w.w;
  }
  return o;
}

__device__ __forceinline__ void load_cond(const bf16* p, float (&c)[32]) {
  const uint4* v = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint4 u = __ldg(v + i);
    const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
    for (int k = 0; k < 8; ++k) c[8 * i + k] = __bfloat162float(e[k]);
  }
}

// Accumulate conv s over the M tiles starting at flat pixels q0[mt]
// (-1: none) for all NT output-channel tiles: 9 taps x cin/16 chunks.
// Source chunk c < 4 is xc0 (ldm 64), c >= 4 the dense concat (ldm 128).
template <int NT, int MT>
__device__ __forceinline__ void conv_mma(AccFrag (&acc)[MT][NT],
                                         const bf16* xc0, const bf16* dense,
                                         const bf16* w, int cin,
                                         const int (&q0)[MT]) {
  constexpr int cout = NT * 16;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) wmma::fill_fragment(acc[mt][nt], 0.f);
  for (int t = 0; t < 9; ++t) {
    const int shift = (t / 3 - 1) * WW + (t % 3 - 1);
    for (int c = 0; c < cin / 16; ++c) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr_[NT];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        wmma::load_matrix_sync(bfr_[nt],
                               w + ((size_t)(t * cin + 16 * c)) * cout + 16 * nt,
                               cout);
      const bf16* src = c < 4 ? xc0 + 16 * c : dense + 16 * (c - 4);
      const int ldm = c < 4 ? kF : 4 * kG;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (q0[mt] < 0) continue;
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
        wmma::load_matrix_sync(af, src + (size_t)(MARG + q0[mt] + shift) * ldm,
                               ldm);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          wmma::mma_sync(acc[mt][nt], af, bfr_[nt], acc[mt][nt]);
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
  const bf16* wconv;  // conv s (s = 0..4): [9][64 + 32 s][cout_s], packed
  const float* bias;  // [5][64]
  const float* sftm;  // [12][32][64]: sft0 (0..3), sft1 (4..7), tail (8..11)
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
  bf16* xc0 = reinterpret_cast<bf16*>(smem);
  bf16* dense = reinterpret_cast<bf16*>(smem + kXc0Bytes);
  float* scratch = reinterpret_cast<float*>(smem + kXc0Bytes + kDenseBytes);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r0 = ty0 - HALO, c0 = tx0 - HALO;  // window origin
  auto inframe = [&](int q) {
    const int gy = r0 + q / WW, gx = c0 + q % WW;
    return q < P && gy >= 0 && gy < H && gx >= 0 && gx < W;
  };

  // zeros everywhere: margins, ring garbage stays finite, out-of-frame = 0
  __syncthreads();  // a previous tile's readers are done with the buffers
  {
    uint4* z = reinterpret_cast<uint4*>(smem);
    const int n = (int)((kXc0Bytes + kDenseBytes) / 16);
    for (int i = tid; i < n; i += kThreads) z[i] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();

  // ---- xc0 = SFT0(x, cond) over the whole window --------------------------
  for (int q = tid; q < P; q += kThreads) {
    if (!inframe(q)) continue;
    const size_t g = (size_t)(r0 + q / WW) * W + (c0 + q % WW);
    float c[32], hs[32], hh[32];
    load_cond(cond_p + g * kG, c);
    sft_hidden(c, p.sftm + 0 * 2048, p.sftb + 0 * 64, hs);
    sft_hidden(c, p.sftm + 2 * 2048, p.sftb + 2 * 64, hh);
    const int gy = r0 + q / WW, gx = c0 + q % WW;
    bf16* xd = xc0 + (size_t)(MARG + q) * kF;
    for (int k = 0; k < kF; k += 4) {
      const float4 sc = sft_out4(hs, p.sftm + 1 * 2048, p.sftb + 1 * 64, k);
      const float4 sh = sft_out4(hh, p.sftm + 3 * 2048, p.sftb + 3 * 64, k);
      const float scv[4] = {sc.x, sc.y, sc.z, sc.w};
      const float shv[4] = {sh.x, sh.y, sh.z, sh.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float xv = xsrc(gy, gx, k + e);
        xd[k + e] = __float2bfloat16_rn(xv * (scv[e] + 1.f) + shv[e]);
      }
    }
  }
  __syncthreads();

  // ---- conv1..conv4 (32 out channels each) into the dense concat ----------
  const bf16* wconv = p.wconv;
  float* scr = scratch + warp * 256;
  for (int s = 0; s < 4; ++s) {
    const int cs = s + 1, cin = kF + kG * s;
    const int q_lo = (cs * WW) / 16 * 16;
    const int q_hi = ((WH - cs) * WW + 15) / 16 * 16;
    const int nm = (q_hi - q_lo) / 16;
    constexpr int MT = 4;
    for (int base = warp; base < nm; base += kWarps * MT) {
      int q0[MT];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int m = base + kWarps * mt;
        q0[mt] = m < nm ? q_lo + 16 * m : -1;
      }
      AccFrag acc[MT][2];
      conv_mma<2, MT>(acc, xc0, dense, wconv, cin, q0);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (q0[mt] < 0) continue;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          wmma::store_matrix_sync(scr, acc[mt][nt], 16, wmma::mem_row_major);
          __syncwarp();
          for (int e = lane; e < 256; e += 32) {
            const int q = q0[mt] + e / 16, n = 16 * nt + e % 16;
            float v = lrelu(scr[e] + __ldg(p.bias + s * 64 + n));
            if (!inframe(q)) v = 0.f;
            dense[(size_t)(MARG + q) * 4 * kG + kG * s + n] =
                __float2bfloat16_rn(v);
          }
          __syncwarp();
        }
      }
    }
    wconv += (size_t)9 * cin * kG;
    __syncthreads();
  }

  // ---- y4 <- SFT1(y4, cond) on the rows conv5 reads ------------------------
  for (int q = 4 * WW + tid; q < (WH - 4) * WW; q += kThreads) {
    if (!inframe(q)) continue;
    const size_t g = (size_t)(r0 + q / WW) * W + (c0 + q % WW);
    float c[32], hs[32], hh[32];
    load_cond(cond_p + g * kG, c);
    sft_hidden(c, p.sftm + 4 * 2048, p.sftb + 4 * 64, hs);
    sft_hidden(c, p.sftm + 6 * 2048, p.sftb + 6 * 64, hh);
    bf16* y = dense + (size_t)(MARG + q) * 4 * kG + 3 * kG;
    for (int k = 0; k < kG; k += 4) {
      const float4 sc = sft_out4(hs, p.sftm + 5 * 2048, p.sftb + 5 * 64, k);
      const float4 sh = sft_out4(hh, p.sftm + 7 * 2048, p.sftb + 7 * 64, k);
      const float scv[4] = {sc.x, sc.y, sc.z, sc.w};
      const float shv[4] = {sh.x, sh.y, sh.z, sh.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float yv = __bfloat162float(y[k + e]);
        y[k + e] = __float2bfloat16_rn(yv * (scv[e] + 1.f) + shv[e]);
      }
    }
  }
  __syncthreads();

  // ---- conv5 (64 out channels) on the core rows, staged in xc0's space ----
  {
    int q0[MT5];
#pragma unroll
    for (int mt = 0; mt < MT5; ++mt) {
      const int m = warp + kWarps * mt;
      q0[mt] = m < NM5 ? Q5_LO + 16 * m : -1;
    }
    AccFrag acc[MT5][4];
    conv_mma<4, MT5>(acc, xc0, dense, wconv, kF + 4 * kG, q0);
    __syncthreads();  // every warp is done reading xc0
    float* stage = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int mt = 0; mt < MT5; ++mt) {
      if (q0[mt] < 0) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        wmma::store_matrix_sync(stage + (size_t)(q0[mt] - Q5_LO) * kF + 16 * nt,
                                acc[mt][nt], kF, wmma::mem_row_major);
    }
  }
  __syncthreads();

  // ---- residual (+ RRDB tail) and store, one thread per core pixel --------
  const float* stage = reinterpret_cast<const float*>(smem);
  for (int pix = tid; pix < TH * TW; pix += kThreads) {
    const int i = pix / TW, j = pix % TW;
    const int gy = ty0 + i, gx = tx0 + j;
    if (gy < 0 || gx < 0 || gy >= H || gx >= W || !dst.owns(gy, gx)) continue;
    const int q = (HALO + i) * WW + HALO + j;
    const float* row = stage + (size_t)(q - Q5_LO) * kF;
    const size_t g = (size_t)gy * W + gx;
    float hs[32], hh[32];
    if (tail) {
      float c[32];
      load_cond(cond_p + g * kG, c);
      sft_hidden(c, p.sftm + 8 * 2048, p.sftb + 8 * 64, hs);
      sft_hidden(c, p.sftm + 10 * 2048, p.sftb + 10 * 64, hh);
    }
    for (int k = 0; k < kF; k += 4) {
      float o[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[e] = (row[k + e] + __ldg(p.bias + 4 * 64 + k + e)) * 0.2f +
               xsrc(gy, gx, k + e);
      if (tail) {
        const float4 sc = sft_out4(hs, p.sftm + 9 * 2048, p.sftb + 9 * 64, k);
        const float4 sh = sft_out4(hh, p.sftm + 11 * 2048, p.sftb + 11 * 64, k);
        const float scv[4] = {sc.x, sc.y, sc.z, sc.w};
        const float shv[4] = {sh.x, sh.y, sh.z, sh.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float v = (o[e] * (scv[e] + 1.f) + shv[e]) * 0.2f;
          o[e] = (tail == kTailRound ? bfr(v) : v) + res(gy, gx, k + e);
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) dst(gy, gx, k + e, o[e]);
    }
  }
}

}  // namespace rdbk
