// A whole RRDB of the SFTNet decoder in one launch for Hopper (sm_90a):
// three SFT residual dense blocks, the RRDB's trailing SFT and both
// residuals.
//
// Replaces the TPU kernel _rrdb_kernel of the JAX reference package's
// ops/pallas_sr.py (pallas_call at pallas_sr.py:428). With x_0 the RRDB's
// bf16 input it computes
//   x_r = block_r(x_{r-1}, cond),  r = 1..3   (rdb_block.cuh)
//   out = bf16(SFT_rrdb(x_3, cond) * 0.2 + x_0)
// Two things differ from three launches of rdb.cu and belong to the
// function: x_1, x_2, x_3 are carried in float32 between the blocks (only
// the conv operands and the SFT input are rounded to bf16 inside a block),
// and the tail is one float32 expression rounded once. The trailing SFT
// uses rows 8..11 of the third block's SFT pack.
//
// Design. The receptive field of three blocks is 15 pixels; a 38x46 window
// of the 192-channel dense concat (671 KB) cannot live in the 227 KB of
// shared memory that one block's 18x26 window already fills. So one thread
// block owns a 36x60 core region and runs block 1 over the region grown by
// 10 pixels, block 2 over it grown by 5, block 3 on the core, each as 8x16
// sub-tiles through rdbk::dense_block_tile, with the float32 x_1 and x_2 in
// a scratch region of its own in device memory (2.1 MB per thread block,
// reused for every region it walks, so it stays in L2). The halo is
// recomputed, not exchanged, as on the TPU: 85 sub-tiles per region against
// the 51 that three separate launches would compute for the same pixels
// (36x60 makes all three grown regions whole numbers of sub-tiles or nearly
// so). Sub-tiles wholly outside the frame are skipped; SAME padding comes
// from zeroing out-of-frame pixels after every stage. The grid is
// persistent: one thread block per SM walks the regions.
//
// What bounds it on the H100: the three blocks' convs at the bf16
// tensor-core peak (~750k MAC per pixel). It recomputes ~1.7x of that and
// runs rdb.cu's tile code (one thread block per SM), so it is slower than
// three launches of rdb.cu.
#include "rdb_block.cuh"

namespace {

using namespace rdbk;

constexpr int CH = 36, CW = 60;              // core region of a thread block
constexpr int kGrowA = 10, kGrowB = 5;       // halo of block 1 / block 2
constexpr int tiles(int n, int t) { return (n + t - 1) / t; }
constexpr int TAY = tiles(CH + 2 * kGrowA, TH), TAX = tiles(CW + 2 * kGrowA, TW);
constexpr int TBY = tiles(CH + 2 * kGrowB, TH), TBX = tiles(CW + 2 * kGrowB, TW);
constexpr int TCY = tiles(CH, TH), TCX = tiles(CW, TW);
constexpr int RA = TAY * TH, CA = TAX * TW;  // rows, cols of the x_1 region
constexpr int RB = TBY * TH, CB = TBX * TW;  // rows, cols of the x_2 region
constexpr size_t kScratchA = (size_t)RA * CA * kF;
constexpr size_t kScratchB = (size_t)RB * CB * kF;

struct RrdbArgs {
  const bf16* x;      // [H, W, 64] the RRDB's input
  const bf16* cond;   // [H, W, 32]
  bf16* out;          // [H, W, 64]
  const bf16* wconv;  // [3][conv floats of one block]
  const float* bias;  // [3][5][64]
  const bf16* sftk;   // [3][12 x 2048]; block 3 matrices 8..11: the RRDB's SFT
  const float* sftb;  // [3][12][64]
  float* scratch;     // [gridDim.x][kScratchA + kScratchB]
  int H, W, nry, nrx;
  int conv_elems;     // bf16 elements of one block's packed convs
};

__device__ __forceinline__ BlockWeights block_weights(const RrdbArgs& p,
                                                      int r) {
  return BlockWeights{p.wconv + (size_t)r * p.conv_elems, p.bias + r * 5 * 64,
                      p.sftk + r * 12 * 2048, p.sftb + r * 12 * 64};
}

// all sub-tiles of one stage: an nty x ntx grid of 8x16 tiles from (y0, x0)
template <class Src, class Dst>
__device__ __forceinline__ void run_stage(unsigned char* smem, const Src& src,
                                          const Dst& dst, const SrcBf16& x0,
                                          const RrdbArgs& p, int r, int y0,
                                          int x0c, int nty, int ntx,
                                          int tail) {
  const BlockWeights w = block_weights(p, r);
  for (int t = 0; t < nty * ntx; ++t) {
    const int ty0 = y0 + (t / ntx) * TH, tx0 = x0c + (t % ntx) * TW;
    if (ty0 >= p.H || tx0 >= p.W || ty0 + TH <= 0 || tx0 + TW <= 0) continue;
    dense_block_tile(smem, src, dst, x0, p.cond, w, p.H, p.W, ty0, tx0, tail);
  }
}

__global__ void __launch_bounds__(kThreads, 1) rrdb_kernel(const RrdbArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* sA = p.scratch + (size_t)blockIdx.x * (kScratchA + kScratchB);
  float* sB = sA + kScratchA;
  const SrcBf16 x0{p.x, p.W};
  for (int region = blockIdx.x; region < p.nry * p.nrx; region += gridDim.x) {
    const int gy0 = (region / p.nrx) * CH, gx0 = (region % p.nrx) * CW;
    const int ya = gy0 - kGrowA, xa = gx0 - kGrowA;
    const int yb = gy0 - kGrowB, xb = gx0 - kGrowB;
    // block 1: x_0 (frame) -> x_1 (scratch A)
    run_stage(smem, x0, DstF32{sA, ya, xa, RA, CA}, x0, p, 0, ya, xa, TAY, TAX,
              kTailNone);
    __syncthreads();  // x_1 is written before any thread reads it
    // block 2: x_1 -> x_2 (scratch B)
    run_stage(smem, SrcF32{sA, ya, xa, RA, CA}, DstF32{sB, yb, xb, RB, CB}, x0,
              p, 1, yb, xb, TBY, TBX, kTailNone);
    __syncthreads();
    // block 3 and the RRDB tail: x_2 -> out, this region's core pixels only
    run_stage(smem, SrcF32{sB, yb, xb, RB, CB},
              DstBf16{p.out, p.W, min(gy0 + CH, p.H), min(gx0 + CW, p.W)}, x0,
              p, 2, gy0, gx0, TCY, TCX, kTailF32);
    __syncthreads();  // scratch A is free for the next region
  }
}

}  // namespace

// floats of scratch one thread block needs
extern "C" long long rrdb_scratch_floats() {
  return (long long)(kScratchA + kScratchB);
}

// number of core regions of an H x W frame
extern "C" int rrdb_regions(int H, int W) {
  return tiles(H, CH) * tiles(W, CW);
}

extern "C" int rrdb_launch(const void* x, const void* cond, void* out,
                           const void* wconv, const float* bias,
                           const void* sftk, const float* sftb,
                           float* scratch, int H, int W, int conv_elems,
                           int blocks, void* stream) {
  if (H == 0 || W == 0) return 0;
  const int nry = tiles(H, CH), nrx = tiles(W, CW);
  RrdbArgs args{static_cast<const bf16*>(x), static_cast<const bf16*>(cond),
                static_cast<bf16*>(out), static_cast<const bf16*>(wconv),
                bias, static_cast<const bf16*>(sftk), sftb, scratch, H, W, nry,
                nrx, conv_elems};
  if (blocks < 1 || blocks > nry * nrx) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      rrdb_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (e != cudaSuccess) return (int)e;
  rrdb_kernel<<<blocks, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      args);
  return (int)cudaGetLastError();
}

extern "C" const char* rrdb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
