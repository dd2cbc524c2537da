// One fused SFT residual dense block of the SFTNet decoder for Hopper
// (sm_90a), plain or with the RRDB tail.
//
// Replaces the TPU kernel _rdb_kernel of the JAX reference package's
// ops/pallas_sr.py (pallas_call at pallas_sr.py:481). Per output pixel it
// computes
//   xc0 = SFT0(x, cond)
//   y_s = lrelu(conv3x3_s([xc0, y_1 .. y_{s-1}]) + b_s),  s = 1..4
//   y_4 <- SFT1(y_4, cond)
//   out = (conv3x3_5([xc0, y_1 .. y_4]) + b_5) * 0.2 + x
// and in tail mode out <- SFT_rrdb(out, cond) * 0.2, then out + x_rrdb.
// Every conv sees SAME zero padding at the frame edge. Storage is bf16,
// sums are float32, and bf16 rounding happens where the TPU kernel rounds:
// xc0, each y_s, the SFT hidden layer, and the output (the tail residual
// is a bf16 add).
//
// Design. The TPU kernel runs a halo-8 tile per sequential grid step and
// packs the condition into channels 64:96 of a 128-channel body for its
// DMA; here x and cond stay two NHWC bf16 tensors and each thread block
// computes one 8x16 output tile from a halo-5 window through
// rdbk::dense_block_tile (rdb_block.cuh, which describes the window, the
// tensor-core convs and the shared-memory plan; rrdb.cu runs the same code
// three blocks deep).
//
// What bounds it on the H100: the convs' bf16 tensor-core work, ~250k MAC
// per output pixel (plus ~110% halo recompute at this tile size). The
// tile code issues mma.sync on ldmatrix operands from XOR-swizzled rows,
// reads the weights in mma fragment order through L1 and runs the SFT
// layers on the tensor cores too; one thread block per SM (shared memory),
// no wgmma/TMA pipeline yet.
#include "rdb_block.cuh"

namespace {

using namespace rdbk;

struct RdbArgs {
  const bf16* x;      // [H, W, 64]
  const bf16* cond;   // [H, W, 32]
  const bf16* xin;    // [H, W, 64] RRDB input (tail mode) or null
  bf16* out;          // [H, W, 64]
  BlockWeights w;
  int H, W, tail;
};

__global__ void __launch_bounds__(kThreads, 1) rdb_kernel(const RdbArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  dense_block_tile(smem, SrcBf16{p.x, p.W}, DstBf16{p.out, p.W, p.H, p.W},
                   SrcBf16{p.xin, p.W}, p.cond, p.w, p.H, p.W,
                   (int)blockIdx.y * TH, (int)blockIdx.x * TW,
                   p.tail ? kTailRound : kTailNone);
}

}  // namespace

extern "C" int rdb_launch(const void* x, const void* cond, const void* xin,
                          void* out, const void* wconv, const float* bias,
                          const void* sftk, const float* sftb, int H, int W,
                          int tail, void* stream) {
  RdbArgs args{static_cast<const bf16*>(x), static_cast<const bf16*>(cond),
               static_cast<const bf16*>(xin), static_cast<bf16*>(out),
               {static_cast<const bf16*>(wconv), bias,
                static_cast<const bf16*>(sftk), sftb},
               H, W, tail};
  if (H == 0 || W == 0) return 0;
  cudaError_t e = cudaFuncSetAttribute(
      rdb_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH);
  rdb_kernel<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(args);
  return (int)cudaGetLastError();
}

extern "C" const char* rdb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
