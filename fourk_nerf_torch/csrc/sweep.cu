// Fused NDC plane sweep for Hopper (sm_90a): the DirectMPIGO encoder of the
// 4K frame, a warp-synchronous march with per-warp sample compaction.
//
// Replaces the TPU kernel _sweep_kernel of the JAX reference package's
// ops/pallas_sweep.py (pallas_call at pallas_sweep.py:614). It computes the
// same function: for each ray, march the depth planes k in order from the
// ray's first in-bounds plane; on each plane take a bilinear sample of the
// packed [Z,X,Y,Cp] grid (channel 0 density, 1..k0_dim features, mask_ch
// the 0/1 free-space mask), test the exact nearest-neighbour mask, apply
// softplus raw2alpha with the per-plane act_shift, the in-bounds test on the
// logical grid and the fast_color_thres cut on alpha and on the weight,
// then evaluate the rgbnet MLP on [k0, PE(spatial), PE(viewdir)] and
// composite front to back. A ray stops when its transmittance drops below
// 1e-3 or it leaves the grid; the stop is exact because the reference
// zeroes alpha for such rays.
//
// What bounds it on the H100: the MLP of the samples with a non-zero weight
// (2 x ~5k FLOP each at width 64) at the bf16 tensor-core peak, the type of
// the reference kernel's MLP on the main path, ~0.6-1.0 ms at fern scale;
// reading the grid's live channels once takes ~0.26 ms. The MLP is the
// cost: run per ray inside `if (w > 0)` it would hold a whole warp
// whenever one lane is weighted (about a third of the lanes are, on the
// fern-scale scenes) and keep its accumulators live through the march.
//
// Design. One thread marches one ray and one warp 32 neighbouring pixels
// (the frame driver orders the rays in 16x8-pixel tiles, so a warp is 16x2
// pixels whose taps share cache lines), in step: the warp walks the union
// of its lanes' plane ranges and stops when every lane has left the grid or
// saturated. The march keeps only the ray's state (transmittance, depth,
// colour) in registers and reads each tap's voxel as 16-byte loads (a bf16
// voxel of 16 channels is two), so the mask, density and k0 of a tap come
// from one request. A lane whose sample has w > 0 appends a record (weight,
// position, k0 bilerp) to its warp's queue in shared memory
// (sweep_queue.cuh); once 32 records wait, the warp runs the MLP over them
// with every lane busy, on the tensor cores for a bf16 grid (mma.sync
// m16n8k16, bf16 x bf16 -> float32, as the reference's bf16 matmuls) and as
// float32 FMAs for a float32 grid, and each lane adds w * sigmoid(logit) of
// its own records in plane order. Depth needs no MLP and stays in the
// march. Warps share nothing and never wait for each other: the kernel has
// no block-wide barrier, and the MLP weights come from device memory
// through L1. The MLP code is kept small: one call site of the flush, the
// activation chosen once per layer, one copy of sinf / cosf. With two
// inlined flushes and a per-element activation switch the kernel took 80 ms
// at 4K instead of 12 (PERF.md).
// What is left at 4K: the march and appends take ~3 ms; the rest is the
// flushes (row staging, 16-row mma.sync tiles with weights through L1, the
// per-lane gather), far from the tensor-core peak.
//
// Precision. With a bf16 grid (the main path, use_bf16) the kernel rounds
// where the TPU kernel does: the two bilinear x weights (the TPU kernel
// interpolates along x with a bf16 matmul), and the MLP's inputs, weights
// and hidden activations; products accumulate in float32 and the y weights,
// biases and composite stay float32. With a float32 grid nothing is
// rounded. Positions are computed without FMA contraction, so in-bounds and
// nearest-mask decisions fall as in the plain version.
#include <type_traits>

#include "sweep_common.cuh"
#include "sweep_queue.cuh"

namespace {

using sweepc::axis_interval;
using sweepc::kThreads;
using sweepc::rnd;
using sweepc::store;
using sweepc::Voxel;
using sweepq::kFull;
using sweepq::kFlush;
using sweepq::kSlots;
typedef __nv_bfloat16 bf16;

constexpr float kEarlyTerm = 1e-3f;
constexpr int kWarps = kThreads / 32;

struct SweepArgs {
  const void* grid;         // [Z, X, Y, Cp], float or bf16
  const float* act_shift;   // [Z]
  const float* a;           // [R, 2] grid-space xy at plane 0
  const float* b;           // [R, 2] xy step per plane
  const float* vde;         // [R, E] viewdir embedding
  const uint4* mlp;         // packed weights (sweep_queue.cuh / sweep_common.cuh)
  float* rgb;               // [R, 3] rgb_feature (no background)
  float* depth;             // [R]
  float* ail;               // [R] alphainv_last
  int R, Z, X, Y, Cp, Xl, Yl, mask_ch, k0_dim, E, spatial_pe, act;
  int n_layers, cin0, cinp;
  size_t warp_bytes;        // one warp's queue
  float interval, fast_thres;
};

// Shared memory: kWarps queues (then, on the float32 path, the per-thread
// hidden-activation scratch of sweep_common.cuh). The MLP weights are read
// from device memory through L1, where the blocks of an SM share one copy.
// CL: grid channels read a tap (>= mask_ch + 1); WP: hidden width padded.
// On a bf16 grid four blocks (16 warps) an SM: 128 registers a thread.
template <typename Tg, int CL, int WP>
__global__ void __launch_bounds__(kThreads, std::is_same<Tg, bf16>::value ? 4 : 1)
    sweep_kernel(const SweepArgs p) {
  constexpr bool kMma = std::is_same<Tg, bf16>::value;
  extern __shared__ __align__(16) unsigned char sm[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned char* qbase = sm;
  const sweepq::Queue<Tg, CL> q(qbase + warp * p.warp_bytes, p.cinp);
  float* hs = reinterpret_cast<float*>(qbase + kWarps * p.warp_bytes) + threadIdx.x;

  const int ray0 = blockIdx.x * blockDim.x + warp * 32;
  const int r = ray0 + lane;
  const Tg* grid = static_cast<const Tg*>(p.grid);
  const float xhi = (float)(p.Xl - 1), yhi = (float)(p.Yl - 1);
  const sweepq::MlpArgs m{p.mlp, p.vde, ray0, p.k0_dim, p.E, p.spatial_pe,
                          p.n_layers, p.act, p.cin0, p.cinp,
                          (float)max(p.Z - 1, 1), xhi, yhi};

  float ax = 0.f, ay = 0.f, bx = 0.f, by = 0.f;
  int k_first = p.Z, k_last = -1;
  if (r < p.R) {
    ax = p.a[2 * r];
    ay = p.a[2 * r + 1];
    bx = p.b[2 * r];
    by = p.b[2 * r + 1];
    float lox, hix, loy, hiy;
    axis_interval(ax, bx, xhi, lox, hix);
    axis_interval(ay, by, yhi, loy, hiy);
    const float k_in = fmaxf(lox, loy), k_out = fminf(hix, hiy);
    if (k_in <= k_out) {
      // one plane of slack on each side: the per-plane in-bounds test below
      // is what decides, the interval only bounds the loop
      k_first = max(0, (int)floorf(fminf(fmaxf(k_in, -2.f), (float)p.Z)) - 1);
      k_last = min(p.Z - 1, (int)floorf(fminf(fmaxf(k_out, -2.f), (float)p.Z)) + 1);
    }
  }
  const int kbeg = __reduce_min_sync(kFull, k_first);
  const int kend = __reduce_max_sync(kFull, k_last);

  float trans = 1.f, c0 = 0.f, c1 = 0.f, c2 = 0.f, dep = 0.f;
  bool live = k_first <= k_last;
  int n = 0, s = 0;  // records waiting, oldest slot
  // one call site of the flush, for the full queue and for the rest at the
  // end, keeps one copy of the MLP code in the loop
  for (int k = kbeg;; ++k) {
    live = live && k <= k_last && !(trans < kEarlyTerm);
    const bool more = __any_sync(kFull, live);
    const float kf = (float)k;
    bool app = false;
    float px = 0.f, py = 0.f, wx0 = 0.f, wx1 = 0.f, wy0 = 0.f, wy1 = 0.f;
    float w = 0.f;
    Voxel<Tg, CL> t00, t10, t01, t11;
    if (live && k >= k_first) {
      // unfused multiply-add, the rounding of the plain version
      px = __fadd_rn(ax, __fmul_rn(bx, kf));
      py = __fadd_rn(ay, __fmul_rn(by, kf));
      if (px >= 0.f && px <= xhi && py >= 0.f && py <= yhi) {
        const float x0f = floorf(px), y0f = floorf(py);
        const float fx = __fsub_rn(px, x0f), fy = __fsub_rn(py, y0f);
        const int x0 = (int)x0f, y0 = (int)y0f;
        const int x1 = min(x0 + 1, p.X - 1), y1 = min(y0 + 1, p.Y - 1);
        const size_t pl = (size_t)k * p.X;
        t00.load(grid + ((pl + x0) * p.Y + y0) * p.Cp);
        t10.load(grid + ((pl + x1) * p.Y + y0) * p.Cp);
        t01.load(grid + ((pl + x0) * p.Y + y1) * p.Cp);
        t11.load(grid + ((pl + x1) * p.Y + y1) * p.Cp);
        wx0 = rnd(__fsub_rn(1.f, fx), grid);
        wx1 = rnd(fx, grid);
        wy0 = __fsub_rn(1.f, fy);
        wy1 = fy;
        // exact nearest mask: y taps within half a voxel select x-bilerps
        // of the 0/1 mask; floor(. + 0.5) of their sum is the nearest x tap
        const int mc = p.mask_ch;
        const float m0 = __fadd_rn(__fmul_rn(wx0, t00.at(mc)), __fmul_rn(wx1, t10.at(mc)));
        const float m1 = __fadd_rn(__fmul_rn(wx0, t01.at(mc)), __fmul_rn(wx1, t11.at(mc)));
        const float ms = __fadd_rn(__fmul_rn(floorf(__fadd_rn(wy0, 0.5f)), m0),
                                   __fmul_rn(floorf(__fadd_rn(wy1, 0.5f)), m1));
        if (floorf(__fadd_rn(ms, 0.5f)) > 0.5f) {
          const float d0 = __fadd_rn(__fmul_rn(wx0, t00.at(0)), __fmul_rn(wx1, t10.at(0)));
          const float d1 = __fadd_rn(__fmul_rn(wx0, t01.at(0)), __fmul_rn(wx1, t11.at(0)));
          const float x = __fadd_rn(__fmul_rn(wy0, d0), __fmul_rn(wy1, d1)) + p.act_shift[k];
          const float sp = fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
          float alpha = 1.f - expf(-sp * p.interval);
          if (p.fast_thres > 0.f && !(alpha > p.fast_thres)) alpha = 0.f;
          if (alpha != 0.f) {  // else no weight, transmittance unchanged
            w = trans * alpha;
            if (p.fast_thres > 0.f && !(w > p.fast_thres)) w = 0.f;
            if (w > 0.f) {
              app = true;
              dep += w * ((kf + 0.5f) / (float)p.Z);
            }
            trans = trans * (1.f - alpha);
          }
        }
      }
    }
    const unsigned bal = __ballot_sync(kFull, app);
    if (app) {
      const int slot = q.slot(s, n + __popc(bal & ((1u << lane) - 1u)));
      q.w[slot] = w;
      q.px[slot] = px;
      q.py[slot] = py;
      q.kf[slot] = kf;
      q.lane[slot] = lane;
#pragma unroll
      for (int c = 1; c < CL; ++c) {
        if (c > p.k0_dim) break;
        const float r0 = __fadd_rn(__fmul_rn(wx0, t00.at(c)), __fmul_rn(wx1, t10.at(c)));
        const float r1 = __fadd_rn(__fmul_rn(wx0, t01.at(c)), __fmul_rn(wx1, t11.at(c)));
        store(q.k0 + (c - 1) * kSlots + slot,
              rnd(__fadd_rn(__fmul_rn(wy0, r0), __fmul_rn(wy1, r1)), grid));
      }
    }
    n += __popc(bal);
    if (n >= kFlush || (!more && n > 0)) {
      const int nf = min(n, kFlush);
      __syncwarp();
      if constexpr (kMma)
        sweepq::mma_flush<CL, WP>(q, m, s, nf, c0, c1, c2);
      else
        sweepq::fma_flush<Tg, CL, WP>(q, m, hs, s, nf, c0, c1, c2);
      s = q.slot(s, nf);
      n -= nf;
    }
    if (!more) break;
  }
  if (r < p.R) {
    p.rgb[3 * r] = c0;
    p.rgb[3 * r + 1] = c1;
    p.rgb[3 * r + 2] = c2;
    p.depth[r] = dep;
    p.ail[r] = trans;
  }
}

template <typename Tg, int CL, int WP>
int launch(SweepArgs args, cudaStream_t stream) {
  constexpr bool kMma = std::is_same<Tg, bf16>::value;
  args.warp_bytes = sweepq::Queue<Tg, CL>::bytes(args.cinp, kMma);
  const size_t smem = kWarps * args.warp_bytes +
                      (kMma ? 0 : (size_t)WP * kThreads * sizeof(float));
  auto kern = sweep_kernel<Tg, CL, WP>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (args.R + kThreads - 1) / kThreads;
  kern<<<blocks, kThreads, smem, stream>>>(args);
  return (int)cudaGetLastError();
}

template <typename Tg, int CL>
int launch_wp(const SweepArgs& args, int wp, cudaStream_t s) {
  if (wp == 64) return launch<Tg, CL, 64>(args, s);
  if (wp == 128) return launch<Tg, CL, 128>(args, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// cl: channels read a tap, 8 or 16 (>= mask_ch + 1, <= Cp). mlp: the
// weights, 16-byte aligned, in the fragment layout of sweep_queue.cuh on a
// bf16 grid and the float layout of sweep_common.cuh on a float32 grid.
// cinp: the first layer's input width, padded to 16 on a bf16 grid.
extern "C" int sweep_launch(const void* grid, int grid_bf16,
                            const float* act_shift, const float* a,
                            const float* b, const float* vde, const void* mlp,
                            float* rgb, float* depth, float* ail, int R, int Z,
                            int X, int Y, int Cp, int Xl, int Yl, int mask_ch,
                            int k0_dim, int E, int spatial_pe, int act,
                            int n_layers, int cin0, int cinp, int wp, int cl,
                            float interval, float fast_thres, void* stream) {
  SweepArgs args{grid, act_shift, a, b, vde, static_cast<const uint4*>(mlp),
                 rgb, depth, ail, R, Z, X, Y, Cp, Xl, Yl, mask_ch, k0_dim, E,
                 spatial_pe, act, n_layers, cin0, cinp, 0, interval,
                 fast_thres};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R == 0) return 0;
  if (mask_ch >= cl || cl > Cp) return (int)cudaErrorInvalidValue;
  if (grid_bf16) {
    if (cl == 8) return launch_wp<bf16, 8>(args, wp, s);
    if (cl == 16) return launch_wp<bf16, 16>(args, wp, s);
  } else {
    if (cl == 8) return launch_wp<float, 8>(args, wp, s);
    if (cl == 16) return launch_wp<float, 16>(args, wp, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* sweep_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
