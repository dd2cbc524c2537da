// Fused NDC plane sweep for Hopper (sm_90a): the DirectMPIGO encoder of the
// 4K frame, one thread per ray.
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
// Design. The TPU kernel walks tile groups in sequence and streams one grid
// stripe per plane into VMEM; on Hopper 132 SMs run blocks in parallel, so
// the natural unit is the ray. Each thread owns one ray and keeps its state
// (transmittance, colour, depth) in registers; neighbouring threads are
// neighbouring pixels, so a warp's taps fall on the same few 32-byte grid
// rows and hit L1/L2. The MLP weights (any depth, width <= 128, padded to
// the template width WP) live in shared memory and are read as float4
// broadcasts; one hidden vector stays in registers while a layer's inputs
// pass through the thread's column of shared scratch (two register vectors
// spilled at width 128). The MLP runs only for samples with a non-zero
// composite weight, which is exact.
//
// Precision. With a bf16 grid (the main path, use_bf16) the kernel rounds
// where the TPU kernel does: the two bilinear x weights (the TPU kernel
// interpolates along x with a bf16 matmul), and the MLP's inputs, weights
// and hidden activations; products accumulate in float32 and the y weights,
// biases and composite stay float32. With a float32 grid nothing is rounded.
//
// What bounds it on the H100: the MLP on the samples with a non-zero weight
// (~5k MAC each at width 64), at the bf16 tensor-core peak, the type of the
// reference kernel's MLP on the main path; reading the grid's 11 live
// channels once at fern scale takes ~0.25 ms. This first version does the
// bf16-rounded products as float32 FMAs on the FP32 pipes, one thread per
// ray, so it stays far above that bound; warp divergence between live and
// dead lanes adds to it. A tensor-core MLP over compacted samples is the
// known next step.
#include "sweep_common.cuh"

namespace {

using sweepc::act_fn;
using sweepc::axis_interval;
using sweepc::feed;
using sweepc::kThreads;
using sweepc::ld;
using sweepc::rnd;

constexpr float kEarlyTerm = 1e-3f;

struct SweepArgs {
  const void* grid;        // [Z, X, Y, Cp], float or bf16
  const float* act_shift;  // [Z]
  const float* a;          // [R, 2] grid-space xy at plane 0
  const float* b;          // [R, 2] xy step per plane
  const float* vde;        // [R, E] viewdir embedding
  const float* mlp;        // packed weights, layout of sweep_common.cuh
  float* rgb;              // [R, 3] rgb_feature (no background)
  float* depth;            // [R]
  float* ail;              // [R] alphainv_last
  int R, Z, X, Y, Cp, Xl, Yl, mask_ch, k0_dim, E, spatial_pe, act;
  int n_layers, cin0, mlp_floats;
  float interval, fast_thres;
};

// Shared memory: the MLP and its scratch, in the layout of sweep_common.cuh.
template <typename Tg, int WP>
__global__ void __launch_bounds__(kThreads) sweep_kernel(const SweepArgs p) {
  extern __shared__ __align__(16) float sm[];
  for (int i = threadIdx.x; i < p.mlp_floats; i += blockDim.x)
    sm[i] = p.mlp[i];
  __syncthreads();
  // per-thread hidden-activation scratch after the weights, [WP][kThreads]
  float* hs = sm + (p.mlp_floats + 3) / 4 * 4 + threadIdx.x;

  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= p.R) return;
  const Tg* grid = static_cast<const Tg*>(p.grid);
  const float ax = p.a[2 * r], ay = p.a[2 * r + 1];
  const float bx = p.b[2 * r], by = p.b[2 * r + 1];
  const float xhi = (float)(p.Xl - 1), yhi = (float)(p.Yl - 1);

  float lox, hix, loy, hiy;
  axis_interval(ax, bx, xhi, lox, hix);
  axis_interval(ay, by, yhi, loy, hiy);
  const float k_in = fmaxf(lox, loy), k_out = fminf(hix, hiy);

  float trans = 1.f, c0 = 0.f, c1 = 0.f, c2 = 0.f, dep = 0.f;
  if (k_in <= k_out) {
    // one plane of slack on each side: the per-plane in-bounds test below
    // is what decides, the interval only bounds the loop
    const int k_first =
        max(0, (int)floorf(fminf(fmaxf(k_in, -2.f), (float)p.Z)) - 1);
    const int k_last =
        min(p.Z - 1, (int)floorf(fminf(fmaxf(k_out, -2.f), (float)p.Z)) + 1);
    const float* W0 = sm;
    const float* B0 = sm + p.cin0 * WP;
    const float zden = (float)max(p.Z - 1, 1);

    for (int k = k_first; k <= k_last; ++k) {
      if (trans < kEarlyTerm) break;
      const float kf = (float)k;
      // unfused multiply-add, the rounding of the plain version
      const float px = __fadd_rn(ax, __fmul_rn(bx, kf));
      const float py = __fadd_rn(ay, __fmul_rn(by, kf));
      if (!(px >= 0.f && px <= xhi && py >= 0.f && py <= yhi)) continue;
      const float x0f = floorf(px), y0f = floorf(py);
      const float fx = __fsub_rn(px, x0f), fy = __fsub_rn(py, y0f);
      const int x0 = (int)x0f, y0 = (int)y0f;
      const int x1 = min(x0 + 1, p.X - 1), y1 = min(y0 + 1, p.Y - 1);
      const size_t pl = (size_t)k * p.X;
      const size_t o00 = ((pl + x0) * p.Y + y0) * p.Cp;
      const size_t o10 = ((pl + x1) * p.Y + y0) * p.Cp;
      const size_t o01 = ((pl + x0) * p.Y + y1) * p.Cp;
      const size_t o11 = ((pl + x1) * p.Y + y1) * p.Cp;
      const float wx0 = rnd(__fsub_rn(1.f, fx), grid), wx1 = rnd(fx, grid);
      const float wy0 = __fsub_rn(1.f, fy), wy1 = fy;
      // channel c interpolated along x at the two y taps
      auto rows = [&](int c, float& r0, float& r1) {
        r0 = __fadd_rn(__fmul_rn(wx0, ld(grid, o00 + c)),
                       __fmul_rn(wx1, ld(grid, o10 + c)));
        r1 = __fadd_rn(__fmul_rn(wx0, ld(grid, o01 + c)),
                       __fmul_rn(wx1, ld(grid, o11 + c)));
      };
      auto sample = [&](int c) {
        float r0, r1;
        rows(c, r0, r1);
        return __fadd_rn(__fmul_rn(wy0, r0), __fmul_rn(wy1, r1));
      };

      // exact nearest mask: y taps within half a voxel select x-bilerps of
      // the 0/1 mask; floor(. + 0.5) of their sum is the nearest x tap
      float m0, m1;
      rows(p.mask_ch, m0, m1);
      const float ms = __fadd_rn(__fmul_rn(floorf(__fadd_rn(wy0, 0.5f)), m0),
                                 __fmul_rn(floorf(__fadd_rn(wy1, 0.5f)), m1));
      if (!(floorf(__fadd_rn(ms, 0.5f)) > 0.5f)) continue;

      const float x = sample(0) + p.act_shift[k];
      const float sp = fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
      float alpha = 1.f - expf(-sp * p.interval);
      if (p.fast_thres > 0.f && !(alpha > p.fast_thres)) alpha = 0.f;
      if (alpha == 0.f) continue;  // no weight, transmittance unchanged
      float w = trans * alpha;
      if (p.fast_thres > 0.f && !(w > p.fast_thres)) w = 0.f;

      if (w > 0.f) {
        float acc[WP];
#pragma unroll
        for (int j = 0; j < WP; ++j) acc[j] = B0[j];
        int i = 0;
        for (int c = 0; c < p.k0_dim; ++c)
          feed<WP>(acc, W0 + (i++) * WP, rnd(sample(1 + c), grid));
        const float sv[3] = {2.f * kf / zden - 1.f, py / yhi * 2.f - 1.f,
                             px / xhi * 2.f - 1.f};
#pragma unroll
        for (int c = 0; c < 3; ++c)
          feed<WP>(acc, W0 + (i++) * WP, rnd(sv[c], grid));
#pragma unroll
        for (int c = 0; c < 3; ++c)
          for (int f = 0; f < p.spatial_pe; ++f)
            feed<WP>(acc, W0 + (i++) * WP,
                     rnd(sinf(sv[c] * (float)(1 << f)), grid));
#pragma unroll
        for (int c = 0; c < 3; ++c)
          for (int f = 0; f < p.spatial_pe; ++f)
            feed<WP>(acc, W0 + (i++) * WP,
                     rnd(cosf(sv[c] * (float)(1 << f)), grid));
        const float* vr = p.vde + (size_t)r * p.E;
        for (int e = 0; e < p.E; ++e)
          feed<WP>(acc, W0 + (i++) * WP, rnd(__ldg(vr + e), grid));

        // hidden and output layers (one register vector stays live)
        float o0, o1, o2;
        sweepc::rest<Tg, WP>(acc, B0 + WP, p.n_layers, p.act, hs, grid, o0, o1,
                          o2);
        c0 += w * (1.f / (1.f + expf(-o0)));
        c1 += w * (1.f / (1.f + expf(-o1)));
        c2 += w * (1.f / (1.f + expf(-o2)));
        dep += w * ((kf + 0.5f) / (float)p.Z);
      }
      trans = trans * (1.f - alpha);
    }
  }
  p.rgb[3 * r] = c0;
  p.rgb[3 * r + 1] = c1;
  p.rgb[3 * r + 2] = c2;
  p.depth[r] = dep;
  p.ail[r] = trans;
}

template <typename Tg, int WP>
int launch(const SweepArgs& args, cudaStream_t stream) {
  const size_t smem =
      ((size_t)(args.mlp_floats + 3) / 4 * 4 + (size_t)WP * kThreads) *
      sizeof(float);
  auto kern = sweep_kernel<Tg, WP>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (args.R + kThreads - 1) / kThreads;
  kern<<<blocks, kThreads, smem, stream>>>(args);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sweep_launch(const void* grid, int grid_bf16,
                            const float* act_shift, const float* a,
                            const float* b, const float* vde, const float* mlp,
                            float* rgb, float* depth, float* ail, int R, int Z,
                            int X, int Y, int Cp, int Xl, int Yl, int mask_ch,
                            int k0_dim, int E, int spatial_pe, int act,
                            int n_layers, int cin0, int wp, int mlp_floats,
                            float interval, float fast_thres, void* stream) {
  SweepArgs args{grid, act_shift, a, b, vde, mlp, rgb, depth, ail,
                 R, Z, X, Y, Cp, Xl, Yl, mask_ch, k0_dim, E, spatial_pe, act,
                 n_layers, cin0, mlp_floats, interval, fast_thres};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R == 0) return 0;
  if (grid_bf16) {
    if (wp == 64) return launch<__nv_bfloat16, 64>(args, s);
    if (wp == 128) return launch<__nv_bfloat16, 128>(args, s);
  } else {
    if (wp == 64) return launch<float, 64>(args, s);
    if (wp == 128) return launch<float, 128>(args, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* sweep_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
