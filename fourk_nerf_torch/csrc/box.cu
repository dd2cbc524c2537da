// Fused bounded-scene sweep for Hopper (sm_90a): the DirectVoxGO encoder of
// a full frame, one thread per ray.
//
// Replaces the TPU kernel _box_kernel of the JAX reference package's
// ops/pallas_box.py (pallas_call at pallas_box.py:533). It computes the same
// function. Ray r takes samples k = 0..kmax_r at the grid position
// (z, u, v)(k) = (z0, u0, v0) + k * (dz, du, dv), affine in k, where z is the
// frame's sweep axis (possibly flipped) and u, v the other two. A sample
// counts while 0 <= z <= Z-1, 0 <= u <= U-1, 0 <= v <= V-1. It takes a
// trilinear sample of the packed [density | k0 | mask] voxels (u blend, then
// v, then the two z planes), the exact nearest-neighbour free-space mask
// from the 0/1 mask channel, softplus raw2alpha with the scalar act_shift,
// the fast_color_thres cut on alpha and again on the weight, the rgbnet MLP
// on [k0 | viewdir PE] (all of k0 when rgb_direct, else k0[3:] with k0[:3]
// added to the logit; no MLP at all when n_layers == 0), and the in-order
// composite. alphainv_last is the transmittance after the last sample taken
// while it was still >= 1e-3, so stopping a ray there is exact.
//
// Design. The TPU kernel holds whole grid planes in VMEM, walks slabs of the
// sweep axis in sequence and interpolates with hat-weight matmuls over a
// window; none of that is the function. On Hopper the unit is the ray, as in
// sweep.cu: one thread marches its own samples from the first to the last k
// whose position can be in range (per-axis interval, one sample of slack;
// the per-sample test decides), gathers the 8 corner voxels (32 bytes each
// at 12 feature channels in bf16; neighbouring threads are neighbouring
// pixels, so a warp's taps share cache lines), and keeps its state in
// registers. The grid keeps its [X,Y,Z,Cp] layout for every pose: the sweep
// axis, its flip and the other two axes arrive as a base offset and three
// voxel strides. Empty space costs a position and four mask loads per
// sample; the MLP runs only for samples with a non-zero weight (exact), with
// its weights in shared memory (sweep_common.cuh, shared with sweep.cu).
//
// Precision. With a bf16 grid (use_bf16) the kernel rounds where the TPU
// kernel does: the two u hat weights (it interpolates along u with a bf16
// matmul), the MLP's inputs, weights and hidden activations. The v and z
// weights, biases, the residual k0[:3] and the composite stay float32.
// Positions are computed without FMA contraction so that in-range and
// nearest-mask decisions fall as in the plain version.
//
// What bounds it on the H100: the larger of its bytes (the grid's live
// channels read once, ~0.03 ms at 160^3, plus the per-ray inputs and maps,
// ~0.03 ms at 800x800) and the MLP of the samples with a non-zero weight
// (2 x (cin0 x 128 + 128 x 128 + 128 x 3) FLOP each) at the bf16 tensor-core
// peak; on a scene whose rays saturate a few samples into a surface the
// bytes are the larger. This first version spends its time elsewhere: the
// bf16-rounded MLP products run as float32 FMAs on the FP32 pipes, lanes of
// a warp diverge between live and dead samples, and empty space inside the
// box is marched sample by sample. It stays far above that bound.
#include "sweep_common.cuh"

namespace {

using sweepc::axis_interval;
using sweepc::feed;
using sweepc::kThreads;
using sweepc::ld;
using sweepc::rnd;

constexpr float kEarlyTerm = 1e-3f;

struct BoxArgs {
  const void* grid;     // [X*Y*Z, Cp] voxels, float or bf16
  const float* consts;  // [R, 8]: u0, du, v0, dv, z0, dz, kmax, unused
  const float* vde;     // [R, E] viewdir embedding
  const float* mlp;     // packed weights, layout of sweep_common.cuh
  float* rgb;           // [R, 3] rgb_feature (no background)
  float* depth;         // [R]
  float* ail;           // [R] alphainv_last
  long long base, sz, su, sv;  // voxel index = base + z*sz + u*su + v*sv
  int R, Z, U, V, Cp, mask_ch, k0_dim, E, act, n_layers, cin0, mlp_floats;
  int rgb_direct;
  float act_shift, interval, fast_thres, inv_nref;
};

template <typename Tg, int WP>
__global__ void __launch_bounds__(kThreads) box_kernel(const BoxArgs p) {
  extern __shared__ __align__(16) float sm[];
  for (int i = threadIdx.x; i < p.mlp_floats; i += blockDim.x)
    sm[i] = p.mlp[i];
  __syncthreads();
  float* hs = sm + (p.mlp_floats + 3) / 4 * 4 + threadIdx.x;

  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= p.R) return;
  const Tg* grid = static_cast<const Tg*>(p.grid);
  const float4 ca = __ldg(reinterpret_cast<const float4*>(p.consts) + 2 * r);
  const float4 cb =
      __ldg(reinterpret_cast<const float4*>(p.consts) + 2 * r + 1);
  const float u0 = ca.x, du = ca.y, v0 = ca.z, dv = ca.w;
  const float z0 = cb.x, dz = cb.y, kmax = cb.z;
  const float uhi = (float)(p.U - 1), vhi = (float)(p.V - 1),
              zhi = (float)(p.Z - 1);

  float lou, hiu, lov, hiv, loz, hiz;
  axis_interval(u0, du, uhi, lou, hiu);
  axis_interval(v0, dv, vhi, lov, hiv);
  axis_interval(z0, dz, zhi, loz, hiz);
  const float k_in = fmaxf(fmaxf(lou, lov), loz);
  const float k_out = fminf(fminf(hiu, hiv), hiz);

  float trans = 1.f, c0 = 0.f, c1 = 0.f, c2 = 0.f, dep = 0.f;
  if (k_in <= k_out && kmax >= 0.f) {
    const float kcap = fminf(kmax, 1e6f);
    const int k_first = max(0, (int)floorf(fminf(fmaxf(k_in, -2.f), kcap)) - 1);
    const int k_last =
        min((int)kcap, (int)floorf(fminf(fmaxf(k_out, -2.f), kcap)) + 1);
    const float* W0 = sm;
    const float* B0 = sm + p.cin0 * WP;
    const int f_lo = p.rgb_direct ? 0 : 3;

    for (int k = k_first; k <= k_last; ++k) {
      if (trans < kEarlyTerm) break;
      const float kf = (float)k;
      // unfused multiply-add, the rounding of the plain version
      const float u = __fadd_rn(u0, __fmul_rn(du, kf));
      const float v = __fadd_rn(v0, __fmul_rn(dv, kf));
      const float z = __fadd_rn(z0, __fmul_rn(dz, kf));
      if (!(u >= 0.f && u <= uhi && v >= 0.f && v <= vhi && z >= 0.f &&
            z <= zhi))
        continue;
      const float jf = fminf(fmaxf(floorf(z), 0.f), (float)(p.Z - 2));
      const float uf = floorf(u), vf = floorf(v);
      const float fz = __fsub_rn(z, jf), fu = __fsub_rn(u, uf),
                  fv = __fsub_rn(v, vf);
      // two-tap hat weights 1 - |pos - tap|, as the reference forms them
      const float wz0 = __fsub_rn(1.f, fz), wz1 = __fsub_rn(1.f, wz0);
      const float wv0 = __fsub_rn(1.f, fv), wv1 = __fsub_rn(1.f, wv0);
      const float hu0 = __fsub_rn(1.f, fu);
      const float wu0 = rnd(hu0, grid), wu1 = rnd(__fsub_rn(1.f, hu0), grid);
      const int j = (int)jf, iu0 = (int)uf, iv0 = (int)vf;
      const int iu1 = min(iu0 + 1, p.U - 1), iv1 = min(iv0 + 1, p.V - 1);
      const int j1 = min(j + 1, p.Z - 1);
      const long long pz0 = p.base + j * p.sz, pz1 = p.base + j1 * p.sz;
      const long long qu0 = iu0 * p.su, qu1 = iu1 * p.su;
      const long long qv0 = iv0 * p.sv, qv1 = iv1 * p.sv;
      // channel c blended along u at one (z plane, v tap)
      auto row = [&](long long pz, long long qv, int c) {
        return __fadd_rn(
            __fmul_rn(wu0, ld(grid, (size_t)(pz + qu0 + qv) * p.Cp + c)),
            __fmul_rn(wu1, ld(grid, (size_t)(pz + qu1 + qv) * p.Cp + c)));
      };
      auto plane = [&](long long pz, int c) {
        return __fadd_rn(__fmul_rn(wv0, row(pz, qv0, c)),
                         __fmul_rn(wv1, row(pz, qv1, c)));
      };
      auto sample = [&](int c) {
        return __fadd_rn(__fmul_rn(plane(pz0, c), wz0),
                         __fmul_rn(plane(pz1, c), wz1));
      };

      // exact nearest mask: the z plane within half a cell, the v taps
      // within half a cell select u-blends of the 0/1 channel, and
      // floor(. + 0.5) of their sum is the nearest u tap
      const long long pzm = fz < 0.5f ? pz0 : pz1;
      const float ms =
          __fadd_rn(__fmul_rn(floorf(__fadd_rn(wv0, 0.5f)),
                              row(pzm, qv0, p.mask_ch)),
                    __fmul_rn(floorf(__fadd_rn(wv1, 0.5f)),
                              row(pzm, qv1, p.mask_ch)));
      if (!(floorf(__fadd_rn(ms, 0.5f)) > 0.5f)) continue;

      const float x = sample(0) + p.act_shift;
      const float sp = fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
      float alpha = 1.f - expf(-sp * p.interval);
      if (p.fast_thres > 0.f && !(alpha > p.fast_thres)) alpha = 0.f;
      if (alpha == 0.f) continue;  // no weight, transmittance unchanged
      float w = trans * alpha;
      if (p.fast_thres > 0.f && !(w > p.fast_thres)) w = 0.f;

      if (w > 0.f) {
        float o0, o1, o2;
        if (p.n_layers == 0) {
          o0 = sample(1);
          o1 = sample(2);
          o2 = sample(3);
        } else {
          float acc[WP];
#pragma unroll
          for (int jj = 0; jj < WP; ++jj) acc[jj] = B0[jj];
          int i = 0;
          for (int c = f_lo; c < p.k0_dim; ++c)
            feed<WP>(acc, W0 + (i++) * WP, rnd(sample(1 + c), grid));
          const float* vr = p.vde + (size_t)r * p.E;
          for (int e = 0; e < p.E; ++e)
            feed<WP>(acc, W0 + (i++) * WP, rnd(__ldg(vr + e), grid));
          sweepc::rest<Tg, WP>(acc, B0 + WP, p.n_layers, p.act, hs, grid, o0, o1,
                            o2);
          if (!p.rgb_direct) {
            o0 += sample(1);
            o1 += sample(2);
            o2 += sample(3);
          }
        }
        c0 += w * (1.f / (1.f + expf(-o0)));
        c1 += w * (1.f / (1.f + expf(-o1)));
        c2 += w * (1.f / (1.f + expf(-o2)));
        dep += w * ((kf + 0.5f) * p.inv_nref);
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
int launch(const BoxArgs& args, cudaStream_t stream) {
  const size_t smem =
      ((size_t)(args.mlp_floats + 3) / 4 * 4 + (size_t)WP * kThreads) *
      sizeof(float);
  auto kern = box_kernel<Tg, WP>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (args.R + kThreads - 1) / kThreads;
  kern<<<blocks, kThreads, smem, stream>>>(args);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int box_launch(const void* grid, int grid_bf16, const float* consts,
                          const float* vde, const float* mlp, float* rgb,
                          float* depth, float* ail, long long base,
                          long long sz, long long su, long long sv, int R,
                          int Z, int U, int V, int Cp, int mask_ch, int k0_dim,
                          int E, int act, int n_layers, int cin0, int wp,
                          int mlp_floats, int rgb_direct, float act_shift,
                          float interval, float fast_thres, float inv_nref,
                          void* stream) {
  BoxArgs args{grid, consts, vde, mlp, rgb, depth, ail, base, sz, su, sv,
               R, Z, U, V, Cp, mask_ch, k0_dim, E, act, n_layers, cin0,
               mlp_floats, rgb_direct, act_shift, interval, fast_thres,
               inv_nref};
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

extern "C" const char* box_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
