// Fused bounded-scene sweep for Hopper (sm_90a): the DirectVoxGO encoder of
// a full frame, a warp-synchronous march with empty-space skipping and
// per-warp sample compaction.
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
// What bounds it on the H100: the larger of its bytes (the grid's live
// channels read once, ~0.03 ms at 160^3, plus the per-ray inputs and maps,
// ~0.03 ms at 800x800) and the MLP of the samples with a non-zero weight
// (2 x (cin0 x 128 + 128 x 128 + 128 x 3) FLOP each) at the bf16 tensor-core
// peak; on a scene whose rays saturate a few samples into a surface the
// bytes are the larger. Run per ray inside `if (w > 0)`, the MLP held a
// whole warp whenever one lane was weighted, and the march paid a position
// and four mask loads for every sample of empty space.
//
// Design, as sweep.cu's. One thread marches one ray and one warp 32
// neighbouring pixels (the frame driver orders the rays in 16x8-pixel
// tiles), in step, over the union of the lanes' k ranges. A tap's voxel is
// one or two 16-byte loads, so its mask, density and k0 come from one
// request; the mask plane's four taps are read first and the other plane's
// only for a sample the mask keeps. A lane whose sample has w > 0 appends a
// record (weight, k0 rounded for the MLP input, float32 k0[:3] for the
// residual) to its warp's queue (sweep_queue.cuh); every 32 records the warp
// runs the MLP with all lanes busy, on mma.sync for a bf16 grid and as
// float32 FMAs for a float32 grid, and each lane adds w * sigmoid(logit) of
// its own records in k order (one flush for both colour modes: the direct
// form's logit offset is 0). Without rgbnet the colour is sigmoid(k0[:3])
// and no queue is used. The grid keeps its [X,Y,Z,Cp] layout for every pose:
// the sweep axis, its flip and the other two axes arrive as a base offset
// and three voxel strides.
//
// Empty-space skipping, exact. The nearest mask of a sample reads only the
// taps of its floor cell (floor(z) clamped to Z-2, floor(u), floor(v)) and
// the next voxel on each axis. The block map `occ` (cuda_box.block_occupancy,
// built once per scene and (axis, flip), in this (z, u, v) order) marks each
// block of kOccBlock voxels a side whose voxels, grown by one on the high
// side of each axis, hold any mask bit; a sample whose floor cell lies in an
// unmarked block has mask 0 and the plain version drops it with no change to
// transmittance, depth or colour. Such a lane reads one byte for the sample
// and proposes the first k at which its floor cell can leave the block:
// per axis the k at which the position, moved toward it by a margin far
// above the float rounding of position, crosses the block's face, rounded
// down, less one sample of slack. The warp then jumps to the least k its
// live lanes propose; a lane whose sample is not skipped proposes k + 1.
//
// Precision. With a bf16 grid (use_bf16) the kernel rounds where the TPU
// kernel does: the two u hat weights (it interpolates along u with a bf16
// matmul), the MLP's inputs, weights and hidden activations. The v and z
// weights, biases, the residual k0[:3] and the composite stay float32.
// Positions are computed without FMA contraction so that in-range and
// nearest-mask decisions fall as in the plain version.
#include <climits>
#include <type_traits>

#include "sweep_common.cuh"
#include "sweep_queue.cuh"

namespace {

using sweepc::axis_interval;
using sweepc::kThreads;
using sweepc::rnd;
using sweepc::store;
using sweepc::Voxel;
using sweepq::kFlush;
using sweepq::kFull;
using sweepq::kSlots;
typedef __nv_bfloat16 bf16;

constexpr float kEarlyTerm = 1e-3f;
// the edge of the empty-space blocks: 2^kOccShift voxels (cuda_box.OCC_BLOCK;
// 16 measured faster than 4 and 8 on the fly-through)
constexpr int kOccShift = 4;
constexpr int kOccBlock = 1 << kOccShift;
constexpr int kWarps = kThreads / 32;

struct BoxArgs {
  const void* grid;         // [X*Y*Z, Cp] voxels, float or bf16
  const float* consts;      // [R, 8]: u0, du, v0, dv, z0, dz, kmax, unused
  const float* vde;         // [R, E] viewdir embedding
  const uint4* mlp;         // packed weights (sweep_queue.cuh / sweep_common.cuh)
  const unsigned char* occ; // [BZ, BU, BV] block map, sweep order
  float* rgb;               // [R, 3] rgb_feature (no background)
  float* depth;             // [R]
  float* ail;               // [R] alphainv_last
  long long base, sz, su, sv;  // voxel index = base + z*sz + u*su + v*sv
  int R, Z, U, V, Cp, mask_ch, k0_dim, E, act, n_layers, cin0, cinp;
  int rgb_direct, BU, BV;
  size_t warp_bytes;        // one warp's queue
  float act_shift, interval, fast_thres, inv_nref;
};

// The box's MLP input row: k0[f_lo:] of the record, then the ray's viewdir
// embedding.
struct BoxRow {
  int f_lo;
  template <typename Q, typename Put>
  __device__ __forceinline__ void operator()(const Q& q,
                                             const sweepq::MlpArgs& m,
                                             int slot, Put&& put) const {
    for (int d = f_lo; d < m.k0_dim; ++d)
      put(sweepq::to_f(q.k0[d * kSlots + slot]));
    const float* vr = m.vde + (size_t)(m.ray0 + q.lane[slot]) * m.E;
    for (int e = 0; e < m.E; ++e) put(__ldg(vr + e));
  }
};

// The four taps of one z plane: a<u><v>.
template <typename Tg, int CL>
struct Plane {
  Voxel<Tg, CL> a00, a10, a01, a11;
  __device__ __forceinline__ void load(const Tg* g, long long pz,
                                       long long qu0, long long qu1,
                                       long long qv0, long long qv1, int Cp) {
    a00.load(g + (size_t)(pz + qu0 + qv0) * Cp);
    a10.load(g + (size_t)(pz + qu1 + qv0) * Cp);
    a01.load(g + (size_t)(pz + qu0 + qv1) * Cp);
    a11.load(g + (size_t)(pz + qu1 + qv1) * Cp);
  }
};

// channel c blended along u at the v tap of a0 / a1
template <typename Tg, int CL>
__device__ __forceinline__ float urow(const Voxel<Tg, CL>& a0,
                                      const Voxel<Tg, CL>& a1, float wu0,
                                      float wu1, int c) {
  return __fadd_rn(__fmul_rn(wu0, a0.at(c)), __fmul_rn(wu1, a1.at(c)));
}

// the first k at which a position p0 + d * k, now in the block
// [lo, lo + size) of its axis, can leave it: never later than the truth
__device__ __forceinline__ float leave_k(float p0, float d, int lo, int size) {
  if (d == 0.f) return 1e9f;
  const float face = (float)(d > 0.f ? lo + size : lo);
  // the float rounding of p0 + d * k is below 2^-22 (|p0| + |face| + 1)
  const float margin = (fabsf(p0) + fabsf(face) + 1.f) * 0x1p-18f;
  return (d > 0.f ? face - margin - p0 : face + margin - p0) / d;
}

// CL: grid channels read a tap (>= mask_ch + 1); WP: hidden width padded.
// On a bf16 grid four blocks (16 warps) an SM: 128 registers a thread.
template <typename Tg, int CL, int WP>
__global__ void __launch_bounds__(kThreads, std::is_same<Tg, bf16>::value ? 4 : 1)
    box_kernel(const BoxArgs p) {
  constexpr bool kMma = std::is_same<Tg, bf16>::value;
  extern __shared__ __align__(16) unsigned char sm[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const sweepq::Queue<Tg, CL> q(sm + warp * p.warp_bytes, p.cinp);
  float* hs = reinterpret_cast<float*>(sm + kWarps * p.warp_bytes) + threadIdx.x;

  const int ray0 = blockIdx.x * blockDim.x + warp * 32;
  const int r = ray0 + lane;
  const Tg* grid = static_cast<const Tg*>(p.grid);
  const sweepq::MlpArgs m{p.mlp, p.vde, ray0, p.k0_dim, p.E, 0, p.n_layers,
                          p.act, p.cin0, p.cinp, 1.f, 1.f, 1.f};
  const BoxRow row{p.rgb_direct ? 0 : 3};
  const float uhi = (float)(p.U - 1), vhi = (float)(p.V - 1),
              zhi = (float)(p.Z - 1);

  float u0 = 0.f, du = 0.f, v0 = 0.f, dv = 0.f, z0 = 0.f, dz = 0.f;
  int k_first = INT_MAX, k_last = -1;
  if (r < p.R) {
    const float4 ca = __ldg(reinterpret_cast<const float4*>(p.consts) + 2 * r);
    const float4 cb =
        __ldg(reinterpret_cast<const float4*>(p.consts) + 2 * r + 1);
    u0 = ca.x, du = ca.y, v0 = ca.z, dv = ca.w;
    z0 = cb.x, dz = cb.y;
    const float kmax = cb.z;
    float lou, hiu, lov, hiv, loz, hiz;
    axis_interval(u0, du, uhi, lou, hiu);
    axis_interval(v0, dv, vhi, lov, hiv);
    axis_interval(z0, dz, zhi, loz, hiz);
    const float k_in = fmaxf(fmaxf(lou, lov), loz);
    const float k_out = fminf(fminf(hiu, hiv), hiz);
    if (k_in <= k_out && kmax >= 0.f) {
      // one sample of slack on each side: the per-sample test decides
      const float kcap = fminf(kmax, 1e6f);
      k_first = max(0, (int)floorf(fminf(fmaxf(k_in, -2.f), kcap)) - 1);
      k_last = min((int)kcap, (int)floorf(fminf(fmaxf(k_out, -2.f), kcap)) + 1);
    }
  }
  const int kbeg = __reduce_min_sync(kFull, k_first);

  float trans = 1.f, c0 = 0.f, c1 = 0.f, c2 = 0.f, dep = 0.f;
  bool live = k_first <= k_last;
  int n = 0, s = 0;  // records waiting, oldest slot
  for (int k = kbeg;;) {
    live = live && k <= k_last && !(trans < kEarlyTerm);
    const bool more = __any_sync(kFull, live);
    int next = !live ? INT_MAX : k < k_first ? k_first : k + 1;
    const float kf = (float)k;
    bool app = false;
    float w = 0.f;
    float smp[CL];  // the trilinear sample, channels 0..k0_dim
    if (live && k >= k_first) {
      // unfused multiply-add, the rounding of the plain version
      const float u = __fadd_rn(u0, __fmul_rn(du, kf));
      const float v = __fadd_rn(v0, __fmul_rn(dv, kf));
      const float z = __fadd_rn(z0, __fmul_rn(dz, kf));
      if (u >= 0.f && u <= uhi && v >= 0.f && v <= vhi && z >= 0.f &&
          z <= zhi) {
        const float jf = fminf(fmaxf(floorf(z), 0.f), (float)(p.Z - 2));
        const float uf = floorf(u), vf = floorf(v);
        const int j = (int)jf, iu0 = (int)uf, iv0 = (int)vf;
        const int bz = j >> kOccShift, bu = iu0 >> kOccShift,
                  bv = iv0 >> kOccShift;
        if (!__ldg(p.occ + ((size_t)bz * p.BU + bu) * p.BV + bv)) {
          // empty block: no sample of it has a mask bit
          const float kx = fminf(
              fminf(leave_k(z0, dz, bz * kOccBlock, kOccBlock),
                    leave_k(u0, du, bu * kOccBlock, kOccBlock)),
              leave_k(v0, dv, bv * kOccBlock, kOccBlock));
          next = max(k + 1, (int)floorf(fminf(fmaxf(kx, 0.f), 1e6f)) - 1);
        } else {
          const float fz = __fsub_rn(z, jf), fu = __fsub_rn(u, uf),
                      fv = __fsub_rn(v, vf);
          // two-tap hat weights 1 - |pos - tap|, as the reference forms them
          const float wz0 = __fsub_rn(1.f, fz), wz1 = __fsub_rn(1.f, wz0);
          const float wv0 = __fsub_rn(1.f, fv), wv1 = __fsub_rn(1.f, wv0);
          const float hu0 = __fsub_rn(1.f, fu);
          const float wu0 = rnd(hu0, grid), wu1 = rnd(__fsub_rn(1.f, hu0), grid);
          const int iu1 = min(iu0 + 1, p.U - 1), iv1 = min(iv0 + 1, p.V - 1);
          const long long qu0 = iu0 * p.su, qu1 = iu1 * p.su;
          const long long qv0 = iv0 * p.sv, qv1 = iv1 * p.sv;
          // the z plane within half a cell carries the nearest mask
          const bool near0 = fz < 0.5f;
          const long long pm = p.base + (near0 ? j : j + 1) * p.sz;
          const long long po = p.base + (near0 ? j + 1 : j) * p.sz;
          Plane<Tg, CL> t;
          t.load(grid, pm, qu0, qu1, qv0, qv1, p.Cp);
          // exact nearest mask: the v taps within half a cell select
          // u-blends of the 0/1 channel; floor(. + 0.5) of their sum is the
          // nearest u tap
          const int mc = p.mask_ch;
          const float ms = __fadd_rn(
              __fmul_rn(floorf(__fadd_rn(wv0, 0.5f)),
                        urow(t.a00, t.a10, wu0, wu1, mc)),
              __fmul_rn(floorf(__fadd_rn(wv1, 0.5f)),
                        urow(t.a01, t.a11, wu0, wu1, mc)));
          if (floorf(__fadd_rn(ms, 0.5f)) > 0.5f) {
            const float wm = near0 ? wz0 : wz1, wo = near0 ? wz1 : wz0;
#pragma unroll
            for (int c = 0; c < CL; ++c) {
              if (c > p.k0_dim) break;
              smp[c] = __fmul_rn(
                  __fadd_rn(__fmul_rn(wv0, urow(t.a00, t.a10, wu0, wu1, c)),
                            __fmul_rn(wv1, urow(t.a01, t.a11, wu0, wu1, c))),
                  wm);
            }
            t.load(grid, po, qu0, qu1, qv0, qv1, p.Cp);
#pragma unroll
            for (int c = 0; c < CL; ++c) {
              if (c > p.k0_dim) break;
              smp[c] = __fadd_rn(
                  smp[c],
                  __fmul_rn(
                      __fadd_rn(__fmul_rn(wv0, urow(t.a00, t.a10, wu0, wu1, c)),
                                __fmul_rn(wv1, urow(t.a01, t.a11, wu0, wu1, c))),
                      wo));
            }
            const float x = smp[0] + p.act_shift;
            const float sp = fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
            float alpha = 1.f - expf(-sp * p.interval);
            if (p.fast_thres > 0.f && !(alpha > p.fast_thres)) alpha = 0.f;
            if (alpha != 0.f) {  // else no weight, transmittance unchanged
              w = trans * alpha;
              if (p.fast_thres > 0.f && !(w > p.fast_thres)) w = 0.f;
              if (w > 0.f) {
                dep += w * ((kf + 0.5f) * p.inv_nref);
                if (p.n_layers == 0) {
                  c0 += w * sweepq::sigmoid(smp[1]);
                  c1 += w * sweepq::sigmoid(smp[2]);
                  c2 += w * sweepq::sigmoid(smp[3]);
                } else {
                  app = true;
                }
              }
              trans = trans * (1.f - alpha);
            }
          }
        }
      }
    }
    const unsigned bal = __ballot_sync(kFull, app);
    if (app) {
      const int slot = q.slot(s, n + __popc(bal & ((1u << lane) - 1u)));
      q.w[slot] = w;
      q.lane[slot] = lane;
      // the logit offset: float32 k0[:3] in the residual form, else 0
      q.px[slot] = p.rgb_direct ? 0.f : smp[1];
      q.py[slot] = p.rgb_direct ? 0.f : smp[2];
      q.kf[slot] = p.rgb_direct ? 0.f : smp[3];
#pragma unroll
      for (int c = 1; c < CL; ++c) {
        if (c > p.k0_dim) break;
        store(q.k0 + (c - 1) * kSlots + slot, rnd(smp[c], grid));
      }
    }
    n += __popc(bal);
    if (n >= kFlush || (!more && n > 0)) {
      // one call site of the flush, for the full queue and for the rest at
      // the end, keeps one copy of the MLP code in the loop
      const int nf = min(n, kFlush);
      __syncwarp();
      if constexpr (kMma)
        sweepq::mma_flush<CL, WP, true>(q, m, s, nf, c0, c1, c2, row);
      else
        sweepq::fma_flush<Tg, CL, WP, true>(q, m, hs, s, nf, c0, c1, c2, row);
      s = q.slot(s, nf);
      n -= nf;
    }
    if (!more) break;
    k = __reduce_min_sync(kFull, next);
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
int launch(BoxArgs args, cudaStream_t stream) {
  constexpr bool kMma = std::is_same<Tg, bf16>::value;
  args.warp_bytes = sweepq::Queue<Tg, CL>::bytes(args.cinp, kMma);
  const size_t smem = kWarps * args.warp_bytes +
                      (kMma ? 0 : (size_t)WP * kThreads * sizeof(float));
  auto kern = box_kernel<Tg, CL, WP>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (args.R + kThreads - 1) / kThreads;
  kern<<<blocks, kThreads, smem, stream>>>(args);
  return (int)cudaGetLastError();
}

template <typename Tg, int CL>
int launch_wp(const BoxArgs& args, int wp, cudaStream_t s) {
  if (wp == 64) return launch<Tg, CL, 64>(args, s);
  if (wp == 128) return launch<Tg, CL, 128>(args, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// cl: channels read a tap, 8 or 16 (> mask_ch and > k0_dim, <= Cp). mlp:
// the weights, 16-byte aligned, in the fragment layout of sweep_queue.cuh
// on a bf16 grid and the float layout of sweep_common.cuh on a float32
// grid (ignored when n_layers is 0). cinp: the first layer's input width,
// padded to 16 on a bf16 grid. occ: the block map of kOccBlock-voxel
// blocks, [ceil(Z/16), ceil(U/16), ceil(V/16)] bytes in sweep order.
extern "C" int box_launch(const void* grid, int grid_bf16, const float* consts,
                          const float* vde, const void* mlp,
                          const unsigned char* occ, float* rgb, float* depth,
                          float* ail, long long base, long long sz,
                          long long su, long long sv, int R, int Z, int U,
                          int V, int Cp, int mask_ch, int k0_dim, int E,
                          int act, int n_layers, int cin0, int cinp, int wp,
                          int cl, int rgb_direct, float act_shift,
                          float interval, float fast_thres, float inv_nref,
                          void* stream) {
  BoxArgs args{grid, consts, vde, static_cast<const uint4*>(mlp), occ, rgb,
               depth, ail, base, sz, su, sv, R, Z, U, V, Cp, mask_ch, k0_dim,
               E, act, n_layers, cin0, cinp, rgb_direct,
               (U + kOccBlock - 1) / kOccBlock, (V + kOccBlock - 1) / kOccBlock,
               0, act_shift, interval, fast_thres, inv_nref};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R == 0) return 0;
  if (mask_ch >= cl || k0_dim >= cl || cl > Cp)
    return (int)cudaErrorInvalidValue;
  if (grid_bf16) {
    if (cl == 8) return launch_wp<bf16, 8>(args, wp, s);
    if (cl == 16) return launch_wp<bf16, 16>(args, wp, s);
  } else {
    if (cl == 8) return launch_wp<float, 8>(args, wp, s);
    if (cl == 16) return launch_wp<float, 16>(args, wp, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* box_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
