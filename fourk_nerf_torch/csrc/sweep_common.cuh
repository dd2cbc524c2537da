// Device code shared by the two sweep kernels (sweep.cu, box.cu): the
// 16-byte voxel loads, bf16 rounding, the in-range sample interval of an
// axis, and the rgbnet MLP one sample a thread in float32 (the float32
// path of sweep_queue.cuh's flush).
//
// Weight layout of the float32 MLP (floats): W0 [cin0][WP], b0 [WP]; then
// for each hidden layer W [WP][WP], b [WP]; then the output layer W [WP][4],
// b [4]. WP is the hidden width padded to 64 or 128; zero padding is exact.
// The caller gives WP x kThreads floats of hidden-activation scratch in
// shared memory.
//
// Precision follows the grid's type (the tag pointer): with a bf16 grid the
// MLP's inputs and hidden activations are rounded to bf16 values (the
// wrapper rounds the weights), products accumulate in float32 and biases
// stay float32. With a float32 grid nothing is rounded.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sweepc {

constexpr int kThreads = 128;

// The first CL channels of one voxel as up to four 16-byte words, held in
// named registers: a channel index known only at run time (the mask's)
// becomes selects, never an indexed array in local memory.
template <typename Tg, int CL>
struct Voxel {
  static constexpr int kWords = CL * (int)sizeof(Tg) / 16;
  static_assert(kWords >= 1 && kWords <= 4, "one to four words a voxel");
  uint4 w0, w1, w2, w3;

  __device__ __forceinline__ void load(const Tg* p) {
    const uint4* q = reinterpret_cast<const uint4*>(p);
    w0 = __ldg(q);
    if constexpr (kWords > 1) w1 = __ldg(q + 1);
    if constexpr (kWords > 2) w2 = __ldg(q + 2);
    if constexpr (kWords > 3) w3 = __ldg(q + 3);
  }
  // 32-bit word i (0 .. 4 kWords - 1)
  __device__ __forceinline__ uint32_t word(int i) const {
    uint4 v = w0;
    if constexpr (kWords > 1) v = (i >> 2) == 1 ? w1 : v;
    if constexpr (kWords > 2) v = (i >> 2) == 2 ? w2 : v;
    if constexpr (kWords > 3) v = (i >> 2) == 3 ? w3 : v;
    const uint32_t lo = (i & 1) ? v.y : v.x, hi = (i & 1) ? v.w : v.z;
    return (i & 2) ? hi : lo;
  }
  __device__ __forceinline__ float at(int c) const {
    if constexpr (sizeof(Tg) == 4) {
      return __uint_as_float(word(c));
    } else {
      const uint32_t u = word(c >> 1);
      return __uint_as_float((c & 1) ? (u & 0xffff0000u) : (u << 16));
    }
  }
};

template <typename Tg>
__device__ __forceinline__ void store(Tg* dst, float v);
template <>
__device__ __forceinline__ void store<float>(float* dst, float v) { *dst = v; }
template <>
__device__ __forceinline__ void store<__nv_bfloat16>(__nv_bfloat16* dst,
                                                     float v) {
  *dst = __float2bfloat16_rn(v);  // v is a bf16 value already
}

__device__ __forceinline__ float rnd(float v, const float*) { return v; }
__device__ __forceinline__ float rnd(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float act_fn(float x, int act) {
  if (act == 0) return fmaxf(x, 0.f);
  if (act == 1) return x >= 0.f ? x : 0.01f * x;
  return expf(-(x * x) / 0.005f);  // GaussianActivation(a=0.05)
}

// acc += v * row, one input unit into all WP units of the next layer
template <int WP>
__device__ __forceinline__ void feed(float (&acc)[WP], const float* row,
                                     float v) {
#pragma unroll
  for (int j = 0; j < WP; j += 4) {
    const float4 w = *reinterpret_cast<const float4*>(row + j);
    acc[j] += v * w.x;
    acc[j + 1] += v * w.y;
    acc[j + 2] += v * w.z;
    acc[j + 3] += v * w.w;
  }
}

// The layers after the first. On entry acc holds layer 0's sums (bias
// included, before the activation) and Wl points at the first hidden
// layer's weights. The activations go through this thread's column hs of
// shared scratch (stride kThreads), so one register vector is live.
// Returns the three output logits.
template <typename Tg, int WP>
__device__ __forceinline__ void rest(float (&acc)[WP], const float* Wl,
                                     int n_layers, int act, float* hs,
                                     const Tg* tag, float& o0, float& o1,
                                     float& o2) {
  for (int l = 1; l < n_layers - 1; ++l) {
#pragma unroll
    for (int j = 0; j < WP; ++j)
      hs[j * kThreads] = rnd(act_fn(acc[j], act), tag);
    const float* Bl = Wl + WP * WP;
#pragma unroll
    for (int j = 0; j < WP; ++j) acc[j] = Bl[j];
    for (int ii = 0; ii < WP; ++ii)
      feed<WP>(acc, Wl + ii * WP, hs[ii * kThreads]);
    Wl = Bl + WP;
  }
  o0 = Wl[WP * 4];
  o1 = Wl[WP * 4 + 1];
  o2 = Wl[WP * 4 + 2];
#pragma unroll
  for (int ii = 0; ii < WP; ++ii) {
    const float h = rnd(act_fn(acc[ii], act), tag);
    const float4 wv = *reinterpret_cast<const float4*>(Wl + ii * 4);
    o0 += h * wv.x;
    o1 += h * wv.y;
    o2 += h * wv.z;
  }
}

// in-range sample interval of one axis (pos = a + b*k in [0, hi])
__device__ __forceinline__ void axis_interval(float a, float b, float hi,
                                              float& lo_k, float& hi_k) {
  constexpr float kBig = 1e9f;
  const bool degen = fabsf(b) <= 1e-12f;
  const float bb = degen ? 1e-12f : b;
  const float t1 = (0.f - a) / bb, t2 = (hi - a) / bb;
  lo_k = fminf(t1, t2);
  hi_k = fmaxf(t1, t2);
  if (degen) {
    const bool inside = a >= 0.f && a <= hi;
    lo_k = inside ? -kBig : kBig;
    hi_k = inside ? kBig : -kBig;
  }
}

}  // namespace sweepc
