// The encoder's grid update for Hopper (sm_90a): the TV gradient added into
// a grid's gradient, and MaskedAdam, each one in-place pass over a dense
// float32 grid that skips the entries whose gradient is zero.
//
// Replaces no TPU kernel: the JAX reference package leaves TV and Adam to
// XLA, which fuses each chain of elementwise ops into one pass. It is the
// counterpart of the original 4K-NeRF's two CUDA kernels
// (frozoul/4K-NeRF lib/cuda/total_variation_kernel.cu and
// lib/cuda/adam_upd_kernel.cu). The port's plain versions, a chain of
// PyTorch elementwise ops each (render.total_variation_grad, the chunked
// loop of optim._update_leaf), read and write every entry ~50 times.
//
// tv: grad += TV(grid) on a contiguous [X, Y, Z, C] grid, per axis
// w/6 * (clip(g_i - g_{i+1}) + clip(g_i - g_{i-1})) with each difference
// clipped to [-1, 1] and a missing neighbour adding nothing; w2 weighs Z
// (the plain version's wx), w1 Y and w0 X (its wz). Sparse mode (dense == 0)
// leaves an entry whose gradient is zero untouched.
//
// adam: m = 0.9 m + 0.1 g, v = 0.99 v + (0.01 g) g,
// p -= (step_size m) / (sqrt(v) + 1e-8), times the per-entry lr where plr is
// given. Masked mode leaves an entry whose gradient is zero untouched, its
// moments included; `touched` (where given) gains the count of entries
// updated, one atomic a block.
//
// What bounds it on the H100: bytes. Each pass has to read every gradient
// entry once (1.35 GB for the pretrain's k0 grid); on top come the touched
// entries' param, moments and neighbours and their writes, which in sparse
// training are a fraction of the grid. Design for that: one thread per
// group of four consecutive entries, the gradient read as one 16-byte word
// (where every pointer is 16-byte aligned; scalar otherwise), a group whose
// gradients are all zero costing that read alone; a touched entry's
// neighbours reached through the strides C, Z*C and Y*Z*C; a whole group
// written back as one 16-byte word, a partly touched one entry by entry.
//
// Bitwise equal to the plain versions: every sum, product, quotient and
// root is a round-to-nearest intrinsic (nvcc cannot contract them into
// FMAs), taken in the plain version's order. For TV that is 0, + axis 2's
// forward term, - its backward term, then axis 1's, then axis 0's, then
// grad + tv. The plain sparse TV adds +0 to a -0 gradient (making it +0),
// which the kernel skips; nothing else differs.
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

__device__ __forceinline__ float clip1(float d) {
  return d < -1.f ? -1.f : (d > 1.f ? 1.f : d);  // NaN passes, as torch's
}

template <int W>
__device__ __forceinline__ void load_w(const float* __restrict__ src, long long e,
                                       float* out) {
  if constexpr (W == 4) {
    const float4 q = *reinterpret_cast<const float4*>(src + e);
    out[0] = q.x, out[1] = q.y, out[2] = q.z, out[3] = q.w;
  } else {
    out[0] = src[e];
  }
}

template <int W>
__device__ __forceinline__ void store_w(float* __restrict__ dst, long long e,
                                        const float* in) {
  if constexpr (W == 4)
    *reinterpret_cast<float4*>(dst + e) = make_float4(in[0], in[1], in[2], in[3]);
  else
    dst[e] = in[0];
}

// The TV gradient of entry e of the grid.
template <typename I>
__device__ __forceinline__ float tv_of(const float* __restrict__ grid, I e,
                                       I C, I Z, I Y, I X, float w0, float w1,
                                       float w2) {
  const I vox = e / C;
  const I z = vox % Z, yx = vox / Z;
  const I y = yx % Y, x = yx / Y;
  const I sz = C, sy = Z * C, sx = Y * Z * C;
  const float c = __ldg(grid + e);
  float tv = 0.f;
  if (z + 1 < Z)
    tv = __fadd_rn(tv, __fmul_rn(clip1(__fsub_rn(c, __ldg(grid + e + sz))), w2));
  if (z > 0)
    tv = __fsub_rn(tv, __fmul_rn(clip1(__fsub_rn(__ldg(grid + e - sz), c)), w2));
  if (y + 1 < Y)
    tv = __fadd_rn(tv, __fmul_rn(clip1(__fsub_rn(c, __ldg(grid + e + sy))), w1));
  if (y > 0)
    tv = __fsub_rn(tv, __fmul_rn(clip1(__fsub_rn(__ldg(grid + e - sy), c)), w1));
  if (x + 1 < X)
    tv = __fadd_rn(tv, __fmul_rn(clip1(__fsub_rn(c, __ldg(grid + e + sx))), w0));
  if (x > 0)
    tv = __fsub_rn(tv, __fmul_rn(clip1(__fsub_rn(__ldg(grid + e - sx), c)), w0));
  return tv;
}

template <typename I, int W>
__global__ void __launch_bounds__(kThreads) tv_kernel(
    const float* __restrict__ grid, float* __restrict__ grad, I n, I C, I Z,
    I Y, I X, float w0, float w1, float w2, int dense) {
  const I groups = n / W;
  const I stride = (I)gridDim.x * kThreads;
  for (I i = (I)blockIdx.x * kThreads + threadIdx.x; i < groups; i += stride) {
    const I e0 = i * W;
    float g[W];
    load_w<W>(grad, e0, g);
    int live = 0;
#pragma unroll
    for (int k = 0; k < W; ++k) live += (dense || g[k] != 0.f);
    if (live == 0) continue;
    bool hit[W];
#pragma unroll
    for (int k = 0; k < W; ++k) {
      hit[k] = dense || g[k] != 0.f;
      if (hit[k])
        g[k] = __fadd_rn(g[k], tv_of(grid, e0 + k, C, Z, Y, X, w0, w1, w2));
    }
    if (live == W) {
      store_w<W>(grad, e0, g);
    } else {
#pragma unroll
      for (int k = 0; k < W; ++k)
        if (hit[k]) grad[e0 + k] = g[k];
    }
  }
  // the entries past the last whole group
  const I e = groups * W + threadIdx.x;
  if (W > 1 && blockIdx.x == 0 && e < n) {
    const float ge = grad[e];
    if (dense || ge != 0.f)
      grad[e] = __fadd_rn(ge, tv_of(grid, e, C, Z, Y, X, w0, w1, w2));
  }
}

template <bool kPlr>
__device__ __forceinline__ void adam_of(float g, float& p, float& m, float& v,
                                        float lr, float step_size) {
  m = __fadd_rn(__fmul_rn(0.9f, m), __fmul_rn(0.1f, g));
  v = __fadd_rn(__fmul_rn(0.99f, v), __fmul_rn(__fmul_rn(0.01f, g), g));
  float d = __fdiv_rn(__fmul_rn(step_size, m), __fadd_rn(__fsqrt_rn(v), 1e-8f));
  if (kPlr) d = __fmul_rn(d, lr);
  p = __fsub_rn(p, d);
}

// One entry, scalar: the partly touched groups and the entries past the
// last whole group.
template <bool kPlr>
__device__ __forceinline__ void adam_entry(float* __restrict__ p,
                                           float* __restrict__ m,
                                           float* __restrict__ v,
                                           const float* __restrict__ plr,
                                           long long e, float g,
                                           float step_size) {
  float pe = p[e], me = m[e], ve = v[e];
  adam_of<kPlr>(g, pe, me, ve, kPlr ? plr[e] : 1.f, step_size);
  p[e] = pe, m[e] = me, v[e] = ve;
}

template <int W, bool kPlr>
__global__ void __launch_bounds__(kThreads) adam_kernel(
    float* __restrict__ p, const float* __restrict__ grad,
    float* __restrict__ m, float* __restrict__ v,
    const float* __restrict__ plr, long long n, float step_size, int masked,
    unsigned long long* touched) {
  const long long groups = n / W;
  const long long stride = (long long)gridDim.x * kThreads;
  unsigned int count = 0;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
       i < groups; i += stride) {
    const long long e0 = i * W;
    float g[W];
    load_w<W>(grad, e0, g);
    int live = 0;
#pragma unroll
    for (int k = 0; k < W; ++k) live += (!masked || g[k] != 0.f);
    count += live;
    if (live == W) {
      float pw[W], mw[W], vw[W], lw[W];
      load_w<W>(p, e0, pw);
      load_w<W>(m, e0, mw);
      load_w<W>(v, e0, vw);
      if (kPlr) load_w<W>(plr, e0, lw);
#pragma unroll
      for (int k = 0; k < W; ++k)
        adam_of<kPlr>(g[k], pw[k], mw[k], vw[k], kPlr ? lw[k] : 1.f, step_size);
      store_w<W>(p, e0, pw);
      store_w<W>(m, e0, mw);
      store_w<W>(v, e0, vw);
    } else if (live > 0) {
#pragma unroll
      for (int k = 0; k < W; ++k)
        if (g[k] != 0.f) adam_entry<kPlr>(p, m, v, plr, e0 + k, g[k], step_size);
    }
  }
  const long long e = groups * W + threadIdx.x;
  if (W > 1 && blockIdx.x == 0 && e < n) {
    const float ge = grad[e];
    if (!masked || ge != 0.f) {
      adam_entry<kPlr>(p, m, v, plr, e, ge, step_size);
      ++count;
    }
  }
  if (touched == nullptr) return;
  __shared__ unsigned int block_count;
  if (threadIdx.x == 0) block_count = 0;
  __syncthreads();
  count = __reduce_add_sync(0xffffffffu, count);
  if ((threadIdx.x & 31) == 0 && count) atomicAdd(&block_count, count);
  __syncthreads();
  if (threadIdx.x == 0 && block_count)
    atomicAdd(touched, (unsigned long long)block_count);
}

int blocks_for(long long work) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const long long need = (work + kThreads - 1) / kThreads;
  const long long most = (long long)sms * kBlocksPerSm;
  return (int)(need < 1 ? 1 : (need < most ? need : most));
}

bool aligned16(const void* a) {
  return (reinterpret_cast<uintptr_t>(a) & 15) == 0;
}

template <typename I>
void launch_tv(const float* grid, float* grad, long long n, long long C,
               long long Z, long long Y, long long X, float w0, float w1,
               float w2, int dense, cudaStream_t s) {
  if (aligned16(grad))
    tv_kernel<I, 4><<<blocks_for(n / 4), kThreads, 0, s>>>(
        grid, grad, (I)n, (I)C, (I)Z, (I)Y, (I)X, w0, w1, w2, dense);
  else
    tv_kernel<I, 1><<<blocks_for(n), kThreads, 0, s>>>(
        grid, grad, (I)n, (I)C, (I)Z, (I)Y, (I)X, w0, w1, w2, dense);
}

template <int W>
void launch_adam(float* p, const float* g, float* m, float* v,
                 const float* plr, long long n, float step_size, int masked,
                 unsigned long long* touched, cudaStream_t s) {
  const int blocks = blocks_for(n / W);
  if (plr)
    adam_kernel<W, true><<<blocks, kThreads, 0, s>>>(p, g, m, v, plr, n,
                                                     step_size, masked, touched);
  else
    adam_kernel<W, false><<<blocks, kThreads, 0, s>>>(p, g, m, v, plr, n,
                                                      step_size, masked, touched);
}

}  // namespace

// grad += TV(grid) in place; both contiguous float32 [X, Y, Z, C].
extern "C" int grid_update_tv(const float* grid, float* grad, long long X,
                              long long Y, long long Z, long long C, float w0,
                              float w1, float w2, int dense, void* stream) {
  const long long n = X * Y * Z * C;
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 32-bit indices where every index and the loop's stride fit: a touched
  // entry's coordinates take three divisions, which cost the 64-bit kernel
  // ~30% more time at the pretrain's grids on the H100 (sparse and dense)
  if (n < (1LL << 31))
    launch_tv<uint32_t>(grid, grad, n, C, Z, Y, X, w0, w1, w2, dense, s);
  else
    launch_tv<unsigned long long>(grid, grad, n, C, Z, Y, X, w0, w1, w2,
                                  dense, s);
  return (int)cudaGetLastError();
}

// One MaskedAdam step of n contiguous float32 entries in place; plr and
// touched may be null.
extern "C" int grid_update_adam(float* p, const float* g, float* m, float* v,
                                const float* plr, long long n,
                                float step_size, int masked,
                                unsigned long long* touched, void* stream) {
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (aligned16(p) && aligned16(g) && aligned16(m) && aligned16(v) &&
      (plr == nullptr || aligned16(plr)))
    launch_adam<4>(p, g, m, v, plr, n, step_size, masked, touched, s);
  else
    launch_adam<1>(p, g, m, v, plr, n, step_size, masked, touched, s);
  return (int)cudaGetLastError();
}

extern "C" const char* grid_update_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
