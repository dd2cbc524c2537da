// Floor probes of the plane sweep's loop skeleton for Hopper (sm_90a).
//
// Counterpart of the TPU probes of the JAX reference package's
// tools/perf/probe_floor.py (pallas_call at :45, :95 and :130). They answer,
// for this card, what a (tile, plane) iteration of a sweep kernel costs
// before it does any useful work: Z planes x T tiles in groups of G, one
// thread block per group, each block running the double loop
// `for plane: for tile of the group:` with one suspect added at a time:
//   empty         nothing but the loop (one float add per thread)
//   empty_sync    the loop with a block-wide barrier per iteration
//   smem_read     + a read of shared memory at a fixed address
//   dyn_window    + a read of the [64, pw] window at a row and column offset
//                 computed in the loop
//   window_mma    + one bf16 tensor-core product of the window,
//                 window[64, pw]^T x wx[64, R] (K = 56 padded to 64), float32
//                 sums, nvcuda::wmma
//   copy_ring     per plane only: a 3-slot cp.async ring that streams one
//                 stripe per plane from device memory into shared memory
// Every kernel writes a checksum that the caller reproduces in closed form or
// with a torch expression, so a body that the compiler emptied is caught.
// The data are small integers, so every float32 sum is exact in any order.
//
// The TPU scripts' stripe (392 x 6144) does not fit shared memory; the
// window's source here is 72 x 1280 bf16 (181 KB with its row padding) and
// the ring's stripe is the caller's choice (3 slots must fit). The source's
// rows are 1288 elements apart, not 1280: the tensor-core product reads the
// window transposed, eight rows at a time, and a row stride that is a
// multiple of 128 bytes would put all eight in the same shared-memory banks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256, kWarps = 8;
constexpr int SROWS = 72, SCOLS = 1280;  // the window's source stripe
constexpr int SLD = SCOLS + 8;           // its row stride, elements
constexpr int NACC = 8;                  // independent accumulators per warp

__device__ __forceinline__ void window_origin(int g, int pw, int& row,
                                              int& col) {
  row = (g % 2) * 8;
  col = (g * 128) % (SCOLS - pw + 128);
}

// mode 0 empty, 1 empty_sync, 2 smem_read, 3 dyn_window
template <int MODE>
__global__ void __launch_bounds__(kThreads, 1)
loop_kernel(const bf16* stripe, float* out, int Z, int G, int pw) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* s = reinterpret_cast<bf16*>(smem);
  const int tid = threadIdx.x;
  if (MODE >= 2) {
    for (int i = tid; i < SROWS * SLD / 8; i += kThreads)
      reinterpret_cast<uint4*>(s)[i] =
          __ldg(reinterpret_cast<const uint4*>(stripe) + i);
    __syncthreads();
  }
  const volatile unsigned short* vs = reinterpret_cast<unsigned short*>(s);
  float acc = 0.f;
  for (int k = 0; k < Z; ++k) {
    for (int g = 0; g < G; ++g) {
      if (MODE == 0 || MODE == 1) {
        acc += 1.f;
        asm volatile("" : "+f"(acc));  // keep the loop: no closed form
        if (MODE == 1) __syncthreads();
      } else if (MODE == 2) {
        acc += __bfloat162float(__ushort_as_bfloat16(vs[tid]));
      } else {
        int row, col;
        window_origin(g, pw, row, col);
        acc += __bfloat162float(__ushort_as_bfloat16(
            vs[(row + tid / 128) * SLD + col + tid % 128]));
      }
    }
  }
  out[blockIdx.x * kThreads + tid] = acc;
}

// One product of the window per (plane, tile): out tiles [pw/16, R/16], each
// with 4 k-steps. A warp owns the ray tiles r = warp, warp + 8, ...; it holds
// the four B fragments of a ray tile and walks the window's column tiles.
// Every product is added into one of NACC accumulators; their sum is the
// checksum, [16, 16] per warp.
__global__ void __launch_bounds__(kThreads, 1)
mma_kernel(const bf16* stripe, const bf16* wx, float* out, int Z, int G,
           int pw, int R) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* s = reinterpret_cast<bf16*>(smem);
  const int tid = threadIdx.x, warp = tid / 32;
  for (int i = tid; i < SROWS * SLD / 8; i += kThreads)
    reinterpret_cast<uint4*>(s)[i] =
        __ldg(reinterpret_cast<const uint4*>(stripe) + i);
  __syncthreads();
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) wmma::fill_fragment(acc[i], 0.f);
  for (int k = 0; k < Z; ++k) {
    for (int g = 0; g < G; ++g) {
      int row, col;
      window_origin(g, pw, row, col);
      const bf16* win = s + row * SLD + col;
      for (int rt = warp; rt < R / 16; rt += kWarps) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wmma::load_matrix_sync(b[kk], wx + (size_t)(16 * kk) * R + 16 * rt, R);
#pragma unroll 1
        for (int c0 = 0; c0 < pw / 16; c0 += NACC) {
#pragma unroll
          for (int i = 0; i < NACC; ++i) {
            if (c0 + i >= pw / 16) break;
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              // window^T: element (column, k) sits at win[k * SLD + column]
              wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a;
              wmma::load_matrix_sync(a, win + (16 * kk) * SLD + 16 * (c0 + i),
                                     SLD);
              wmma::mma_sync(acc[i], a, b[kk], acc[i]);
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 1; i < NACC; ++i)
#pragma unroll
    for (int e = 0; e < acc[0].num_elements; ++e) acc[0].x[e] += acc[i].x[e];
  wmma::store_matrix_sync(out + ((size_t)blockIdx.x * kWarps + warp) * 256,
                          acc[0], 16, wmma::mem_row_major);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src)
               : "memory");
}

// 3 slots, 2 copies ahead: plane k is awaited, plane k+2 is started, and
// each thread samples one 16-byte chunk of plane k's stripe (a chunk that
// moves with k, so the samples of a block cover the whole stripe).
__global__ void __launch_bounds__(kThreads, 1)
ring_kernel(const bf16* packed, float* out, int Z, int chunks) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const size_t stripe_bytes = (size_t)chunks * 16;
  const unsigned char* src =
      reinterpret_cast<const unsigned char*>(packed) +
      (size_t)blockIdx.x * Z * stripe_bytes;
  auto start = [&](int k) {
    if (k < Z) {
      unsigned char* dst = smem + (size_t)(k % 3) * stripe_bytes;
      const unsigned char* from = src + (size_t)k * stripe_bytes;
      for (int c = tid; c < chunks; c += kThreads)
        cp_async16(dst + 16 * (size_t)c, from + 16 * (size_t)c);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  start(0);
  start(1);
  float acc = 0.f;
  for (int k = 0; k < Z; ++k) {
    asm volatile("cp.async.wait_group 1;" ::: "memory");
    __syncthreads();  // plane k has landed; slot (k+2)%3 is no longer read
    start(k + 2);
    const int c = (tid * 15 + k * 7) % chunks;
    const uint4 v = *reinterpret_cast<const uint4*>(
        smem + (size_t)(k % 3) * stripe_bytes + 16 * (size_t)c);
    const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) acc += __bfloat162float(e[j]);
  }
  out[blockIdx.x * kThreads + tid] = acc;
}

template <class K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

// mode 0..3: the loop kernels; out [groups, 256] float32.
extern "C" int probe_floor_loop(int mode, const void* stripe, float* out,
                                int groups, int Z, int G, int pw,
                                void* stream) {
  const size_t bytes = mode >= 2 ? (size_t)SROWS * SLD * 2 : 0;
  const bf16* s = static_cast<const bf16*>(stripe);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pw % 16 || pw > SCOLS - 128 || pw < 128) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSuccess;
  switch (mode) {
    case 0: loop_kernel<0><<<groups, kThreads, 0, st>>>(s, out, Z, G, pw); break;
    case 1: loop_kernel<1><<<groups, kThreads, 0, st>>>(s, out, Z, G, pw); break;
    case 2:
      e = allow_smem(loop_kernel<2>, bytes);
      if (e != cudaSuccess) return (int)e;
      loop_kernel<2><<<groups, kThreads, bytes, st>>>(s, out, Z, G, pw);
      break;
    case 3:
      e = allow_smem(loop_kernel<3>, bytes);
      if (e != cudaSuccess) return (int)e;
      loop_kernel<3><<<groups, kThreads, bytes, st>>>(s, out, Z, G, pw);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// out [groups, 8 warps, 16, 16] float32; wx [64, R] bf16.
extern "C" int probe_floor_mma(const void* stripe, const void* wx, float* out,
                               int groups, int Z, int G, int pw, int R,
                               void* stream) {
  const size_t bytes = (size_t)SROWS * SLD * 2;
  if (pw % 16 || pw > SCOLS - 128 || pw < 128 || R % 16)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem(mma_kernel, bytes);
  if (e != cudaSuccess) return (int)e;
  mma_kernel<<<groups, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(stripe), static_cast<const bf16*>(wx), out, Z, G,
      pw, R);
  return (int)cudaGetLastError();
}

// packed [groups, Z, chunks * 8] bf16; out [groups, 256] float32.
extern "C" int probe_floor_ring(const void* packed, float* out, int groups,
                                int Z, int chunks, void* stream) {
  const size_t bytes = (size_t)3 * chunks * 16;
  if (bytes > 232448 || chunks < 1) return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem(ring_kernel, bytes);
  if (e != cudaSuccess) return (int)e;
  ring_kernel<<<groups, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(packed), out, Z, chunks);
  return (int)cudaGetLastError();
}

extern "C" int probe_floor_stripe_rows() { return SROWS; }
extern "C" int probe_floor_stripe_cols() { return SCOLS; }
extern "C" int probe_floor_stripe_ld() { return SLD; }

extern "C" const char* probe_floor_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
