// Six small kernels for the constructs a transposed sweep kernel is built
// from, for Hopper (sm_90a).
//
// Counterpart of the lowering probes of the JAX reference package's
// tools/perf/probe_mosaic.py (pallas_call at :18), which asks the TPU
// compiler whether it lowers each construct and checks the result. Here every
// construct is a kernel written out by hand at the same shapes, and the
// caller holds each against a torch expression:
//   dot_tt        out[L, R] = patch[P, L]^T wx[P, R], float32 FMAs
//   dot_tt_bf16   the same with operands rounded to bf16, float32 sums, on
//                 the tensor cores (nvcuda::wmma, patch^T as a column-major
//                 operand)
//   r3_bcast      out[(q, c), r] = z[(q, c), r] * wy[q, r]
//   strided_row   out[q, r] = z[(q, row), r]
//   repeat_rows   out[(q, c), r] = wy[q, r]
//   block_reduce  out[c, r] = sum_q z[(q, c), r], as a pairwise tree over
//                 contiguous row blocks (halves down to 3 x Cp rows, then the
//                 last three added left to right), so the caller can
//                 reproduce the float32 sum exactly
// They move or combine a few megabytes: each is bound by bytes or by launch
// time, and none is on a frame's path.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

__global__ void dot_tt_kernel(const float* patch, const float* wx, float* out,
                              int P, int L, int R) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x, l = blockIdx.y;
  if (r >= R) return;
  float acc = 0.f;
  for (int p = 0; p < P; ++p)
    acc = fmaf(__ldg(patch + (size_t)p * L + l), __ldg(wx + (size_t)p * R + r),
               acc);
  out[(size_t)l * R + r] = acc;
}

// one warp per 16x16 output tile; P is a multiple of 16
__global__ void dot_tt_bf16_kernel(const bf16* patch, const bf16* wx,
                                   float* out, int P, int L, int R) {
  const int lt = blockIdx.y, rt = blockIdx.x;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
  wmma::fill_fragment(acc, 0.f);
  for (int k = 0; k < P; k += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
    wmma::load_matrix_sync(a, patch + (size_t)k * L + 16 * lt, L);
    wmma::load_matrix_sync(b, wx + (size_t)k * R + 16 * rt, R);
    wmma::mma_sync(acc, a, b, acc);
  }
  wmma::store_matrix_sync(out + (size_t)(16 * lt) * R + 16 * rt, acc, R,
                          wmma::mem_row_major);
}

// mode 0 r3_bcast, 1 strided_row, 2 repeat_rows; one thread per output
__global__ void move_kernel(int mode, const float* z, const float* wy,
                            float* out, int Q, int Cp, int R, int row) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x, o = blockIdx.y;
  if (r >= R) return;
  if (mode == 0) {
    out[(size_t)o * R + r] = z[(size_t)o * R + r] * wy[(size_t)(o / Cp) * R + r];
  } else if (mode == 1) {
    out[(size_t)o * R + r] = z[((size_t)o * Cp + row) * R + r];
  } else {
    out[(size_t)o * R + r] = wy[(size_t)(o / Cp) * R + r];
  }
}

// The tree of the header comment for one output row c and column r: the
// Q * Cp rows are halved (lower half + upper half) until `odd` blocks of Cp
// rows are left, which are added left to right. FOLD = Q / odd, a power of
// two; vals[m] holds row i + m * (odd * Cp).
constexpr int kMaxFold = 64;

__global__ void block_reduce_kernel(const float* z, float* out, int Cp, int R,
                                    int odd, int fold) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x, c = blockIdx.y;
  if (r >= R) return;
  const int top = odd * Cp;
  float total = 0.f;
  for (int b = 0; b < odd; ++b) {
    float vals[kMaxFold];
    for (int m = 0; m < fold; ++m)
      vals[m] = z[(size_t)(c + b * Cp + m * top) * R + r];
    for (int w = fold / 2; w >= 1; w /= 2)
      for (int m = 0; m < w; ++m) vals[m] = vals[m] + vals[m + w];
    total = b == 0 ? vals[0] : total + vals[0];
  }
  out[(size_t)c * R + r] = total;
}

}  // namespace

extern "C" int probe_ops_dot_tt(const float* patch, const float* wx,
                                float* out, int P, int L, int R, void* stream) {
  dim3 grid((R + 255) / 256, L);
  dot_tt_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      patch, wx, out, P, L, R);
  return (int)cudaGetLastError();
}

extern "C" int probe_ops_dot_tt_bf16(const void* patch, const void* wx,
                                     float* out, int P, int L, int R,
                                     void* stream) {
  if (P % 16 || L % 16 || R % 16) return (int)cudaErrorInvalidValue;
  dim3 grid(R / 16, L / 16);
  dot_tt_bf16_kernel<<<grid, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(patch), static_cast<const bf16*>(wx), out, P, L,
      R);
  return (int)cudaGetLastError();
}

// rows: the number of output rows (Q * Cp, Q, Q * Cp for modes 0, 1, 2)
extern "C" int probe_ops_move(int mode, const float* z, const float* wy,
                              float* out, int Q, int Cp, int R, int row,
                              void* stream) {
  if (mode < 0 || mode > 2 || row < 0 || row >= Cp)
    return (int)cudaErrorInvalidValue;
  dim3 grid((R + 255) / 256, mode == 1 ? Q : Q * Cp);
  move_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      mode, z, wy, out, Q, Cp, R, row);
  return (int)cudaGetLastError();
}

extern "C" int probe_ops_block_reduce(const float* z, float* out, int Q, int Cp,
                                      int R, void* stream) {
  int odd = Q, fold = 1;
  while (odd % 2 == 0) {
    odd /= 2;
    fold *= 2;
  }
  if (Q < 1 || fold > kMaxFold) return (int)cudaErrorInvalidValue;
  dim3 grid((R + 255) / 256, Cp);
  block_reduce_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      z, out, Cp, R, odd, fold);
  return (int)cudaGetLastError();
}

extern "C" const char* probe_ops_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
