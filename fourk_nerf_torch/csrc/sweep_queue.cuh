// Device code of the plane sweep's sample queue (sweep.cu): the per-warp
// queue of samples that need the rgbnet MLP, and the two ways a warp runs
// the MLP over it with all 32 lanes busy.
//
// The queue. Each warp owns a ring of records in shared memory, stored
// field by field (structure of arrays, so that 32 lanes reading 32
// consecutive records hit 32 banks). A record is one (ray, plane) sample
// with a non-zero composite weight: the owning lane, the weight w, the
// grid-space position (px, py) and plane k, and the k0 bilerp (rounded to
// the grid's type, as the MLP input is). The march appends at most one
// record a lane a plane, at the slot given by a __ballot_sync / __popc
// prefix; once 32 records wait, the warp flushes the 32 oldest, and at the
// end whatever is left. The ring of 64 has room for 31 waiting records plus
// 32 appended in one plane. (Flushes of 16 or 48 records measured slower.)
//
// A flush evaluates the MLP on the records' input rows [k0, PE(spatial),
// PE(viewdir)], writes w * sigmoid(logit) of each record to a result row,
// and then each lane adds the results of its own records in slot order,
// which is plane order: a ray's colour is summed front to back, as the
// plain version sums it, with no atomics.
//
// mma_flush, the bf16 path: lane i writes record i's input row, rounded to
// bf16, into a staging row of the warp (rows padded by 16 bytes, so that
// ldmatrix reads them without bank conflicts); the warp then runs each
// layer as mma.sync m16n8k16 (bf16 x bf16, float32 sums), one 16-row M
// tile at a time. Layer l's C fragments get bias, activation and bf16
// rounding in registers and become layer l+1's A fragments, as in
// rdb_block.cuh. The weights are bf16 in fragment order
// (cuda_sweep.pack_mlp_fragments): per k-step of 16 inputs and pair of
// 8-wide output tiles, lane l's two B fragments of both tiles are one
// 16-byte word, read through L1 (512 contiguous bytes a warp). The output
// layer is one n8 tile (3 logits used).
//
// fma_flush, the float32 path: lane i evaluates record i's MLP as float32
// FMAs with the weights of sweep_common.cuh, so nothing is rounded.
//
// The box sweep (box.cu) shares the queue and both flushes through two
// template arguments whose defaults are the plane sweep's: Row, which
// writes a record's input row (SweepRow: input_row below), and kOffset,
// which adds the record's three float fields (px, py, kf; the box keeps its
// float32 k0[:3] there) to the logits before the sigmoid.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sweep_common.cuh"

namespace sweepq {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kFlush = 32;  // records a flush
constexpr int kSlots = 64;  // >= kFlush - 1 waiting + 32 appended in a plane

typedef __nv_bfloat16 bf16;

// One warp's queue in shared memory; `k0` holds kCh rows of kSlots values.
template <typename Tg, int kCh>
struct Queue {
  float* w;
  float* px;
  float* py;
  float* kf;
  int* lane;
  Tg* k0;      // [kCh][kSlots]
  float* res;  // [kFlush][4]: w * sigmoid(logit) of a flush's records
  bf16* stg;   // [kFlush][row]: the bf16 path's staging rows
  int row;     // staging row stride in bf16 values (cinp + 8)

  static constexpr size_t kRecBytes =
      (kSlots * (5 * 4 + kCh * sizeof(Tg)) + kFlush * 4 * 4 + 15) / 16 * 16;
  static __host__ __device__ size_t bytes(int cinp, bool staging) {
    return kRecBytes + (staging ? (size_t)kFlush * (cinp + 8) * 2 : 0);
  }
  __device__ Queue(unsigned char* base, int cinp) {
    w = reinterpret_cast<float*>(base);
    px = w + kSlots;
    py = px + kSlots;
    kf = py + kSlots;
    lane = reinterpret_cast<int*>(kf + kSlots);
    res = reinterpret_cast<float*>(lane + kSlots);
    k0 = reinterpret_cast<Tg*>(res + kFlush * 4);
    stg = reinterpret_cast<bf16*>(base + kRecBytes);
    row = cinp + 8;
  }
  __device__ __forceinline__ int slot(int s, int i) const {
    return (s + i) & (kSlots - 1);
  }
};

// What a flush needs besides the queue.
struct MlpArgs {
  const uint4* mlp;          // the weights in device memory
  const float* vde;          // [R, E] viewdir embedding
  int ray0;                  // the warp's first ray
  int k0_dim, E, spatial_pe, n_layers, act, cin0, cinp;
  float zden, xhi, yhi;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// Hands the MLP input row of the record in `slot` to put(v), in the order
// of the first layer's rows: k0, the spatial coordinates, their sines and
// cosines (channel-major), the viewdir embedding, computed as the plain
// version computes them; put() rounds them to the MLP's type.
template <typename Q, typename Put>
__device__ __forceinline__ void input_row(const Q& q, const MlpArgs& m,
                                          int slot, Put&& put) {
  for (int d = 0; d < m.k0_dim; ++d) put(to_f(q.k0[d * kSlots + slot]));
  const float kf = q.kf[slot], px = q.px[slot], py = q.py[slot];
  const float sv[3] = {2.f * kf / m.zden - 1.f, py / m.yhi * 2.f - 1.f,
                       px / m.xhi * 2.f - 1.f};
#pragma unroll
  for (int d = 0; d < 3; ++d) put(sv[d]);
#pragma unroll 1
  for (int e = 0; e < 6 * m.spatial_pe; ++e) {
    const int d = (e / m.spatial_pe) % 3, f = e % m.spatial_pe;
    const float x = sv[d] * (float)(1 << f);
    put(e < 3 * m.spatial_pe ? sinf(x) : cosf(x));
  }
  const float* vr = m.vde + (size_t)(m.ray0 + q.lane[slot]) * m.E;
  for (int e = 0; e < m.E; ++e) put(__ldg(vr + e));
}

// The plane sweep's input row.
struct SweepRow {
  template <typename Q, typename Put>
  __device__ __forceinline__ void operator()(const Q& q, const MlpArgs& m,
                                             int slot, Put&& put) const {
    input_row(q, m, slot, put);
  }
};

// Each lane adds the results of its own records among the nf flushed from
// slot s, in slot order: one ballot a lane finds that lane's records, then
// each lane walks its own in order.
template <typename Q>
__device__ __forceinline__ void gather(const Q& q, int s, int nf, float& c0,
                                       float& c1, float& c2) {
  const int me = threadIdx.x & 31;
  const int owner = me < nf ? q.lane[q.slot(s, me)] : -1;
  unsigned mine = 0;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const unsigned b = __ballot_sync(kFull, owner == j);
    if (me == j) mine = b;
  }
  while (mine) {
    const int t = __ffs(mine) - 1;
    mine &= mine - 1;
    const float4 v = *reinterpret_cast<const float4*>(q.res + 4 * t);
    c0 += v.x;
    c1 += v.y;
    c2 += v.z;
  }
}

// ---------------------------------------------------------------- float32

template <typename Tg, int kCh, int WP, bool kOffset = false,
          typename Row = SweepRow>
__device__ __forceinline__ void fma_flush(const Queue<Tg, kCh>& q,
                                          const MlpArgs& m, float* hs, int s,
                                          int nf, float& c0, float& c1,
                                          float& c2, Row row = Row()) {
  using sweepc::feed;
  using sweepc::rnd;
  const Tg* tag = nullptr;
  const int i = threadIdx.x & 31;
  if (i < nf) {
    const int slot = q.slot(s, i);
    const float* W0 = reinterpret_cast<const float*>(m.mlp);
    const float* B0 = W0 + m.cin0 * WP;
    float acc[WP];
#pragma unroll
    for (int j = 0; j < WP; ++j) acc[j] = B0[j];
    int c = 0;
    row(q, m, slot,
        [&](float v) { feed<WP>(acc, W0 + (c++) * WP, rnd(v, tag)); });
    float o0, o1, o2;
    sweepc::rest<Tg, WP>(acc, B0 + WP, m.n_layers, m.act, hs, tag, o0, o1, o2);
    if constexpr (kOffset) {
      o0 += q.px[slot];
      o1 += q.py[slot];
      o2 += q.kf[slot];
    }
    const float w = q.w[slot];
    *reinterpret_cast<float4*>(q.res + 4 * i) =
        make_float4(w * sigmoid(o0), w * sigmoid(o1), w * sigmoid(o2), 0.f);
  }
  __syncwarp();
  gather(q, s, nf, c0, c1, c2);
  __syncwarp();
}

// ------------------------------------------------------------------- bf16

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&a)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr)
      : "memory");
}

// d += a * b: m16n8k16, bf16 operands, float32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Builds one staging row, two bf16 values to a 32-bit store.
struct RowWriter {
  uint32_t* row;
  int j = 0;
  uint32_t pend = 0;
  __device__ __forceinline__ void put_bits(uint32_t b) {
    if (j & 1)
      row[j >> 1] = pend | (b << 16);
    else
      pend = b;
    ++j;
  }
  __device__ __forceinline__ void put(float v) {
    const bf16 h = __float2bfloat16_rn(v);
    put_bits(*reinterpret_cast<const unsigned short*>(&h));
  }
};

// Weights in device memory, bf16 path (cuda_sweep.pack_mlp_fragments):
// fragment words of layer 0 [cinp/16][WP/16][32], of each hidden layer
// [WP/16][WP/16][32], of the output layer [WP/16][32] (one 16-wide pair, its
// first n8 tile used); then float32 biases b0 [WP], hidden [WP] each,
// output [8].
template <int WP>
__device__ __forceinline__ void layer_bias(const float* b, float (&acc)[WP / 8][4]) {
  const int tq = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < WP / 8; ++j) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(b + 8 * j + 2 * tq));
    acc[j][0] = acc[j][2] = v.x;
    acc[j][1] = acc[j][3] = v.y;
  }
}

// bf16(act(C)) of WP outputs as the A fragments of the next product
// (C tile j is k-step j / 2, half j % 2)
template <int WP, int ACT>
__device__ __forceinline__ void to_a_act(const float (&acc)[WP / 8][4],
                                         uint32_t (&ah)[WP / 16][4]) {
  using sweepc::act_fn;
#pragma unroll
  for (int j = 0; j < WP / 8; ++j) {
    ah[j >> 1][2 * (j & 1)] = pack2(act_fn(acc[j][0], ACT), act_fn(acc[j][1], ACT));
    ah[j >> 1][2 * (j & 1) + 1] =
        pack2(act_fn(acc[j][2], ACT), act_fn(acc[j][3], ACT));
  }
}

template <int WP>
__device__ __forceinline__ void to_a(const float (&acc)[WP / 8][4], int act,
                                     uint32_t (&ah)[WP / 16][4]) {
  if (act == 0)
    to_a_act<WP, 0>(acc, ah);
  else if (act == 1)
    to_a_act<WP, 1>(acc, ah);
  else
    to_a_act<WP, 2>(acc, ah);
}

// The MLP of the 16 staged rows [16 mt, 16 mt + 16). res[4 i + 3] holds
// the weight of row i on entry (and with kOffset res[4 i + c] the offset of
// logit c); res[4 i + c] receives w * sigmoid(logit c), c < 3. (Two M tiles
// at once, sharing the B loads, measured slower: more registers, fewer
// warps.)
template <int WP, bool kOffset>
__device__ __forceinline__ void mma_tile(const bf16* stg, int row,
                                         const MlpArgs& m, float* res, int nf,
                                         int mt) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  constexpr int NP = WP / 16;
  const uint4* frag = m.mlp;
  const int ksteps0 = m.cinp / 16;
  const float* bias = reinterpret_cast<const float*>(
      frag + ((size_t)ksteps0 * NP + (size_t)(m.n_layers - 2) * NP * NP + NP) * 32);

  float acc[WP / 8][4];
  layer_bias<WP>(bias, acc);
  const uint32_t sbase = (uint32_t)__cvta_generic_to_shared(stg);
  for (int kk = 0; kk < ksteps0; ++kk) {
    uint32_t a[4];
    ldmatrix_x4(sbase + ((mt * 16 + (lane & 15)) * row + (2 * kk + (lane >> 4)) * 8) * 2, a);
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const uint4 w = __ldg(frag + (kk * NP + p) * 32 + lane);
      mma_bf16(acc[2 * p], a, w.x, w.y);
      mma_bf16(acc[2 * p + 1], a, w.z, w.w);
    }
  }
  frag += ksteps0 * NP * 32;
  bias += WP;

  uint32_t ah[NP][4];
  to_a<WP>(acc, m.act, ah);
  for (int l = 1; l < m.n_layers - 1; ++l) {
    layer_bias<WP>(bias, acc);
#pragma unroll
    for (int kk = 0; kk < NP; ++kk)
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const uint4 w = __ldg(frag + (kk * NP + p) * 32 + lane);
        mma_bf16(acc[2 * p], ah[kk], w.x, w.y);
        mma_bf16(acc[2 * p + 1], ah[kk], w.z, w.w);
      }
    to_a<WP>(acc, m.act, ah);
    frag += NP * NP * 32;
    bias += WP;
  }

  // output layer: one n8 tile; lane (g, tq) holds logits 2 tq, 2 tq + 1 of
  // rows g and g + 8
  const float2 bo = __ldg(reinterpret_cast<const float2*>(bias + 2 * tq));
  float o[4] = {bo.x, bo.y, bo.x, bo.y};
#pragma unroll
  for (int kk = 0; kk < NP; ++kk) {
    const uint4 w = __ldg(frag + kk * 32 + lane);
    mma_bf16(o, ah[kk], w.x, w.y);
  }
  if (tq < 2) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = mt * 16 + g + 8 * h;
      if (i < nf) {
        const float w = res[4 * i + 3];
        float a0 = o[2 * h], a1 = o[2 * h + 1];
        if constexpr (kOffset) {
          a0 += res[4 * i + 2 * tq];
          a1 += res[4 * i + 1];
        }
        res[4 * i + 2 * tq] = w * sigmoid(a0);
        if (tq == 0) res[4 * i + 1] = w * sigmoid(a1);
      }
    }
  }
}

template <int kCh, int WP, bool kOffset = false, typename Row = SweepRow>
__device__ __forceinline__ void mma_flush(const Queue<bf16, kCh>& q,
                                          const MlpArgs& m, int s, int nf,
                                          float& c0, float& c1, float& c2,
                                          Row row = Row()) {
  // lane i stages record i's input row and weight (zeros past nf and past
  // cin0)
  const int i = threadIdx.x & 31;
  RowWriter rw{reinterpret_cast<uint32_t*>(q.stg + i * q.row)};
  float w = 0.f;
  if (i < nf) {
    const int slot = q.slot(s, i);
    w = q.w[slot];
    row(q, m, slot, [&](float v) { rw.put(v); });
    if constexpr (kOffset) {
      q.res[4 * i] = q.px[slot];
      q.res[4 * i + 1] = q.py[slot];
      q.res[4 * i + 2] = q.kf[slot];
    }
  }
  while (rw.j < m.cinp) rw.put_bits(0u);
  q.res[4 * i + 3] = w;  // the weight rides in the unused fourth column
  __syncwarp();
#pragma unroll 1
  for (int mt = 0; 16 * mt < nf; ++mt)
    mma_tile<WP, kOffset>(q.stg, q.row, m, q.res, nf, mt);
  __syncwarp();
  gather(q, s, nf, c0, c1, c2);
  __syncwarp();
}

}  // namespace sweepq
