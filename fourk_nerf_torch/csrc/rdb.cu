// One fused SFT residual dense block of the SFTNet decoder for Hopper
// (sm_90a), plain or with the RRDB tail.
//
// Replaces the TPU kernel _rdb_kernel of the JAX reference package's
// ops/pallas_sr.py (pallas_sr.py:65, pallas_call at :481). Per output pixel
// it computes
//   xc0 = SFT0(x, cond)
//   y_s = lrelu(conv3x3_s([xc0, y_1 .. y_{s-1}]) + b_s),  s = 1..4
//   y_4 <- SFT1(y_4, cond)
//   out = (conv3x3_5([xc0, y_1 .. y_4]) + b_5) * 0.2 + x
// and in tail mode out <- bf16(SFT_rrdb(out, cond) * 0.2) + x_rrdb. Every
// conv sees SAME zero padding at the frame edge. Storage is bf16, sums are
// float32, and bf16 rounding happens where the TPU kernel rounds: xc0, each
// y_s, the SFT hidden layer, and the output.
//
// What bounds it on the H100: the convs' bf16 tensor-core work, 249,856 MAC
// per output pixel, 0.385 ms for a 1008x756 frame at the bf16 peak. A tile
// recomputes its halo: the halo-5 window of an 8x16 tile, and convs 1-4 run
// 64 rows of M for 32 channels (two taps a product, a third alone).
//
// Design. Each SM runs one persistent thread block of two warpgroups that
// walks over 8x16 output tiles. A tile's halo-5 window (18x26 pixels) lives
// in shared memory as 128-byte pixel rows, 128-byte swizzled (xc0 and the
// dense concat y_1..y_4 in three panels), so a 3x3 tap is a constant row
// offset. Every conv product is a wgmma m64nNk16: its N is the warpgroup's
// pixel rows, read straight from those rows through a shared-memory
// descriptor (any row may start it), and its M the output channels, whose
// weights come as A from registers. The weights, which every tile reads
// whole (552 KB as wgmma A tiles), no longer reach each warp from L2 a step
// at a time: they stream by bulk async copies (cp.async.bulk, mbarrier
// completion) into a ring of 6 KB pieces beside the window, running ahead
// across convs and tiles; a warp loads a group's A with ldmatrix once its
// piece has landed and releases it when its products have issued, and the
// last warp to release a stage refills it (no producer warp). The next
// group's A loads while a group's products run. The warpgroups meet at a
// block barrier only between the block's stages (SFT0, the convs, SFT1),
// where one reads what the last wrote. The SFT layers run on mma.sync with
// their matrices staged in shared memory. The TPU kernel's weights sit in
// VMEM for the whole grid; here they are the stream the design is built
// around (the mma.sync design it replaces read them from L2 through a
// 28 KB L1, warp by warp, at ~7% of the bound).

#include "rdb_block.cuh"

namespace {

using namespace rdbk;

// The window's buffers, three panels of 128-byte pixel rows (buffer row
// kMarg + q for window pixel q): xc0, the dense concat's channels 0-63
// (y1, y2) and 64-127 (y3, y4). A 16-byte chunk of 8 channels sits at
// chunk ^ (row & 7), the 128-byte swizzle wgmma's descriptors read, on
// panels aligned to 1024 bytes. A conv reads at most WW + 1 rows past its
// own and convs 1-4 eight more below (their products run 8 pixels wide):
// inside [q_lo(conv1) - WW - 1, PP + 8) = [-11, 488), so a margin of 16
// zero rows above and 8 below.
constexpr int kMarg = 16;
constexpr int kRows = kMarg + PP + 8;  // 504
constexpr size_t kPanel = (size_t)kRows * kXRow;
constexpr size_t kWin = 3 * kPanel;
static_assert(kMarg >= WW + 1 - (WW / 16 * 16) && kPanel % 1024 == 0, "panels");
static_assert((size_t)NM5 * 16 * kStage * 4 <= kPanel, "conv5 staging");

// The weight ring: a tile reads the five convs' weights as wgmma's A, a
// step (64 rows x 16 inputs) 2 KB: 6 steps a 16-channel input chunk for
// convs 1-4 (their 32 channels, tap pairs) and 9 for conv5 (552 KB), as 92
// pieces of 6 KB, three steps each; every conv starts on a piece.
constexpr int kStepBytes = 64 * 16 * 2;
constexpr int kPiece = 3 * kStepBytes;
constexpr int kStages = 6;
constexpr int kConv14 = kStepBytes * 6 * (4 * kF + 6 * kG) / 16;
constexpr int kConvBytes = kConv14 + kStepBytes * 9 * (kF + 4 * kG) / 16;
constexpr int kPieces = kConvBytes / kPiece;  // 92 a tile
constexpr size_t kRingOff = kWin;
constexpr size_t kBarOff = kRingOff + (size_t)kStages * kPiece;
constexpr size_t kCntOff = kBarOff + kStages * 8;
constexpr size_t kMaskOff = kCntOff + kStages * 4;  // the window's frame bits
constexpr size_t kSmemWS = kMaskOff + PP / 8 + 1024;  // + alignment
static_assert(6 * kF / 16 % 3 == 0 && 6 * kG / 16 % 3 == 0 &&
                  kConv14 % kPiece == 0 && kConvBytes % kPiece == 0,
              "every conv starts on a piece");
static_assert(kSmemWS <= 232448, "shared memory over the sm_90 limit");

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}
// whether the phase of parity `parity` of `bar` has completed (waits a
// while for it first)
__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done;
}
// `bytes` from global `src` into shared `dst`, completing on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// the block's barrier between its stages; the writes before it (generic
// proxy) become visible to the wgmma reads after it (async proxy)
__device__ __forceinline__ void block_sync() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
}

// The weight ring. A piece lands in its stage by a bulk copy that completes
// on the stage's full barrier; each thread keeps the stage and phase of the
// next piece it waits for (fs, fp). A warp releases the pieces it has read
// in order (rk of them so far) by counting itself in the stage's counter in
// shared memory; the warp that counts last issues the copy of the piece
// kStages further on into the stage. So every stage is refilled as soon as
// the last warp is done with it, by that warp, and no warp is set aside to
// produce or has to look whether the others are done.
struct Ring {
  uint32_t data, full;
  int* cnt;
  const unsigned char* src;
  int total;  // pieces this block takes, kPieces a tile
  int fs, rk;
  uint32_t fp;
  __device__ __forceinline__ void load(int stage, int piece) {
    bulk_load(data + stage * kPiece, src + (size_t)(piece % kPieces) * kPiece,
              kPiece, full + 8 * stage);
  }
  // shared address of the next piece, once it has landed
  __device__ __forceinline__ uint32_t wait() {
    while (!mbar_try(full + 8 * fs, fp)) {
    }
    __syncwarp();
    const uint32_t at = data + fs * kPiece;
    if (++fs == kStages) { fs = 0; fp ^= 1; }
    return at;
  }
  __device__ __forceinline__ void release() {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) {
      const int stage = rk % kStages;
      if (atomicAdd(cnt + stage, 1) == kWarps - 1) {
        cnt[stage] = 0;
        if (rk + kStages < total) load(stage, rk + kStages);
      }
    }
    ++rk;
  }
};

// ---- wgmma ---------------------------------------------------------------
// A shared-memory descriptor of 128-byte-swizzled K-major rows (8-row groups
// 1024 bytes apart) starting at saddr; the swizzle follows the address bits,
// so any row and any 32-byte K offset may start it.
__device__ __forceinline__ uint64_t act_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// keep the compiler from moving accesses of the accumulators across the
// asynchronous products
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) asm volatile("" : "+f"(d[r])::"memory");
}

// d += a b over 64 output channels (A: this warp's 16 of them from
// registers, in the mma.sync A layout) and N pixels (B: K-major rows at the
// descriptor b): wgmma m64nNk16, bf16 in, float32 sums; pixel block j of 8
// is d[4 j .. 4 j + 3] in the mma.sync C layout
template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2],
                                      const uint32_t (&a)[4], uint64_t b);
template <>
__device__ __forceinline__ void wgmma<224>(float (&d)[112],
                                           const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n224k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63,"
      "%64,%65,%66,%67,%68,%69,%70,%71,%72,%73,%74,%75,%76,%77,%78,%79,"
      "%80,%81,%82,%83,%84,%85,%86,%87,%88,%89,%90,%91,%92,%93,%94,%95,"
      "%96,%97,%98,%99,%100,%101,%102,%103,%104,%105,%106,%107,%108,%109,%110,%111"
      "}, {%112,%113,%114,%115}, %116, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}
template <>
__device__ __forceinline__ void wgmma<192>(float (&d)[96],
                                           const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63,"
      "%64,%65,%66,%67,%68,%69,%70,%71,%72,%73,%74,%75,%76,%77,%78,%79,"
      "%80,%81,%82,%83,%84,%85,%86,%87,%88,%89,%90,%91,%92,%93,%94,%95"
      "}, {%96,%97,%98,%99}, %100, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}
template <>
__device__ __forceinline__ void wgmma<176>(float (&d)[88],
                                           const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n176k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63,"
      "%64,%65,%66,%67,%68,%69,%70,%71,%72,%73,%74,%75,%76,%77,%78,%79,"
      "%80,%81,%82,%83,%84,%85,%86,%87"
      "}, {%88,%89,%90,%91}, %92, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}
template <>
__device__ __forceinline__ void wgmma<144>(float (&d)[72],
                                           const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n144k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63,"
      "%64,%65,%66,%67,%68,%69,%70,%71"
      "}, {%72,%73,%74,%75}, %76, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}
template <>
__device__ __forceinline__ void wgmma<112>(float (&d)[56],
                                           const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55"
      "}, {%56,%57,%58,%59}, %60, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

struct RdbArgs {
  const bf16* x;      // [H, W, 64]
  const bf16* cond;   // [H, W, 32]
  const bf16* xin;    // [H, W, 64] RRDB input (tail mode) or null
  bf16* out;          // [H, W, 64]
  BlockWeights w;     // w.wconv in ldmatrix A order (cuda_sr._to_afrag)
  int H, W, tail;
};

// A tile's window: origin (r0, c0) in frame coordinates
struct Win {
  int r0, c0, H, W;
  __device__ __forceinline__ bool in(int q) const {  // pixel q in the frame
    const int gy = r0 + q / WW, gx = c0 + q % WW;
    return q < P && gy >= 0 && gy < H && gx >= 0 && gx < W;
  }
};

// ---- SFT layers from shared memory --------------------------------------
// An SFT's four matrices (rdb_block.cuh's fragment order, 4 KB each) and
// biases (64 floats each) are staged in rows 0..71 of the dense panels,
// which no stage of the block reads while the SFT runs: matrices 0, 1 in
// panel 0, matrices 2, 3 in panel 1, the biases after matrix 1.
constexpr int kSftBias = (int)kPanel + 2 * kSftMat * 16;
__device__ __forceinline__ int sft_mat(int m) {
  return (int)kPanel * (1 + m / 2) + (m % 2) * kSftMat * 16;
}
static_assert(kSftBias + 4 * 64 * 4 <=
                  (int)kPanel + (kMarg + Q5_LO - WW - 1) * kXRow,
              "the staged SFT stays above the rows conv5 and SFT1 touch");
// the SFT at matrix `base` (0: sft0, 4: sft1, 8: the RRDB's) into place;
// a barrier must follow before it is read
__device__ __forceinline__ void stage_sft(unsigned char* smem,
                                          const BlockWeights& w, int base) {
  const uint4* k = reinterpret_cast<const uint4*>(w.sftk) + base * kSftMat;
  for (int i = threadIdx.x; i < 4 * kSftMat; i += kThreads)
    *reinterpret_cast<uint4*>(smem + sft_mat(i / kSftMat) +
                              16 * (i % kSftMat)) = __ldg(k + i);
  const float4* b = reinterpret_cast<const float4*>(w.sftb + base * 64);
  for (int i = threadIdx.x; i < 64; i += kThreads)
    *reinterpret_cast<float4*>(smem + kSftBias + 16 * i) = __ldg(b + i);
}
// sft_hidden / sft_out / sft_mma of rdb_block.cuh, reading the staged SFT
__device__ __forceinline__ void sft_hidden_s(const uint32_t (&ac)[2][4],
                                             const uint4* M, const float* b,
                                             uint32_t (&ah)[2][4]) {
  const int lane = threadIdx.x & 31, tq = lane & 3;
  float h[4][4] = {};
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const uint4 w = M[(kk * 4 + p) * 32 + lane];
      mma_bf16(h[2 * p], ac[kk], w.x, w.y);
      mma_bf16(h[2 * p + 1], ac[kk], w.z, w.w);
    }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 bj = *reinterpret_cast<const float2*>(b + 8 * j + 2 * tq);
    ah[j >> 1][2 * (j & 1)] = pack2(lrelu(h[j][0] + bj.x), lrelu(h[j][1] + bj.y));
    ah[j >> 1][2 * (j & 1) + 1] =
        pack2(lrelu(h[j][2] + bj.x), lrelu(h[j][3] + bj.y));
  }
}
template <int NT>
__device__ __forceinline__ void sft_out_s(const uint32_t (&ah)[2][4],
                                          const uint4* M, const float* b,
                                          float (&o)[NT][4]) {
  const int lane = threadIdx.x & 31, tq = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const float2 bj = *reinterpret_cast<const float2*>(b + 8 * j + 2 * tq);
    o[j][0] = o[j][2] = bj.x;
    o[j][1] = o[j][3] = bj.y;
  }
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int p = 0; p < NT / 2; ++p) {
      const uint4 w = M[(kk * 4 + p) * 32 + lane];
      mma_bf16(o[2 * p], ah[kk], w.x, w.y);
      mma_bf16(o[2 * p + 1], ah[kk], w.z, w.w);
    }
}
template <int NT>
__device__ __forceinline__ void sft_s(const uint32_t (&ac)[2][4],
                                      const unsigned char* smem,
                                      float (&sc)[NT][4], float (&sh)[NT][4]) {
  const float* b = reinterpret_cast<const float*>(smem + kSftBias);
  auto mat = [&](int m) {
    return reinterpret_cast<const uint4*>(smem + sft_mat(m));
  };
  uint32_t ah[2][4];
  sft_hidden_s(ac, mat(0), b, ah);
  sft_out_s<NT>(ah, mat(1), b + 64, sc);
  sft_hidden_s(ac, mat(2), b + 128, ah);
  sft_out_s<NT>(ah, mat(3), b + 192, sh);
}

// byte offset of channel chunk ch (8 channels) of buffer row r of the
// dense concat
__device__ __forceinline__ int dense_at(int r, int ch) {
  return (int)kPanel * (1 + (ch >> 3)) + swz(r, ch & 7, kXRow);
}

// stores four 8x8 bf16 tiles transposed: tile m (this lane's registers of
// it in the mma.sync C layout, r[m]) goes to the eight 16-byte rows at the
// addresses lanes 8 m .. 8 m + 7 give
__device__ __forceinline__ void stmatrix_t4(uint32_t addr, uint32_t r0,
                                            uint32_t r1, uint32_t r2,
                                            uint32_t r3) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1,%2,%3,%4};" ::
          "r"(addr),
      "r"(r0), "r"(r1), "r"(r2), "r"(r3)
      : "memory");
}
__device__ __forceinline__ void stmatrix_t1(uint32_t addr, uint32_t r0) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x1.trans.shared.b16 [%0], {%1};" ::"r"(addr),
      "r"(r0)
      : "memory");
}

// Conv S + 1 (S = 0..4) over 16-channel input chunks c (c < 4 from xc0,
// then the dense concat's). Each warpgroup takes N pixel rows of the conv's
// [q_lo, q_hi) as the N of one wgmma m64nNk16 a step, read straight from
// the swizzled rows (the tap is an offset of the descriptor); the 64 rows
// of M are A from registers, 16 a warp, loaded from the ring with ldmatrix.
// Conv5's M is its 64 output channels, a step a tap and a chunk. Convs 1-4
// have 32 channels, so a step carries two taps of a kernel row dy: rows
// 16 wq + r (r < 8) are channel 8 wq + r of tap (dy, -1) and rows
// 16 wq + 8 + r the same channel of tap (dy, 0), whose sum for output
// pixel q lands in column q + 1; tap (dy, +1) runs alone (zeros below).
// Those products run 8 pixels wider, and y(q) = upper(q) + lower(q + 1).
// The products go by groups of pieces (one piece for convs 1-4; three for
// conv5, whose products are half as wide): a group's A loads into
// registers all at once, its products issue as one wgmma group, and the
// next group's A loads while that group runs (two register buffers); a
// piece is released once the products that read its A have issued (12 KB
// pieces in three stages measured slower: convs 1-4 then fill and drain
// the pipeline over four to ten pieces). Convs 1-4 end in y_{S+1} =
// lrelu(conv + b) (zero off the frame), stored transposed into the dense
// concat; conv5 in its float32 sums staged in xc0's space.
template <int S>
__device__ __forceinline__ void conv(unsigned char* smem, const float* bias,
                                     const uint32_t* inframe, Ring& ring) {
  constexpr bool kPair = S < 4;
  constexpr int NCH = (kF + kG * S) / 16;
  constexpr int q_lo = kPair ? ((S + 1) * WW) / 16 * 16 : Q5_LO;
  constexpr int q_hi = kPair ? ((WH - S - 1) * WW + 15) / 16 * 16 : Q5_HI;
  constexpr int N = (q_hi - q_lo) / 2;  // 216, 184, 168, 136, 112
  constexpr int NB = kPair ? N + 8 : N;  // the products' width
  constexpr int kPcs = (kPair ? 6 : 9) * NCH / 3;
  constexpr int PPG = kPair ? 1 : 3, SPG = 3 * PPG, kGroups = kPcs / PPG;
  static_assert(N % 8 == 0 && (kPair ? 6 : 9) * NCH % 3 == 0 &&
                    kPcs % PPG == 0,
                "shape");
  const uint32_t xs = (uint32_t)__cvta_generic_to_shared(smem);
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int wq = warp & 3, g = lane >> 2, tq = lane & 3;
  const int p0 = q_lo + (warp >> 2) * N;
  float acc[NB / 2];
#pragma unroll
  for (int e = 0; e < NB / 2; ++e) acc[e] = 0.f;
  uint32_t a[2][SPG][4];
  auto load = [&](uint32_t(&f)[SPG][4]) {
#pragma unroll
    for (int pp = 0; pp < PPG; ++pp) {
      const uint32_t w = ring.wait() + wq * 512 + lane * 16;
#pragma unroll
      for (int u = 0; u < 3; ++u) ldmatrix_x4(w + u * kStepBytes, f[3 * pp + u]);
    }
  };
  // the products of group gr from A in cur, then the next group's A in nxt
  auto group = [&](int gr, uint32_t(&cur)[SPG][4], uint32_t(&nxt)[SPG][4]) {
    fence_acc(acc);
    wg_fence();
#pragma unroll
    for (int u = 0; u < SPG; ++u) {
      const int i = gr * SPG + u, k = i / NCH, c = i - k * NCH;
      const int shift = kPair ? (k % 3 - 1) * WW + (k < 3 ? -1 : 1)
                              : (k / 3 - 1) * WW + (k % 3 - 1);
      const uint32_t panel = c < 4 ? xs : xs + (uint32_t)kPanel * (c / 8 + 1);
      const uint32_t row = kMarg + p0 + shift;
      wgmma<NB>(acc, cur[u], act_desc(panel + row * kXRow + 32 * (c % 4)));
    }
    wg_commit();
#pragma unroll
    for (int pp = 0; pp < PPG; ++pp) ring.release();
    wg_wait<1>();  // the group before is done with its A
    if (gr + 1 < kGroups) load(nxt);
  };
  load(a[0]);
#pragma unroll 1
  for (int gr = 0; gr < kGroups; gr += 2) {
    group(gr, a[0], a[1]);
    if (gr + 1 < kGroups) group(gr + 1, a[1], a[0]);
  }
  wg_wait<0>();
  fence_acc(acc);

  if constexpr (kPair) {
    // channel 8 wq + g; output pixel p0 + 8 j + 2 tq + e
    const float b = __ldg(bias + S * 64 + 8 * wq + g);
    uint32_t v[N / 8];
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const float x = tq > 0 ? acc[4 * j + 2] : acc[4 * j + 6];
      const float next = __shfl_sync(0xffffffffu, x, tq < 3 ? lane + 1 : lane - 3);
      const int q = p0 + 8 * j + 2 * tq;
      const bool k0 = (inframe[q >> 5] >> (q & 31)) & 1;
      const bool k1 = (inframe[(q + 1) >> 5] >> ((q + 1) & 31)) & 1;
      v[j] = pack2(k0 ? lrelu(acc[4 * j] + acc[4 * j + 3] + b) : 0.f,
                   k1 ? lrelu(acc[4 * j + 1] + next + b) : 0.f);
    }
    // lane l addresses row l % 8 of tile l / 8: pixel block j + l / 8,
    // channel chunk 4 S + wq of the concat
    const int ch = 4 * S + wq;
    const uint32_t pan = xs + (uint32_t)kPanel * (1 + (ch >> 3));
    auto at = [&](int j) {
      return pan + swz(kMarg + p0 + 8 * j + (lane & 7), ch & 7, kXRow);
    };
#pragma unroll
    for (int j = 0; j < N / 8; j += 4) {
      if (j + 4 <= N / 8)
        stmatrix_t4(at(j + (lane >> 3)), v[j], v[j + 1], v[j + 2], v[j + 3]);
      else
#pragma unroll
        for (int jj = j; jj < N / 8; ++jj) stmatrix_t1(at(jj), v[jj]);
    }
  } else {
    block_sync();  // every warp is done reading xc0
    const int lo = 16 * wq + g;  // this lane's channels lo and lo + 8
    float* stage = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float* px = stage + (size_t)(p0 + 8 * j + 2 * tq + e - Q5_LO) * kStage;
        px[lo] = acc[4 * j + e];
        px[lo + 8] = acc[4 * j + 2 + e];
      }
  }
  block_sync();
}

// One 8x16 output tile with origin (ty0, tx0)
__device__ __forceinline__ void tile(unsigned char* smem, const RdbArgs& p,
                                     int ty0, int tx0, Ring& ring) {
  const int H = p.H, W = p.W;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tq = lane & 3;  // mma C layout
  const int r0 = ty0 - HALO, c0 = tx0 - HALO;  // window origin
  const Win win{r0, c0, H, W};
  auto gidx = [&](int q) {
    return (size_t)(r0 + q / WW) * W + (c0 + q % WW);
  };
  const uint32_t* x2 = reinterpret_cast<const uint32_t*>(p.x);
  const uint32_t* xin2 = reinterpret_cast<const uint32_t*>(p.xin);

  block_sync();  // the last tile's epilogue is done with xc0's space
  // ---- xc0 = SFT0(x, cond) on every window row, zero off the frame --------
  uint32_t* inframe = reinterpret_cast<uint32_t*>(smem + kMaskOff);
  if (tid < PP / 32) {
    uint32_t bits = 0;
    for (int b = 0; b < 32; ++b) bits |= (uint32_t)win.in(32 * tid + b) << b;
    inframe[tid] = bits;
  }
  stage_sft(smem, p.w, 0);
  for (int i = tid; i < kMarg * kXRow / 16; i += kThreads)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
  block_sync();
  for (int m = warp; m < PP / 16; m += kWarps) {
    const int qa = 16 * m + g, qb = qa + 8;
    const bool ina = win.in(qa), inb = win.in(qb);
    uint32_t ac[2][4];
    cond_frag(p.cond, ina, gidx(qa), inb, gidx(qb), ac);
    float sc[8][4], sh[8][4];
    sft_s<8>(ac, smem, sc, sh);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int q = hr ? qb : qa;
      const bool in = hr ? inb : ina;
      const uint32_t* xp = x2 + (in ? gidx(q) : 0) * (kF / 2) + tq;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 v = in ? unpack2(__ldg(xp + 4 * j)) : make_float2(0, 0);
        *reinterpret_cast<uint32_t*>(smem + swz(kMarg + q, j, kXRow) + 4 * tq) =
            in ? pack2(v.x * (sc[j][2 * hr] + 1.f) + sh[j][2 * hr],
                       v.y * (sc[j][2 * hr + 1] + 1.f) + sh[j][2 * hr + 1])
               : 0u;
      }
    }
  }
  block_sync();

  // ---- conv1..conv4 (32 out channels each) into the dense concat ----------
  conv<0>(smem, p.w.bias, inframe, ring);
  conv<1>(smem, p.w.bias, inframe, ring);
  conv<2>(smem, p.w.bias, inframe, ring);
  conv<3>(smem, p.w.bias, inframe, ring);

  // ---- y4 <- SFT1(y4, cond) on the rows conv5 reads ------------------------
  stage_sft(smem, p.w, 4);
  block_sync();
  {
    constexpr int lo = 4 * WW, hi = (WH - 4) * WW;  // 260 pixels, 17 M tiles
    for (int m = warp; 16 * m < hi - lo; m += kWarps) {
      const int qa = lo + 16 * m + g, qb = qa + 8;
      const bool ina = qa < hi && win.in(qa), inb = qb < hi && win.in(qb);
      uint32_t ac[2][4];
      cond_frag(p.cond, ina, gidx(qa), inb, gidx(qb), ac);
      float sc[4][4], sh[4][4];
      sft_s<4>(ac, smem, sc, sh);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        if (!(hr ? inb : ina)) continue;
        const int r = kMarg + (hr ? qb : qa);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t* y =
              reinterpret_cast<uint32_t*>(smem + dense_at(r, 12 + j) + 4 * tq);
          const float2 f = unpack2(*y);
          *y = pack2(f.x * (sc[j][2 * hr] + 1.f) + sh[j][2 * hr],
                     f.y * (sc[j][2 * hr + 1] + 1.f) + sh[j][2 * hr + 1]);
        }
      }
    }
  }
  block_sync();

  // ---- conv5 (64 out channels) on the core rows, staged in xc0's space ----
  conv<4>(smem, p.w.bias, inframe, ring);

  // ---- residual (+ RRDB tail) and store: one warp per core row ------------
  if (p.tail) {
    stage_sft(smem, p.w, 8);
    block_sync();
  }
  const float* stage = reinterpret_cast<const float*>(smem);
  for (int i = warp; i < TH; i += kWarps) {
    const int gy = ty0 + i;
    int gx[2];
    bool ok[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      gx[hr] = tx0 + g + 8 * hr;
      ok[hr] = gy < H && gx[hr] < W;
    }
    // x and the residual first, so their loads overlap the tail's SFT
    uint32_t xv[2][8], rv[2][8];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const size_t px =
          ok[hr] ? ((size_t)gy * W + gx[hr]) * (kF / 2) + tq : 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        xv[hr][j] = ok[hr] ? __ldg(x2 + px + 4 * j) : 0u;
        rv[hr][j] = ok[hr] && p.tail ? __ldg(xin2 + px + 4 * j) : 0u;
      }
    }
    float sc[8][4], sh[8][4];
    if (p.tail) {
      uint32_t ac[2][4];
      cond_frag(p.cond, ok[0], (size_t)gy * W + gx[0], ok[1],
                (size_t)gy * W + gx[1], ac);
      sft_s<8>(ac, smem, sc, sh);
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      if (!ok[hr]) continue;
      const int q = (HALO + i) * WW + HALO + g + 8 * hr;
      const float* row = stage + (size_t)(q - Q5_LO) * kStage;
      const size_t px = ((size_t)gy * W + gx[hr]) * (kF / 2) + tq;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = 8 * j + 2 * tq;
        const float2 x = unpack2(xv[hr][j]);
        float o0 = (row[n] + __ldg(p.w.bias + 4 * 64 + n)) * 0.2f + x.x;
        float o1 = (row[n + 1] + __ldg(p.w.bias + 4 * 64 + n + 1)) * 0.2f +
                   x.y;
        if (p.tail) {
          const float2 r = unpack2(rv[hr][j]);
          o0 = bfr((o0 * (sc[j][2 * hr] + 1.f) + sh[j][2 * hr]) * 0.2f) + r.x;
          o1 = bfr((o1 * (sc[j][2 * hr + 1] + 1.f) + sh[j][2 * hr + 1]) *
                   0.2f) +
               r.y;
        }
        reinterpret_cast<uint32_t*>(p.out)[px + 4 * j] = pack2(o0, o1);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1) rdb_kernel(const RdbArgs p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  unsigned char* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(smem);
  const int tiles_x = (p.W + TW - 1) / TW;
  const int tiles = tiles_x * ((p.H + TH - 1) / TH);
  const int mine = (tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;
  int* cnt = reinterpret_cast<int*>(smem + kCntOff);
  Ring ring{base + (uint32_t)kRingOff, base + (uint32_t)kBarOff, cnt,
            reinterpret_cast<const unsigned char*>(p.w.wconv),
            mine * kPieces, 0, 0, 0};
  if (threadIdx.x < kStages) cnt[threadIdx.x] = 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(ring.full + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int s = 0; s < kStages && s < ring.total; ++s) ring.load(s, s);
  }
  // zeros once: the margins and the rows a tile does not write stay finite
  for (int i = threadIdx.x; i < (int)(kWin / 16); i += kThreads)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  for (int t = blockIdx.x; t < tiles; t += gridDim.x)
    tile(smem, p, (t / tiles_x) * TH, (t % tiles_x) * TW, ring);
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
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(rdb_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kSmemWS);
  if (e != cudaSuccess) return (int)e;
  const int tiles = ((W + TW - 1) / TW) * ((H + TH - 1) / TH);
  rdb_kernel<<<tiles < sms ? tiles : sms, kThreads, kSmemWS,
               static_cast<cudaStream_t>(stream)>>>(args);
  return (int)cudaGetLastError();
}

extern "C" const char* rdb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
