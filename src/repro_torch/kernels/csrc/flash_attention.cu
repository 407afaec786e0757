// Blocked (flash) GQA attention, forward, as CUDA kernels for sm_90a.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention.py:
// flash_attention (body `_kernel`).  Same function: q (B,H,Sq,D) and k, v
// (B,Hkv,Sk,D), f32 or bf16; queries aligned to the END of the keys
// (q_offset = Sk - Sq); causal and sliding-window masks; fp32 running max,
// denominator and accumulator across KV tiles; masked scores out of the
// softmax (-1e38 as in the TPU kernel, -inf in the bf16 kernel: the same
// output) and the output divided by max(l, 1e-30), as the TPU kernel does;
// KV head h / (H/Hkv), never repeated.  The TPU grid walks the KV blocks of one Q
// tile as its sequential last dimension with the running state in VMEM
// scratch; here one block owns one (b, h, query tile) and loops over the KV
// tiles itself, the running state in registers.  The loop covers only the
// tiles the causal and window predicates can reach (the TPU kernel's
// `pl.when` skip, made into loop bounds).  Any Sq and Sk: q rows past Sq are
// computed on zeros and not stored, keys past Sk are masked.  D is a
// template parameter (16, 32, 64, 128, 256).
//
// bf16: `flash_fwd_kernel_wgmma`, on Hopper's warpgroup tensor cores fed by
// TMA (FlashAttention-3's shape, hopper.cuh's primitives).  A block of 384
// threads: warpgroup 0 produces, warpgroups 1 and 2 consume, each owning 64
// of the block's 128 query rows.  One producer thread loads the Q tile once
// and then the K and V tiles (BK keys) into a ring of STAGES stages, each
// tile a TMA copy of the 3-D tensor map (D, S, B*heads) swizzled over 128
// bytes (a D 16 or 32 row holds 32 or 64 bytes and takes that swizzle);
// rows past Sq or Sk land as zeros, never the next head's.  Full barriers
// (K and V apart, so Q K^T starts while V lands) carry the copies' bytes,
// empty barriers the consumers' release.  setmaxnreg gives the producer 32
// registers a thread and the consumers 232.  Per KV tile a consumer
// warpgroup computes S = Q K^T with wgmma, both operands K-major in shared
// memory; the online softmax runs on the fp32 accumulator fragments (a row's
// max and sum over the four lanes of a quad); P is split in registers into
// two bf16 A-fragments (hi and lo, below) and O += P V is two register-A
// wgmmas against the same V tile, read MN-major (transposed) by its
// descriptor: no round trip of P through shared memory.  Within a
// warpgroup P V of tile it - 1 runs under the softmax of tile it; the two
// warpgroups share each K/V tile and take turns to issue their products
// (ping-pong, named barriers; not at D 256, where it was slower), so one's
// softmax runs under the other's products.  Masks are applied only on
// tiles that straddle the diagonal, the window's edge or Sk, and a
// warpgroup skips the products of a tile none of its rows can see.  The
// grid is (H, q tiles x splits, B) with the q tiles in reverse, so the
// longest causal tiles start first.
//
// Tiles (kernels/flash_attention.py:launch_plan reads the same): 128 query
// rows; 128 keys a KV tile up to D 128, 64 at D 256; 4 stages up to D 64,
// 3 at D 128, 2 at D 256.  A consumer thread holds O (D / 2 fp32), S (BK /
// 2 fp32) and P's halves (BK / 2 registers): 128 + 32 + 32 at D 256, under
// the 232 registers.  Shared memory, Q + 2 x STAGES x BK x D x 2 bytes: at
// D 128 32 KB + 192 KB, at D 256 64 KB + 128 KB; one block an SM.
// tools/flash_variants.py times the tiles and the ping-pong against their
// alternatives on the card.
//
// Split over the keys.  When two splits of the (B, H, q tile) grid fit in
// one wave of 132 blocks and the keys span two tiles or more (a rank's
// Whisper cross attention at Sq 1 or 32 against 1500 frames: 64 blocks),
// the wrapper asks for n_split > 1 (launch_plan's):
// split s takes KV tiles [s per, (s + 1) per), per = ceil(tiles / n_split),
// and writes its unnormalised fp32 O, its m and l to the wrapper's scratch.
// The last block of a (b, h, q tile) to finish, by an atomic ticket (the
// writes fenced before it, the reads from L2 after), merges them in the
// same launch: M = max m_s, O = sum 2^(m_s - M) O_s / max(sum 2^(m_s - M)
// l_s, 1e-30).  A split that saw only masked keys for a row (m_s = -1e38)
// weighs 0 there, as the TPU kernel's `corr` makes such keys count.  The
// tickets are zeroed on the stream before each launch: a CUDA graph's
// replays and two streams never share them.
//
// Numerics of the bf16 kernel.  The reference scales q by 1/sqrt(D) in fp32
// before the product; scaling the bf16 q would add a rounding, so the kernel
// multiplies the fp32 scores instead: with x = s * (log2(e) / sqrt(D)) it
// takes p = 2^(x - m), which is exp(s/sqrt(D) - m') in another base.  The
// reference computes P V in fp32 (its Pallas kernel casts v to fp32 for the
// product, its model path's streaming attention likewise), so P is not
// rounded to bf16 as the operand: each fp32 p is split into hi = bf16(p) and
// lo = bf16(p - hi), and hi V + lo V go into the same fp32 accumulator.  V is
// bf16, exact in fp32, so the two products carry about 16 bits of P where
// one bf16 P carries 8 (and TF32 would carry 11); P V then costs two wgmmas
// where it cost one, the kernel's products about 1.5x.  l sums the fp32 P.
//
// f32: `flash_fwd_kernel`, fp32 FMAs from shared memory (one block of 256
// threads, four lanes sharing a query row, K/V tiles staged as fp32; 32-key
// tiles from D 128 up, so D 256 takes 34,976 floats, 139,904 B).  This
// is a dispatch by type, not a fallback: the serving path is bf16, and
// TF32 tensor cores would miss the f32 tolerance (2e-5).
//
// Bound on an H100: operations for long sequences, bytes for few queries.
// At B1 H32 D128 S2048 causal the products are ~3.4e10 FLOP (35 us at the
// 989 TFLOP/s bf16 tensor-core peak; the hi/lo P makes the kernel's own
// 1.5x that) against ~42 MB moved (12.5 us at 3.35 TB/s); Whisper's cross
// attention at Sq 1 reads 49 MB of K and V (14.7 us) for 0.1 GFLOP.
//
// The row statistic for the backward.  Given a non-null lse (B,H,Sq) fp32,
// which the wrapper passes only where autograd will take the gradient (a
// serving call passes null and writes nothing), each kernel writes every
// row's log-sum-exp of its scaled scores in the NATURAL base, the base
// csrc/flash_attention_bwd.cu reads: the bf16 kernel, which works in base
// 2 with log2(e) / sqrt(D) folded into its scores, writes ln 2 (m + log2
// l) from its base-2 running max and sum (the split merge ln 2 (M + log2
// L)); the f32 kernel, whose scale is in its staged q, m + ln l.  A row
// that sees no key gets +inf (exp(s - lse) = 0 on any key).
//
// Rows that see no key (causal with Sq > Sk: the first Sq - Sk rows).  The
// reference's softmax over such a row's all-NEG_INF scores is uniform, so
// its output is the mean of v over the Sk keys of its KV head.  Every path
// writes that mean there (`v_mean`, summed in fp32 from v in device memory
// by the epilogue of a block that holds such rows: the unsplit epilogue,
// the split merge and the f32 kernel's); no model path makes such a call,
// and a block without such rows takes one uniform branch more.
//
// The launchers take PyTorch's current stream, allocate nothing (the
// wrapper passes the split's scratch) and return cudaGetLastError() right
// after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1.0e38f;     // the TPU kernel's NEG_INF

// ---------------------------------------------------------------------------
// bf16 on wgmma
// ---------------------------------------------------------------------------
constexpr int kWgThreads = 384;         // producer + 2 consumer warpgroups
constexpr int kWgBQ = 128;              // query rows per block, 64 a consumer
constexpr int kProducerRegs = 32;
constexpr int kConsumerRegs = 232;      // 32 x 128 + 232 x 256 <= 168 x 384

template <int D> struct WgTile {
  static constexpr int BK = D > 128 ? 64 : 128;          // keys per KV tile
  static constexpr int STAGES = D > 128 ? 2 : D == 128 ? 3 : 4;
  static constexpr int SW = D * 2 < 128 ? D * 2 : 128;   // swizzle bytes
  static constexpr int CE = SW / 2;     // bf16 columns of a slab
  static constexpr int NCH = D / CE;    // slabs across D
  static constexpr int Q_BYTES = kWgBQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;
  static constexpr int BAR_BYTES = 256;
  // 1024 bytes of slack to align the tiles on the swizzle's atoms
  static constexpr int smem_bytes =
      1024 + Q_BYTES + 2 * STAGES * KV_BYTES + BAR_BYTES;
};

// (a, b) -> their bf16 pair hi and the bf16 pair of what hi leaves out,
// lo = bf16(x - float(hi)): hi + lo carries about 16 bits of each value
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// a row's log-sum-exp in the natural base, as the backward reads it, from
// the base-2 running max m (of x = s log2(e) / sqrt(D)) and sum l = sum
// 2^(x - m): ln 2 (m + log2 l); +inf for a row that saw no key (l = 0)
__device__ __forceinline__ float lse_of(float m, float l) {
  return l > 0.0f ? (m + log2f(l)) * 0.6931471805599453f
                  : __int_as_float(0x7f800000);
}

// the mean over the Sk keys of kv head bhk of v's columns c .. c + N - 1,
// fp32 (the output of a row that sees no key)
template <int N, typename T>
__device__ __forceinline__ void v_mean(const T* __restrict__ v, size_t bhk,
                                       int Sk, int D, int c, int stride,
                                       float (&out)[N]) {
  const T* p = v + bhk * Sk * D + c;
#pragma unroll
  for (int e = 0; e < N; ++e) out[e] = 0.0f;
  for (int j = 0; j < Sk; ++j)
#pragma unroll
    for (int e = 0; e < N; ++e)
      out[e] += static_cast<float>(p[static_cast<size_t>(j) * D + e * stride]);
#pragma unroll
  for (int e = 0; e < N; ++e) out[e] /= static_cast<float>(Sk);
}

// One block's work, as the producer and the consumers see it.
struct Job {
  int H, Sq, Sk, causal, window, n_split;
  int n0;                               // rows that see no key: [0, n0)
  int bh, bhk, q0, qt, n_qt, split, q_offset;
  int n_wg;                             // consumer warpgroups with rows
  int t_begin, n_tiles;                 // this split's reachable KV tiles
  float scale_log2;
};

// the producer thread: Q once, then K and V of each tile into the ring
template <int D>
__device__ __forceinline__ void produce(const Job& j, const CUtensorMap* tq,
                                        const CUtensorMap* tk,
                                        const CUtensorMap* tv, uint32_t sQ,
                                        uint32_t sK, uint32_t sV,
                                        uint64_t* qbar, uint64_t* fullK,
                                        uint64_t* fullV, uint64_t* empty) {
  using T = WgTile<D>;
  constexpr int BK = T::BK, ST = T::STAGES, SW = T::SW, CE = T::CE;
  hopper::tma_prefetch(tk);
  hopper::tma_prefetch(tv);
  hopper::mbar_expect_tx(qbar, T::Q_BYTES);
#pragma unroll
  for (int c = 0; c < T::NCH; ++c)
    hopper::tma_load_3d(sQ + c * kWgBQ * SW, tq, c * CE, j.q0, j.bh, qbar);
  for (int it = 0; it < j.n_tiles; ++it) {
    const int s = it % ST;
    if (it >= ST) hopper::mbar_wait(empty + s, ((it / ST) - 1) & 1);
    const int k0 = (j.t_begin + it) * BK;
    hopper::mbar_expect_tx(fullK + s, T::KV_BYTES);
#pragma unroll
    for (int c = 0; c < T::NCH; ++c)
      hopper::tma_load_3d(sK + s * T::KV_BYTES + c * BK * SW, tk, c * CE, k0,
                          j.bhk, fullK + s);
    hopper::mbar_expect_tx(fullV + s, T::KV_BYTES);
#pragma unroll
    for (int c = 0; c < T::NCH; ++c)
      hopper::tma_load_3d(sV + s * T::KV_BYTES + c * BK * SW, tv, c * CE, k0,
                          j.bhk, fullV + s);
  }
}

// S = Q K^T for the warpgroup's 64 rows and tile `it`, issued (not waited);
// the first k-step overwrites sc (scale-d 0), which is neither cleared nor
// fenced first: a register written while another wgmma runs (even by an
// empty asm) makes ptxas serialize the two
template <int D>
__device__ __forceinline__ void issue_s(float (&sc)[WgTile<D>::BK / 2],
                                        uint32_t qrows, uint32_t kst) {
  using T = WgTile<D>;
  constexpr int BK = T::BK, SW = T::SW;
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 32 / SW, off = kk * 32 % SW;
    const uint64_t da =
        hopper::smem_desc(qrows + c * kWgBQ * SW + off, 16, 8 * SW, SW);
    const uint64_t db =
        hopper::smem_desc(kst + c * BK * SW + off, 16, 8 * SW, SW);
    hopper::Wgmma<BK>::template ss<0, 0>(sc, da, db, kk > 0);
  }
  hopper::wgmma_commit();
}

// O += hi V + lo V for one tile, V MN-major, issued (not waited)
template <int D>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2],
                                         uint32_t (&ph)[WgTile<D>::BK / 16][4],
                                         uint32_t (&pl)[WgTile<D>::BK / 16][4],
                                         uint32_t vst) {
  using T = WgTile<D>;
  constexpr int BK = T::BK, SW = T::SW;
  hopper::fence_operands(acc);
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    hopper::fence_operands(ph[kk]);
    hopper::fence_operands(pl[kk]);
  }
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t dv =
        hopper::smem_desc(vst + kk * 16 * SW, BK * SW, 8 * SW, SW);
    hopper::Wgmma<D>::template rs<1>(acc, ph[kk], dv, 1);
    hopper::Wgmma<D>::template rs<1>(acc, pl[kk], dv, 1);
  }
  hopper::wgmma_commit();
}

// mask tile k0's scores in place (only on a tile that straddles an edge),
// then the online softmax on x = s log2(e) / sqrt(D): the new row max (of
// the raw scores, scaled once), corr (the old sums' factor), p = 2^(x - m)
// in place, one fma and one ex2 a score, l = l corr + sum p.  A masked
// score is -inf: its p is 0, and a row that has seen no key keeps m =
// -1e38, l = 0 and O = 0 (the TPU kernel's -1e38 scores give such a row p
// = 1 until the first visible key's corr zeroes it: the same output).
template <int BK>
__device__ __forceinline__ void softmax(float (&sc)[BK / 2], float (&m)[2],
                                        float (&l)[2], float (&corr)[2],
                                        const Job& j, int k0, int wq_first,
                                        int wq_last, int qpos0, int t) {
  const bool edge = k0 + BK > j.Sk ||
                    (j.causal && k0 + BK - 1 > wq_first) ||
                    (j.window > 0 && k0 <= wq_last - j.window);
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    float x = sc[i];
    if (edge) {
      const int kpos = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
      const int qpos = qpos0 + ((i >> 1) & 1) * 8;
      const bool ok = kpos < j.Sk && (!j.causal || kpos <= qpos) &&
                      (j.window <= 0 || kpos > qpos - j.window);
      x = ok ? x : __int_as_float(0xff800000);   // -inf
    }
    sc[i] = x;
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r] * j.scale_log2);
    corr[r] = exp2_approx(m[r] - m_new);
    m[r] = m_new;
  }
  float ps[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    sc[i] = exp2_approx(fmaf(sc[i], j.scale_log2, -m[(i >> 1) & 1]));
    ps[(i >> 1) & 1] += sc[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + ps[r];
}

// P split into two bf16 A-fragments straight from the fp32 p: keys 16 kk ..
// 16 kk + 15 are the accumulators' n8 blocks 2 kk and 2 kk + 1
template <int BK>
__device__ __forceinline__ void split_p(const float (&sc)[BK / 2],
                                        uint32_t (&ph)[BK / 16][4],
                                        uint32_t (&pl)[BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      split_bf16(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1], ph[kk][e],
                 pl[kk][e]);
}

// the last block of a (b, h, q tile) merges the splits' O, m and l: a
// thread a row takes M and 1/L in one pass (into shared memory), then a
// thread a 16-column chunk of a row sums the splits' O
template <int D>
__device__ __forceinline__ void merge_splits(const Job& j,
                                             __nv_bfloat16* __restrict__ o,
                                             const __nv_bfloat16* __restrict__ vg,
                                             float* __restrict__ lse,
                                             const float* part,
                                             const float* pm,
                                             const float* pl_, float* stat,
                                             int ct, int threads) {
  const int rows = min(j.q0 + kWgBQ, j.Sq) - j.q0;
  const size_t split0 = static_cast<size_t>(j.bh) * j.n_split * j.Sq + j.q0;
  for (int r = ct; r < rows; r += threads) {
    float M = kNegInf, L = 0.0f;
#pragma unroll 4
    for (int sp = 0; sp < j.n_split; ++sp) {
      const size_t i = split0 + static_cast<size_t>(sp) * j.Sq + r;
      const float ms = __ldcg(pm + i), ls = __ldcg(pl_ + i);
      const float mn = fmaxf(M, ms);
      L = L * exp2_approx(M - mn) + ls * exp2_approx(ms - mn);
      M = mn;
    }
    stat[r] = M;
    stat[kWgBQ + r] = 1.0f / fmaxf(L, 1e-30f);
    if (lse != nullptr)
      lse[static_cast<size_t>(j.bh) * j.Sq + j.q0 + r] = lse_of(M, L);
  }
  hopper::bar_sync(1, threads);
  for (int item = ct; item < rows * (D / 16); item += threads) {
    const int r = item / (D / 16), c = item % (D / 16);
    const float M = stat[r], inv = stat[kWgBQ + r];
    float a[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) a[e] = 0.0f;
    if (j.q0 + r < j.n0) {
      v_mean<16>(vg, j.bhk, j.Sk, D, 16 * c, 1, a);
    } else {
#pragma unroll 4
      for (int sp = 0; sp < j.n_split; ++sp) {
        const size_t i = split0 + static_cast<size_t>(sp) * j.Sq + r;
        const float w = exp2_approx(__ldcg(pm + i) - M);
        const float4* src = reinterpret_cast<const float4*>(part + i * D) + 4 * c;
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const float4 x = __ldcg(src + v);
          a[4 * v] += w * x.x;
          a[4 * v + 1] += w * x.y;
          a[4 * v + 2] += w * x.z;
          a[4 * v + 3] += w * x.w;
        }
      }
#pragma unroll
      for (int e = 0; e < 16; ++e) a[e] *= inv;
    }
    uint32_t packed[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const __nv_bfloat162 h2 = __floats2bfloat162_rn(a[2 * e], a[2 * e + 1]);
      packed[e] = *reinterpret_cast<const uint32_t*>(&h2);
    }
    uint4* dst = reinterpret_cast<uint4*>(
        o + (static_cast<size_t>(j.bh) * j.Sq + j.q0 + r) * D + 16 * c);
    dst[0] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
    dst[1] = make_uint4(packed[4], packed[5], packed[6], packed[7]);
  }
}

// a consumer warpgroup (wg 0 or 1): rows [q0 + 64 wg, q0 + 64 wg + 64).
// Per tile it the products of tile it - 1's P V run while the softmax of
// tile it runs: S(it) and P V(it - 1) are issued together, the wait for
// S(it) leaves P V(it - 1) in flight, and O is rescaled once it lands.
template <int D>
__device__ __forceinline__ void consume(const Job& j, int wg, int tid,
                                        uint32_t sQ, uint32_t sK, uint32_t sV,
                                        uint64_t* qbar, uint64_t* fullK,
                                        uint64_t* fullV, uint64_t* empty,
                                        int* last, float* stat,
                                        __nv_bfloat16* __restrict__ o,
                                        const __nv_bfloat16* __restrict__ vg,
                                        float* __restrict__ lse,
                                        float* __restrict__ part,
                                        int* __restrict__ tickets) {
  using T = WgTile<D>;
  constexpr int BK = T::BK, ST = T::STAGES, SW = T::SW;
  constexpr bool kPingPong = D <= 128;
  const int lt = tid % 128;
  const int warp = lt / 32, lane = lt % 32;
  const int g = lane >> 2, t = lane & 3;
  const int r_wg = j.q0 + 64 * wg;
  const int wq_first = r_wg + j.q_offset;
  const int wq_last = min(r_wg + 64, j.Sq) - 1 + j.q_offset;
  const int row0 = r_wg + 16 * warp + g;          // this lane's rows: +0, +8
  const int qpos0 = row0 + j.q_offset;
  const uint32_t qrows = sQ + 64 * wg * SW;

  // the tiles some row of this warpgroup sees: [w_lo, w_hi) of n_tiles
  int w_lo = 0, w_hi = j.n_tiles;
  if (j.causal) w_hi = min(w_hi, max(0, wq_last / BK - j.t_begin + 1));
  if (j.window > 0) {
    const int x = wq_first - j.window + 1;        // the first key row 0 sees
    if (x > 0) w_lo = min(j.n_tiles, max(0, x / BK - j.t_begin));
  }
  w_hi = max(w_hi, w_lo);

  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};            // this lane's part of the row sums
  float corr[2];
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
  float sc[BK / 2];
  uint32_t ph[BK / 16][4], pl[BK / 16][4];

  auto release = [&](int it) {
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(empty + it % ST);
  };
  // ping-pong: with two warpgroups at work they take turns to issue a
  // tile's products (named barriers 3 and 4), warpgroup 0 first, so one's
  // softmax runs under the other's products; a tile a warpgroup passes
  // takes its turn all the same, so both take n_tiles turns
  const bool pp = kPingPong && j.n_wg == 2;
  auto turn = [&]() {
    if (pp) hopper::bar_sync(3 + wg, 256);
  };
  auto hand_over = [&](int it) {
    if (pp && !(wg == 1 && it == j.n_tiles - 1))
      hopper::bar_arrive(4 - wg, 256);
  };
  if (pp && wg == 1 && j.n_tiles > 0) hopper::bar_arrive(3, 256);
  auto pass = [&](int it) {             // a tile no row here sees
    hopper::mbar_wait(fullK + it % ST, (it / ST) & 1);
    hopper::mbar_wait(fullV + it % ST, (it / ST) & 1);
    release(it);
    turn();
    hand_over(it);
  };
  auto take = [&](int it) {             // tile it's K has landed
    hopper::mbar_wait(fullK + it % ST, (it / ST) & 1);
  };
  auto k_tile = [&](int it) { return sK + (it % ST) * T::KV_BYTES; };
  auto pv = [&](int it) {               // O += P V(it), issued
    hopper::mbar_wait(fullV + it % ST, (it / ST) & 1);
    issue_pv<D>(acc, ph, pl, sV + (it % ST) * T::KV_BYTES);
  };
  auto pv_landed = [&](int it) {        // after the wait that covers it
    hopper::fence_operands(acc);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      hopper::fence_operands(ph[kk]);
      hopper::fence_operands(pl[kk]);
    }
    release(it);
  };
  auto scores = [&](int it) {
    softmax<BK>(sc, m, l, corr, j, (j.t_begin + it) * BK, wq_first, wq_last,
                qpos0, t);
  };

  hopper::mbar_wait(qbar, 0);
  for (int it = 0; it < w_lo; ++it) pass(it);
  if (w_lo < w_hi) {
    take(w_lo);
    turn();
    issue_s<D>(sc, qrows, k_tile(w_lo));
    hand_over(w_lo);
    hopper::wgmma_wait<0>();
    hopper::fence_operands(sc);
    scores(w_lo);
    split_p<BK>(sc, ph, pl);
    for (int it = w_lo + 1; it < w_hi; ++it) {
      take(it);
      turn();
      issue_s<D>(sc, qrows, k_tile(it));
      pv(it - 1);
      hand_over(it);
      hopper::wgmma_wait<1>();          // S(it) landed, P V(it - 1) runs
      hopper::fence_operands(sc);
      scores(it);
      hopper::wgmma_wait<0>();
      pv_landed(it - 1);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
      split_p<BK>(sc, ph, pl);
    }
    pv(w_hi - 1);
    hopper::wgmma_wait<0>();
    pv_landed(w_hi - 1);
  }
  for (int it = w_hi; it < j.n_tiles; ++it) pass(it);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if (j.n_split == 1) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = row0 + 8 * r;
      if (qi >= j.Sq) continue;
      const float inv = 1.0f / fmaxf(l[r], 1e-30f);
      if (lse != nullptr && t == 0)
        lse[static_cast<size_t>(j.bh) * j.Sq + qi] = lse_of(m[r], l[r]);
      __nv_bfloat16* orow = o + (static_cast<size_t>(j.bh) * j.Sq + qi) * D;
      if (qi < j.n0) {
        for (int c = 0; c < D / 8; ++c) {
          float mean[2];
          v_mean<2>(vg, j.bhk, j.Sk, D, 8 * c + 2 * t, 1, mean);
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * c + 2 * t) =
              __floats2bfloat162_rn(mean[0], mean[1]);
        }
        continue;
      }
#pragma unroll
      for (int c = 0; c < D / 8; ++c)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * c + 2 * t) =
            __floats2bfloat162_rn(acc[4 * c + 2 * r] * inv,
                                  acc[4 * c + 2 * r + 1] * inv);
    }
    return;
  }

  // this split's unnormalised O, m and l, then the ticket
  const size_t rows_all =
      static_cast<size_t>(gridDim.z) * j.H * j.n_split * j.Sq;
  float* pm = part + rows_all * D;
  float* pl_ = pm + rows_all;
  const size_t rbase = static_cast<size_t>(j.bh * j.n_split + j.split) * j.Sq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + 8 * r;
    if (qi >= j.Sq) continue;
    float* prow = part + (rbase + qi) * D;
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      *reinterpret_cast<float2*>(prow + 8 * c + 2 * t) =
          make_float2(acc[4 * c + 2 * r], acc[4 * c + 2 * r + 1]);
    if (t == 0) {
      pm[rbase + qi] = m[r];
      pl_[rbase + qi] = l[r];
    }
  }
  const int threads = 128 * j.n_wg;
  __threadfence();
  hopper::bar_sync(1, threads);
  if (tid == 128)
    *last = atomicAdd(tickets + j.bh * j.n_qt + j.qt, 1) == j.n_split - 1;
  hopper::bar_sync(1, threads);
  if (!*last) return;
  __threadfence();
  merge_splits<D>(j, o, vg, lse, part, pm, pl_, stat, tid - 128, threads);
}

// part: n_split > 1 only; the splits' fp32 O (B*H, n_split, Sq, D), then m
// and l (B*H, n_split, Sq) each.  tickets: (B*H, q tiles), zeroed.  lse:
// (B*H, Sq) fp32 or null (lse_of).
template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_fwd_kernel_wgmma(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __nv_bfloat16* __restrict__ vg,
                       __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                       float* __restrict__ part,
                       int* __restrict__ tickets, int H, int Hkv, int Sq,
                       int Sk, int causal, int window, float scale_log2,
                       int n_split) {
  using T = WgTile<D>;
  constexpr int BK = T::BK, ST = T::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sQ = hopper::smem_u32(base);
  const uint32_t sK = sQ + T::Q_BYTES;            // stage s at + s KV_BYTES
  const uint32_t sV = sK + ST * T::KV_BYTES;
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(base + T::Q_BYTES + 2 * ST * T::KV_BYTES);
  uint64_t* qbar = bars;
  uint64_t* fullK = bars + 1;
  uint64_t* fullV = bars + 1 + ST;
  uint64_t* empty = bars + 1 + 2 * ST;
  int* last = reinterpret_cast<int*>(bars + 1 + 3 * ST);

  Job j;
  j.H = H, j.Sq = Sq, j.Sk = Sk, j.causal = causal, j.window = window;
  j.n_split = n_split, j.scale_log2 = scale_log2;
  j.n0 = causal ? max(0, Sq - Sk) : 0;
  const int h = blockIdx.x, b = blockIdx.z;
  j.n_qt = (Sq + kWgBQ - 1) / kWgBQ;
  j.qt = j.n_qt - 1 - static_cast<int>(blockIdx.y) / n_split;  // longest 1st
  j.split = static_cast<int>(blockIdx.y) % n_split;
  j.q0 = j.qt * kWgBQ;
  j.bh = b * H + h;
  j.bhk = b * Hkv + h / (H / Hkv);
  j.q_offset = Sk - Sq;
  j.n_wg = Sq - j.q0 > 64 ? 2 : 1;
  // the KV tiles some query of this tile can reach, within this split
  const int q_first = j.q0 + j.q_offset;
  const int q_last = min(j.q0 + kWgBQ, Sq) - 1 + j.q_offset;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  const int k_begin = window > 0 ? max(0, q_first - window + 1) : 0;
  const int per = ((Sk + BK - 1) / BK + n_split - 1) / n_split;
  j.t_begin = max(k_begin / BK, j.split * per);
  j.n_tiles =
      max(0, min((k_end + BK - 1) / BK, (j.split + 1) * per) - j.t_begin);

  const int tid = threadIdx.x;
  if (tid == 0) {
    hopper::mbar_init(qbar, 1);
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      hopper::mbar_init(fullK + s, 1);
      hopper::mbar_init(fullV + s, 1);
      hopper::mbar_init(empty + s, 4 * j.n_wg);   // one arrival a warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  // the warpgroup's index, warp-uniform to the compiler (setmaxnreg's
  // regions must not reconverge)
  const int wgi = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (wgi == 0) {
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (tid == 0)
      produce<D>(j, &tq, &tk, &tv, sQ, sK, sV, qbar, fullK, fullV, empty);
  } else {
    hopper::setmaxnreg_inc<kConsumerRegs>();
    if (wgi - 1 < j.n_wg)
      consume<D>(j, wgi - 1, tid, sQ, sK, sV, qbar, fullK, fullV, empty,
                 last, reinterpret_cast<float*>(base), o, vg, lse, part,
                 tickets);
  }
}

// ---------------------------------------------------------------------------
// f32 on the FMA units
// ---------------------------------------------------------------------------
constexpr int kThreads = 256;
constexpr int kRowThreads = 4;          // lanes sharing one query row
constexpr int kBQ = kThreads / kRowThreads;   // 64 query rows per block

template <int D> struct Tile {
  static constexpr int BK = D >= 128 ? 32 : 64;   // keys per KV tile
  static constexpr int smem_floats =
      kBQ * (D + 1) + BK * (D + 1) + BK * D + kBQ * (BK + 1);
};

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int H,
                 int Hkv, int Sq, int Sk, int causal, int window,
                 float scale) {
  constexpr int BK = Tile<D>::BK;
  constexpr int KPT = BK / kRowThreads;   // keys scored per lane
  constexpr int DPT = D / kRowThreads;    // output dims per lane
  extern __shared__ float smem[];
  float* Qs = smem;                       // [kBQ][D + 1]  scaled queries
  float* Ks = Qs + kBQ * (D + 1);         // [BK][D + 1]
  float* Vs = Ks + BK * (D + 1);          // [BK][D]
  float* Ps = Vs + BK * D;                // [kBQ][BK + 1] probabilities

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.x * kBQ;
  const int q_offset = Sk - Sq;
  const int tid = threadIdx.x;
  const int row = tid / kRowThreads;
  const int sub = tid % kRowThreads;
  const size_t qbase = (static_cast<size_t>(b) * H + h) * Sq * D;
  const size_t kbase = (static_cast<size_t>(b) * Hkv + hk) * Sk * D;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const int qi = q0 + r;
    Qs[r * (D + 1) + c] =
        qi < Sq ? q[qbase + static_cast<size_t>(qi) * D + c] * scale : 0.0f;
  }

  // the KV tiles some query of this tile can reach
  const int q_first = q0 + q_offset;
  const int q_last = min(q0 + kBQ, Sq) - 1 + q_offset;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  int k_begin = window > 0 ? max(0, q_first - window + 1) : 0;
  k_begin = (k_begin / BK) * BK;

  const int qpos = q0 + row + q_offset;
  float m = kNegInf, l = 0.0f;
  float acc[DPT];
#pragma unroll
  for (int d = 0; d < DPT; ++d) acc[d] = 0.0f;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();   // the previous tile is consumed (and Q is staged)
    for (int i = tid; i < BK * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const int kj = k0 + r;
      float kk = 0.0f, vv = 0.0f;
      if (kj < Sk) {
        const size_t g = kbase + static_cast<size_t>(kj) * D + c;
        kk = k[g];
        vv = v[g];
      }
      Ks[r * (D + 1) + c] = kk;
      Vs[r * D + c] = vv;
    }
    __syncthreads();

    float s[KPT];
    float tmax = kNegInf;
#pragma unroll
    for (int jj = 0; jj < KPT; ++jj) {
      const int j = jj * kRowThreads + sub;
      const float* qr = Qs + row * (D + 1);
      const float* kr = Ks + j * (D + 1);
      float dot = 0.0f;
#pragma unroll 16
      for (int c = 0; c < D; ++c) dot = fmaf(qr[c], kr[c], dot);
      const int kpos = k0 + j;
      const bool ok = kpos < Sk && (!causal || kpos <= qpos) &&
                      (window <= 0 || kpos > qpos - window);
      s[jj] = ok ? dot : kNegInf;
      tmax = fmaxf(tmax, s[jj]);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m, tmax);
    const float corr = expf(m - m_new);
    float psum = 0.0f;
#pragma unroll
    for (int jj = 0; jj < KPT; ++jj) {
      const float p = expf(s[jj] - m_new);
      psum += p;
      Ps[row * (BK + 1) + jj * kRowThreads + sub] = p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * corr + psum;
    m = m_new;
    __syncwarp();      // the row's four lanes wrote its probabilities
#pragma unroll
    for (int d = 0; d < DPT; ++d) acc[d] *= corr;
    const float* pr = Ps + row * (BK + 1);
    for (int j = 0; j < BK; ++j) {
      const float p = pr[j];
      const float* vr = Vs + j * D + sub;
#pragma unroll
      for (int d = 0; d < DPT; ++d) acc[d] = fmaf(p, vr[d * kRowThreads], acc[d]);
    }
  }

  const int qi = q0 + row;
  if (qi < Sq) {
    const float denom = fmaxf(l, 1e-30f);
    float* orow = o + qbase + static_cast<size_t>(qi) * D;
    if (causal && qi < Sq - Sk)           // a row that sees no key
      v_mean<DPT>(v, static_cast<size_t>(b) * Hkv + hk, Sk, D, sub,
                  kRowThreads, acc);
    else
#pragma unroll
      for (int d = 0; d < DPT; ++d) acc[d] /= denom;
#pragma unroll
    for (int d = 0; d < DPT; ++d) orow[d * kRowThreads + sub] = acc[d];
    // the row's log-sum-exp, natural base (the scale is in Qs); +inf for a
    // row that saw no key (m never left -1e38).  Written after o: before
    // it, the D 32 instance spilled
    if (lse != nullptr && sub == 0)
      lse[qbase / D + qi] = m > kNegInf ? m + __logf(l)
                                        : __int_as_float(0x7f800000);
  }
}

// raise a kernel's dynamic shared-memory limit once per instance, at its
// first launch (never again, so a later launch may be captured into a CUDA
// graph)
template <typename K>
cudaError_t raise_smem(K kernel, size_t smem, bool* raised) {
  if (smem <= 48 * 1024 || *raised) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess) *raised = true;
  return err;
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 float* lse, int B,
                 int H, int Hkv, int Sq, int Sk, int causal, int window,
                 int n_split, float* part, int* tickets,
                 cudaStream_t stream) {
  using T = WgTile<D>;
  if (n_split < 1 || (n_split > 1 && (part == nullptr || tickets == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool raised = false;
  cudaError_t err = raise_smem(flash_fwd_kernel_wgmma<D>, T::smem_bytes,
                               &raised);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap tq, tk, tv;
  const CUtensorMapDataType bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  int e = hopper::encode_3d(&tq, bf16, 2, q, D, Sq,
                            static_cast<uint64_t>(B) * H, T::CE, kWgBQ,
                            T::SW);
  if (e == 0)
    e = hopper::encode_3d(&tk, bf16, 2, k, D, Sk,
                          static_cast<uint64_t>(B) * Hkv, T::CE, T::BK,
                          T::SW);
  if (e == 0)
    e = hopper::encode_3d(&tv, bf16, 2, v, D, Sk,
                          static_cast<uint64_t>(B) * Hkv, T::CE, T::BK,
                          T::SW);
  if (e != 0) return e;
  const dim3 grid(H, ((Sq + kWgBQ - 1) / kWgBQ) * n_split, B);
  const float scale_log2 =
      1.4426950408889634f / sqrtf(static_cast<float>(D));
  flash_fwd_kernel_wgmma<D><<<grid, kWgThreads, T::smem_bytes, stream>>>(
      tq, tk, tv, static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(o), lse, part, tickets, H, Hkv, Sq,
      Sk, causal, window, scale_log2, n_split);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               float* lse, int B,
               int H, int Hkv, int Sq, int Sk, int causal, int window,
               cudaStream_t stream) {
  const size_t smem = sizeof(float) * Tile<D>::smem_floats;
  static bool raised = false;
  cudaError_t err = raise_smem(flash_fwd_kernel<D>, smem, &raised);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, H, Hkv, Sq, Sk,
      causal, window, 1.0f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B,
           int H, int Hkv, int Sq, int Sk, int causal, int window, int dtype,
           int n_split, float* part, int* tickets, cudaStream_t s) {
  if (dtype == 0 && n_split == 1)
    return launch_f32<D>(q, k, v, o, lse, B, H, Hkv, Sq, Sk, causal, window,
                         s);
  if (dtype == 1)
    return launch_wgmma<D>(q, k, v, o, lse, B, H, Hkv, Sq, Sk, causal, window,
                           n_split, part, tickets, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int D> long long tiling(int which) {
  using T = WgTile<D>;
  switch (which) {
    case 0: return kWgBQ;
    case 1: return T::BK;
    case 2: return T::STAGES;
    case 3: return T::smem_bytes;
    default: return -1;
  }
}

int dispatch(const void* q, const void* k, const void* v, void* o,
             float* lse, int B,
             int H, int Hkv, int Sq, int Sk, int D, int causal, int window,
             int dtype, int n_split, float* part, int* tickets,
             cudaStream_t s) {
  switch (D) {
    case 16: return launch<16>(q, k, v, o, lse, B, H, Hkv, Sq, Sk, causal, window, dtype, n_split, part, tickets, s);
    case 32: return launch<32>(q, k, v, o, lse, B, H, Hkv, Sq, Sk, causal, window, dtype, n_split, part, tickets, s);
    case 64: return launch<64>(q, k, v, o, lse, B, H, Hkv, Sq, Sk, causal, window, dtype, n_split, part, tickets, s);
    case 128: return launch<128>(q, k, v, o, lse, B, H, Hkv, Sq, Sk, causal, window, dtype, n_split, part, tickets, s);
    case 256: return launch<256>(q, k, v, o, lse, B, H, Hkv, Sq, Sk, causal, window, dtype, n_split, part, tickets, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  q, k, v, o contiguous (bf16: 16-byte
// aligned); o is (B,H,Sq,D); lse (B,H,Sq) fp32, each row's log-sum-exp in
// the natural base (+inf for a row that sees no key), or null.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, float* lse, int B, int H, int Hkv, int Sq,
                           int Sk, int D, int causal, int window, int dtype,
                           void* stream) {
  return dispatch(q, k, v, o, lse, B, H, Hkv, Sq, Sk, D, causal, window, dtype, 1,
                  nullptr, nullptr, static_cast<cudaStream_t>(stream));
}

// bf16 only, the keys split n_split ways (launch_plan's): part holds
// B*H*n_split*Sq*(D + 2) floats, tickets B*H*ceil(Sq / 128) ints, zeroed
int flash_attention_split_launch(const void* q, const void* k,
                                 const void* v, void* o, float* lse, int B,
                                 int H,
                                 int Hkv, int Sq, int Sk, int D, int causal,
                                 int window, int n_split, float* part,
                                 int* tickets, void* stream) {
  return dispatch(q, k, v, o, lse, B, H, Hkv, Sq, Sk, D, causal, window, 1,
                  n_split, part, tickets, static_cast<cudaStream_t>(stream));
}

// the bf16 kernel's tiling at head dim D: which = 0 query rows a block, 1
// keys a KV tile, 2 stages, 3 dynamic shared memory in bytes; -1 otherwise
long long flash_attention_tiling(int D, int which) {
  switch (D) {
    case 16: return tiling<16>(which);
    case 32: return tiling<32>(which);
    case 64: return tiling<64>(which);
    case 128: return tiling<128>(which);
    case 256: return tiling<256>(which);
    default: return -1;
  }
}

}  // extern "C"
