// Blocked (flash) GQA attention, backward, bf16, on Hopper's warpgroup
// tensor cores (wgmma) fed by TMA, for sm_90a.
//
// The same function, numerics and decomposition as flash_attention_bwd.cu
// (its header: P from the forward's lse, delta = rowsum(P o dP) from the
// recomputed fp32 P and dP, P and dS fed to the products as bf16 hi and lo
// halves summing into fp32, each query head's dk and dv rounded to bf16
// before a GQA group sums them in fp32, the no-key rows' dO / Sk in dv),
// and the same two kernels on the caller's stream with no atomics: the dq
// kernel owns its rows, the dk/dv kernel its keys.  What differs is how the
// card does the work.  kernels/flash_attention.py:bwd_plan sends bf16 at D
// 16-128 here (Zamba2, Whisper, Mixtral); D 256 stays on the mma.sync
// kernels (below).
//
// Both kernels are the forward's shape (flash_attention.cu): 384 threads,
// warpgroup 0 produces (one warp: TMA copies into a ring of stages on full
// and empty mbarriers), warpgroups 1 and 2 consume, 64 rows each of the
// block's 128; setmaxnreg gives the producer 40 registers a thread and the
// consumers 232.  Tiles are TMA boxes swizzled over 128 bytes (a D 16 or
// 32 row: its 32 or 64), landing as W/2-column slabs (hopper.cuh).
//
//   dq kernel    a block per (b, h, 128 query rows), longest causal tiles
//                first.  Q and dO land once (dO through a 4-D tensor map of
//                its strides: the model's (B, Sq, H, D) cotangent
//                transposed, never copied); K and V tiles of 64 keys run
//                through the ring twice.  Sweep 1: S = Q K^T and dP = dO V^T
//                on wgmma (K and V K-major B operands), delta += rowsum(P o
//                dP) on the accumulators, written for the dk/dv kernel.
//                Sweep 2: S and dP again, dS = P (dP - delta) / sqrt(D) in
//                registers, dq += dS K as register-A wgmmas (hi, lo) with K
//                read MN-major from the same tile; tile it's S and dP are
//                issued with tile it - 1's dq product, whose wait then
//                covers tile it's elementwise work (the forward's order).
//                The two warpgroups take turns to issue their products
//                (ping-pong, named barriers).
//   dk/dv kernel a block per (b, kv head, 128 keys).  K and V land once;
//                the producer runs the group's heads' Q and dO tiles of
//                KV_BQ queries through the ring, and each tile's lse and
//                delta (per column here) beside them.  S^T = K Q^T and dP^T
//                = V dO^T on wgmma (Q and dO K-major B operands); the
//                accumulators are keys x queries, so P^T and dS^T stand in
//                the A-fragment layout as they are (hopper.cuh): dV += P^T
//                dO and dK += dS^T Q are register-A wgmmas (hi and lo, two
//                each) with dO and Q read MN-major through a transposed
//                descriptor from the same tiles, as the forward's P V reads
//                V: no round trip through shared memory.  Up to D 64 the
//                two warpgroups take turns to issue their products
//                (ping-pong, named barriers), so one's exponentials run
//                under the other's products.  At a head's end the no-key
//                rows' dO / Sk go into dv, and the head's dk and dv round
//                into the group's sums (fa_bwd::round_into).
//
// A warpgroup skips the products of a tile none of its rows (keys) can
// see, and masks only on tiles that straddle the diagonal, the window's
// edge, Sq or Sk.  The exponential is ex2.approx.ftz, as the forward's.
//
// Registers (32-bit, a thread): the dk/dv kernel holds dk and dv (D / 2
// each), S^T and dP^T (KV_BQ / 2 each) and the four halves (KV_BQ / 4
// each): 192 at D 64 (Q/dO tiles of 64 queries) and at D 128 (of 32: at
// 64 ptxas serialised the wgmmas for want of registers, C7512; at 128 it
// did so at D 64).  At D 256
// dk and dv alone would take 256: that head dim stays on
// flash_attention_bwd.cu (a dispatch by shape; tools/flash_bwd_probe.py
// compiles this design at D 256: the dk/dv kernel spills, PERF.md).  The
// dq kernel: dq (D / 2), S and dP (32 each, K/V tiles of 64 keys), the
// halves of dS (32): 128 at D 64, 160 at D 128; with tiles of 128 keys
// its pipelined sweep spilled at D 64.  tools/flash_bwd_variants.py times
// these choices against their alternatives.
//
// Bound: operations, as flash_attention_bwd.cu's header counts them.
//
// The launcher encodes the tensor maps (host work on every call), takes
// PyTorch's current stream, allocates nothing and returns
// cudaGetLastError() after the second launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "flash_attention_bwd.cuh"
#include "hopper.cuh"

namespace {

using namespace fa_bwd;

constexpr int kThreads = 384;           // producer + 2 consumer warpgroups
constexpr int kRows = 128;              // a block's rows (queries or keys)
// the producer warp's loads of lse and delta spilled at 24 and 32
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;      // 40 x 128 + 232 x 256 = 168 x 384

// 2^x, ftz (the forward's exp2_approx)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int D> struct Wt {
  static constexpr int SW = D * 2 < 128 ? D * 2 : 128;   // swizzle bytes
  static constexpr int CE = SW / 2;     // bf16 columns of a slab
  static constexpr int NCH = D / CE;    // slabs across D
  static constexpr int ROW_TILE = kRows * D * 2;   // Q, dO (dq); K, V (dk/dv)
  // dq kernel: K/V tiles of DQ_BK keys in DQ_ST stages
  static constexpr int DQ_BK = 64;
  static constexpr int DQ_ST = D > 64 ? 3 : 4;
  static constexpr int DQ_TILE = DQ_BK * D * 2;
  static constexpr int DQ_SMEM = 1024 + 2 * ROW_TILE + DQ_ST * 2 * DQ_TILE + 256;
  // dk/dv kernel: Q/dO tiles of KV_BQ queries in KV_ST stages, each with
  // its lse (base 2) and delta
  static constexpr int KV_BQ = D > 64 ? 32 : 64;
  // the dk/dv kernel's two warpgroups take turns to issue their products
  static constexpr bool KV_PP = D <= 64;
  static constexpr int KV_ST = D > 64 ? 3 : 4;
  static constexpr int KV_TILE = KV_BQ * D * 2;
  static constexpr int KV_SMEM = 1024 + 2 * ROW_TILE + KV_ST * 2 * KV_TILE +
                                 KV_ST * 2 * KV_BQ * 4 + D * 4 + 256;
};

__device__ __forceinline__ unsigned char* aligned_base(unsigned char* raw) {
  return raw + ((1024 - (hopper::smem_u32(raw) & 1023)) & 1023);
}

// acc (64 x N) = A B^T over D: A the warpgroup's 64 rows at `arows` of a
// 128-row tile, B the N rows of the tile at `brows`, both K-major
template <int D, int N>
__device__ __forceinline__ void issue_nt(float (&acc)[N / 2], uint32_t arows,
                                         uint32_t brows) {
  constexpr int SW = Wt<D>::SW;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 32 / SW, off = kk * 32 % SW;
    const uint64_t da =
        hopper::smem_desc(arows + c * kRows * SW + off, 16, 8 * SW, SW);
    const uint64_t db =
        hopper::smem_desc(brows + c * N * SW + off, 16, 8 * SW, SW);
    hopper::Wgmma<N>::template ss<0, 0>(acc, da, db, kk > 0);
  }
}

// acc (64 x D) += (hi + lo) (64 x N) B, B the N rows of the tile at
// `brows` read MN-major (transposed), issued and committed (not waited)
template <int D, int N>
__device__ __forceinline__ void issue_rn(float (&acc)[D / 2],
                                         uint32_t (&hi)[N / 16][4],
                                         uint32_t (&lo)[N / 16][4],
                                         uint32_t brows) {
  constexpr int SW = Wt<D>::SW;
  hopper::fence_operands(acc);
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    hopper::fence_operands(hi[kk]);
    hopper::fence_operands(lo[kk]);
  }
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    const uint64_t db =
        hopper::smem_desc(brows + kk * 16 * SW, N * SW, 8 * SW, SW);
    hopper::Wgmma<D>::template rs<1>(acc, hi[kk], db, 1);
    hopper::Wgmma<D>::template rs<1>(acc, lo[kk], db, 1);
  }
  hopper::wgmma_commit();
}

// after the wait that covers issue_rn: its registers may be touched again
template <int D, int N>
__device__ __forceinline__ void landed(float (&acc)[D / 2],
                                       uint32_t (&hi)[N / 16][4],
                                       uint32_t (&lo)[N / 16][4]) {
  hopper::fence_operands(acc);
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    hopper::fence_operands(hi[kk]);
    hopper::fence_operands(lo[kk]);
  }
}

// an accumulator of N columns as the A-fragments of its two bf16 halves:
// columns 16 kk .. 16 kk + 15 are its n8 blocks 2 kk and 2 kk + 1
template <int N>
__device__ __forceinline__ void split_frag(const float (&x)[N / 2],
                                           uint32_t (&hi)[N / 16][4],
                                           uint32_t (&lo)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      split_bf16(x[8 * kk + 2 * e], x[8 * kk + 2 * e + 1], hi[kk][e],
                 lo[kk][e]);
}

// ---------------------------------------------------------------------------
// dq kernel
// ---------------------------------------------------------------------------
struct DqJob {
  int b, h, bh, bhk, q0, n_wg, t_lo, n_t;
};

template <int D>
__device__ __forceinline__ void dq_produce(const DqJob& j,
                                           const CUtensorMap* tq,
                                           const CUtensorMap* tdo,
                                           const CUtensorMap* tk,
                                           const CUtensorMap* tv, uint32_t sQ,
                                           uint32_t sdO, uint32_t sK,
                                           uint64_t* qbar, uint64_t* full,
                                           uint64_t* empty) {
  using T = Wt<D>;
  constexpr int ST = T::DQ_ST, SW = T::SW, CE = T::CE, BK = T::DQ_BK;
  hopper::tma_prefetch(tk);
  hopper::tma_prefetch(tv);
  hopper::mbar_expect_tx(qbar, 2 * T::ROW_TILE);
#pragma unroll
  for (int c = 0; c < T::NCH; ++c) {
    hopper::tma_load_3d(sQ + c * kRows * SW, tq, c * CE, j.q0, j.bh, qbar);
    hopper::tma_load_4d(sdO + c * kRows * SW, tdo, c * CE, j.q0, j.h, j.b,
                        qbar);
  }
  for (int step = 0; step < 2 * j.n_t; ++step) {
    const int s = step % ST;
    if (step >= ST) hopper::mbar_wait(empty + s, ((step / ST) - 1) & 1);
    const int k0 = (j.t_lo + step % j.n_t) * BK;
    const uint32_t dst = sK + s * 2 * T::DQ_TILE;
    hopper::mbar_expect_tx(full + s, 2 * T::DQ_TILE);
#pragma unroll
    for (int c = 0; c < T::NCH; ++c) {
      hopper::tma_load_3d(dst + c * BK * SW, tk, c * CE, k0, j.bhk, full + s);
      hopper::tma_load_3d(dst + T::DQ_TILE + c * BK * SW, tv, c * CE, k0,
                          j.bhk, full + s);
    }
  }
}

// a consumer warpgroup (wg 0 or 1): rows [q0 + 64 wg, q0 + 64 wg + 64)
template <int D>
__device__ __forceinline__ void dq_consume(const Args& a, const DqJob& j,
                                           int wg, int tid, uint32_t sQ,
                                           uint32_t sdO, uint32_t sK,
                                           uint64_t* qbar, uint64_t* full,
                                           uint64_t* empty) {
  using T = Wt<D>;
  constexpr int ST = T::DQ_ST, SW = T::SW, BK = T::DQ_BK;
  const int lt = tid % 128;
  const int warp = lt / 32, lane = lt % 32;
  const int g = lane >> 2, t = lane & 3;
  const int off = a.Sk - a.Sq;
  const int r_wg = j.q0 + 64 * wg;
  const int wq_first = r_wg + off;
  const int wq_last = min(r_wg + 64, a.Sq) - 1 + off;
  const int row0 = r_wg + 16 * warp + g;          // this lane's rows: +0, +8
  const uint32_t qrows = sQ + 64 * wg * SW, dorows = sdO + 64 * wg * SW;

  // the tiles some row of this warpgroup sees: [w_lo, w_hi) of n_t
  int w_lo = 0, w_hi = j.n_t;
  if (a.causal)
    w_hi = wq_last < 0 ? 0 : min(w_hi, max(0, wq_last / BK - j.t_lo + 1));
  if (a.window > 0) {
    const int x = wq_first - a.window + 1;        // the first key row 0 sees
    if (x > 0) w_lo = min(j.n_t, max(0, x / BK - j.t_lo));
  }
  w_hi = max(w_hi, w_lo);

  float lse2[2], delta[2] = {0.0f, 0.0f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + 8 * r;
    lse2[r] = qi < a.Sq ? a.lse[static_cast<size_t>(j.bh) * a.Sq + qi] * kLog2e
                        : 0.0f;
  }
  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.0f;
  float sc[BK / 2], dp[BK / 2];
  uint32_t dh[BK / 16][4], dl[BK / 16][4];

  auto kst_of = [&](int step) { return sK + (step % ST) * 2 * T::DQ_TILE; };
  auto take = [&](int step) {
    hopper::mbar_wait(full + step % ST, (step / ST) & 1);
  };
  auto release = [&](int step) {
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(empty + step % ST);
  };
  // ping-pong: with two warpgroups at work they take turns to issue their
  // products (named barriers 3 and 4), warpgroup 0 first, so one's
  // elementwise work runs under the other's products; each takes 2 n_t + 1
  // turns (a tile one, the last dq product one)
  const bool pp = j.n_wg == 2;
  const int turns = 2 * j.n_t + 1;
  int turn_no = 0;
  auto turn = [&]() {
    if (pp) hopper::bar_sync(3 + wg, 256);
  };
  auto hand_over = [&]() {
    if (pp && !(wg == 1 && turn_no == turns - 1))
      hopper::bar_arrive(4 - wg, 256);
    ++turn_no;
  };
  if (pp && wg == 1) hopper::bar_arrive(3, 256);
  auto scores = [&](int step) {           // S and dP of `step`, issued
    hopper::wgmma_fence();
    issue_nt<D, BK>(sc, qrows, kst_of(step));
    issue_nt<D, BK>(dp, dorows, kst_of(step) + T::DQ_TILE);
    hopper::wgmma_commit();
  };
  // P of `step`'s tile on the landed scores; sweep 1 sums P o dP into
  // delta, sweep 2 leaves dS in sc
  auto probs = [&](int step, auto second) {
    constexpr bool kSecond = decltype(second)::value;
    const int k0 = (j.t_lo + step % j.n_t) * BK;
    const bool edge = k0 + BK > a.Sk ||
                      (a.causal && k0 + BK - 1 > wq_first) ||
                      (a.window > 0 && k0 <= wq_last - a.window);
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int r = (i >> 1) & 1;
      float p = ex2(fmaf(sc[i], a.scale_log2, -lse2[r]));
      if (edge &&
          !visible(a, row0 + 8 * r, k0 + 8 * (i >> 2) + 2 * t + (i & 1)))
        p = 0.0f;
      if (kSecond)
        sc[i] = p * (dp[i] - delta[r]) * a.scale;
      else
        delta[r] = fmaf(p, dp[i], delta[r]);
    }
  };
  auto landed_s = [&]() {
    hopper::fence_operands(sc);
    hopper::fence_operands(dp);
  };

  hopper::mbar_wait(qbar, 0);
  auto pass = [&](int step) {              // a tile no row here sees
    take(step);
    turn();
    hand_over();
    release(step);
  };
  // sweep 1: delta
  for (int step = 0; step < w_lo; ++step) pass(step);
  for (int step = w_lo; step < w_hi; ++step) {
    take(step);
    turn();
    scores(step);
    hand_over();
    hopper::wgmma_wait<0>();
    landed_s();
    probs(step, std::false_type());
    release(step);
  }
  for (int step = w_hi; step < j.n_t; ++step) pass(step);
#pragma unroll
  for (int r = 0; r < 2; ++r) {                   // the row's four lanes
    delta[r] += __shfl_xor_sync(0xffffffffu, delta[r], 1);
    delta[r] += __shfl_xor_sync(0xffffffffu, delta[r], 2);
  }
  // sweep 2: dq.  Steps of tiles no row here sees pass; over the others
  // tile it's S and dP are issued with tile it - 1's dq product, whose
  // wait then covers tile it's elementwise work
  const int s0 = j.n_t;
  auto dq_of = [&](int step) {            // dq += dS K of `step`, issued
    issue_rn<D, BK>(dq, dh, dl, kst_of(step));
  };
  for (int it = 0; it < w_lo; ++it) pass(s0 + it);
  if (w_lo < w_hi) {
    take(s0 + w_lo);
    turn();
    scores(s0 + w_lo);
    hand_over();
    hopper::wgmma_wait<0>();
    landed_s();
    probs(s0 + w_lo, std::true_type());
    split_frag<BK>(sc, dh, dl);
    for (int it = w_lo + 1; it < w_hi; ++it) {
      const int step = s0 + it;
      take(step);
      turn();
      scores(step);
      dq_of(step - 1);
      hand_over();
      hopper::wgmma_wait<1>();            // S and dP landed, dq(it - 1) runs
      landed_s();
      probs(step, std::true_type());
      hopper::wgmma_wait<0>();
      landed<D, BK>(dq, dh, dl);
      release(step - 1);
      split_frag<BK>(sc, dh, dl);
    }
    turn();
    dq_of(s0 + w_hi - 1);
    hand_over();
    hopper::wgmma_wait<0>();
    landed<D, BK>(dq, dh, dl);
    release(s0 + w_hi - 1);
  }
  for (int it = w_hi; it < j.n_t; ++it) pass(s0 + it);
  if (pp && turn_no < turns) {          // rows that see no key: the last
    turn();
    hand_over();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + 8 * r;
    if (qi >= a.Sq) continue;
    const size_t row = static_cast<size_t>(j.bh) * a.Sq + qi;
    if (t == 0) a.delta[row] = delta[r];
    bf16* out = static_cast<bf16*>(a.dq) + row * D;
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * c + 2 * t) =
          __floats2bfloat162_rn(dq[4 * c + 2 * r], dq[4 * c + 2 * r + 1]);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
fa_bwd_wg_dq(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tdo,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv, const Args a) {
  using T = Wt<D>;
  constexpr int ST = T::DQ_ST, BK = T::DQ_BK;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = aligned_base(smem_raw);
  const uint32_t sQ = hopper::smem_u32(base);
  const uint32_t sdO = sQ + T::ROW_TILE;
  const uint32_t sK = sdO + T::ROW_TILE;          // stage s at + 2 s DQ_TILE
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + 2 * T::ROW_TILE +
                                               ST * 2 * T::DQ_TILE);
  uint64_t* qbar = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + ST;

  DqJob j;
  const int n_qt = (a.Sq + kRows - 1) / kRows;
  j.h = blockIdx.y, j.b = blockIdx.z;
  j.q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * kRows;  // longest 1st
  j.bh = j.b * a.H + j.h;
  j.bhk = j.b * a.Hkv + j.h / (a.H / a.Hkv);
  j.n_wg = a.Sq - j.q0 > 64 ? 2 : 1;
  int k_begin, k_end;
  key_range(a, j.q0, min(j.q0 + kRows, a.Sq), k_begin, k_end);
  j.t_lo = k_begin / BK;
  j.n_t = k_end > k_begin ? (k_end + BK - 1) / BK - j.t_lo : 0;

  const int tid = threadIdx.x;
  if (tid == 0) {
    hopper::mbar_init(qbar, 1);
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      hopper::mbar_init(full + s, 1);
      hopper::mbar_init(empty + s, 4 * j.n_wg);  // one arrival a warp
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
      dq_produce<D>(j, &tq, &tdo, &tk, &tv, sQ, sdO, sK, qbar, full, empty);
  } else {
    hopper::setmaxnreg_inc<kConsumerRegs>();
    if (wgi - 1 < j.n_wg)
      dq_consume<D>(a, j, wgi - 1, tid, sQ, sdO, sK, qbar, full, empty);
  }
}

// ---------------------------------------------------------------------------
// dk/dv kernel
// ---------------------------------------------------------------------------
struct KvJob {
  int b, hk, bhk, G, k0, n_wg, t_lo, n_t;
};

// the producer warp: K and V once, then each (head, query tile)'s Q and dO
// by TMA (one lane) and its lse (base 2) and delta by the warp's loads,
// handed over by the stage's full barrier
template <int D>
__device__ __forceinline__ void kv_produce(const Args& a, const KvJob& j,
                                           int lane, const CUtensorMap* tk,
                                           const CUtensorMap* tv,
                                           const CUtensorMap* tq,
                                           const CUtensorMap* tdo,
                                           uint32_t sK, uint32_t sV,
                                           uint32_t sQ, float* sL,
                                           uint64_t* kvbar, uint64_t* full,
                                           uint64_t* empty) {
  using T = Wt<D>;
  constexpr int ST = T::KV_ST, SW = T::SW, CE = T::CE, BQ = T::KV_BQ;
  if (lane == 0) {
    hopper::tma_prefetch(tq);
    hopper::tma_prefetch(tdo);
    hopper::mbar_expect_tx(kvbar, 2 * T::ROW_TILE);
#pragma unroll
    for (int c = 0; c < T::NCH; ++c) {
      hopper::tma_load_3d(sK + c * kRows * SW, tk, c * CE, j.k0, j.bhk, kvbar);
      hopper::tma_load_3d(sV + c * kRows * SW, tv, c * CE, j.k0, j.bhk, kvbar);
    }
  }
  for (int it = 0; it < j.G * j.n_t; ++it) {
    const int s = it % ST;
    if (it >= ST) hopper::mbar_wait(empty + s, ((it / ST) - 1) & 1);
    const int h = j.hk * j.G + it / j.n_t;
    const int qs = (j.t_lo + it % j.n_t) * BQ;
    const size_t bh = static_cast<size_t>(j.b) * a.H + h;
    float* l = sL + s * 2 * BQ;
    for (int i = lane; i < BQ; i += 32) {
      const int qi = qs + i;
      l[i] = qi < a.Sq ? a.lse[bh * a.Sq + qi] * kLog2e : 0.0f;
      l[BQ + i] = qi < a.Sq ? a.delta[bh * a.Sq + qi] : 0.0f;
    }
    __syncwarp();
    if (lane == 0) {
      const uint32_t dst = sQ + s * 2 * T::KV_TILE;
      hopper::mbar_expect_tx(full + s, 2 * T::KV_TILE);  // and its release
#pragma unroll
      for (int c = 0; c < T::NCH; ++c) {
        hopper::tma_load_3d(dst + c * BQ * SW, tq, c * CE, qs,
                            static_cast<int>(bh), full + s);
        hopper::tma_load_4d(dst + T::KV_TILE + c * BQ * SW, tdo, c * CE, qs,
                            h, j.b, full + s);
      }
    }
  }
}

// a consumer warpgroup (wg 0 or 1): keys [k0 + 64 wg, k0 + 64 wg + 64)
template <int D>
__device__ __forceinline__ void kv_consume(const Args& a, const KvJob& j,
                                           int wg, int tid, uint32_t sK,
                                           uint32_t sV, uint32_t sQ,
                                           const float* sL, float* sX,
                                           uint64_t* kvbar, uint64_t* full,
                                           uint64_t* empty) {
  using T = Wt<D>;
  constexpr int ST = T::KV_ST, SW = T::SW, BQ = T::KV_BQ;
  const int lt = tid % 128, ct = tid - 128;
  const int warp = lt / 32, lane = lt % 32;
  const int g = lane >> 2, t = lane & 3;
  const int off = a.Sk - a.Sq;
  const int kw0 = j.k0 + 64 * wg;
  const int key0 = kw0 + 16 * warp + g;          // this lane's keys: +0, +8
  const uint32_t krows = sK + 64 * wg * SW, vrows = sV + 64 * wg * SW;
  const int n0 = a.causal ? max(0, a.Sq - a.Sk) : 0;
  const int consumers = 128 * j.n_wg;
  // the query tiles [wt_lo, wt_hi) of n_t in which some key of this
  // warpgroup is seen
  int wq_b, wq_e;
  query_range(a, kw0, min(kw0 + 64, a.Sk), wq_b, wq_e);
  const int wt_lo = min(j.n_t, max(0, wq_b / BQ - j.t_lo));
  const int wt_hi =
      wq_e > wq_b ? max(wt_lo, min(j.n_t, (wq_e + BQ - 1) / BQ - j.t_lo))
                  : wt_lo;

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.0f;
  float st[BQ / 2], dpt[BQ / 2];
  uint32_t ph[BQ / 16][4], pl[BQ / 16][4], dh[BQ / 16][4], dl[BQ / 16][4];
  const size_t plane = static_cast<size_t>(a.B) * a.Hkv * a.Sk * D;

  auto release = [&](int it) {
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(empty + it % ST);
  };
  // P^T and dS^T of tile it (stage s, queries from qs) in place of S^T and
  // dP^T, once those have landed
  auto probs = [&](int s, int qs) {
    const float* l = sL + s * 2 * BQ;
    const bool edge = qs + BQ > a.Sq ||
                      (a.causal && kw0 + 63 > qs + off) ||
                      (a.window > 0 && qs + BQ - 1 + off - a.window >= kw0);
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) {
      const int c = 8 * (i >> 2) + 2 * t + (i & 1);
      float p = ex2(fmaf(st[i], a.scale_log2, -l[c]));
      if (edge && !visible(a, qs + c, key0 + 8 * ((i >> 1) & 1))) p = 0.0f;
      st[i] = p;
      dpt[i] = p * (dpt[i] - l[BQ + c]) * a.scale;
    }
  };
  auto scores = [&](int s) {              // S^T and dP^T of stage s, issued
    const uint32_t qst = sQ + s * 2 * T::KV_TILE;
    hopper::wgmma_fence();
    issue_nt<D, BQ>(st, krows, qst);
    issue_nt<D, BQ>(dpt, vrows, qst + T::KV_TILE);
    hopper::wgmma_commit();
  };

  // ping-pong (named barriers 3 and 4, warpgroup 0 first): two turns a
  // tile, one for S^T and dP^T, one for dV and dK
  const bool pp = T::KV_PP && j.n_wg == 2;
  const int turns = 2 * j.G * j.n_t;
  int turn_no = 0;
  auto turn = [&]() {
    if (pp) hopper::bar_sync(3 + wg, 256);
  };
  auto hand_over = [&]() {
    if (pp && !(wg == 1 && turn_no == turns - 1))
      hopper::bar_arrive(4 - wg, 256);
    ++turn_no;
  };
  if (pp && wg == 1 && turns > 0) hopper::bar_arrive(3, 256);

  hopper::mbar_wait(kvbar, 0);
  for (int jh = 0; jh < j.G; ++jh) {
    const int h = j.hk * j.G + jh;
    auto pass = [&](int it) {             // a tile no key here is seen in
      hopper::mbar_wait(full + it % ST, (it / ST) & 1);
      turn();
      hand_over();
      turn();
      hand_over();
      release(it);
    };
    const int it0 = jh * j.n_t;
    for (int i2 = 0; i2 < wt_lo; ++i2) pass(it0 + i2);
    for (int i2 = wt_lo; i2 < wt_hi; ++i2) {
      const int it = it0 + i2, s = it % ST;
      const int qs = (j.t_lo + i2) * BQ;
      const uint32_t qst = sQ + s * 2 * T::KV_TILE;
      const uint32_t dost = qst + T::KV_TILE;
      hopper::mbar_wait(full + s, (it / ST) & 1);
      turn();
      scores(s);
      hand_over();
      hopper::wgmma_wait<0>();
      hopper::fence_operands(st);
      hopper::fence_operands(dpt);
      probs(s, qs);
      split_frag<BQ>(st, ph, pl);
      turn();
      issue_rn<D, BQ>(dv, ph, pl, dost);        // dV += P^T dO
      split_frag<BQ>(dpt, dh, dl);              // under it
      issue_rn<D, BQ>(dk, dh, dl, qst);         // dK += dS^T Q
      hand_over();
      hopper::wgmma_wait<0>();
      landed<D, BQ>(dv, ph, pl);
      landed<D, BQ>(dk, dh, dl);
      release(it);
    }
    for (int i2 = wt_hi; i2 < j.n_t; ++i2) pass(it0 + i2);
    // the head's end: the no-key rows' dv, then into the group's sums
    if (n0 > 0) {
      for (int c = ct; c < D; c += consumers)
        sX[c] = no_key_dv<bf16>(a, j.b, h, c, n0);
      hopper::bar_sync(1, consumers);
#pragma unroll
      for (int i = 0; i < D / 2; ++i)
        dv[i] += sX[8 * (i >> 2) + 2 * t + (i & 1)];
      hopper::bar_sync(1, consumers);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key0 + 8 * r;
      if (key >= a.Sk) continue;
      const size_t base = (static_cast<size_t>(j.bhk) * a.Sk + key) * D;
#pragma unroll
      for (int c = 0; c < D / 8; ++c)
        round_into(a, base, plane, 8 * c + 2 * t, jh, j.G, dk[4 * c + 2 * r],
                   dk[4 * c + 2 * r + 1], dv[4 * c + 2 * r],
                   dv[4 * c + 2 * r + 1]);
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.0f;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
fa_bwd_wg_dkdv(const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tdo, const Args a) {
  using T = Wt<D>;
  constexpr int ST = T::KV_ST, BQ = T::KV_BQ;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = aligned_base(smem_raw);
  const uint32_t sK = hopper::smem_u32(base);
  const uint32_t sV = sK + T::ROW_TILE;
  const uint32_t sQ = sV + T::ROW_TILE;           // stage s at + 2 s KV_TILE
  float* sL = reinterpret_cast<float*>(base + 2 * T::ROW_TILE +
                                       ST * 2 * T::KV_TILE);
  float* sX = sL + ST * 2 * BQ;                   // the no-key rows' dv
  uint64_t* bars = reinterpret_cast<uint64_t*>(sX + D);
  uint64_t* kvbar = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + ST;

  KvJob j;
  j.hk = blockIdx.y, j.b = blockIdx.z;
  j.bhk = j.b * a.Hkv + j.hk;
  j.G = a.H / a.Hkv;
  j.k0 = blockIdx.x * kRows;
  const int k1 = min(j.k0 + kRows, a.Sk);
  j.n_wg = k1 - j.k0 > 64 ? 2 : 1;
  int q_begin, q_end;
  query_range(a, j.k0, k1, q_begin, q_end);
  j.t_lo = q_begin / BQ;
  j.n_t = q_end > q_begin ? (q_end + BQ - 1) / BQ - j.t_lo : 0;

  const int tid = threadIdx.x;
  if (tid == 0) {
    hopper::mbar_init(kvbar, 1);
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      hopper::mbar_init(full + s, 1);
      hopper::mbar_init(empty + s, 4 * j.n_wg);  // one arrival a warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();
  const int wgi = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (wgi == 0) {
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (tid < 32)
      kv_produce<D>(a, j, tid, &tk, &tv, &tq, &tdo, sK, sV, sQ, sL, kvbar,
                    full, empty);
  } else {
    hopper::setmaxnreg_inc<kConsumerRegs>();
    if (wgi - 1 < j.n_wg)
      kv_consume<D>(a, j, wgi - 1, tid, sK, sV, sQ, sL, sX, kvbar, full,
                    empty);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------
template <typename K>
cudaError_t raise_smem(K kernel, size_t smem, bool* raised) {
  if (smem <= 48 * 1024 || *raised) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess) *raised = true;
  return err;
}

// the (D, rows, B*heads) map of a contiguous q, k or v, boxes of `rows`
template <int D>
int encode_rows(CUtensorMap* map, const void* p, int S, long long heads,
                int rows) {
  using T = Wt<D>;
  return hopper::encode_3d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, p, D, S,
                           static_cast<uint64_t>(heads), T::CE, rows, T::SW);
}

// dO (B, H, Sq, D) at its strides (elements, D's 1) as a 4-D map
template <int D>
int encode_do(CUtensorMap* map, const void* p, const long long* st, int B,
              int H, int Sq, int rows) {
  using T = Wt<D>;
  const uint64_t dims[4] = {static_cast<uint64_t>(D),
                            static_cast<uint64_t>(Sq),
                            static_cast<uint64_t>(H),
                            static_cast<uint64_t>(B)};
  const uint64_t strides[3] = {static_cast<uint64_t>(st[2]) * 2,
                               static_cast<uint64_t>(st[1]) * 2,
                               static_cast<uint64_t>(st[0]) * 2};
  const uint32_t box[4] = {static_cast<uint32_t>(T::CE),
                           static_cast<uint32_t>(rows), 1, 1};
  return hopper::encode_strided(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, p,
                                dims, strides, box, T::SW);
}

template <int D>
int launch(const Args& a, const long long* do_st, cudaStream_t stream) {
  using T = Wt<D>;
  static bool raised[2] = {false, false};
  cudaError_t err = raise_smem(fa_bwd_wg_dq<D>, T::DQ_SMEM, &raised[0]);
  if (err == cudaSuccess)
    err = raise_smem(fa_bwd_wg_dkdv<D>, T::KV_SMEM, &raised[1]);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long bh = static_cast<long long>(a.B) * a.H;
  const long long bhk = static_cast<long long>(a.B) * a.Hkv;
  // the dq kernel's maps: Q and dO in boxes of 128 rows, K and V of DQ_BK;
  // the dk/dv kernel's: K and V of 128 rows, Q and dO of KV_BQ (the same
  // maps where the boxes agree)
  CUtensorMap q_dq, do_dq, k_dq, v_dq, q_kv, do_kv, k_kv, v_kv;
  int e = encode_rows<D>(&q_dq, a.q, a.Sq, bh, kRows);
  if (e == 0) e = encode_do<D>(&do_dq, a.dO, do_st, a.B, a.H, a.Sq, kRows);
  if (e == 0) e = encode_rows<D>(&k_kv, a.k, a.Sk, bhk, kRows);
  if (e == 0) e = encode_rows<D>(&v_kv, a.v, a.Sk, bhk, kRows);
  if (T::DQ_BK == kRows) {
    k_dq = k_kv, v_dq = v_kv;
  } else {
    if (e == 0) e = encode_rows<D>(&k_dq, a.k, a.Sk, bhk, T::DQ_BK);
    if (e == 0) e = encode_rows<D>(&v_dq, a.v, a.Sk, bhk, T::DQ_BK);
  }
  if (T::KV_BQ == kRows) {
    q_kv = q_dq, do_kv = do_dq;
  } else {
    if (e == 0) e = encode_rows<D>(&q_kv, a.q, a.Sq, bh, T::KV_BQ);
    if (e == 0) e = encode_do<D>(&do_kv, a.dO, do_st, a.B, a.H, a.Sq, T::KV_BQ);
  }
  if (e != 0) return e;
  const dim3 g_dq((a.Sq + kRows - 1) / kRows, a.H, a.B);
  const dim3 g_kv((a.Sk + kRows - 1) / kRows, a.Hkv, a.B);
  fa_bwd_wg_dq<D><<<g_dq, kThreads, T::DQ_SMEM, stream>>>(q_dq, do_dq, k_dq,
                                                          v_dq, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fa_bwd_wg_dkdv<D><<<g_kv, kThreads, T::KV_SMEM, stream>>>(k_kv, v_kv, q_kv,
                                                            do_kv, a);
  return static_cast<int>(cudaGetLastError());
}

template <int D> long long tiling(int which) {
  using T = Wt<D>;
  switch (which) {
    case 0: return kRows;
    case 1: return T::DQ_BK;
    case 2: return T::DQ_ST;
    case 3: return T::DQ_SMEM;
    case 4: return kRows;
    case 5: return T::KV_BQ;
    case 6: return T::KV_ST;
    case 7: return T::KV_SMEM;
    case 8: return kThreads;
    default: return -1;
  }
}

}  // namespace

extern "C" {

// bf16 only, D in 16, 32, 64, 128.  q, k, v contiguous and 16-byte
// aligned; lse (B,H,Sq) fp32; dO (B,H,Sq,D) at do_strides (elements, the
// last 1, the others 16-byte multiples; its base 16-byte aligned); dq, dk,
// dv contiguous bf16; ws: B*H*Sq floats of delta, then with H > Hkv
// 2*B*Hkv*Sk*D floats of the group's sums
int flash_attention_bwd_wgmma_launch(const void* q, const void* k,
                                     const void* v, const float* lse,
                                     const void* dO, void* dq, void* dk,
                                     void* dv, float* ws,
                                     const long long* do_strides, int B,
                                     int H, int Hkv, int Sq, int Sk, int D,
                                     int causal, int window, void* stream) {
  if (Hkv < 1 || H % Hkv || Sk < 1 || Sq < 1 || do_strides[3] != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = q, a.k = k, a.v = v, a.lse = lse, a.dO = dO;
  a.dq = dq, a.dk = dk, a.dv = dv;
  a.delta = ws;
  a.sums = ws + static_cast<size_t>(B) * H * Sq;
  a.do_sb = do_strides[0], a.do_sh = do_strides[1], a.do_ss = do_strides[2];
  a.B = B, a.H = H, a.Hkv = Hkv, a.Sq = Sq, a.Sk = Sk;
  a.causal = causal, a.window = window;
  a.scale = 1.0f / sqrtf(static_cast<float>(D));
  a.scale_log2 = kLog2e / sqrtf(static_cast<float>(D));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(a, do_strides, s);
    case 32: return launch<32>(a, do_strides, s);
    case 64: return launch<64>(a, do_strides, s);
    case 128: return launch<128>(a, do_strides, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// the kernels' tiling at head dim D: which = 0 query rows a dq block, 1
// keys a K/V tile, 2 its stages, 3 the dq kernel's dynamic shared memory in
// bytes, 4 keys a dk/dv block, 5 query rows a Q/dO tile, 6 its stages, 7
// the dk/dv kernel's shared memory, 8 threads a block (both kernels); -1
// otherwise
long long flash_attention_bwd_wgmma_tiling(int D, int which) {
  switch (D) {
    case 16: return tiling<16>(which);
    case 32: return tiling<32>(which);
    case 64: return tiling<64>(which);
    case 128: return tiling<128>(which);
    default: return -1;
  }
}

}  // extern "C"
