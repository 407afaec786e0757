// Chunked gated linear recurrence (SSD / Mamba2 / mLSTM core), backward, on
// Hopper's warpgroup tensor cores fed by TMA (sm_90a).
//
// The gradient of ssd_scan.cu's forward, the same function as
// ssd_scan_bwd.cu's kernels (the reference's backward is jax.vjp of
// ref.ssd_scan_ref, src/repro/kernels/ops.py:_ssd_bwd_rule; the plain
// version is kernels/ssd_scan.py:ssd_scan_bwd_plain, whose docstring gives
// the decomposition).  This file takes the calls kernels/ssd_scan.py:
// bwd_plan sends it: bf16 q/k and N = P = 64 (one 64-column slab each, the
// width of every wgmma here), a chunk whose dq fits a block's shared memory
// (Q <= 256 on an H100); v, dy and log_a f32 or bf16, any S, q/k groups of
// any size.  Per chunk of Q steps, cum the inclusive cumsum of log_a, tot its
// last value, h_in the state entering the chunk and dh_out the gradient of
// the state leaving it; A = (q k^T) masked to s <= t, D_ts = e^(cum_t -
// cum_s), W = A D, dW = (dy v^T) masked, dA = dW D:
//
//   dq = dA k + diag(e^cum) dy h_in^T
//   dk = dA^T q + diag(e^(tot - cum)) v dh_out^T
//   dv = W^T dy + diag(e^(tot - cum)) k dh_out
//   dlog_a = the reverse cumsum of dcum within the chunk (ssd_scan_bwd.cu).
//
// Three kernels on the caller's stream, one call of the host launcher:
//
//   ssd_bwd_wg_chain  the states: a block per (chain, b, h), two an SM.
//     The forward chain's block walks chunks 0 .. nc - 2 in order, the
//     reverse chain's nc - 1 .. 1, each chunk's increment inc = sum_s k_s^T
//     e^(tot - cum_s) v_s (forward) or up = sum_t q_t^T e^cum_t dy_t
//     (reverse) from tiles a producer thread streams in ahead, then the
//     state, kept in registers, e^tot state + inc: the next chunk's h_in
//     (the previous chunk's dh_out), written once.  The reverse chain starts
//     from the final state's cotangent (or zero), the last chunk's dh_out.
//     No block waits for another, and the chain's sums keep their order.
//   ssd_bwd_wg_chunk  a block per (b, h, chunk): dq, dk, dv and dlog_a of
//     the chunk, all on chip (below).
//   ssd_bwd_wg_group  at G < H, each group's dq and dk: the heads' bf16
//     gradients (each already rounded to q's type, as autograd rounds them
//     where q is widened for each head) summed in order in fp32 and rounded
//     once more.
//
// The chunk kernel.  384 threads: warp 0's first thread issues every TMA
// copy, warps 1-3 (96 builders) split fp32 tiles into bf16 parts, and two
// consumer warpgroups run wgmma.  A chunk is cut into 64-row tiles; for each
// key tile j (k_j by TMA, v_j split into parts, resident while j lasts) and
// each query tile i >= j (q_i by TMA and dy_i split into parts, through a
// ring of two slots), the two consumer warpgroups take the query tile's two
// 32-row halves, so neither waits for the other within a pair:
//   S^T = k_j q_i^T and dP^T = v_j dy_i^T (m64n32, the keys as rows), then
//   W^T and dA^T in the accumulators; dk_j += dA^T q_i and dv_j += W^T dy_i
//   with A from those registers (m64n64, the halves' partial sums in each
//   warpgroup's registers); and dq_i^T += k_j^T dA_ij^T (m64n32) from dA's
//   parts in shared memory, into dq^T kept in shared memory for the whole
//   chunk, each thread's own accumulators, summed over j in order.
// At the end of key tile j the state terms (one warpgroup e^(tot - cum) v_j
// dh_out^T for dk, the other e^(tot - cum) k_j dh_out for dv) and the two
// halves' partials meet through the freed slot; dk_j and dv_j are written
// once.  Last, per query tile, e^cum dy_i h_in^T completes dq_i, written
// once, and a warp scans dcum into dlog_a.
//
// Products.  Every operand in shared memory is a bf16 tile of 64-value rows,
// 128-byte swizzled as TMA lands q and k, so wgmma reads it K-major or, with
// its transpose bit, MN-major, and no copy is transposed.  An fp32 operand
// is split once, when its tile is staged (or in registers, for the A of
// dk and dv), into three bf16 parts x = x1 + x2 + x3 (round to nearest each;
// |x - x1 - x2 - x3| <= 2^-27 |x|).  A product with a bf16 operand takes the
// fp32 one's three parts (exact products, fp32 sums); a product of two fp32
// operands takes the six part pairs whose weight reaches 2^-16 (x1y1, x1y2,
// x2y1, x1y3, x2y2, x3y1), smallest first: both keep fp32 accuracy, at the
// cost of 1.5 and 3 TF32 products in tensor-core time.
//
// What the design does about PR 31's limits (ssd_scan_bwd.cu): the products
// are wgmma from shared memory or registers, never scalar fragment loads,
// and every fp32 tile is split once; the tiles arrive by TMA into rings with
// mbarriers while the consumers compute, and the two consumer warpgroups
// take turns to issue their products (named barriers), so one's elementwise
// work overlaps the other's products; dq never leaves the chip until it is
// whole (no per-pair read-modify-write of global memory); the states and
// the chains are one launch that reads v and dy once and no state twice;
// the group sum reads the heads' bf16 gradients.  Nothing is added across
// blocks by atomics, and every sum runs in a fixed order, so two calls give
// the same bits.
//
// Bound on an H100: operations.  At Zamba2's training shape (B4 H64 G1 S2048
// N = P = 64, chunk 256, bf16 q/k, fp32 v, dy and log_a) the causal halves
// of the backward's products at the cheaper of TF32 and bf16 parts are
// 0.2567 ms of tensor-core time (kernels/ssd_scan.py:work_backward), against
// ~0.42 GB moved (0.13 ms at 3.35 TB/s).  The design spends more: the
// diagonal tiles compute their masked half, the chain kernel reads v and dy
// once more (0.27 GB, 0.08 ms), and dy's tile is staged and split again for
// each key tile and once more for the inter term (PERF.md gives the time
// beside the bound, and the split between the kernels).
//
// The launcher takes PyTorch's current stream, allocates nothing and returns
// cudaGetLastError() after the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTileB = 64 * 128;       // a bf16 64 x 64 tile, 128-byte rows
constexpr int kPartsB = 3 * kTileB;    // an fp32 tile's three bf16 parts
constexpr int kHalfB = 4096;           // 32 rows of a bf16 tile
constexpr int kRawB = 32 * 64 * 4;     // a raw half tile (32 rows) as TMA lands it
constexpr int kQSlotB = kTileB + kPartsB;   // q_i, then dy_i's parts
constexpr int kBuilders = 96;
constexpr int kChunkThreads = 384;
constexpr int kChainThreads = 192;    // a warpgroup, two warps
constexpr int kChainStages = 4;        // the chain kernel's tile ring
constexpr int kChunkRaw = 4;           // raw half tiles in flight
constexpr int kBarConsumers = 1, kBarWg = 2;  // named barriers (kBarWg + w)
constexpr int kBarTurn = 4;                    // and kBarTurn + w
// setmaxnreg's split of the chunk kernel, 56 x 128 + 224 x 256 <= 65536
constexpr int kProducerRegs = 56, kConsumerRegs = 224;

enum { kKV, kPair, kDH, kHin };       // the chunk kernel's staged items

// the six part pairs (x of A, y of B) of a product of two fp32 operands,
// smallest first: x3y1, x2y2, x1y3, x2y1, x1y2, x1y1
__host__ __device__ constexpr int pair_a(int x) {
  return x == 0 ? 2 : x == 1 || x == 3 ? 1 : 0;
}
__host__ __device__ constexpr int pair_b(int x) {
  return x == 2 ? 2 : x == 1 || x == 4 ? 1 : 0;
}

__device__ __forceinline__ float ld(const void* p, int bf, long long i) {
  return bf ? __bfloat162float(static_cast<const bf16*>(p)[i])
            : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ float exp_clip(float x) {
  return __expf(fminf(fmaxf(x, -60.0f), 0.0f));
}
__device__ __forceinline__ float in_clip(float x) {
  return (x >= -60.0f && x <= 0.0f) ? 1.0f : 0.0f;
}

__device__ __forceinline__ uint32_t u32(__nv_bfloat162 h) {
  return *reinterpret_cast<const uint32_t*>(&h);
}

// (x, y) -> their three bf16 parts, each a packed pair (x low)
__device__ __forceinline__ void split3(float x, float y, uint32_t& p1,
                                       uint32_t& p2, uint32_t& p3) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(x, y);
  const float2 af = __bfloat1622float2(a);
  const float rx = x - af.x, ry = y - af.y;
  const __nv_bfloat162 b = __floats2bfloat162_rn(rx, ry);
  const float2 bf = __bfloat1622float2(b);
  p1 = u32(a);
  p2 = u32(b);
  p3 = u32(__floats2bfloat162_rn(rx - bf.x, ry - bf.y));
}

// byte offset of element (r, c) in a 64-column bf16 tile of 128-byte rows,
// 16-byte chunks XOR-permuted by r % 8 (TMA's 128-byte swizzle)
__device__ __forceinline__ int swz(int r, int c) {
  return r * 128 + (((c >> 3) ^ (r & 7)) << 4) + ((c & 7) << 1);
}

__device__ __forceinline__ float tile_bf16(const unsigned char* t, int r,
                                           int c) {
  const unsigned short u =
      *reinterpret_cast<const unsigned short*>(t + swz(r, c));
  return __uint_as_float(static_cast<uint32_t>(u) << 16);
}

// K-major: rows of the operand's M or N, 64 values along K; k-step kk
__device__ __forceinline__ uint64_t kdesc(uint32_t a, int kk) {
  return hopper::smem_desc(a + kk * 32, 16, 1024, 128);
}
// MN-major (read transposed): rows along K, 64 values of M or N; k-step kk
__device__ __forceinline__ uint64_t mdesc(uint32_t a, int kk) {
  return hopper::smem_desc(a + kk * 16 * 128, 64 * 128, 1024, 128);
}

// rows r0 .. r0 + 31 of a tile from a raw half tile (32 rows of 64 values,
// fp32 or bf16, unswizzled) into the three bf16 parts at `parts` (three
// swizzled 64 x 64 tiles), times scale[r] where given; rows >= valid zero.
// Builder bt of kBuilders.
__device__ __forceinline__ void split_rows(unsigned char* parts,
                                           const unsigned char* raw,
                                           int raw_bf, int r0,
                                           const float* scale, int valid,
                                           int bt) {
#pragma unroll 1
  for (int gi = bt; gi < 32 * 8; gi += kBuilders) {
    const int rr = gi >> 3, cg = gi & 7, r = r0 + rr;
    float x[8];
    if (raw_bf) {
      const uint4 u = *reinterpret_cast<const uint4*>(raw + rr * 128 + cg * 16);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(h[e]);
        x[2 * e] = f.x;
        x[2 * e + 1] = f.y;
      }
    } else {
      const float4* s4 =
          reinterpret_cast<const float4*>(raw + rr * 256 + cg * 32);
      const float4 a = s4[0], b = s4[1];
      x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
      x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
    }
    const bool in = r < valid;
    const float sc = in && scale != nullptr ? scale[r] : 1.0f;
    uint32_t p1[4], p2[4], p3[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      split3(in ? x[2 * e] * sc : 0.0f, in ? x[2 * e + 1] * sc : 0.0f, p1[e],
             p2[e], p3[e]);
    const int off = r * 128 + ((cg ^ (r & 7)) << 4);
    *reinterpret_cast<uint4*>(parts + off) = make_uint4(p1[0], p1[1], p1[2],
                                                        p1[3]);
    *reinterpret_cast<uint4*>(parts + kTileB + off) =
        make_uint4(p2[0], p2[1], p2[2], p2[3]);
    *reinterpret_cast<uint4*>(parts + 2 * kTileB + off) =
        make_uint4(p3[0], p3[1], p3[2], p3[3]);
  }
}

// the inclusive cumsum of log_a over a chunk's L steps into cum[0 .. Qp)
// (steps past L add 0): a warp, 32 steps at a time in order, every load of
// 256 steps issued before the scan
__device__ __forceinline__ void warp_cumsum(float* cum, const void* la,
                                            int la_bf, long long base, int L,
                                            int Qp, int lane) {
  float carry = 0.0f;
  for (int t1 = 0; t1 < Qp; t1 += 256) {
    float xs[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int t = t1 + 32 * k + lane;
      xs[k] = t < L ? ld(la, la_bf, base + t) : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (t1 + 32 * k >= Qp) break;
      float x = xs[k];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += y;
      }
      x += carry;
      cum[t1 + 32 * k + lane] = x;
      carry = __shfl_sync(0xffffffffu, x, 31);
    }
  }
}

struct Args {
  int B, H, G, S, Q, nc, Qp;
  int v_bf, la_bf, gy_bf;
  const void* la;
  const float* gs;                     // the final state's cotangent, or null
  long long gs_st[4];
  float *hs, *ds;    // (nc, B*H, 64, 64): h_in and dh_out of every chunk
  bf16 *dqo, *dko;   // dq, dk of each head (the outputs at G = H)
  void *dv, *dla;
};

// ---------------------------------------------------------------------------
// ssd_bwd_wg_chain
// ---------------------------------------------------------------------------
// byte offsets past the 1024-byte alignment: a ring of tile stages (a bf16
// tile of k or q, a raw tile of v or dy), two chunk slots (a chunk's cumsum
// and scale), the mbarriers
struct ChainLay {
  int x, raw, cum, scale, bars, end;
};
__host__ __device__ inline ChainLay chain_layout(int Qp) {
  ChainLay m;
  m.x = 0;
  m.raw = m.x + kChainStages * kTileB;
  m.cum = m.raw + kChainStages * 2 * kRawB;
  m.scale = m.cum + 2 * Qp * 4;
  m.bars = m.scale + 2 * Qp * 4;
  m.end = m.bars + 8 * (2 * kChainStages + 4);
  return m;
}
__host__ __device__ inline int chain_smem(int Q) {
  return 1024 + chain_layout((Q + 63) / 64 * 64).end;
}

// the k-th link of block `item`'s chain: blocks [0, BH) the forward chain
// of head b * H + h (chunks 0 .. nc - 2, each writing h_in of the next),
// blocks [BH, 2 BH) the reverse one (chunks nc - 1 .. 1, each writing dh_out
// of the one before)
struct ChainJob {
  bool fwd;
  int c, bh, b, h, c0, L, bhg, nT;
  __device__ ChainJob(const Args& a, int item, int k) {
    const int BH = a.B * a.H;
    fwd = item < BH;
    bh = item % BH;
    c = fwd ? k : a.nc - 1 - k;
    b = bh / a.H;
    h = bh % a.H;
    c0 = c * a.Q;
    L = min(a.Q, a.S - c0);
    bhg = b * a.G + h / (a.H / a.G);
    nT = (L + 63) / 64;
  }
};

// A block per (chain, b, h), two an SM: the head's chain runs in order in
// one block, its state in the consumer warpgroup's registers, so no link
// waits for another block.  Warp 4's first thread streams every chunk's
// tiles into the ring, running ahead into the next chunk; warp 5 computes
// each chunk's cumsum and scale into a chunk slot; the consumer warpgroup
// computes the chunk's increment transposed, inc^T (p x n) = sum_s y'_s^T
// x_s (y' = v e^(tot - cum), x = k; or y' = dy e^cum, x = q), A = y'^T from
// the raw tiles in three bf16 parts split in registers, B = x as TMA lands
// it (read transposed), then state = e^tot state + inc, written as the next
// chunk's h_in (or the previous chunk's dh_out).  The reverse chain first
// writes the last chunk's dh_out, the final state's cotangent (or zero).
__global__ void __launch_bounds__(kChainThreads, 2)
ssd_bwd_wg_chain(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const __grid_constant__ CUtensorMap tg, Args a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  const int Qp = a.Qp;
  const ChainLay lay = chain_layout(Qp);
  const uint32_t sb = hopper::smem_u32(base);
  float* cums = reinterpret_cast<float*>(base + lay.cum);     // [2][Qp]
  float* scales = reinterpret_cast<float*>(base + lay.scale); // [2][Qp]
  uint64_t* full = reinterpret_cast<uint64_t*>(base + lay.bars);
  uint64_t* empty = full + kChainStages;
  uint64_t* cfull = empty + kChainStages;   // [2] a chunk slot's
  uint64_t* cempty = cfull + 2;             // [2]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int item = blockIdx.x, links = a.nc - 1;
  if (tid == 0) {
    for (int s = 0; s < kChainStages; ++s) {
      hopper::mbar_init(full + s, 1);
      hopper::mbar_init(empty + s, 4);
    }
    for (int s = 0; s < 2; ++s) {
      hopper::mbar_init(cfull + s, 32);
      hopper::mbar_init(cempty + s, 4);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp == 5) {                     // each chunk's cumsum and scale
    for (int k = 0; k < links; ++k) {
      const int slot = k & 1;
      if (k >= 2) hopper::mbar_wait(cempty + slot, ((k >> 1) - 1) & 1);
      const ChainJob j(a, item, k);
      float* cum = cums + slot * Qp;
      warp_cumsum(cum, a.la, a.la_bf,
                  static_cast<long long>(j.bh) * a.S + j.c0, j.L, Qp, lane);
      __syncwarp();
      const float tot = cum[Qp - 1];
      for (int t = lane; t < Qp; t += 32)
        scales[slot * Qp + t] =
            t < j.L ? exp_clip(j.fwd ? tot - cum[t] : cum[t]) : 0.0f;
      __syncwarp();
      hopper::mbar_arrive(cfull + slot);
    }
    return;
  }
  if (warp == 4) {                     // the tiles
    if (lane != 0) return;
    const bool fwd = item < a.B * a.H;
    const CUtensorMap* mx = fwd ? &tk : &tq;
    const CUtensorMap* my = fwd ? &tv : &tg;
    hopper::tma_prefetch(mx);
    hopper::tma_prefetch(my);
    const int eb = (fwd ? a.v_bf : a.gy_bf) ? 2 : 4;
    int n = 0;
    for (int k = 0; k < links; ++k) {
      const ChainJob j(a, item, k);
      for (int t = 0; t < j.nT; ++t, ++n) {
        const int s = n % kChainStages;
        if (n >= kChainStages)
          hopper::mbar_wait(empty + s, ((n / kChainStages) - 1) & 1);
        hopper::mbar_expect_tx(full + s, kTileB + 64 * 64 * eb);
        hopper::tma_load_3d(sb + lay.x + s * kTileB, mx, 0, j.c0 + 64 * t,
                            j.bhg, full + s);
        for (int hh = 0; hh < 2; ++hh) {
          const uint32_t dst = sb + lay.raw + (2 * s + hh) * kRawB;
          const int row = j.c0 + 64 * t + 32 * hh;
          if (fwd)
            hopper::tma_load_3d(dst, my, 0, row, j.bh, full + s);
          else
            hopper::tma_load_4d(dst, my, 0, row, j.h, j.b, full + s);
        }
      }
    }
    return;
  }

  // the consumer warpgroup: element e of the state, (n, p) = (8 (e >> 2) +
  // 2 q4 + (e & 1), 16 warp + g + 8 ((e >> 1) & 1)), as inc^T's accumulator
  // holds it
  const int g = lane >> 2, q4 = lane & 3;
  const size_t NP = 64 * 64, BHs = static_cast<size_t>(a.B) * a.H;
  const ChainJob j0(a, item, 0);
  float* slots = j0.fwd ? a.hs : a.ds;
  float state[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int pp = 16 * warp + g + 8 * ((e >> 1) & 1);
    const int nn = 8 * (e >> 2) + 2 * q4 + (e & 1);
    state[e] = 0.0f;
    if (!j0.fwd) {                     // dh_out of the last chunk
      if (a.gs != nullptr)
        state[e] = a.gs[j0.b * a.gs_st[0] + j0.h * a.gs_st[1] +
                        nn * a.gs_st[2] + pp * a.gs_st[3]];
      slots[((a.nc - 1) * BHs + j0.bh) * NP + nn * 64 + pp] = state[e];
    }
  }
  int n = 0;
  for (int k = 0; k < links; ++k) {
    const int slot = k & 1;
    const ChainJob j(a, item, k);
    const int rbf = j.fwd ? a.v_bf : a.gy_bf;
    const int rs = rbf ? 128 : 256;    // a raw row's bytes
    hopper::mbar_wait(cfull + slot, (k >> 1) & 1);
    const float* scale = scales + slot * Qp;
    const float et = exp_clip(cums[slot * Qp + Qp - 1]);
    float acc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] = 0.0f;
    for (int t = 0; t < j.nT; ++t, ++n) {
      const int s = n % kChainStages;
      hopper::mbar_wait(full + s, (n / kChainStages) & 1);
      const unsigned char* raw = base + lay.raw + 2 * s * kRawB;
      // A fragments of y'^T (rows p = 16 warp + g (+ 8), k-step kk's steps
      // s = 16 kk + 2 q4 (+ 1, + 8, + 9)), three bf16 parts each
      uint32_t fa[3][4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int pp = 16 * warp + g + 8 * (e & 1);
          const int s0 = 16 * kk + 8 * (e >> 1) + 2 * q4;
          float y[2];
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            // row s0 + cc of the tile: in the raw half tile (s0 + cc) / 32
            const int r = s0 + cc;
            const unsigned char* at = raw + (r >> 5) * kRawB + (r & 31) * rs;
            y[cc] = scale[64 * t + s0 + cc] *
                    (rbf ? __bfloat162float(
                               reinterpret_cast<const bf16*>(at)[pp])
                         : reinterpret_cast<const float*>(at)[pp]);
          }
          split3(y[0], y[1], fa[0][kk][e], fa[1][kk][e], fa[2][kk][e]);
        }
      const uint32_t xs = sb + lay.x + s * kTileB;
      hopper::fence_operands(acc);
#pragma unroll
      for (int p = 0; p < 3; ++p)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) hopper::fence_operands(fa[p][kk]);
      hopper::wgmma_fence();
#pragma unroll
      for (int p = 2; p >= 0; --p)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hopper::Wgmma<64>::rs<1>(acc, fa[p][kk], mdesc(xs, kk), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operands(acc);
#pragma unroll
      for (int p = 0; p < 3; ++p)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) hopper::fence_operands(fa[p][kk]);
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(empty + s);
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(cempty + slot);
    // the link: the next chunk's h_in (or the previous one's dh_out)
    float* out = slots + ((j.fwd ? j.c + 1 : j.c - 1) * BHs + j.bh) * NP;
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int pp = 16 * warp + g + 8 * ((e >> 1) & 1);
      const int nn = 8 * (e >> 2) + 2 * q4 + (e & 1);
      state[e] = fmaf(et, state[e], acc[e]);
      out[nn * 64 + pp] = state[e];
    }
  }
}

// ---------------------------------------------------------------------------
// ssd_bwd_wg_chunk
// ---------------------------------------------------------------------------
struct ChunkLay {
  int dq, k, v, q, da, raw, f, bars, end;
};
// byte offsets past the 1024-byte alignment: dq^T of every query tile (two
// halves of 16 accumulators a thread), k_j, the V slot (v_j's parts, last
// h_in's), the ring of two Q slots (q_i, then dy_i's or dh_out's parts), the
// two warpgroups' dA parts (32 rows of 64 keys, three parts), the raw half
// tiles, the fp32 arrays (cum, e^(tot - cum), e^cum, dcum's row sums by
// warp, its column sums and state terms, the exchange of column sums, the
// dot), the mbarriers
__host__ __device__ inline ChunkLay chunk_layout(int Qp) {
  ChunkLay m;
  m.dq = 0;
  m.k = m.dq + (Qp / 64) * 2 * 16 * 128 * 4;
  m.v = m.k + kTileB;
  m.q = m.v + kPartsB;
  m.da = m.q + 2 * kQSlotB;
  m.raw = m.da + 2 * 3 * kHalfB;
  m.f = m.raw + kChunkRaw * kRawB;
  m.bars = m.f + (9 * Qp + 64 + 16) * 4;
  m.end = m.bars + 8 * (9 + 2 * kChunkRaw);
  return m;
}
__host__ __device__ inline int chunk_smem(int Q) {
  return 1024 + chunk_layout((Q + 63) / 64 * 64).end;
}

template <typename F>
__device__ __forceinline__ void for_items(int nT, bool inter, F&& f) {
  for (int j = 0; j < nT; ++j) {
    f(kKV, j);
    for (int i = j; i < nT; ++i) f(kPair, i);
    f(kDH, 0);
  }
  if (inter) {
    f(kHin, 0);
    for (int i = 0; i < nT; ++i) f(kPair, i);
  }
}

// issue acc (+)= A B over the six part pairs of two fp32 operands (A's parts
// at pa, B's at pb, K-major, 4 k-steps); acc is overwritten unless `add`
template <int N, typename Acc>
__device__ __forceinline__ void issue_six(Acc& acc, uint32_t pa, uint32_t pb,
                                          bool add) {
#pragma unroll
  for (int x = 0; x < 6; ++x)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hopper::Wgmma<N>::template ss<0, 0>(
          acc, kdesc(pa + pair_a(x) * kTileB, kk),
          kdesc(pb + pair_b(x) * kTileB, kk), add || x > 0 || kk > 0);
}

__global__ void __launch_bounds__(kChunkThreads, 1)
ssd_bwd_wg_chunk(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const __grid_constant__ CUtensorMap tg,
                 const __grid_constant__ CUtensorMap ths,
                 const __grid_constant__ CUtensorMap tds, Args a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  const int Qp = a.Qp;
  const ChunkLay lay = chunk_layout(Qp);
  const uint32_t sb = hopper::smem_u32(base);
  float* dqs = reinterpret_cast<float*>(base + lay.dq);
  float* cum = reinterpret_cast<float*>(base + lay.f);  // [Qp]
  float* es = cum + Qp;          // [Qp] e^(tot - cum), 0 past L
  float* et = es + Qp;           // [Qp] e^cum, 0 past L
  float* rsum = et + Qp;         // [4][Qp] dcum's row sums (and inter) by warp
  float* colsum = rsum + 4 * Qp; // [Qp]
  float* stt = colsum + Qp;      // [Qp] the state terms
  float* csum1 = stt + Qp;       // [64] the second warpgroup's column sums
  float* red = csum1 + 64;       // [16]
  uint64_t* kfull = reinterpret_cast<uint64_t*>(base + lay.bars);
  uint64_t* vfull = kfull + 1;
  uint64_t* kvempty = vfull + 1;
  uint64_t* qfull = kvempty + 1;       // [2]
  uint64_t* pfull = qfull + 2;         // [2]
  uint64_t* qempty = pfull + 2;        // [2]
  uint64_t* rawfull = qempty + 2;      // [kChunkRaw]
  uint64_t* rawempty = rawfull + kChunkRaw;

  const int tid = threadIdx.x;
  const int BH = a.B * a.H;
  const int c = blockIdx.x / BH, bh = blockIdx.x % BH;
  const int b = bh / a.H, h = bh % a.H;
  const int bhg = b * a.G + h / (a.H / a.G);
  const int c0 = c * a.Q, L = min(a.Q, a.S - c0), nT = (L + 63) / 64;
  if (tid == 0) {
    hopper::mbar_init(kfull, 1);
    hopper::mbar_init(vfull, kBuilders);
    hopper::mbar_init(kvempty, 8);
    for (int s = 0; s < 2; ++s) {
      hopper::mbar_init(qfull + s, 1);
      hopper::mbar_init(pfull + s, kBuilders);
      hopper::mbar_init(qempty + s, 8);
    }
    for (int r = 0; r < kChunkRaw; ++r) {
      hopper::mbar_init(rawfull + r, 1);
      hopper::mbar_init(rawempty + r, kBuilders);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();
  const uint32_t sK = sb + lay.k, sV = sb + lay.v;
  const CUtensorMap *mq = &tq, *mk = &tk, *mv = &tv, *mg = &tg, *mh = &ths,
                    *md = &tds;
  auto qslot = [&](int s) { return sb + lay.q + s * kQSlotB; };
  const int wgi = __shfl_sync(0xffffffffu, tid / 128, 0);

  if (wgi == 0) {
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (tid == 0) {                    // the producer: every TMA copy
      hopper::tma_prefetch(mq);
      hopper::tma_prefetch(mk);
      hopper::tma_prefetch(mv);
      hopper::tma_prefetch(mg);
      int kv = 0, z = 0, raw = 0;
      for_items(nT, c > 0, [&](int kind, int idx) {
        const bool kvs = kind == kKV || kind == kHin;
        const int s = z & 1;
        // the raw tiles first (they wait only for the raw ring), then the
        // bf16 tile into the item's slot once it is free
        const int eb = kind == kKV ? (a.v_bf ? 2 : 4)
                       : kind == kPair ? (a.gy_bf ? 2 : 4) : 4;
        for (int hh = 0; hh < 2; ++hh, ++raw) {
          const int r = raw % kChunkRaw;
          if (raw >= kChunkRaw)
            hopper::mbar_wait(rawempty + r, ((raw / kChunkRaw) - 1) & 1);
          hopper::mbar_expect_tx(rawfull + r, 32 * 64 * eb);
          const uint32_t dst = sb + lay.raw + r * kRawB;
          const int row = c0 + 64 * idx + 32 * hh;
          if (kind == kKV)
            hopper::tma_load_3d(dst, mv, 0, row, bh, rawfull + r);
          else if (kind == kPair)
            hopper::tma_load_4d(dst, mg, 0, row, h, b, rawfull + r);
          else
            hopper::tma_load_3d(dst, kind == kDH ? md : mh, 0, 32 * hh,
                                c * BH + bh, rawfull + r);
        }
        if (kvs && kv > 0) hopper::mbar_wait(kvempty, (kv - 1) & 1);
        if (!kvs && z >= 2) hopper::mbar_wait(qempty + s, ((z >> 1) - 1) & 1);
        if (kind == kKV) {
          hopper::mbar_expect_tx(kfull, kTileB);
          hopper::tma_load_3d(sK, mk, 0, c0 + 64 * idx, bhg, kfull);
        } else if (kind == kPair) {
          hopper::mbar_expect_tx(qfull + s, kTileB);
          hopper::tma_load_3d(qslot(s), mq, 0, c0 + 64 * idx, bhg,
                              qfull + s);
        } else {
          hopper::mbar_arrive(kvs ? kfull : qfull + s);
        }
        if (kvs)
          ++kv;
        else
          ++z;
      });
    } else if (tid >= 32) {            // the builders: fp32 tiles into parts
      const int bt = tid - 32;
      int kv = 0, z = 0, raw = 0;
      for_items(nT, c > 0, [&](int kind, int idx) {
        const bool kvs = kind == kKV || kind == kHin;
        const int s = z & 1;
        if (kvs && kv > 0) hopper::mbar_wait(kvempty, (kv - 1) & 1);
        if (!kvs && z >= 2) hopper::mbar_wait(qempty + s, ((z >> 1) - 1) & 1);
        unsigned char* parts = kvs ? base + lay.v : base + lay.q +
                                                        s * kQSlotB + kTileB;
        const int rbf = kind == kKV ? a.v_bf : kind == kPair ? a.gy_bf : 0;
        const int valid = kind == kKV || kind == kPair ? L - 64 * idx : 64;
        for (int hh = 0; hh < 2; ++hh, ++raw) {
          const int r = raw % kChunkRaw;
          hopper::mbar_wait(rawfull + r, (raw / kChunkRaw) & 1);
          split_rows(parts, base + lay.raw + r * kRawB, rbf, 32 * hh, nullptr,
                     valid, bt);
          hopper::mbar_arrive(rawempty + r);
        }
        hopper::fence_proxy_async();
        hopper::mbar_arrive(kvs ? vfull : pfull + s);
        if (kvs)
          ++kv;
        else
          ++z;
      });
    }
    return;
  }
  hopper::setmaxnreg_inc<kConsumerRegs>();

  // the consumers: warpgroup w takes rows 32 w .. 32 w + 31 of each query
  // tile; a thread holds accumulator rows 16 warp + g (+ 8), columns 8 jb +
  // 2 q4 (+ 1)
  const int ct = tid - 128, w = wgi - 1, lt = ct % 128;
  const int warp = lt / 32, lane = lt % 32, g = lane >> 2, q4 = lane & 3;
  const long long row0 = static_cast<long long>(bh) * a.S + c0;

  // -- the chunk's cumsum and its exponentials -------------------------------
  if (ct < 32) warp_cumsum(cum, a.la, a.la_bf, row0, L, Qp, ct);
  for (int t = ct; t < 4 * Qp; t += 256) rsum[t] = 0.0f;
  hopper::bar_sync(kBarConsumers, 256);
  const float tot = cum[Qp - 1];
  for (int t = ct; t < Qp; t += 256) {
    es[t] = t < L ? exp_clip(tot - cum[t]) : 0.0f;
    et[t] = t < L ? exp_clip(cum[t]) : 0.0f;
  }
  hopper::bar_sync(kBarConsumers, 256);

  const uint32_t dAw = sb + lay.da + w * 3 * kHalfB;
  unsigned char* dAg = base + lay.da + w * 3 * kHalfB;
  int kv = 0, z = 0;
  // the warpgroups take turns to issue their products (named barrier
  // kBarTurn + w is w's turn), so one's elementwise work overlaps the
  // other's products; both issue the same number of batches, and the second
  // warpgroup hands the first its turn once before its first batch and not
  // after its last
  int batches = 0;
  for (int j = 0; j < nT; ++j) batches += 2 * (nT - j) + 1;
  if (c > 0) batches += nT;
  auto my_turn = [&]() {
    hopper::bar_sync(kBarTurn + w, 256);
  };
  auto your_turn = [&]() {
    if (w == 0 || --batches > 0)
      hopper::bar_arrive(kBarTurn + 1 - w, 256);
  };
  if (w == 1) hopper::bar_arrive(kBarTurn, 256);
  auto qrelease = [&](int s) {
    hopper::fence_proxy_async();
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(qempty + s);
  };
  // dq^T of query tile i, this warpgroup's half: 16 floats of this thread
  auto dq_at = [&](int i, int e) {
    return dqs + ((i * 2 + w) * 16 + e) * 128 + lt;
  };

  for (int j = 0; j < nT; ++j) {
    hopper::mbar_wait(kfull, kv & 1);
    hopper::mbar_wait(vfull, kv & 1);
    float dk[32], dv[32], csum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int e = 0; e < 32; ++e) dk[e] = dv[e] = 0.0f;
    const float cs0 = cum[64 * j + 16 * warp + g];
    const float cs1 = cum[64 * j + 16 * warp + g + 8];
    for (int i = j; i < nT; ++i, ++z) {
      const int s = z & 1;
      hopper::mbar_wait(qfull + s, (z >> 1) & 1);
      hopper::mbar_wait(pfull + s, (z >> 1) & 1);
      const uint32_t sq = qslot(s) + w * kHalfB;      // q_i's half
      const uint32_t sy = qslot(s) + kTileB + w * kHalfB;   // dy_i's half
      // S^T = k_j q_i^T and dP^T = v_j dy_i^T over this half's 32 queries
      float sT[16], dpT[16];
      my_turn();
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hopper::Wgmma<32>::ss<0, 0>(sT, kdesc(sK, kk), kdesc(sq, kk), kk > 0);
      issue_six<32>(dpT, sV, sy, false);
      hopper::wgmma_commit();
      your_turn();
      hopper::wgmma_wait<0>();
      hopper::fence_operands(sT);
      hopper::fence_operands(dpT);
      // W^T, dA^T masked to s <= t < L; ww = dP W where the exponent is in
      // the clip: its row sums (per key) and column sums (per query)
      float colp[8];
#pragma unroll
      for (int jb = 0; jb < 4; ++jb)
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int tl = 64 * i + 32 * w + 8 * jb + 2 * q4 + cc;
          const float ctv = cum[tl];
          colp[2 * jb + cc] = 0.0f;
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int sl = 64 * j + 16 * warp + g + 8 * hr;
            const int e = 4 * jb + 2 * hr + cc;
            const float x = ctv - (hr ? cs1 : cs0);
            const bool ok = tl >= sl && tl < L;
            const float d = exp_clip(x);
            const float wv = ok ? sT[e] * d : 0.0f;
            const float da = ok ? dpT[e] * d : 0.0f;
            const float ww = ok ? dpT[e] * wv * in_clip(x) : 0.0f;
            sT[e] = wv;
            dpT[e] = da;
            csum[hr] += ww;
            colp[2 * jb + cc] += ww;
          }
        }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
#pragma unroll
        for (int o = 4; o < 32; o <<= 1)
          colp[e] += __shfl_xor_sync(0xffffffffu, colp[e], o);
      }
      if (g == 0) {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          rsum[warp * Qp + 64 * i + 32 * w + 8 * (e >> 1) + 2 * q4 + (e & 1)] +=
              colp[e];
      }
      // dA^T's and W^T's parts as A fragments (keys 16 kk .. of the half:
      // the accumulators' n8 blocks 2 kk and 2 kk + 1), dA's parts also
      // into shared memory as 32 rows of queries by 64 keys
      uint32_t fa[3][2][4], fw[3][2][4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = 8 * kk + 2 * e;
          split3(dpT[x], dpT[x + 1], fa[0][kk][e], fa[1][kk][e], fa[2][kk][e]);
          split3(sT[x], sT[x + 1], fw[0][kk][e], fw[1][kk][e], fw[2][kk][e]);
          // element x: row 16 warp + g + 8 (e & 1), column 8 (2 kk + e / 2)
          // + 2 q4 (+ 1)
          const int sl = 16 * warp + g + 8 * (e & 1);
          const int tl = 8 * (2 * kk + (e >> 1)) + 2 * q4;
#pragma unroll
          for (int p = 0; p < 3; ++p) {
            const uint32_t v2 = fa[p][kk][e];
            unsigned char* dst = dAg + p * kHalfB;
            *reinterpret_cast<unsigned short*>(dst + swz(tl, sl)) =
                static_cast<unsigned short>(v2 & 0xffffu);
            *reinterpret_cast<unsigned short*>(dst + swz(tl + 1, sl)) =
                static_cast<unsigned short>(v2 >> 16);
          }
        }
      // dk_j += dA^T q_i (three parts), dv_j += W^T dy_i (six part pairs)
      // and dq_i^T (n x t) += k_j^T dA^T from the parts just stored
      hopper::fence_proxy_async();
      hopper::bar_sync(kBarWg + w, 128);
      float dq[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) dq[e] = j > 0 ? *dq_at(i, e) : 0.0f;
      hopper::fence_operands(dq);
      hopper::fence_operands(dk);
      hopper::fence_operands(dv);
#pragma unroll
      for (int p = 0; p < 3; ++p)
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          hopper::fence_operands(fa[p][kk]);
          hopper::fence_operands(fw[p][kk]);
        }
      my_turn();
      hopper::wgmma_fence();
#pragma unroll
      for (int p = 2; p >= 0; --p)
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
          hopper::Wgmma<64>::rs<1>(dk, fa[p][kk], mdesc(sq, kk), 1);
#pragma unroll
      for (int x = 0; x < 6; ++x)
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
          hopper::Wgmma<64>::rs<1>(dv, fw[pair_a(x)][kk],
                                   mdesc(sy + pair_b(x) * kTileB, kk), 1);
#pragma unroll
      for (int p = 2; p >= 0; --p)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hopper::Wgmma<32>::ss<1, 0>(dq, mdesc(sK, kk),
                                      kdesc(dAw + p * kHalfB, kk), 1);
      hopper::wgmma_commit();
      your_turn();
      hopper::wgmma_wait<0>();
      hopper::fence_operands(dq);
      hopper::fence_operands(dk);
      hopper::fence_operands(dv);
#pragma unroll
      for (int p = 0; p < 3; ++p)
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          hopper::fence_operands(fa[p][kk]);
          hopper::fence_operands(fw[p][kk]);
        }
#pragma unroll
      for (int e = 0; e < 16; ++e) *dq_at(i, e) = dq[e];
      qrelease(s);
    }

    // -- key tile j's state terms and the halves' partial sums -------------
    {
      const int s = z & 1;
      hopper::mbar_wait(qfull + s, (z >> 1) & 1);
      hopper::mbar_wait(pfull + s, (z >> 1) & 1);
      const uint32_t sd = qslot(s) + kTileB;          // dh_out's parts
      float gx[32];                    // w 0: v_j dh_out^T; w 1: k_j dh_out
      my_turn();
      hopper::wgmma_fence();
      if (w == 0) {
        issue_six<64>(gx, sV, sd, false);
      } else {
#pragma unroll
        for (int p = 2; p >= 0; --p)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            hopper::Wgmma<64>::ss<0, 1>(gx, kdesc(sK, kk),
                                        mdesc(sd + p * kTileB, kk),
                                        p < 2 || kk > 0);
      }
      hopper::wgmma_commit();
      your_turn();
      hopper::wgmma_wait<0>();
      hopper::fence_operands(gx);
      const int sl0 = 64 * j + 16 * warp + g;
      const float e0 = es[sl0], e1 = es[sl0 + 8];
      if (w == 0) {                    // the state terms of dcum
        const unsigned char* kt = base + lay.k;
        float r0 = 0.0f, r1 = 0.0f;
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int n = 8 * (e >> 2) + 2 * q4 + (e & 1);
          const int sl = 16 * warp + g + 8 * ((e >> 1) & 1);
          const float kg = tile_bf16(kt, sl, n) * gx[e];
          if ((e >> 1) & 1)
            r1 += kg;
          else
            r0 += kg;
        }
#pragma unroll
        for (int o = 1; o < 4; o <<= 1) {
          r0 += __shfl_xor_sync(0xffffffffu, r0, o);
          r1 += __shfl_xor_sync(0xffffffffu, r1, o);
        }
        if (q4 == 0) {
          stt[sl0] = e0 * in_clip(tot - cum[sl0]) * r0;
          stt[sl0 + 8] = e1 * in_clip(tot - cum[sl0 + 8]) * r1;
        }
      }
#pragma unroll
      for (int e = 0; e < 32; ++e) gx[e] *= (e >> 1) & 1 ? e1 : e0;
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(kvempty);   // k_j, v_j are free
      ++kv;
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        csum[0] += __shfl_xor_sync(0xffffffffu, csum[0], o);
        csum[1] += __shfl_xor_sync(0xffffffffu, csum[1], o);
      }
      // the slot's parts are read: exchange the partials through it
      hopper::bar_sync(kBarConsumers, 256);
      float* x1 = reinterpret_cast<float*>(base + lay.q + s * kQSlotB);
      float* x0 = x1 + 32 * 128;
      float* mine = w == 0 ? x0 : x1;
      float* theirs = w == 0 ? x1 : x0;
#pragma unroll
      for (int e = 0; e < 32; ++e) mine[e * 128 + lt] = w == 0 ? dv[e] : dk[e];
      if (w == 1 && q4 == 0) {
        csum1[16 * warp + g] = csum[0];
        csum1[16 * warp + g + 8] = csum[1];
      }
      hopper::bar_sync(kBarConsumers, 256);
      // w 0 writes dk_j, w 1 dv_j: the two halves in order, then the state
      // term
      float out[32];
#pragma unroll
      for (int e = 0; e < 32; ++e)
        out[e] = w == 0 ? (dk[e] + theirs[e * 128 + lt]) + gx[e]
                        : (theirs[e * 128 + lt] + dv[e]) + gx[e];
      if (w == 0 && q4 == 0) {
        colsum[sl0] = csum[0] + csum1[16 * warp + g];
        colsum[sl0 + 8] = csum[1] + csum1[16 * warp + g + 8];
      }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int sl = sl0 + 8 * hr;
        if (sl >= L) continue;
        const long long row = static_cast<long long>(bh) * a.S + c0 + sl;
#pragma unroll
        for (int jb = 0; jb < 8; ++jb) {
          const int n = 8 * jb + 2 * q4;
          const float x = out[4 * jb + 2 * hr], y = out[4 * jb + 2 * hr + 1];
          if (w == 0) {
            *reinterpret_cast<__nv_bfloat162*>(a.dko + row * 64 + n) =
                __floats2bfloat162_rn(x, y);
          } else if (a.v_bf) {
            *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(a.dv) +
                                               row * 64 + n) =
                __floats2bfloat162_rn(x, y);
          } else {
            *reinterpret_cast<float2*>(static_cast<float*>(a.dv) + row * 64 +
                                       n) = make_float2(x, y);
          }
        }
      }
      qrelease(s);
      ++z;
    }
  }

  // -- per query tile: e^cum dy h_in^T completes dq, written once -----------
  // (and <h_in, dh_out>'s operands, loaded first, summed after)
  float hv[16], dv2[16];
  const size_t NP = 64 * 64;
  if (c > 0) {
    const float* hi = a.hs + (static_cast<size_t>(c) * BH + bh) * NP;
    const float* di = a.ds + (static_cast<size_t>(c) * BH + bh) * NP;
#pragma unroll
    for (int x = 0; x < 16; ++x) {
      hv[x] = __ldcg(hi + ct + 256 * x);
      dv2[x] = __ldcg(di + ct + 256 * x);
    }
  }
  if (c > 0) {
    hopper::mbar_wait(kfull, kv & 1);
    hopper::mbar_wait(vfull, kv & 1);
  }
  unsigned char* stage = dAg;          // dq's bf16 rows, 32 x 128 bytes
  for (int i = 0; i < nT; ++i) {
    float dq[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) dq[e] = *dq_at(i, e);
    if (c > 0) {
      const int s = z & 1;
      hopper::mbar_wait(qfull + s, (z >> 1) & 1);
      hopper::mbar_wait(pfull + s, (z >> 1) & 1);
      const uint32_t sy = qslot(s) + kTileB + w * kHalfB;
      float gq[16];                    // (dy h_in^T)^T over the half
      my_turn();
      hopper::wgmma_fence();
      issue_six<32>(gq, sV, sy, false);
      hopper::wgmma_commit();
      your_turn();
      hopper::wgmma_wait<0>();
      hopper::fence_operands(gq);
      // the inter term of dcum: e^cum_t <q_t, gq_t>, column sums
      const unsigned char* qt = base + lay.q + s * kQSlotB;
      float colp[8];
#pragma unroll
      for (int jb = 0; jb < 4; ++jb)
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int tr = 32 * w + 8 * jb + 2 * q4 + cc;
          const int tl = 64 * i + tr;
          float sum = 0.0f;
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int n = 16 * warp + g + 8 * hr;
            const int e = 4 * jb + 2 * hr + cc;
            sum += tile_bf16(qt, tr, n) * gq[e];
            dq[e] = fmaf(et[tl], gq[e], dq[e]);
          }
          colp[2 * jb + cc] = sum;
        }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
#pragma unroll
        for (int o = 4; o < 32; o <<= 1)
          colp[e] += __shfl_xor_sync(0xffffffffu, colp[e], o);
      }
      if (g == 0) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int tl = 64 * i + 32 * w + 8 * (e >> 1) + 2 * q4 + (e & 1);
          rsum[warp * Qp + tl] += et[tl] * in_clip(cum[tl]) * colp[e];
        }
      }
      qrelease(s);
      ++z;
    }
    // dq^T's half (n x 32 t) as bf16 rows of t, then 16-byte stores
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int n = 16 * warp + g + 8 * ((e >> 1) & 1);
      const int tr = 8 * (e >> 2) + 2 * q4 + (e & 1);
      *reinterpret_cast<bf16*>(stage + tr * 128 + n * 2) =
          __float2bfloat16_rn(dq[e]);
    }
    hopper::bar_sync(kBarWg + w, 128);
    {
      const int r = lt >> 2, tl = 64 * i + 32 * w + r;
      if (tl < L) {
        const uint4* src =
            reinterpret_cast<const uint4*>(stage + r * 128 + (lt & 3) * 32);
        uint4* dst = reinterpret_cast<uint4*>(a.dqo + (row0 + tl) * 64 +
                                              (lt & 3) * 16);
        dst[0] = src[0];
        dst[1] = src[1];
      }
    }
    hopper::bar_sync(kBarWg + w, 128);
  }

  // -- dcum, and dlog_a its reverse cumsum in the chunk ---------------------
  float dot = 0.0f;
  if (c > 0) {
#pragma unroll
    for (int x = 0; x < 16; ++x) dot = fmaf(hv[x], dv2[x], dot);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
  if (lane == 0) red[ct / 32] = dot;
  hopper::bar_sync(kBarConsumers, 256);
  if (ct >= 32) return;
  const int ln = ct;
  float extra = 0.0f;
  for (int t = ln; t < L; t += 32) extra += stt[t];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    extra += __shfl_xor_sync(0xffffffffu, extra, o);
  float dsum = 0.0f;
  for (int x = 0; x < 8; ++x) dsum += red[x];
  extra += exp_clip(tot) * in_clip(tot) * dsum;
  float carry = 0.0f;
  for (int t0 = (L - 1) / 32 * 32; t0 >= 0; t0 -= 32) {
    const int t = t0 + ln;
    float v = 0.0f;
    if (t < L) {
      v = ((rsum[t] + rsum[Qp + t]) + (rsum[2 * Qp + t] + rsum[3 * Qp + t])) -
          colsum[t] - stt[t];
      if (t == L - 1) v += extra;
    }
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_down_sync(0xffffffffu, v, o);
      if (ln + o < 32) v += y;
    }
    v += carry;
    if (t < L) {
      if (a.la_bf)
        static_cast<bf16*>(a.dla)[row0 + t] = __float2bfloat16_rn(v);
      else
        static_cast<float*>(a.dla)[row0 + t] = v;
    }
    carry = __shfl_sync(0xffffffffu, v, 0);
  }
}

// ---------------------------------------------------------------------------
// ssd_bwd_wg_group: each group's dq and dk from its heads' bf16 gradients
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(256)
ssd_bwd_wg_group(const bf16* __restrict__ dqh, const bf16* __restrict__ dkh,
                 bf16* __restrict__ dq, bf16* __restrict__ dk, int B, int H,
                 int G, int S) {
  const long long per = static_cast<long long>(B) * G * S * 8;   // octets
  const long long e = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (e >= 2 * per) return;
  const bool is_k = e >= per;
  const long long x = is_k ? e - per : e;   // octet of (b, g, s, 8 n)
  const long long sn = static_cast<long long>(S) * 8;
  const long long bg = x / sn, r = x % sn;
  const int rep = H / G;
  const long long h0 = (bg / G) * H + (bg % G) * rep;
  const uint4* src = reinterpret_cast<const uint4*>(is_k ? dkh : dqh);
  float sum[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) sum[k] = 0.0f;
  for (int i = 0; i < rep; ++i) {
    const uint4 u = src[(h0 + i) * sn + r];
    const __nv_bfloat162* hv = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(hv[k]);
      sum[2 * k] += f.x;
      sum[2 * k + 1] += f.y;
    }
  }
  uint4 o;
  uint32_t* op = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    op[k] = u32(__floats2bfloat162_rn(sum[2 * k], sum[2 * k + 1]));
  reinterpret_cast<uint4*>(is_k ? dk : dq)[x] = o;
}

cudaError_t raise_smem(const void* kernel, bool* raised) {
  if (*raised) return cudaSuccess;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err == cudaSuccess) *raised = true;
  return err;
}

}  // namespace

extern "C" {

// the chunk kernel's dynamic shared memory at chunk Q (the larger of the
// two kernels'; kernels/ssd_scan.py:bwd_wgmma_smem)
long long ssd_scan_bwd_wgmma_smem(int Q) {
  const int a = chunk_smem(Q), b = chain_smem(Q);
  return a > b ? a : b;
}

// bf16 q, k (B,G,S,64), 16-byte aligned; v (B,H,S,64) and la (B,H,S)
// contiguous, v 16-byte aligned; gy (B,H,S,64) at element strides gy_st
// (gy_st[3] = 1, the others multiples of 16 bytes, 16-byte aligned); gs
// (B,H,64,64) fp32 at strides gs_st, or null (zero).  dq, dk (B,G,S,64)
// bf16, dv of v's type, dla of la's type, contiguous.  ws: fp32 workspace of
// ssd_scan.py's bwd_workspace(..., "wgmma") words: h_in and dh_out slots
// (nc, B*H, 64, 64) each, at G < H the heads' bf16 dq and dk (B,H,S,64)
// each.  *_bf: 1 for
// bfloat16, 0 for float32.
int ssd_scan_bwd_wgmma_launch(const void* q, const void* k, const void* v,
                              const void* la, const void* gy, const void* gs,
                              void* dq, void* dk, void* dv, void* dla,
                              void* ws, const long long* gy_st,
                              const long long* gs_st, int B, int H, int G,
                              int S, int Q, int v_bf, int la_bf, int gy_bf,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args a;
  a.B = B;
  a.H = H;
  a.G = G;
  a.S = S;
  a.Q = Q;
  a.nc = (S + Q - 1) / Q;
  a.Qp = (Q + 63) / 64 * 64;
  a.v_bf = v_bf;
  a.la_bf = la_bf;
  a.gy_bf = gy_bf;
  a.la = la;
  a.gs = static_cast<const float*>(gs);
  for (int i = 0; i < 4; ++i) a.gs_st[i] = gs != nullptr ? gs_st[i] : 0;
  const long long BH = static_cast<long long>(B) * H;
  const long long slots = a.nc * BH * 64 * 64;
  float* w = static_cast<float*>(ws);
  a.hs = w;
  a.ds = w + slots;
  float* heads = a.ds + slots;
  const long long hw = G != H ? BH * S * 64 : 0;   // bf16 pairs: two tensors
  a.dqo = G != H ? reinterpret_cast<bf16*>(heads) : static_cast<bf16*>(dq);
  a.dko = G != H ? reinterpret_cast<bf16*>(heads) + BH * S * 64
                 : static_cast<bf16*>(dk);
  a.dv = dv;
  a.dla = dla;

  static bool raised_chain = false, raised_chunk = false;
  cudaError_t err = raise_smem(reinterpret_cast<const void*>(ssd_bwd_wg_chain),
                               &raised_chain);
  if (err == cudaSuccess)
    err = raise_smem(reinterpret_cast<const void*>(ssd_bwd_wg_chunk),
                     &raised_chunk);
  if (err != cudaSuccess) return static_cast<int>(err);

  const CUtensorMapDataType tb = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUtensorMapDataType tf = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const uint64_t bg = static_cast<uint64_t>(B) * G;
  CUtensorMap tq, tk, tv, tg, ths, tds;
  int e = hopper::encode_3d(&tq, tb, 2, q, 64, S, bg, 64, 64, 128);
  if (e == 0) e = hopper::encode_3d(&tk, tb, 2, k, 64, S, bg, 64, 64, 128);
  if (e == 0)
    e = hopper::encode_3d(&tv, v_bf ? tb : tf, v_bf ? 2 : 4, v, 64, S, BH, 64,
                          32, 0);
  if (e == 0) {
    const uint64_t eb = gy_bf ? 2 : 4;
    const uint64_t dims[4] = {64, static_cast<uint64_t>(S),
                              static_cast<uint64_t>(H),
                              static_cast<uint64_t>(B)};
    const uint64_t strides[3] = {gy_st[2] * eb, gy_st[1] * eb, gy_st[0] * eb};
    const uint32_t box[4] = {64, 32, 1, 1};
    e = hopper::encode_strided(&tg, gy_bf ? tb : tf, 4, gy, dims, strides, box,
                               0);
  }
  if (e == 0)
    e = hopper::encode_3d(&ths, tf, 4, a.hs, 64, 64, a.nc * BH, 64, 32, 0);
  if (e == 0)
    e = hopper::encode_3d(&tds, tf, 4, a.ds, 64, 64, a.nc * BH, 64, 32, 0);
  if (e != 0) return e;

  ssd_bwd_wg_chain<<<static_cast<unsigned>(2 * BH), kChainThreads,
                     chain_smem(Q), st>>>(tq, tk, tv, tg, a);
  ssd_bwd_wg_chunk<<<static_cast<unsigned>(a.nc * BH), kChunkThreads,
                     chunk_smem(Q), st>>>(tq, tk, tv, tg, ths, tds, a);
  if (G != H) {
    const long long octets = 2 * static_cast<long long>(B) * G * S * 8;
    ssd_bwd_wg_group<<<static_cast<unsigned>((octets + 255) / 256), 256, 0,
                       st>>>(a.dqo, a.dko, static_cast<bf16*>(dq),
                             static_cast<bf16*>(dk), B, H, G, S);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
