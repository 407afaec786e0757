// Chunked gated linear recurrence (SSD / Mamba2 / mLSTM core), backward, as
// CUDA kernels for sm_90a.
//
// The gradient of ssd_scan.cu's forward.  The TPU reference has no backward
// kernel: src/repro/kernels/ops.py:_ssd_bwd_rule takes jax.vjp of
// ref.ssd_scan_ref, and the models differentiate chunked_gla
// (src/repro/models/ssm.py), which XLA compiles into fused loops.  These
// kernels compute that same function (the plain version is
// kernels/ssd_scan.py:ssd_scan_bwd_plain, which follows the same
// decomposition), fp32 throughout, every exponent clipped to [-60, 0] as the
// forward clips it and passing no gradient where it is clipped.  Per chunk of
// Q steps, cum the inclusive cumsum of log_a, tot its last value, h_in the
// state entering the chunk and dh_out the gradient of the state leaving it;
// A = (q k^T) masked to s <= t, D_ts = e^(cum_t - cum_s), W = A D and
// dW = (dy v^T) masked:
//
//   dh_in = e^tot dh_out + (diag(e^cum) q)^T dy       (the reverse chain)
//   dq    = (dW D) k + diag(e^cum) dy h_in^T
//   dk    = (dW D)^T q + diag(e^(tot - cum)) v dh_out^T
//   dv    = W^T dy + diag(e^(tot - cum)) k dh_out
//   dcum_t = sum_s (dW W)_ts - sum_t' (dW W)_t't + e^cum_t <dy_t, q_t h_in>
//            - e^(tot - cum_t) k_t^T dh_out v_t, and the last step adds
//            sum_s e^(tot - cum_s) k_s^T dh_out v_s + e^tot <h_in, dh_out>
//   dlog_a = the reverse cumsum of dcum within the chunk.
//
// Four kernels on the caller's stream, one call of the host launcher:
//
//   ssd_bwd_states  a block per (b, h, chunk, 64 n x 64 p tile): the chunk's
//                   state increment sum_s e^(tot - cum_s) k_s v_s^T (the
//                   forward's, so the states are recomputed and the forward
//                   keeps none) and the reverse chain's sum_t e^cum_t q_t
//                   dy_t^T, into two (chunks, B*H, N, P) buffers, and each
//                   chunk's tot;
//   ssd_bwd_chain   a block per (b, h, 1024 state elements): both chains in
//                   place, the forward one leaving h_in and the reverse one
//                   (from the final state's cotangent) dh_out in every
//                   chunk's slot, and each chunk's e^tot <h_in, dh_out> over
//                   the block's elements;
//   ssd_bwd_chunk   a block per (b, h, chunk, 64-column slab): over key tiles
//                   j of 64 steps, and for each over query tiles i >= j, the
//                   64 x 64 tiles S_ij = q_i k_j^T and dP_ij = dy_i v_j^T
//                   (over every n and p slab, so N and P of any size hold in
//                   registers a 64 x 64 accumulator each; a slab's block
//                   computes them again), W_ij and dA_ij; dk_j and dv_j on
//                   the slab's columns accumulate in registers, dq_i's are
//                   added in order of j into a per-head fp32 dq that only
//                   this block touches; then the state terms of each key
//                   tile, and the inter term of each query tile;
//   ssd_bwd_finish  a block per (b, h, chunk) adds the partial sums into dcum
//                   and writes dlog_a, and at G < H further blocks sum each
//                   group's heads of dq and dk, in order, in fp32: each
//                   head's gradient rounded to q's type first, as autograd
//                   rounds it where q is widened for each head, the sum
//                   rounded once more.
//
// Nothing is added across blocks by atomics and every sum runs in a fixed
// order, so the gradients are the same bits from run to run (training
// replays its steps bit for bit).
//
// Products.  Every 64 x 64 product runs on the tensor cores as mma.sync
// m16n8k8 tf32, from fp32 tiles in shared memory (64 rows, 68 floats a row,
// so a fragment's row-major reads fall on 32 banks).  An fp32 operand is
// split into tf32 hi = rna(x) and lo = rna(x - hi), and a_lo b_hi + a_hi b_lo
// + a_hi b_hi keeps fp32 accuracy (3xTF32, the lo lo term ~2^-22 of the
// product); a bf16 operand is exact in tf32 and needs no lo part, so a
// product with one takes two mma, and the bf16 scores one.
//
// Bound on an H100: operations.  At Zamba2's training shape (B4 H64 S2048
// N = P = 64, chunk 256, bf16 q/k, fp32 v, dy and log_a) the causal halves
// of the five Q x Q products (S, dP, dq, dk and dv's W^T dy) and the five
// (Q, N) x (N, P)-sized products per chunk are ~65 GFLOP, ~0.29 ms of tensor
// core time at the types' rates (kernels/ssd_scan.py:work_backward), against
// ~0.42 GB moved (~0.12 ms).  The design spends more: the diagonal tiles
// compute their masked half, the fragments are read from shared memory as
// scalars and split in registers, and the tiles are loaded between
// barriers without a pipeline (PERF.md gives its time beside the bound).
//
// The launcher takes PyTorch's current stream, allocates nothing and returns
// cudaGetLastError() after the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;           // 8 warps: 4 row groups x 2 halves
constexpr int kT = 64;                  // tile edge
constexpr int kLd = kT + 4;             // a tile row in shared memory
constexpr int kTile = kT * kLd;         // floats of one tile
constexpr int kChainElems = 4 * kThreads;  // state elements a chain block owns

struct Args {
  const void *q, *k, *v, *la, *gy;
  const float* gs;                      // the final state's cotangent, or null
  int qk_bf, v_bf, la_bf, gy_bf;        // 1: bfloat16, 0: float32
  long long gy_st[4], gs_st[4];         // strides (elements) of gy and gs
  int B, H, G, S, N, P, Q, Qp, nc, nNs, nPs, nKV, R, splits;
  float *hb, *db;   // (nc, B*H, N, P): increments, then h_in and dh_out
  float* part;      // (B*H, S, R): rows' and columns' sums, inter, state
  float* dots;      // (B*H, nc, splits): e^tot <h_in, dh_out>, by blocks
  float* tots;      // (B*H, nc): each chunk's tot
  float *dqh, *dkh; // (B, H, S, N) fp32 per head: dq's sums (and dk at
                    // G < H, else null)
  void *dq, *dk, *dv, *dla;
};

__device__ __forceinline__ float ld(const void* p, int bf, long long i) {
  return bf ? __bfloat162float(static_cast<const bf16*>(p)[i])
            : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void st(void* p, int bf, long long i, float x) {
  if (bf)
    static_cast<bf16*>(p)[i] = __float2bfloat16(x);
  else
    static_cast<float*>(p)[i] = x;
}

// exp of an exponent clipped to [-60, 0], and whether its gradient passes
// (inside the clip, its ends included, as torch.clamp's passes)
__device__ __forceinline__ float exp_clip(float x) {
  return __expf(fminf(fmaxf(x, -60.0f), 0.0f));
}
__device__ __forceinline__ float in_clip(float x) {
  return (x >= -60.0f && x <= 0.0f) ? 1.0f : 0.0f;
}

// c += a (16x8 tf32, row) * b (8x8 tf32, col), fp32 accumulate
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A warp's part of a 64 x 64 tile: rows m0 + g (+ 8), columns n0 + 8 j +
// 2 t4 (+ 1); acc[j][e] is row m0 + g + 8 (e / 2), column n0 + 8 j + 2 t4 +
// e % 2.
struct Frag {
  int g, t4, m0, n0;
  __device__ Frag() {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    g = lane >> 2;
    t4 = lane & 3;
    m0 = (w & 3) * 16;
    n0 = (w >> 2) * 32;
  }
  __device__ int row(int e) const { return m0 + g + 8 * (e >> 1); }
  __device__ int col(int j, int e) const { return n0 + 8 * j + 2 * t4 + (e & 1); }
};

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
}

// an fp32 operand's tf32 hi and lo parts; a bf16 value is exact in tf32
// and is its own hi part
template <bool EXACT>
__device__ __forceinline__ void parts(float x, uint32_t& hi, uint32_t& lo) {
  if (EXACT) {
    hi = __float_as_uint(x);
  } else {
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
    const float r = x - __uint_as_float(hi);
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(r));
  }
}

// acc += A B over the 64-deep contraction, A(m, k) = a[m * am + k * ak] and
// B(k, n) = b[k * bk + n * bn] in shared memory; an exact operand (bf16 at
// the source) takes no lo part.  The lo products go first.
template <bool AX, bool BX>
__device__ __forceinline__ void mma64_(float (&acc)[4][4], const float* a,
                                       int am, int ak, const float* b, int bk,
                                       int bn) {
  const Frag f;
#pragma unroll 2
  for (int k0 = 0; k0 < kT; k0 += 8) {
    uint32_t ah[4], al[4];
    const int ka = k0 + f.t4;
    parts<AX>(a[(f.m0 + f.g) * am + ka * ak], ah[0], al[0]);
    parts<AX>(a[(f.m0 + f.g + 8) * am + ka * ak], ah[1], al[1]);
    parts<AX>(a[(f.m0 + f.g) * am + (ka + 4) * ak], ah[2], al[2]);
    parts<AX>(a[(f.m0 + f.g + 8) * am + (ka + 4) * ak], ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = f.n0 + 8 * j + f.g;
      uint32_t bh0, bl0, bh1, bl1;
      parts<BX>(b[ka * bk + n * bn], bh0, bl0);
      parts<BX>(b[(ka + 4) * bk + n * bn], bh1, bl1);
      if (!AX) mma(acc[j], al, bh0, bh1);
      if (!BX) mma(acc[j], ah, bl0, bl1);
      mma(acc[j], ah, bh0, bh1);
    }
  }
}

__device__ __forceinline__ void mma64(float (&acc)[4][4], const float* a,
                                      int am, int ak, const float* b, int bk,
                                      int bn, bool a_exact, bool b_exact) {
  if (a_exact && b_exact)
    mma64_<true, true>(acc, a, am, ak, b, bk, bn);
  else if (a_exact)
    mma64_<true, false>(acc, a, am, ak, b, bk, bn);
  else if (b_exact)
    mma64_<false, true>(acc, a, am, ak, b, bk, bn);
  else
    mma64_<false, false>(acc, a, am, ak, b, bk, bn);
}

// dst[r][c] = src[base + r rs + c cs] (times scale[r] where scale is given)
// for r < rows, c < cols, else 0.  Whole rows of 64 contiguous values at
// 16-byte aligned addresses load as 16-byte vectors, every load of a thread
// issued before its first store.
__device__ __forceinline__ void load_tile(float* dst, const void* src, int bf,
                                          long long base, long long rs,
                                          long long cs, int rows, int cols,
                                          const float* scale = nullptr) {
  const int per = bf ? 8 : 4;             // values in 16 bytes
  const bool vec =
      cs == 1 && cols == kT && rs % per == 0 && base % per == 0 &&
      reinterpret_cast<uintptr_t>(src) % 16 == 0;
  if (vec && bf) {
    const bf16* p = static_cast<const bf16*>(src) + base;
    uint4 raw[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int e = threadIdx.x + i * kThreads, r = e >> 3;
      raw[i] = r < rows ? *reinterpret_cast<const uint4*>(p + r * rs +
                                                          (e & 7) * 8)
                        : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int e = threadIdx.x + i * kThreads, r = e >> 3;
      const float sc = scale != nullptr && r < rows ? scale[r] : 1.0f;
      const __nv_bfloat162* h =
          reinterpret_cast<const __nv_bfloat162*>(&raw[i]);
      float4* d = reinterpret_cast<float4*>(dst + r * kLd + (e & 7) * 8);
      const float2 x0 = __bfloat1622float2(h[0]), x1 = __bfloat1622float2(h[1]);
      const float2 x2 = __bfloat1622float2(h[2]), x3 = __bfloat1622float2(h[3]);
      d[0] = make_float4(x0.x * sc, x0.y * sc, x1.x * sc, x1.y * sc);
      d[1] = make_float4(x2.x * sc, x2.y * sc, x3.x * sc, x3.y * sc);
    }
    return;
  }
  if (vec) {
    const float* p = static_cast<const float*>(src) + base;
    float4 raw[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = threadIdx.x + i * kThreads, r = e >> 4;
      raw[i] = r < rows ? *reinterpret_cast<const float4*>(p + r * rs +
                                                           (e & 15) * 4)
                        : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = threadIdx.x + i * kThreads, r = e >> 4;
      const float sc = scale != nullptr && r < rows ? scale[r] : 1.0f;
      *reinterpret_cast<float4*>(dst + r * kLd + (e & 15) * 4) = make_float4(
          raw[i].x * sc, raw[i].y * sc, raw[i].z * sc, raw[i].w * sc);
    }
    return;
  }
#pragma unroll 4
  for (int e = threadIdx.x; e < kT * kT; e += kThreads) {
    const int r = e / kT, c = e % kT;
    float x = 0.0f;
    if (r < rows && c < cols) {
      x = ld(src, bf, base + r * rs + c * cs);
      if (scale != nullptr) x *= scale[r];
    }
    dst[r * kLd + c] = x;
  }
}

// A staging tile and what it holds (block-uniform), so a tile the block
// already holds is not loaded again
struct Stage {
  float* buf;
  int tag;
  __device__ bool take(int want) {
    if (tag == want) return false;
    tag = want;
    return true;
  }
};
__device__ __forceinline__ int tag_of(int tensor, int tile, int slab) {
  return (tensor << 24) | (tile << 12) | slab;
}
enum { kQ = 1, kK, kDY, kV, kH };

// cum[t] = the inclusive cumsum of log_a over the chunk's steps (0 past its
// valid ones), t < Qp (Q rounded up to whole 64-row tiles, whose rows past Q
// keep the last sum): warp 0, 32 steps at a time in order; the same
// arithmetic in every kernel, so all see the same cum.  The caller syncs.
__device__ __forceinline__ void chunk_cum(float* cum, const Args& a,
                                          long long base, int valid) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  float carry = 0.0f;
  for (int t0 = 0; t0 < a.Qp; t0 += 32) {
    const int t = t0 + lane;
    float x = t < valid ? ld(a.la, a.la_bf, base + t) : 0.0f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    x += carry;
    cum[t] = x;
    carry = __shfl_sync(0xffffffffu, x, 31);
  }
}

// sum over the warp's 32 columns of each of its two rows, into
// red[half][row] (half = the warp's column half); the caller syncs
__device__ __forceinline__ void row_sums(const float (&x)[4][4], float* red) {
  const Frag f;
  float r0 = 0.0f, r1 = 0.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    r0 += x[j][0] + x[j][1];
    r1 += x[j][2] + x[j][3];
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    r0 += __shfl_xor_sync(0xffffffffu, r0, o);
    r1 += __shfl_xor_sync(0xffffffffu, r1, o);
  }
  if (f.t4 == 0) {
    red[(f.n0 / 32) * kT + f.m0 + f.g] = r0;
    red[(f.n0 / 32) * kT + f.m0 + f.g + 8] = r1;
  }
}

// sum over the warp's 16 rows of each of its columns, into
// red[row group][column]; the caller syncs
__device__ __forceinline__ void col_sums(const float (&x)[4][4], float* red) {
  const Frag f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float c0 = x[j][0] + x[j][2], c1 = x[j][1] + x[j][3];
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      c0 += __shfl_xor_sync(0xffffffffu, c0, o);
      c1 += __shfl_xor_sync(0xffffffffu, c1, o);
    }
    if (f.g == 0) {
      red[(f.m0 / 16) * kT + f.n0 + 8 * j + 2 * f.t4] = c0;
      red[(f.m0 / 16) * kT + f.n0 + 8 * j + 2 * f.t4 + 1] = c1;
    }
  }
}

// acc's rows < rows and columns < cols to out[base + r rs + c] (type bf)
__device__ __forceinline__ void store_tile(const float (&acc)[4][4], void* out,
                                           int bf, long long base,
                                           long long rs, int rows, int cols) {
  const Frag f;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = f.row(e), c = f.col(j, e);
      if (r < rows && c < cols) st(out, bf, base + r * rs + c, acc[j][e]);
    }
}

struct Head {
  int bh, b, h, c, c0, valid;
  long long qk, v, la;   // element offsets of the head's q/k, v, log_a rows
  __device__ Head(const Args& a, int bh_, int c_) : bh(bh_), c(c_) {
    b = bh / a.H;
    h = bh % a.H;
    c0 = c * a.Q;
    valid = min(a.Q, a.S - c0);
    const int grp = h / (a.H / a.G);
    qk = (static_cast<long long>(b) * a.G + grp) * a.S * a.N;
    v = static_cast<long long>(bh) * a.S * a.P;
    la = static_cast<long long>(bh) * a.S;
  }
  __device__ long long qrow(const Args& a, int s) const {   // q, k row s
    return qk + static_cast<long long>(s) * a.N;
  }
  __device__ long long vrow(const Args& a, int s) const {    // v row s
    return v + static_cast<long long>(s) * a.P;
  }
  __device__ long long gy(const Args& a, int s, int p) const {
    return b * a.gy_st[0] + h * a.gy_st[1] + s * a.gy_st[2] + p * a.gy_st[3];
  }
  __device__ long long state(const Args& a) const {   // this chunk's slot
    return (static_cast<long long>(c) * a.B * a.H + bh) * a.N * a.P;
  }
};

// ---------------------------------------------------------------------------
// ssd_bwd_states: the chunk's state increment and the reverse chain's term
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads, 2) ssd_bwd_states(Args a) {
  extern __shared__ float sm[];
  float *sK = sm, *sV = sK + kTile, *sQ = sV + kTile, *sG = sQ + kTile;
  float* cum = sG + kTile;
  float* e_rem = cum + a.Qp;
  float* e_cum = e_rem + a.Q;
  int x = blockIdx.x;
  const int pt = x % a.nPs;
  x /= a.nPs;
  const int nt = x % a.nNs;
  x /= a.nNs;
  const Head hd(a, x / a.nc, x % a.nc);
  const int n0 = nt * kT, p0 = pt * kT;
  const int ncols = min(kT, a.N - n0), pcols = min(kT, a.P - p0);
  chunk_cum(cum, a, hd.la + hd.c0, hd.valid);
  __syncthreads();
  const float tot = cum[a.Q - 1];
  if (nt == 0 && pt == 0 && threadIdx.x == 0)
    a.tots[static_cast<long long>(hd.bh) * a.nc + hd.c] = tot;
  for (int t = threadIdx.x; t < a.Q; t += kThreads) {
    e_rem[t] = exp_clip(tot - cum[t]);
    e_cum[t] = exp_clip(cum[t]);
  }
  float inc[4][4], up[4][4];
  zero(inc);
  zero(up);
  for (int s0 = 0; s0 < hd.valid; s0 += kT) {
    const int rows = min(kT, hd.valid - s0), s = hd.c0 + s0;
    __syncthreads();
    const long long qk = hd.qrow(a, s) + n0;
    load_tile(sK, a.k, a.qk_bf, qk, a.N, 1, rows, ncols);
    load_tile(sQ, a.q, a.qk_bf, qk, a.N, 1, rows, ncols);
    load_tile(sV, a.v, a.v_bf, hd.vrow(a, s) + p0,
              a.P, 1, rows, pcols, e_rem + s0);
    load_tile(sG, a.gy, a.gy_bf, hd.gy(a, s, p0), a.gy_st[2], a.gy_st[3],
              rows, pcols, e_cum + s0);
    __syncthreads();
    // inc(n, p) += sum_s k(s, n) v'(s, p); up(n, p) += sum_t q(t, n) dy'(t, p)
    mma64(inc, sK, 1, kLd, sV, kLd, 1, a.qk_bf, false);
    mma64(up, sQ, 1, kLd, sG, kLd, 1, a.qk_bf, false);
  }
  const long long o = hd.state(a) + static_cast<long long>(n0) * a.P + p0;
  store_tile(inc, a.hb, 0, o, a.P, ncols, pcols);
  store_tile(up, a.db, 0, o, a.P, ncols, pcols);
}

// ---------------------------------------------------------------------------
// ssd_bwd_chain: h_in and dh_out of every chunk, in place
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads) ssd_bwd_chain(Args a) {
  __shared__ float red[kThreads / 32];
  const int split_ = blockIdx.x % a.splits, bh = blockIdx.x / a.splits;
  const long long NP = static_cast<long long>(a.N) * a.P;
  const float* tots = a.tots + static_cast<long long>(bh) * a.nc;
  // chunk c's slot of this head: c * cst (chunk-major, so the blocks of
  // one step of the chain spread over the whole buffer)
  const long long cst = static_cast<long long>(a.B) * a.H * NP;
  float* hb = a.hb + bh * NP;
  float* db = a.db + bh * NP;
  const int b = bh / a.H, h = bh % a.H;
  float hs[4], ds[4], x[4];
  long long el[4];
  bool ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    el[i] = static_cast<long long>(split_) * kChainElems + i * kThreads +
            threadIdx.x;
    ok[i] = el[i] < NP;
    hs[i] = 0.0f;
    ds[i] = 0.0f;
    if (ok[i] && a.gs != nullptr) {
      const long long n = el[i] / a.P, p = el[i] % a.P;
      ds[i] = a.gs[b * a.gs_st[0] + h * a.gs_st[1] + n * a.gs_st[2] +
                   p * a.gs_st[3]];
    }
  }
  // forward: slot c <- h_in = the state entering chunk c
  for (int c = 0; c < a.nc; ++c) {
    const float et = exp_clip(tots[c]);
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = ok[i] ? hb[c * cst + el[i]] : 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (ok[i]) hb[c * cst + el[i]] = hs[i];
      hs[i] = et * hs[i] + x[i];
    }
  }
  // reverse: slot c <- dh_out, and the block's part of <h_in, dh_out>
  for (int c = a.nc - 1; c >= 0; --c) {
    const float et = exp_clip(tots[c]);
    float dot = 0.0f, hi[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[i] = ok[i] ? db[c * cst + el[i]] : 0.0f;
      hi[i] = ok[i] ? hb[c * cst + el[i]] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (ok[i]) db[c * cst + el[i]] = ds[i];
      dot += hi[i] * ds[i];
      ds[i] = et * ds[i] + x[i];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      dot += __shfl_xor_sync(0xffffffffu, dot, o);
    __syncthreads();
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = dot;
    __syncthreads();
    if (threadIdx.x == 0) {
      float sum = 0.0f;
      for (int w = 0; w < kThreads / 32; ++w) sum += red[w];
      a.dots[(static_cast<long long>(bh) * a.nc + c) * a.splits + split_] =
          et * in_clip(tots[c]) * sum;
    }
  }
}

// ---------------------------------------------------------------------------
// ssd_bwd_chunk: dq (query role), dk and dv (key role), the partial sums
// ---------------------------------------------------------------------------
struct Tiles {
  Stage q, k, dy, v;
  float *w, *da, *cum, *red;
};

// S_ij = q_i k_j^T and dP_ij = dy_i v_j^T over every n and p slab; the
// four operands' first slabs load together
__device__ __forceinline__ void scores(const Args& a, const Head& hd,
                                       Tiles& s, int i, int j,
                                       float (&S)[4][4], float (&dP)[4][4]) {
  const int ri = min(kT, hd.valid - i * kT), rj = min(kT, hd.valid - j * kT);
  const int ti = hd.c0 + i * kT, tj = hd.c0 + j * kT;
  zero(S);
  zero(dP);
  const int nlast = a.nNs - 1;
  for (int x = 0; x < a.nNs + a.nPs - 1; ++x) {
    // step 0 loads n slab 0 and p slab 0; then the n slabs, then the p
    const int ns = x < a.nNs ? x : nlast, ps = x == 0 ? 0 : x - nlast;
    const bool lq = x < a.nNs && s.q.take(tag_of(kQ, i, ns));
    const bool lk = x < a.nNs && s.k.take(tag_of(kK, j, ns));
    const bool lg = (x == 0 || x >= a.nNs) && s.dy.take(tag_of(kDY, i, ps));
    const bool lv = (x == 0 || x >= a.nNs) && s.v.take(tag_of(kV, j, ps));
    if (lq || lk || lg || lv) {
      const int n0 = ns * kT, nc = min(kT, a.N - n0);
      const int p0 = ps * kT, pc = min(kT, a.P - p0);
      __syncthreads();
      if (lq)
        load_tile(s.q.buf, a.q, a.qk_bf, hd.qrow(a, ti) + n0, a.N, 1, ri, nc);
      if (lk)
        load_tile(s.k.buf, a.k, a.qk_bf, hd.qrow(a, tj) + n0, a.N, 1, rj, nc);
      if (lg)
        load_tile(s.dy.buf, a.gy, a.gy_bf, hd.gy(a, ti, p0), a.gy_st[2],
                  a.gy_st[3], ri, pc);
      if (lv)
        load_tile(s.v.buf, a.v, a.v_bf, hd.vrow(a, tj) + p0, a.P, 1, rj, pc);
      __syncthreads();
    }
    if (x < a.nNs)
      mma64(S, s.q.buf, kLd, 1, s.k.buf, 1, kLd, a.qk_bf, a.qk_bf);
    if (x == 0 || x >= a.nNs)
      mma64(dP, s.dy.buf, kLd, 1, s.v.buf, 1, kLd, a.gy_bf, a.v_bf);
  }
}

// W = S D and dA = dP D masked to s <= t (into shared memory when asked),
// and ww = dP W where the decay's exponent is inside the clip
__device__ __forceinline__ void weigh(const Tiles& s, int i, int j,
                                      float (&S)[4][4], float (&dP)[4][4],
                                      bool keep_w) {
  const Frag f;
#pragma unroll
  for (int jj = 0; jj < 4; ++jj)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = f.row(e), c = f.col(jj, e);
      const int t = i * kT + r, u = j * kT + c;
      float w = 0.0f, da = 0.0f, ww = 0.0f;
      if (t >= u) {
        const float x = s.cum[t] - s.cum[u], d = exp_clip(x);
        w = S[jj][e] * d;
        da = dP[jj][e] * d;
        ww = dP[jj][e] * w * in_clip(x);
      }
      if (keep_w) s.w[r * kLd + c] = w;
      s.da[r * kLd + c] = da;
      S[jj][e] = ww;
    }
}

// the state terms of key tile j: dk += e^(tot - cum) v dh_out^T and dv +=
// e^(tot - cum) k dh_out on the slab's columns, and the rows' part of
// e^(tot - cum_s) k_s^T dh_out v_s over the slab's n columns into red[0..1]
__device__ __forceinline__ void state_terms(const Args& a, const Head& hd,
                                            Tiles& s, int j, int cs,
                                            float (&dk)[4][4],
                                            float (&dv)[4][4]) {
  const Frag f;
  const int rows = min(kT, hd.valid - j * kT), u0 = hd.c0 + j * kT;
  const int n0 = cs * kT, ncols = min(kT, a.N - n0);
  const int p0 = cs * kT, pcols = min(kT, a.P - p0);
  const float tot = s.cum[a.Q - 1];
  float g[4][4];
  if (cs < a.nNs) {
    zero(g);                              // v dh_out^T over the p slabs
    for (int ps = 0; ps < a.nPs; ++ps) {
      const int q0 = ps * kT, qc = min(kT, a.P - q0);
      const bool lv = s.v.take(tag_of(kV, j, ps));
      __syncthreads();
      if (lv)
        load_tile(s.v.buf, a.v, a.v_bf, hd.vrow(a, u0) + q0, a.P, 1, rows,
                  qc);
      load_tile(s.w, a.db, 0, hd.state(a) + n0 * a.P + q0, a.P, 1, ncols, qc);
      __syncthreads();
      mma64(g, s.v.buf, kLd, 1, s.w, 1, kLd, a.v_bf, false);
    }
    const bool lk = s.k.take(tag_of(kK, j, cs));
    __syncthreads();
    if (lk)
      load_tile(s.k.buf, a.k, a.qk_bf, hd.qrow(a, u0) + n0, a.N, 1, rows,
                ncols);
    __syncthreads();
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = f.row(e), c = f.col(jj, e);
        dk[jj][e] += exp_clip(tot - s.cum[j * kT + r]) * g[jj][e];
        g[jj][e] *= s.k.buf[r * kLd + c];
      }
    row_sums(g, s.red);
  }
  if (cs < a.nPs) {
    zero(g);                              // k dh_out over the n slabs
    for (int ns = 0; ns < a.nNs; ++ns) {
      const int m0 = ns * kT, mc = min(kT, a.N - m0);
      const bool lk = s.k.take(tag_of(kK, j, ns));
      __syncthreads();
      if (lk)
        load_tile(s.k.buf, a.k, a.qk_bf, hd.qrow(a, u0) + m0, a.N, 1, rows,
                  mc);
      load_tile(s.da, a.db, 0, hd.state(a) + m0 * a.P + p0, a.P, 1, mc,
                pcols);
      __syncthreads();
      mma64(g, s.k.buf, kLd, 1, s.da, kLd, 1, a.qk_bf, false);
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dv[jj][e] += exp_clip(tot - s.cum[j * kT + f.row(e)]) * g[jj][e];
  }
}

// a block per (b, h, chunk, 64-column slab cs): over key tiles j, and for
// each over query tiles i >= j, S_ij and dP_ij, then dk_j and dv_j on the
// slab's columns in registers and dq_i's by dA_ij k_j added in order of j
// to the per-head fp32 dq (the block's own rows, no other block touches
// them); dcum's row and column sums of dW W over the whole chunk; last, per
// query tile, dq's inter term
__global__ void __launch_bounds__(kThreads, 2) ssd_bwd_chunk(Args a) {
  extern __shared__ float sm[];
  Tiles s;
  s.q = {sm, 0};
  s.k = {sm + kTile, 0};
  s.dy = {sm + 2 * kTile, 0};
  s.v = {sm + 3 * kTile, 0};
  s.w = sm + 4 * kTile;
  s.da = sm + 5 * kTile;
  s.red = sm + 6 * kTile;                 // 6 x 64
  s.cum = s.red + 6 * kT;                 // Qp
  float* rsum = s.cum + a.Qp;             // Qp: each row's sum of dW W
  const int cs = blockIdx.x % a.nKV;
  const Head hd(a, blockIdx.x / a.nKV / a.nc, blockIdx.x / a.nKV % a.nc);
  const Frag f;
  const int nTv = (hd.valid + kT - 1) / kT;
  const int n0 = cs * kT, ncols = min(kT, a.N - n0);
  const int p0 = cs * kT, pcols = min(kT, a.P - p0);
  const bool do_q = cs < a.nNs, do_v = cs < a.nPs;
  const long long hrow = static_cast<long long>(hd.bh) * a.S;
  chunk_cum(s.cum, a, hd.la + hd.c0, hd.valid);
  for (int t = threadIdx.x; t < a.Qp; t += kThreads) rsum[t] = 0.0f;
  __syncthreads();
  float S[4][4], dP[4][4], dk[4][4], dv[4][4];
  for (int j = 0; j < nTv; ++j) {
    const int rj = min(kT, hd.valid - j * kT), u0 = hd.c0 + j * kT;
    zero(dk);
    zero(dv);
    float csum = 0.0f;                    // thread c < 64: column c's sum
    for (int i = j; i < nTv; ++i) {
      const int ri = min(kT, hd.valid - i * kT), ti = hd.c0 + i * kT;
      scores(a, hd, s, i, j, S, dP);
      __syncthreads();                    // tiles read, w / da free
      weigh(s, i, j, S, dP, do_v);
      col_sums(S, s.red);
      row_sums(S, s.red + 4 * kT);
      if (do_q && s.q.take(tag_of(kQ, i, cs)))
        load_tile(s.q.buf, a.q, a.qk_bf, hd.qrow(a, ti) + n0, a.N, 1, ri,
                  ncols);
      if (do_q && s.k.take(tag_of(kK, j, cs)))
        load_tile(s.k.buf, a.k, a.qk_bf, hd.qrow(a, u0) + n0, a.N, 1, rj,
                  ncols);
      if (do_v && s.dy.take(tag_of(kDY, i, cs)))
        load_tile(s.dy.buf, a.gy, a.gy_bf, hd.gy(a, ti, p0), a.gy_st[2],
                  a.gy_st[3], ri, pcols);
      __syncthreads();
      if (threadIdx.x < kT) {
        const int x = threadIdx.x;
        csum += s.red[x] + s.red[kT + x] + s.red[2 * kT + x] +
                s.red[3 * kT + x];
        rsum[i * kT + x] += s.red[4 * kT + x] + s.red[5 * kT + x];
      }
      // dv(s, p) += sum_t W(t, s) dy(t, p)
      if (do_v) mma64(dv, s.w, 1, kLd, s.dy.buf, kLd, 1, false, a.gy_bf);
      if (do_q) {
        // dk(s, n) += sum_t dA(t, s) q(t, n); dq(t, n) += sum_s dA(t, s)
        // k(s, n), into the head's fp32 dq in order of j
        mma64(dk, s.da, 1, kLd, s.q.buf, kLd, 1, false, a.qk_bf);
        const long long o = (hrow + ti) * a.N + n0;
        float part[4][4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = f.row(e), c = f.col(jj, e);
            part[jj][e] = j > 0 && r < ri && c < ncols
                              ? a.dqh[o + r * a.N + c] : 0.0f;
          }
        mma64(part, s.da, kLd, 1, s.k.buf, kLd, 1, false, a.qk_bf);
        store_tile(part, a.dqh, 0, o, a.N, ri, ncols);
      }
    }
    state_terms(a, hd, s, j, cs, dk, dv);
    __syncthreads();
    const long long o = hrow + u0;
    if (do_q)
      store_tile(dk, a.dkh != nullptr ? static_cast<void*>(a.dkh) : a.dk,
                 a.dkh != nullptr ? 0 : a.qk_bf, o * a.N + n0, a.N, rj,
                 ncols);
    if (do_v) store_tile(dv, a.dv, a.v_bf, o * a.P + p0, a.P, rj, pcols);
    if (threadIdx.x < rj) {
      const int r = threadIdx.x;
      float* pr = a.part + (o + r) * a.R;
      if (cs == 0) pr[1] = csum;
      if (do_q) {
        const float x = s.cum[a.Q - 1] - s.cum[j * kT + r];
        pr[2 + a.nNs + cs] =
            exp_clip(x) * in_clip(x) * (s.red[r] + s.red[kT + r]);
      }
    }
  }
  if (!do_q) return;
  // per query tile: gq = dy h_in^T over the p slabs, dq += e^cum gq, and
  // the inter term's part e^cum_t <q_t, gq_t> over the slab's n columns
  for (int i = 0; i < nTv; ++i) {
    const int ri = min(kT, hd.valid - i * kT), ti = hd.c0 + i * kT;
    zero(S);
    for (int ps = 0; ps < a.nPs; ++ps) {
      const int q0 = ps * kT, qc = min(kT, a.P - q0);
      const bool lg = s.dy.take(tag_of(kDY, i, ps));
      __syncthreads();
      if (lg)
        load_tile(s.dy.buf, a.gy, a.gy_bf, hd.gy(a, ti, q0), a.gy_st[2],
                  a.gy_st[3], ri, qc);
      s.v.tag = tag_of(kH, cs, ps);
      load_tile(s.v.buf, a.hb, 0, hd.state(a) + n0 * a.P + q0, a.P, 1,
                ncols, qc);
      __syncthreads();
      mma64(S, s.dy.buf, kLd, 1, s.v.buf, 1, kLd, a.gy_bf, false);
    }
    const bool lq = s.q.take(tag_of(kQ, i, cs));
    __syncthreads();
    if (lq)
      load_tile(s.q.buf, a.q, a.qk_bf, hd.qrow(a, ti) + n0, a.N, 1, ri,
                ncols);
    __syncthreads();
    const long long o = (hrow + ti) * a.N + n0;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = f.row(e), c = f.col(jj, e);
        const float g = S[jj][e];
        dP[jj][e] = r < ri && c < ncols ? a.dqh[o + r * a.N + c] : 0.0f;
        dP[jj][e] += exp_clip(s.cum[i * kT + r]) * g;
        S[jj][e] = s.q.buf[r * kLd + c] * g;
      }
    row_sums(S, s.red);
    __syncthreads();
    store_tile(dP, a.G != a.H ? static_cast<void*>(a.dqh) : a.dq,
               a.G != a.H ? 0 : a.qk_bf, o, a.N, ri, ncols);
    if (threadIdx.x < ri) {
      const int r = threadIdx.x;
      const float x = s.cum[i * kT + r];
      float* pr = a.part + (hrow + ti + r) * a.R;
      if (cs == 0) pr[0] = rsum[i * kT + r];
      pr[2 + cs] = exp_clip(x) * in_clip(x) * (s.red[r] + s.red[kT + r]);
    }
  }
}

// ---------------------------------------------------------------------------
// ssd_bwd_finish: dlog_a per chunk; at G < H the groups' sums of dq and dk
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads) ssd_bwd_finish(Args a) {
  extern __shared__ float sm[];
  const long long chunks = static_cast<long long>(a.B) * a.H * a.nc;
  if (blockIdx.x >= chunks) {
    const long long per = static_cast<long long>(a.B) * a.G * a.S * a.N;
    const long long e =
        (blockIdx.x - chunks) * static_cast<long long>(kThreads) + threadIdx.x;
    if (e >= 2 * per) return;
    const bool is_k = e >= per;
    const long long x = is_k ? e - per : e;
    const long long sn = static_cast<long long>(a.S) * a.N;
    const long long bg = x / sn, r = x % sn;
    const int rep = a.H / a.G;
    const float* src = is_k ? a.dkh : a.dqh;
    const long long h0 = (bg / a.G) * a.H + (bg % a.G) * rep;
    float sum = 0.0f;
    for (int i = 0; i < rep; ++i) {
      const float g = src[(h0 + i) * sn + r];
      sum += a.qk_bf ? __bfloat162float(__float2bfloat16(g)) : g;
    }
    st(is_k ? a.dk : a.dq, a.qk_bf, x, sum);
    return;
  }
  float* dc = sm;                        // Q
  float* stt = dc + a.Q;                 // Q
  const Head hd(a, static_cast<int>(blockIdx.x / a.nc),
                static_cast<int>(blockIdx.x % a.nc));
  const long long row0 = static_cast<long long>(hd.bh) * a.S + hd.c0;
  for (int t = threadIdx.x; t < hd.valid; t += kThreads) {
    const float* pr = a.part + (row0 + t) * a.R;
    float inter = 0.0f, state = 0.0f;
    for (int c = 0; c < a.nNs; ++c) {
      inter += pr[2 + c];
      state += pr[2 + a.nNs + c];
    }
    dc[t] = pr[0] - pr[1] + inter - state;
    stt[t] = state;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float extra = 0.0f;
    for (int t = 0; t < hd.valid; ++t) extra += stt[t];
    const float* d = a.dots + (static_cast<long long>(hd.bh) * a.nc + hd.c) *
                                  a.splits;
    for (int i = 0; i < a.splits; ++i) extra += d[i];
    dc[hd.valid - 1] += extra;
    float acc = 0.0f;
    for (int t = hd.valid - 1; t >= 0; --t) {
      acc += dc[t];
      st(a.dla, a.la_bf, hd.la + hd.c0 + t, acc);
    }
  }
}

int q_pad(int Q) { return (Q + kT - 1) / kT * kT; }
int chunk_smem(int Q) { return (6 * kTile + 6 * kT + 2 * q_pad(Q)) * 4; }
int states_smem(int Q) { return (4 * kTile + q_pad(Q) + 2 * Q) * 4; }
int finish_smem(int Q) { return 2 * Q * 4; }

// raise a kernel's shared-memory limit to the opt-in maximum once, at its
// first launch (never again, so a later launch may be captured into a CUDA
// graph)
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

// the largest dynamic shared memory a launch at chunk Q takes
long long ssd_scan_bwd_smem(int Q) {
  const long long a = chunk_smem(Q), b = states_smem(Q), c = finish_smem(Q);
  const long long ab = a > b ? a : b;
  return ab > c ? ab : c;
}

// q, k (B,G,S,N); v (B,H,S,P); la (B,H,S), contiguous; gy (B,H,S,P) at
// strides gy_st; gs (B,H,N,P) fp32 at strides gs_st, or null (zero).
// dq, dk, dv, dla: outputs of q's, q's, v's and la's types, contiguous.
// ws: fp32 workspace of ssd_scan.py's bwd_workspace() floats.  *_bf: 1 for
// bfloat16, 0 for float32.
int ssd_scan_bwd_launch(const void* q, const void* k, const void* v,
                        const void* la, const void* gy, const void* gs,
                        void* dq, void* dk, void* dv, void* dla, void* ws,
                        const long long* gy_st, const long long* gs_st, int B,
                        int H, int G, int S, int N, int P, int Q, int qk_bf,
                        int v_bf, int la_bf, int gy_bf, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.la = la;
  a.gy = gy;
  a.gs = static_cast<const float*>(gs);
  a.qk_bf = qk_bf;
  a.v_bf = v_bf;
  a.la_bf = la_bf;
  a.gy_bf = gy_bf;
  for (int i = 0; i < 4; ++i) {
    a.gy_st[i] = gy_st[i];
    a.gs_st[i] = gs != nullptr ? gs_st[i] : 0;
  }
  a.B = B;
  a.H = H;
  a.G = G;
  a.S = S;
  a.N = N;
  a.P = P;
  a.Q = Q;
  a.nc = (S + Q - 1) / Q;
  a.Qp = q_pad(Q);
  a.nNs = (N + kT - 1) / kT;
  a.nPs = (P + kT - 1) / kT;
  a.nKV = a.nNs > a.nPs ? a.nNs : a.nPs;
  a.R = 2 + 2 * a.nNs;
  const long long NP = static_cast<long long>(N) * P;
  a.splits = static_cast<int>((NP + kChainElems - 1) / kChainElems);
  const long long BH = static_cast<long long>(B) * H;
  float* w = static_cast<float*>(ws);
  a.hb = w;
  a.db = a.hb + a.nc * BH * NP;
  a.part = a.db + BH * a.nc * NP;
  a.dots = a.part + BH * S * a.R;
  a.tots = a.dots + BH * a.nc * a.splits;
  a.dqh = a.tots + BH * a.nc;
  a.dkh = G != H ? a.dqh + BH * S * N : nullptr;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.dla = dla;

  static bool raised_chunk = false, raised_states = false,
              raised_finish = false;
  cudaError_t err = raise_smem(reinterpret_cast<const void*>(ssd_bwd_chunk),
                               &raised_chunk);
  if (err == cudaSuccess)
    err = raise_smem(reinterpret_cast<const void*>(ssd_bwd_states),
                     &raised_states);
  if (err == cudaSuccess)
    err = raise_smem(reinterpret_cast<const void*>(ssd_bwd_finish),
                     &raised_finish);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int cs = chunk_smem(Q), ss = states_smem(Q), fs = finish_smem(Q);
  const long long chunks = BH * a.nc;
  ssd_bwd_states<<<static_cast<unsigned>(chunks * a.nNs * a.nPs), kThreads,
                   ss, s>>>(a);
  ssd_bwd_chain<<<static_cast<unsigned>(BH * a.splits), kThreads, 0, s>>>(a);
  ssd_bwd_chunk<<<static_cast<unsigned>(chunks * a.nKV), kThreads, cs,
                  s>>>(a);
  const long long groups =
      G != H ? (2 * static_cast<long long>(B) * G * S * N + kThreads - 1) /
                   kThreads
             : 0;
  ssd_bwd_finish<<<static_cast<unsigned>(chunks + groups), kThreads, fs,
                   s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
