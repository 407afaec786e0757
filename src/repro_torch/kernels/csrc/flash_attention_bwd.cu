// Blocked (flash) GQA attention, backward, as CUDA kernels for sm_90a.
//
// The gradient of flash_attention.cu's forward.  The TPU reference has no
// backward kernel: src/repro/kernels/ops.py:_fa_bwd takes jax.vjp of
// ref.attention_ref, the whole fp32 score matrix and its softmax.  These
// kernels compute that same function without the matrix (the plain version
// is kernels/flash_attention.py:flash_attention_bwd_plain, which follows the
// same decomposition).  q (B,H,Sq,D), k and v (B,Hkv,Sk,D), Hkv | H,
// queries aligned to the END of the keys, the forward's causal and window
// masks; lse (B,H,Sq) is the forward's fp32 log-sum-exp of each row's
// scaled scores in the natural base (+inf for a row that sees no key).  Per
// query row i and key j the row sees, with s = q_i.k_j / sqrt(D):
//
//   P_ij  = exp(s - lse_i)                  (0 for a key the row does not see)
//   dP_ij = dO_i . v_j
//   delta_i = sum_j P_ij dP_ij              (the recomputed fp32 P and dP)
//   dS_ij = P_ij (dP_ij - delta_i) / sqrt(D)
//   dq_i  = sum_j dS_ij k_j
//   dk_j  = sum_i dS_ij q_i,   dv_j = sum_i P_ij dO_i   (per query head)
//
// A GQA group's dk and dv are the sums over its H/Hkv query heads, each
// head's rounded to the inputs' type first and the sum kept in fp32, as
// autograd of the plain version sums them (repeat_interleave, then
// .float()).  A row that sees no key (causal, Sq > Sk: the first Sq - Sk
// rows) has the reference's uniform softmax over its all-NEG_INF scores:
// its gradient reaches no q and no k, and every key's v takes dO_i / Sk.
//
// delta from the recomputed P and dP, not from dO.O as FlashAttention takes
// it: the bf16-rounded o puts an error of about 2^-9 of delta's scale into
// every dS, 5-10x the reference's error in dq (the CPU tests), and the
// port's CPU backward, which the tests hold to the reference across the
// models, is autograd's formula.  It costs one more sweep over the keys in
// the dq kernel: two more products a visible pair, 10 where 8 would do.
//
// Two kernels on the caller's stream, one call of the host launcher, no
// atomics and no result that depends on block order:
//
//   dq kernel    a block per (b, h, 64-row query tile): sweep 1 over the
//                key tiles the tile's rows reach (the forward's loop
//                bounds) recomputes S and dP and sums delta, which it
//                writes for the next kernel; sweep 2 recomputes them again
//                and accumulates dq += dS K in registers.
//   dk/dv kernel a block per (b, kv head, 64-key tile): walks the group's
//                query heads in order and, for each, the query tiles that
//                see its keys, recomputing S^T and dP^T, and accumulates
//                dv += P^T dO and dk += dS^T q in registers; at a head's
//                end it adds the no-key rows' dO / Sk to dv and rounds the
//                head's dk and dv into the group's fp32 sums (workspace,
//                each element owned by one thread), or, for the group's
//                last head, into the outputs.
//
// This file serves bf16 at D 256 and every f32 call;
// kernels/flash_attention.py:bwd_plan sends bf16 at D 16-128 to
// flash_attention_bwd_wgmma.cu, and the launcher refuses bf16 at another D.
//
// bf16 (D 256): mma.sync.m16n8k16 with fp32 accumulation.  The dq kernel
// takes 4 warps of 16 rows; the dk/dv kernel 8 warps, two to a 16-key slab,
// each holding half of D's columns of dk and dv (128 + 128 fp32 a thread
// would not fit).  Operands from shared memory by ldmatrix (.trans where the
// product contracts over a tile's rows), rows padded by 16 bytes; tiles by
// cp.async in one stage (two would halve the blocks an SM holds).  q.k and
// dO.v are exact in one pass (bf16 operands, fp32 sums).  P and dS are fp32
// and the reference's products take them in fp32: each is split into hi =
// bf16(x) and lo = bf16(x - hi), and hi B + lo B go into one fp32
// accumulator (about 16 bits of the operand), as the forward does for P V.
//
// f32: the same two kernels on the FMA units (256 threads, four lanes to a
// row, tiles of fp32 in shared memory), a dispatch by type: TF32 would
// miss the f32 tolerance.  A group's dk and dv sum in the same fp32
// registers (rounding f32 to f32 changes nothing).
//
// Bound: operations.  Five products a visible pair, eight as the bf16
// kernels issue them (kernels/flash_attention.py:work_backward): at
// Gemma-7B's train shape (B2 H16 S2048 D256 causal) 1.72e11 FLOP, 0.174 ms
// at the H100's 989 TFLOP/s bf16 peak, 0.278 ms with the hi/lo passes.
//
// The launcher takes PyTorch's current stream, allocates nothing (the
// wrapper passes the workspace) and returns cudaGetLastError() after the
// second launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_attention_bwd.cuh"

namespace {

using namespace fa_bwd;

// ---------------------------------------------------------------------------
// bf16 on mma.sync
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool pred) {
  const int n = pred ? 16 : 0;          // 0: sixteen zero bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc (16 x N) = A (16 x K, rows of sA) . B^T, B (N x K) the rows of sB;
// both row-major in shared memory at LD elements a row
template <int K, int N, int LD>
__device__ __forceinline__ void mma_nt(float (&acc)[N / 8][4], const bf16* sA,
                                       const bf16* sB, int lane) {
#pragma unroll
  for (int i = 0; i < N / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, smem_u32(sA + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8));
#pragma unroll
    for (int np = 0; np < N / 16; ++np) {
      uint32_t b[4];
      ldsm_x4(b, smem_u32(sB + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                          kk * 16 + ((lane >> 3) & 1) * 8));
      mma(acc[2 * np], a, b[0], b[1]);
      mma(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// acc (16 x N) += (hi + lo) (16 x K, A-fragments in registers) . B, B (K x
// N) the rows of sB, row-major at LD elements a row (read transposed)
template <int K, int N, int LD>
__device__ __forceinline__ void mma_rn(float (&acc)[N / 8][4],
                                       const uint32_t (&hi)[K / 16][4],
                                       const uint32_t (&lo)[K / 16][4],
                                       const bf16* sB, int lane) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
#pragma unroll
    for (int np = 0; np < N / 16; ++np) {
      uint32_t b[4];
      ldsm_x4_t(b, smem_u32(sB +
                            (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                            np * 16 + (lane >> 4) * 8));
      mma(acc[2 * np], hi[kk], b[0], b[1]);
      mma(acc[2 * np], lo[kk], b[0], b[1]);
      mma(acc[2 * np + 1], hi[kk], b[2], b[3]);
      mma(acc[2 * np + 1], lo[kk], b[2], b[3]);
    }
}

// a 16 x N accumulator as the A-fragments of a 16 x N operand, two halves:
// columns 16 kk .. 16 kk + 15 are the accumulator's n8 blocks 2 kk, 2 kk + 1
template <int N>
__device__ __forceinline__ void split_frag(const float (&x)[N / 8][4],
                                           uint32_t (&hi)[N / 16][4],
                                           uint32_t (&lo)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    split_bf16(x[2 * kk][0], x[2 * kk][1], hi[kk][0], lo[kk][0]);
    split_bf16(x[2 * kk][2], x[2 * kk][3], hi[kk][1], lo[kk][1]);
    split_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1], hi[kk][2], lo[kk][2]);
    split_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3], hi[kk][3], lo[kk][3]);
  }
}

// R rows of D bf16 at `stride` elements a row into sT (LD a row); rows at
// or past `valid` as zeros
template <int D, int R, int LD, int NT>
__device__ __forceinline__ void load_rows(bf16* sT, const bf16* g,
                                          long long stride, int valid,
                                          int tid) {
  constexpr int CH = D / 8;
#pragma unroll 4
  for (int i = tid; i < R * CH; i += NT) {
    const int r = i / CH, c = i % CH;
    const bool ok = r < valid;
    cp_async16(smem_u32(sT + r * LD + c * 8), ok ? g + r * stride + c * 8 : g,
               ok);
  }
}

// the bf16 kernels' tiling (D 256), one stage of tiles each
struct BT {
  static constexpr int D = 256;
  static constexpr int LD = D + 8;                 // a row, 16 bytes padded
  // dq kernel: 64 query rows, 4 warps; KT keys a K/V tile
  static constexpr int QB = 64;
  static constexpr int KT = 32;
  static constexpr int DQ_SMEM = 2 * (2 * QB * LD + 2 * KT * LD);
  // dk/dv kernel: 64 keys; 4 slabs of 16 keys x 2 halves of D's columns
  // (DC each), a warp each; QT query rows a Q/dO tile
  static constexpr int KB = 64;
  static constexpr int DC = D / 2;
  static constexpr int QT = 32;
  static constexpr int KV_THREADS = 256;
  static constexpr int KV_SMEM =
      2 * (2 * KB * LD + 2 * QT * LD) + 4 * (2 * QT + D);
};

__global__ void __launch_bounds__(128)
fa_bwd_dq_mma(const Args a) {
  using T = BT;
  constexpr int D = T::D, LD = T::LD, QB = T::QB, KT = T::KT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sdO = sQ + QB * LD;
  bf16* sK = sdO + QB * LD;                        // K, then V
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n_qt = (a.Sq + QB - 1) / QB;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x);  // longest first
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * QB, q1 = min(q0 + QB, a.Sq);
  const size_t bh = static_cast<size_t>(b) * a.H + h;
  const size_t bhk = static_cast<size_t>(b) * a.Hkv + h / (a.H / a.Hkv);
  const bf16* q = static_cast<const bf16*>(a.q) + (bh * a.Sq + q0) * D;
  const bf16* dO = static_cast<const bf16*>(a.dO) + b * a.do_sb +
                   h * a.do_sh + static_cast<long long>(q0) * a.do_ss;
  const bf16* k = static_cast<const bf16*>(a.k) + bhk * a.Sk * D;
  const bf16* v = static_cast<const bf16*>(a.v) + bhk * a.Sk * D;

  int k_begin, k_end;
  key_range(a, q0, q1, k_begin, k_end);
  const int t_lo = k_begin / KT;
  const int n_t = k_end > k_begin ? (k_end + KT - 1) / KT - t_lo : 0;

  load_rows<D, QB, LD, 128>(sQ, q, D, q1 - q0, tid);
  load_rows<D, QB, LD, 128>(sdO, dO, a.do_ss, q1 - q0, tid);
  auto issue = [&](int step) {            // step: sweep * n_t + tile
    const int k0 = (t_lo + step % n_t) * KT;
    load_rows<D, KT, LD, 128>(sK, k + static_cast<size_t>(k0) * D, D,
                              a.Sk - k0, tid);
    load_rows<D, KT, LD, 128>(sK + KT * LD, v + static_cast<size_t>(k0) * D,
                              D, a.Sk - k0, tid);
  };

  const int row0 = q0 + 16 * w + g;       // this lane's rows: + 0, + 8
  float lse2[2], delta[2] = {0.0f, 0.0f};
#pragma unroll
  for (int r = 0; r < 2; ++r)
    lse2[r] = row0 + 8 * r < a.Sq ? a.lse[bh * a.Sq + row0 + 8 * r] * kLog2e
                                  : 0.0f;
  float dq[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[i][e] = 0.0f;

  cp_commit();                          // Q and dO
  for (int step = 0; step < 2 * n_t; ++step) {
    issue(step);
    cp_commit();
    cp_wait<0>();
    __syncthreads();
    const bf16* tK = sK;
    const bf16* tV = sK + KT * LD;
    const int sweep = step / n_t;
    const int k0 = (t_lo + step % n_t) * KT;
    float s[KT / 8][4], dp[KT / 8][4];
    mma_nt<D, KT, LD>(s, sQ + 16 * w * LD, tK, lane);
    mma_nt<D, KT, LD>(dp, sdO + 16 * w * LD, tV, lane);
    const bool edge = k0 + KT > a.Sk || (a.causal && k0 + KT - 1 > q0 + a.Sk - a.Sq) ||
                      (a.window > 0 && k0 <= q1 - 1 + a.Sk - a.Sq - a.window);
#pragma unroll
    for (int nb = 0; nb < KT / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float p = exp2f(fmaf(s[nb][e], a.scale_log2, -lse2[r]));
        if (edge && !visible(a, row0 + 8 * r, k0 + 8 * nb + 2 * t + (e & 1)))
          p = 0.0f;
        if (sweep == 0)
          delta[r] = fmaf(p, dp[nb][e], delta[r]);
        else
          s[nb][e] = p * (dp[nb][e] - delta[r]) * a.scale;
      }
    if (sweep == 1) {
      uint32_t hi[KT / 16][4], lo[KT / 16][4];
      split_frag<KT>(s, hi, lo);
      mma_rn<KT, D, LD>(dq, hi, lo, tK, lane);
    } else if (step == n_t - 1) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        delta[r] += __shfl_xor_sync(0xffffffffu, delta[r], 1);
        delta[r] += __shfl_xor_sync(0xffffffffu, delta[r], 2);
      }
    }
    __syncthreads();
  }
  cp_wait<0>();                         // a tile that reaches no key
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= a.Sq) continue;
    if (t == 0) a.delta[bh * a.Sq + row] = delta[r];
    bf16* out = static_cast<bf16*>(a.dq) + (bh * a.Sq + row) * D;
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * nb + 2 * t) =
          __floats2bfloat162_rn(dq[nb][2 * r], dq[nb][2 * r + 1]);
  }
}

__global__ void __launch_bounds__(BT::KV_THREADS)
fa_bwd_dkdv_mma(const Args a) {
  using T = BT;
  constexpr int D = T::D, LD = T::LD, KB = T::KB, QT = T::QT;
  constexpr int DC = T::DC, NT = T::KV_THREADS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + KB * LD;
  bf16* sQ = sV + KB * LD;                         // Q, then dO
  float* sL = reinterpret_cast<float*>(sQ + 2 * QT * LD);  // lse2, delta
  float* sX = sL + 2 * QT;                         // the no-key rows' dv
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int slab = w & 3, half = w >> 2;           // keys 16 slab, cols DC half
  const int hk = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.Hkv;
  const int k0 = blockIdx.x * KB, k1 = min(k0 + KB, a.Sk);
  const size_t bhk = static_cast<size_t>(b) * a.Hkv + hk;
  load_rows<D, KB, LD, NT>(sK, static_cast<const bf16*>(a.k) +
                                   (bhk * a.Sk + k0) * D, D, k1 - k0, tid);
  load_rows<D, KB, LD, NT>(sV, static_cast<const bf16*>(a.v) +
                                   (bhk * a.Sk + k0) * D, D, k1 - k0, tid);
  int q_begin, q_end;
  query_range(a, k0, k1, q_begin, q_end);
  const int t_lo = q_begin / QT;
  const int n_t = q_end > q_begin ? (q_end + QT - 1) / QT - t_lo : 0;
  const int n0 = a.causal ? max(0, a.Sq - a.Sk) : 0;

  auto issue = [&](int step) {            // step: head j * n_t + tile
    const int h = hk * G + step / n_t;
    const int qs = (t_lo + step % n_t) * QT;
    const size_t bh = static_cast<size_t>(b) * a.H + h;
    load_rows<D, QT, LD, NT>(sQ, static_cast<const bf16*>(a.q) +
                                     (bh * a.Sq + qs) * D, D, a.Sq - qs, tid);
    load_rows<D, QT, LD, NT>(
        sQ + QT * LD,
        static_cast<const bf16*>(a.dO) + b * a.do_sb + h * a.do_sh +
            static_cast<long long>(qs) * a.do_ss,
        a.do_ss, a.Sq - qs, tid);
    for (int i = tid; i < QT; i += NT) {
      const int qi = qs + i;
      sL[i] = qi < a.Sq ? a.lse[bh * a.Sq + qi] * kLog2e : 0.0f;
      sL[QT + i] = qi < a.Sq ? a.delta[bh * a.Sq + qi] : 0.0f;
    }
  };

  const int key0 = k0 + 16 * slab + g;    // this lane's keys: + 0, + 8
  float dk[DC / 8][4], dv[DC / 8][4];
#pragma unroll
  for (int i = 0; i < DC / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.0f;

  cp_commit();                          // K and V
  for (int j = 0; j < G; ++j) {
    const int h = hk * G + j;
    for (int it = 0; it < n_t; ++it) {
      issue(j * n_t + it);
      cp_commit();
      cp_wait<0>();
      __syncthreads();
      const bf16* tQ = sQ;
      const bf16* tdO = sQ + QT * LD;
      const float* l = sL;
      const int qs = (t_lo + it) * QT;
      float s[QT / 8][4], dp[QT / 8][4];
      mma_nt<D, QT, LD>(s, sK + 16 * slab * LD, tQ, lane);
      mma_nt<D, QT, LD>(dp, sV + 16 * slab * LD, tdO, lane);
      const int off = a.Sk - a.Sq;
      const bool edge = qs + QT > a.Sq || k0 + KB > a.Sk ||
                        (a.causal && k0 + KB - 1 > qs + off) ||
                        (a.window > 0 && qs + QT - 1 + off - a.window >= k0);
#pragma unroll
      for (int nb = 0; nb < QT / 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * nb + 2 * t + (e & 1);
          float p = exp2f(fmaf(s[nb][e], a.scale_log2, -l[c]));
          if (edge && !visible(a, qs + c, key0 + 8 * (e >> 1))) p = 0.0f;
          s[nb][e] = p;
          dp[nb][e] = p * (dp[nb][e] - l[QT + c]) * a.scale;
        }
      {
        uint32_t hi[QT / 16][4], lo[QT / 16][4];
        split_frag<QT>(s, hi, lo);
        mma_rn<QT, DC, LD>(dv, hi, lo, tdO + half * DC, lane);
        split_frag<QT>(dp, hi, lo);
        mma_rn<QT, DC, LD>(dk, hi, lo, tQ + half * DC, lane);
      }
      __syncthreads();
    }
    // the head's end: the no-key rows' dv, then into the group's sums
    if (n0 > 0) {
      for (int c = tid; c < D; c += NT) sX[c] = no_key_dv<bf16>(a, b, h, c, n0);
      __syncthreads();
#pragma unroll
      for (int nb = 0; nb < DC / 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dv[nb][e] += sX[half * DC + 8 * nb + 2 * t + (e & 1)];
      __syncthreads();
    }
    const size_t plane = static_cast<size_t>(a.B) * a.Hkv * a.Sk * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (key0 + 8 * r >= a.Sk) continue;
      const size_t base = (bhk * a.Sk + key0 + 8 * r) * D + half * DC;
#pragma unroll
      for (int nb = 0; nb < DC / 8; ++nb)
        round_into(a, base, plane, 8 * nb + 2 * t, j, G, dk[nb][2 * r],
                   dk[nb][2 * r + 1], dv[nb][2 * r], dv[nb][2 * r + 1]);
    }
#pragma unroll
    for (int i = 0; i < DC / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.0f;
  }
  cp_wait<0>();                         // keys that no query sees
}

// ---------------------------------------------------------------------------
// f32 on the FMA units
// ---------------------------------------------------------------------------
constexpr int kThreads = 256;
constexpr int kLanes = 4;               // lanes sharing a row
constexpr int kRows = kThreads / kLanes;   // 64 rows a block

template <int D> struct FT {
  static constexpr int LD = D + 1;
  static constexpr int KT = D >= 256 ? 16 : D >= 128 ? 32 : 64;  // dq: keys
  static constexpr int QT = KT;                                  // dk/dv: rows
  static constexpr int DQ_FLOATS = 2 * kRows * LD + 2 * KT * LD + kRows * (KT + 1);
  static constexpr int KV_FLOATS =
      2 * kRows * LD + 2 * QT * LD + 2 * kRows * (QT + 1) + 2 * QT + D;
};

template <int D>
__device__ __forceinline__ void load_f32(float* s, const float* g,
                                         long long stride, int rows,
                                         int valid, int tid, float mul) {
  for (int i = tid; i < rows * D; i += kThreads) {
    const int r = i / D, c = i % D;
    s[r * (D + 1) + c] = r < valid ? g[r * stride + c] * mul : 0.0f;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dq_f32(const Args a) {
  using T = FT<D>;
  constexpr int LD = T::LD, KT = T::KT, KPT = KT / kLanes, DPT = D / kLanes;
  extern __shared__ float fsm[];
  float* sQ = fsm;                       // [64][LD]
  float* sdO = sQ + kRows * LD;
  float* sK = sdO + kRows * LD;          // [KT][LD]
  float* sV = sK + KT * LD;
  float* sS = sV + KT * LD;              // [64][KT + 1] dS
  const int tid = threadIdx.x, rw = tid / kLanes, sub = tid % kLanes;
  const int n_qt = (a.Sq + kRows - 1) / kRows;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * kRows;
  const int q1 = min(q0 + kRows, a.Sq);
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t bh = static_cast<size_t>(b) * a.H + h;
  const size_t bhk = static_cast<size_t>(b) * a.Hkv + h / (a.H / a.Hkv);
  const float* k = static_cast<const float*>(a.k) + bhk * a.Sk * D;
  const float* v = static_cast<const float*>(a.v) + bhk * a.Sk * D;
  load_f32<D>(sQ, static_cast<const float*>(a.q) + (bh * a.Sq + q0) * D, D,
              kRows, q1 - q0, tid, 1.0f);
  load_f32<D>(sdO, static_cast<const float*>(a.dO) + b * a.do_sb +
                       h * a.do_sh + static_cast<long long>(q0) * a.do_ss,
              a.do_ss, kRows, q1 - q0, tid, 1.0f);
  int k_begin, k_end;
  key_range(a, q0, q1, k_begin, k_end);
  k_begin = (k_begin / KT) * KT;
  const int qi = q0 + rw;
  const float lse = qi < a.Sq ? a.lse[bh * a.Sq + qi] : 0.0f;
  float delta = 0.0f;
  float acc[DPT];
#pragma unroll
  for (int d = 0; d < DPT; ++d) acc[d] = 0.0f;
  for (int sweep = 0; sweep < 2; ++sweep) {
    for (int kt = k_begin; kt < k_end; kt += KT) {
      __syncthreads();
      load_f32<D>(sK, k + static_cast<size_t>(kt) * D, D, KT, a.Sk - kt, tid,
                  1.0f);
      load_f32<D>(sV, v + static_cast<size_t>(kt) * D, D, KT, a.Sk - kt, tid,
                  1.0f);
      __syncthreads();
      const float* qr = sQ + rw * LD;
      const float* dr = sdO + rw * LD;
#pragma unroll
      for (int jj = 0; jj < KPT; ++jj) {
        const int jk = jj * kLanes + sub;
        const float* kr = sK + jk * LD;
        const float* vr = sV + jk * LD;
        float s = 0.0f, dp = 0.0f;
#pragma unroll 16
        for (int c = 0; c < D; ++c) {
          s = fmaf(qr[c], kr[c], s);
          dp = fmaf(dr[c], vr[c], dp);
        }
        const float p =
            visible(a, qi, kt + jk) ? expf(s * a.scale - lse) : 0.0f;
        if (sweep == 0)
          delta = fmaf(p, dp, delta);
        else
          sS[rw * (KT + 1) + jk] = p * (dp - delta) * a.scale;
      }
      if (sweep == 1) {
        __syncwarp();
        const float* sr = sS + rw * (KT + 1);
        for (int jk = 0; jk < KT; ++jk) {
          const float ds = sr[jk];
          const float* kr = sK + jk * LD + sub;
#pragma unroll
          for (int d = 0; d < DPT; ++d) acc[d] = fmaf(ds, kr[d * kLanes], acc[d]);
        }
      }
    }
    if (sweep == 0) {
      delta += __shfl_xor_sync(0xffffffffu, delta, 1);
      delta += __shfl_xor_sync(0xffffffffu, delta, 2);
    }
  }
  if (qi < a.Sq) {
    if (sub == 0) a.delta[bh * a.Sq + qi] = delta;
    float* out = static_cast<float*>(a.dq) + (bh * a.Sq + qi) * D;
#pragma unroll
    for (int d = 0; d < DPT; ++d) out[d * kLanes + sub] = acc[d];
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dkdv_f32(const Args a) {
  using T = FT<D>;
  constexpr int LD = T::LD, QT = T::QT, QPT = QT / kLanes, DPT = D / kLanes;
  extern __shared__ float fsm[];
  float* sK = fsm;                       // [64][LD]
  float* sV = sK + kRows * LD;
  float* sQ = sV + kRows * LD;           // [QT][LD]
  float* sdO = sQ + QT * LD;
  float* sP = sdO + QT * LD;             // [64][QT + 1]
  float* sS = sP + kRows * (QT + 1);
  float* sL = sS + kRows * (QT + 1);     // lse, delta [QT] each
  float* sX = sL + 2 * QT;               // the no-key rows' dv [D]
  const int tid = threadIdx.x, rw = tid / kLanes, sub = tid % kLanes;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.Hkv;
  const int k0 = blockIdx.x * kRows, k1 = min(k0 + kRows, a.Sk);
  const size_t bhk = static_cast<size_t>(b) * a.Hkv + hk;
  load_f32<D>(sK, static_cast<const float*>(a.k) + (bhk * a.Sk + k0) * D, D,
              kRows, k1 - k0, tid, 1.0f);
  load_f32<D>(sV, static_cast<const float*>(a.v) + (bhk * a.Sk + k0) * D, D,
              kRows, k1 - k0, tid, 1.0f);
  int q_begin, q_end;
  query_range(a, k0, k1, q_begin, q_end);
  q_begin = (q_begin / QT) * QT;
  const int n0 = a.causal ? max(0, a.Sq - a.Sk) : 0;
  const int kj = k0 + rw;
  float dk[DPT], dv[DPT];
#pragma unroll
  for (int d = 0; d < DPT; ++d) dk[d] = dv[d] = 0.0f;
  for (int j = 0; j < G; ++j) {
    const int h = hk * G + j;
    const size_t bh = static_cast<size_t>(b) * a.H + h;
    for (int qs = q_begin; qs < q_end; qs += QT) {
      __syncthreads();
      load_f32<D>(sQ, static_cast<const float*>(a.q) + (bh * a.Sq + qs) * D,
                  D, QT, a.Sq - qs, tid, 1.0f);
      load_f32<D>(sdO, static_cast<const float*>(a.dO) + b * a.do_sb +
                           h * a.do_sh + static_cast<long long>(qs) * a.do_ss,
                  a.do_ss, QT, a.Sq - qs, tid, 1.0f);
      for (int i = tid; i < QT; i += kThreads) {
        sL[i] = qs + i < a.Sq ? a.lse[bh * a.Sq + qs + i] : 0.0f;
        sL[QT + i] = qs + i < a.Sq ? a.delta[bh * a.Sq + qs + i] : 0.0f;
      }
      __syncthreads();
      const float* kr = sK + rw * LD;
      const float* vr = sV + rw * LD;
#pragma unroll
      for (int jj = 0; jj < QPT; ++jj) {
        const int iq = jj * kLanes + sub;
        const float* qr = sQ + iq * LD;
        const float* dr = sdO + iq * LD;
        float s = 0.0f, dp = 0.0f;
#pragma unroll 16
        for (int c = 0; c < D; ++c) {
          s = fmaf(kr[c], qr[c], s);
          dp = fmaf(vr[c], dr[c], dp);
        }
        const float p =
            visible(a, qs + iq, kj) ? expf(s * a.scale - sL[iq]) : 0.0f;
        sP[rw * (QT + 1) + iq] = p;
        sS[rw * (QT + 1) + iq] = p * (dp - sL[QT + iq]) * a.scale;
      }
      __syncwarp();
      const float* pr = sP + rw * (QT + 1);
      const float* sr = sS + rw * (QT + 1);
      for (int iq = 0; iq < QT; ++iq) {
        const float p = pr[iq], ds = sr[iq];
        const float* qr = sQ + iq * LD + sub;
        const float* dr = sdO + iq * LD + sub;
#pragma unroll
        for (int d = 0; d < DPT; ++d) {
          dv[d] = fmaf(p, dr[d * kLanes], dv[d]);
          dk[d] = fmaf(ds, qr[d * kLanes], dk[d]);
        }
      }
    }
    if (n0 > 0) {
      __syncthreads();
      for (int c = tid; c < D; c += kThreads)
        sX[c] = no_key_dv<float>(a, b, h, c, n0);
      __syncthreads();
#pragma unroll
      for (int d = 0; d < DPT; ++d) dv[d] += sX[d * kLanes + sub];
    }
  }
  if (kj < a.Sk) {
    float* ok = static_cast<float*>(a.dk) + (bhk * a.Sk + kj) * D;
    float* ov = static_cast<float*>(a.dv) + (bhk * a.Sk + kj) * D;
#pragma unroll
    for (int d = 0; d < DPT; ++d) {
      ok[d * kLanes + sub] = dk[d];
      ov[d * kLanes + sub] = dv[d];
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------
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

// the dq kernel (blocks of 64 query rows), then the dk/dv kernel (blocks of
// 64 keys), on the caller's stream
template <typename KQ, typename KKV>
int launch2(const Args& a, KQ dq_kernel, int dq_threads, size_t s_dq,
            KKV kv_kernel, int kv_threads, size_t s_kv, bool* raised,
            cudaStream_t stream) {
  cudaError_t err = raise_smem(dq_kernel, s_dq, &raised[0]);
  if (err == cudaSuccess) err = raise_smem(kv_kernel, s_kv, &raised[1]);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 g_dq((a.Sq + 63) / 64, a.H, a.B);
  const dim3 g_kv((a.Sk + 63) / 64, a.Hkv, a.B);
  dq_kernel<<<g_dq, dq_threads, s_dq, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  kv_kernel<<<g_kv, kv_threads, s_kv, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int launch_mma(const Args& a, cudaStream_t stream) {
  static bool raised[2] = {false, false};
  return launch2(a, fa_bwd_dq_mma, 128, BT::DQ_SMEM, fa_bwd_dkdv_mma,
                 BT::KV_THREADS, BT::KV_SMEM, raised, stream);
}

template <int D>
int launch_f32(const Args& a, cudaStream_t stream) {
  static bool raised[2] = {false, false};
  return launch2(a, fa_bwd_dq_f32<D>, kThreads, 4 * FT<D>::DQ_FLOATS,
                 fa_bwd_dkdv_f32<D>, kThreads, 4 * FT<D>::KV_FLOATS, raised,
                 stream);
}

// which: as flash_attention_bwd_tiling
long long tiling_mma(int which) {
  switch (which) {
    case 0: return BT::QB;
    case 1: return BT::KT;
    case 2: return 1;
    case 3: return BT::DQ_SMEM;
    case 4: return BT::KB;
    case 5: return BT::QT;
    case 6: return 1;
    case 7: return BT::KV_SMEM;
    case 8: return BT::KV_THREADS;
    default: return -1;
  }
}

template <int D>
long long tiling_f32(int which) {
  switch (which) {
    case 0: return kRows;
    case 1: return FT<D>::KT;
    case 2: return 1;
    case 3: return 4LL * FT<D>::DQ_FLOATS;
    case 4: return kRows;
    case 5: return FT<D>::QT;
    case 6: return 1;
    case 7: return 4LL * FT<D>::KV_FLOATS;
    case 8: return kThreads;
    default: return -1;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (D 16-256), 1 = bfloat16 (D 256).  q, k, v
// contiguous and 16-byte aligned; lse (B,H,Sq) fp32; dO (B,H,Sq,D) at
// do_strides (elements, the last 1; rows 16-byte aligned); dq, dk, dv
// contiguous, in the inputs' type; ws: B*H*Sq floats of delta, then for
// bf16 with H > Hkv 2*B*Hkv*Sk*D floats of the group's sums
int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                               const float* lse, const void* dO, void* dq,
                               void* dk, void* dv, float* ws,
                               const long long* do_strides, int B, int H,
                               int Hkv, int Sq, int Sk, int D, int causal,
                               int window, int dtype, void* stream) {
  if (Hkv < 1 || H % Hkv || Sk < 1 || (dtype != 0 && dtype != 1) ||
      (dtype == 1 && D != 256) || do_strides[3] != 1)
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
  if (dtype == 1) return launch_mma(a, s);
  switch (D) {
    case 16: return launch_f32<16>(a, s);
    case 32: return launch_f32<32>(a, s);
    case 64: return launch_f32<64>(a, s);
    case 128: return launch_f32<128>(a, s);
    case 256: return launch_f32<256>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// the kernels' tiling at head dim D (dtype 0 = float32, 1 = bfloat16):
// which = 0 query rows a dq block, 1 keys a K/V tile, 2 its stages, 3 the
// dq kernel's dynamic shared memory in bytes, 4 keys a dk/dv block, 5 query
// rows a Q/dO tile, 6 its stages, 7 the dk/dv kernel's shared memory, 8 the
// dk/dv kernel's threads; -1 otherwise (bfloat16 at a D other than 256)
long long flash_attention_bwd_tiling(int D, int dtype, int which) {
  if (dtype == 1) return D == 256 ? tiling_mma(which) : -1;
  if (dtype != 0) return -1;
  switch (D) {
    case 16: return tiling_f32<16>(which);
    case 32: return tiling_f32<32>(which);
    case 64: return tiling_f32<64>(which);
    case 128: return tiling_f32<128>(which);
    case 256: return tiling_f32<256>(which);
    default: return -1;
  }
}

}  // extern "C"
