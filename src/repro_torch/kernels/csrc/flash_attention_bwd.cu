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
// bf16: mma.sync.m16n8k16 with fp32 accumulation, 4 warps of 16 rows (at D
// 256 the dk/dv kernel takes 8 warps, two to a 16-key slab, each holding
// half of D's columns of dk and dv: 128 + 128 fp32 a thread would not fit).
// Operands from shared memory by ldmatrix (.trans where the product
// contracts over a tile's rows), rows padded by 16 bytes; tiles by cp.async,
// the next tile's copy in flight under the current tile's products (one
// stage at D 256, where two would halve the blocks an SM holds).  q.k and
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
// Zamba2's train shape (B4 H32 S2048 D64 causal) 1.72e11 FLOP, 0.174 ms at
// the H100's 989 TFLOP/s bf16 peak, 0.278 ms with the hi/lo passes.
//
// The launcher takes PyTorch's current stream, allocates nothing (the
// wrapper passes the workspace) and returns cudaGetLastError() after the
// second launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* lse;      // (B*H, Sq), natural base
  const void* dO;        // rows at do_sb, do_sh, do_ss elements; D stride 1
  void* dq;
  void* dk;
  void* dv;
  float* delta;          // (B*H, Sq), written by the dq kernel
  float* sums;           // bf16 with H > Hkv: dk then dv, (B*Hkv, Sk, D) each
  long long do_sb, do_sh, do_ss;
  int B, H, Hkv, Sq, Sk, causal, window;
  float scale;           // 1 / sqrt(D)
  float scale_log2;      // log2(e) / sqrt(D)
};

__device__ __forceinline__ bool visible(const Args& a, int qi, int kj) {
  const int qpos = qi + a.Sk - a.Sq;
  return qi < a.Sq && kj < a.Sk && (!a.causal || kj <= qpos) &&
         (a.window <= 0 || kj > qpos - a.window);
}

// the keys [k_begin, k_end) some row of [q0, q1) sees (q1 <= Sq)
__device__ __forceinline__ void key_range(const Args& a, int q0, int q1,
                                          int& k_begin, int& k_end) {
  const int off = a.Sk - a.Sq;
  k_end = a.causal ? min(a.Sk, q1 + off) : a.Sk;
  k_begin = a.window > 0 ? max(0, q0 + off - a.window + 1) : 0;
  k_end = max(k_end, k_begin);
}

// the queries [q_begin, q_end) that see some key of [k0, k1) (k1 <= Sk)
__device__ __forceinline__ void query_range(const Args& a, int k0, int k1,
                                            int& q_begin, int& q_end) {
  const int off = a.Sk - a.Sq;
  q_begin = a.causal ? max(0, k0 - off) : 0;
  q_end = a.window > 0
              ? static_cast<int>(min(static_cast<long long>(a.Sq),
                                     static_cast<long long>(k1) - 1 +
                                         a.window - off))
              : a.Sq;
  q_end = max(q_end, q_begin);
}

// dO / Sk summed over the rows that see no key, column c, head bh
template <typename T>
__device__ __forceinline__ float no_key_dv(const Args& a, int b, int h,
                                           int c, int n0) {
  const T* g = static_cast<const T*>(a.dO) + b * a.do_sb + h * a.do_sh + c;
  float s = 0.0f;
  for (int r = 0; r < n0; ++r) s += static_cast<float>(g[r * a.do_ss]);
  return s / static_cast<float>(a.Sk);
}

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

// (a, b) -> their bf16 pair hi and the bf16 pair of what hi leaves out
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
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

template <int D> struct BT {
  static constexpr int LD = D + 8;                 // a row, 16 bytes padded
  // dq kernel: 64 query rows, 4 warps; KT keys a tile
  static constexpr int QB = 64;
  static constexpr int KT = D > 128 ? 32 : 64;
  static constexpr int DQ_ST = D > 128 ? 1 : 2;    // K/V tile stages
  static constexpr int DQ_SMEM = 2 * (2 * QB * LD + DQ_ST * 2 * KT * LD);
  // dk/dv kernel: 64 keys; 4 warps of 16 keys x DS column splits; QT
  // query rows a tile
  static constexpr int KB = 64;
  static constexpr int DS = D > 128 ? 2 : 1;
  static constexpr int DC = D / DS;
  static constexpr int QT = D > 64 ? 32 : 64;
  static constexpr int KV_ST = D > 128 ? 1 : 2;    // Q/dO tile stages
  static constexpr int KV_THREADS = 128 * DS;
  static constexpr int KV_SMEM =
      2 * (2 * KB * LD + KV_ST * 2 * QT * LD) + 4 * (KV_ST * 2 * QT + D);
};

template <int D>
__global__ void __launch_bounds__(128)
fa_bwd_dq_mma(const Args a) {
  using T = BT<D>;
  constexpr int LD = T::LD, QB = T::QB, KT = T::KT, ST = T::DQ_ST;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sdO = sQ + QB * LD;
  bf16* sK = sdO + QB * LD;                        // stage s at + 2 s KT LD
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
    bf16* s = sK + (step % ST) * 2 * KT * LD;
    load_rows<D, KT, LD, 128>(s, k + static_cast<size_t>(k0) * D, D,
                              a.Sk - k0, tid);
    load_rows<D, KT, LD, 128>(s + KT * LD, v + static_cast<size_t>(k0) * D,
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

  const int steps = 2 * n_t;
  if (steps > 0 && ST == 2) issue(0);
  cp_commit();                          // with Q and dO
  for (int step = 0; step < steps; ++step) {
    if (ST == 2 && step + 1 < steps) {
      issue(step + 1);
      cp_commit();
      cp_wait<1>();
    } else {
      if (ST == 1) {
        issue(step);
        cp_commit();
      }
      cp_wait<0>();
    }
    __syncthreads();
    const bf16* tK = sK + (step % ST) * 2 * KT * LD;
    const bf16* tV = tK + KT * LD;
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

template <int D>
__global__ void __launch_bounds__(BT<D>::KV_THREADS)
fa_bwd_dkdv_mma(const Args a) {
  using T = BT<D>;
  constexpr int LD = T::LD, KB = T::KB, QT = T::QT, ST = T::KV_ST;
  constexpr int DC = T::DC, NT = T::KV_THREADS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + KB * LD;
  bf16* sQ = sV + KB * LD;                         // stage s at + 2 s QT LD
  float* sL = reinterpret_cast<float*>(sQ + ST * 2 * QT * LD);  // lse2, delta
  float* sX = sL + ST * 2 * QT;                    // the no-key rows' dv
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
    bf16* s = sQ + (step % ST) * 2 * QT * LD;
    load_rows<D, QT, LD, NT>(s, static_cast<const bf16*>(a.q) +
                                    (bh * a.Sq + qs) * D, D, a.Sq - qs, tid);
    load_rows<D, QT, LD, NT>(
        s + QT * LD,
        static_cast<const bf16*>(a.dO) + b * a.do_sb + h * a.do_sh +
            static_cast<long long>(qs) * a.do_ss,
        a.do_ss, a.Sq - qs, tid);
    float* l = sL + (step % ST) * 2 * QT;
    for (int i = tid; i < QT; i += NT) {
      const int qi = qs + i;
      l[i] = qi < a.Sq ? a.lse[bh * a.Sq + qi] * kLog2e : 0.0f;
      l[QT + i] = qi < a.Sq ? a.delta[bh * a.Sq + qi] : 0.0f;
    }
  };

  const int key0 = k0 + 16 * slab + g;    // this lane's keys: + 0, + 8
  float dk[DC / 8][4], dv[DC / 8][4];
#pragma unroll
  for (int i = 0; i < DC / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.0f;

  if (n_t > 0 && ST == 2) issue(0);
  cp_commit();                          // with K and V
  for (int j = 0; j < G; ++j) {
    const int h = hk * G + j;
    for (int it = 0; it < n_t; ++it) {
      const int step = j * n_t + it;
      if (ST == 2 && step + 1 < G * n_t) {
        issue(step + 1);
        cp_commit();
        cp_wait<1>();
      } else {
        if (ST == 1) {
          issue(step);
          cp_commit();
        }
        cp_wait<0>();
      }
      __syncthreads();
      const bf16* tQ = sQ + (step % ST) * 2 * QT * LD;
      const bf16* tdO = tQ + QT * LD;
      const float* l = sL + (step % ST) * 2 * QT;
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
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (key0 + 8 * r >= a.Sk) continue;
      const size_t base = (bhk * a.Sk + key0 + 8 * r) * D + half * DC;
      float* sk = a.sums + base;
      float* sv = a.sums + static_cast<size_t>(a.B) * a.Hkv * a.Sk * D + base;
#pragma unroll
      for (int nb = 0; nb < DC / 8; ++nb) {
        const int c = 8 * nb + 2 * t;
        const __nv_bfloat162 rk =
            __floats2bfloat162_rn(dk[nb][2 * r], dk[nb][2 * r + 1]);
        const __nv_bfloat162 rv =
            __floats2bfloat162_rn(dv[nb][2 * r], dv[nb][2 * r + 1]);
        if (G == 1) {
          *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(a.dk) + base + c) = rk;
          *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(a.dv) + base + c) = rv;
          continue;
        }
        float2 fk = __bfloat1622float2(rk), fv = __bfloat1622float2(rv);
        if (j > 0) {
          const float2 ok = *reinterpret_cast<const float2*>(sk + c);
          const float2 ov = *reinterpret_cast<const float2*>(sv + c);
          fk.x += ok.x, fk.y += ok.y, fv.x += ov.x, fv.y += ov.y;
        }
        if (j < G - 1) {
          *reinterpret_cast<float2*>(sk + c) = fk;
          *reinterpret_cast<float2*>(sv + c) = fv;
        } else {
          *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(a.dk) + base + c) =
              __floats2bfloat162_rn(fk.x, fk.y);
          *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(a.dv) + base + c) =
              __floats2bfloat162_rn(fv.x, fv.y);
        }
      }
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

template <int D>
long long smem_bytes(int dtype, int which) {
  if (dtype == 1) return which == 0 ? BT<D>::DQ_SMEM : BT<D>::KV_SMEM;
  return 4LL * (which == 0 ? FT<D>::DQ_FLOATS : FT<D>::KV_FLOATS);
}

template <int D>
int launch(const Args& a, int dtype, cudaStream_t stream) {
  static bool raised[4] = {false, false, false, false};
  const size_t s_dq = smem_bytes<D>(dtype, 0), s_kv = smem_bytes<D>(dtype, 1);
  const dim3 g_dq((a.Sq + 63) / 64, a.H, a.B);
  const dim3 g_kv((a.Sk + 63) / 64, a.Hkv, a.B);
  cudaError_t err;
  if (dtype == 1) {
    err = raise_smem(fa_bwd_dq_mma<D>, s_dq, &raised[0]);
    if (err == cudaSuccess)
      err = raise_smem(fa_bwd_dkdv_mma<D>, s_kv, &raised[1]);
    if (err != cudaSuccess) return static_cast<int>(err);
    fa_bwd_dq_mma<D><<<g_dq, 128, s_dq, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    fa_bwd_dkdv_mma<D><<<g_kv, BT<D>::KV_THREADS, s_kv, stream>>>(a);
  } else {
    err = raise_smem(fa_bwd_dq_f32<D>, s_dq, &raised[2]);
    if (err == cudaSuccess)
      err = raise_smem(fa_bwd_dkdv_f32<D>, s_kv, &raised[3]);
    if (err != cudaSuccess) return static_cast<int>(err);
    fa_bwd_dq_f32<D><<<g_dq, kThreads, s_dq, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    fa_bwd_dkdv_f32<D><<<g_kv, kThreads, s_kv, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  q, k, v contiguous and 16-byte
// aligned; lse (B,H,Sq) fp32; dO (B,H,Sq,D) at do_strides (elements, the
// last 1; rows 16-byte aligned); dq, dk, dv contiguous, in the inputs'
// type; ws: B*H*Sq floats of delta, then for bf16 with H > Hkv
// 2*B*Hkv*Sk*D floats of the group's sums
int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                               const float* lse, const void* dO, void* dq,
                               void* dk, void* dv, float* ws,
                               const long long* do_strides, int B, int H,
                               int Hkv, int Sq, int Sk, int D, int causal,
                               int window, int dtype, void* stream) {
  if (Hkv < 1 || H % Hkv || Sk < 1 || (dtype != 0 && dtype != 1) ||
      do_strides[3] != 1)
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
    case 16: return launch<16>(a, dtype, s);
    case 32: return launch<32>(a, dtype, s);
    case 64: return launch<64>(a, dtype, s);
    case 128: return launch<128>(a, dtype, s);
    case 256: return launch<256>(a, dtype, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
