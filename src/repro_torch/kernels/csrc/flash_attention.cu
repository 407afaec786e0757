// Blocked (flash) GQA attention, forward, as CUDA kernels for sm_90a.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention.py:
// flash_attention (body `_kernel`).  Same function: q (B,H,Sq,D) and k, v
// (B,Hkv,Sk,D), f32 or bf16; queries aligned to the END of the keys
// (q_offset = Sk - Sq); causal and sliding-window masks; fp32 running max,
// denominator and accumulator across KV tiles; masked scores set to -1e38
// and the output divided by max(l, 1e-30), as the TPU kernel does; KV head
// h / (H/Hkv), never repeated.  The TPU grid walks the KV blocks of one Q
// tile as its sequential last dimension with the running state in VMEM
// scratch; here one block owns one (b, h, 64-query tile) and loops over the
// KV tiles itself, the running state in registers.  The loop covers only the
// tiles the causal and window predicates can reach (the TPU kernel's
// `pl.when` skip, made into loop bounds).  Any Sq and Sk: q rows past Sq are
// computed on zeros and not stored, keys past Sk are masked.  D is a
// template parameter (16, 32, 64, 128, 256).
//
// bf16: `flash_fwd_kernel_tc`, on the tensor cores (FlashAttention-2's
// forward pass).  4 warps, each owning 16 of the block's 64 query rows.  The
// Q tile is loaded once into registers as mma A-fragments (ldmatrix).  K and
// V tiles of 64 keys stay bf16 in shared memory, rows padded by 16 bytes (8
// consecutive rows of an ldmatrix then fall on 32 distinct banks), double
// buffered with cp.async so that the next tile's load overlaps this tile's
// products; rows past Sq or Sk are zero-filled (src-size 0).  S = Q K^T is
// mma.sync m16n8k16 bf16 -> fp32; the online softmax runs on the
// accumulator fragments (a row's max and sum over the four lanes of a quad,
// by shuffles; fp32 m and l); P is split in registers into two bf16
// A-fragments (hi and lo, below) for P V, V read with ldmatrix.trans: no
// round trip through shared memory.  Masks are applied only on tiles that straddle the
// diagonal, the window's edge or Sk.  The grid is (H, q tiles, B) with the
// q tiles in reverse, so the longest causal tiles of every head start first
// and the tail of the last wave runs short tiles.
//
// Head dim 256 (Gemma) changes two things.  A warp's O accumulator is
// 128 fp32 registers a thread (16 rows x 256 columns over 32 lanes); Q's
// fragments kept in registers would add 64 and the S tile of 64 keys 32, past
// the 255-register limit, so the kernel would spill.  At D 256 the kernel
// therefore (a) reads Q's A-fragments from shared memory at each k-step
// (ldmatrix, 16 a KV tile per warp) instead of holding them, and (b) takes
// KV tiles of 32 keys, so S is 16 registers.  ptxas gives the instance 254
// registers a thread and no spill (240 before P V took P's two bf16
// halves; chip_smoke.py prints its report per instance and fails on a
// spill).  The shared memory is then (64 + 4 x 32) rows x 264 x 2 B =
// 101,376 B, where 64-key tiles would take 168,960 B, one block to an SM.
// Two blocks fit an SM only while the registers allow it too: 256 (254
// rounded up) x 128 threads x 2 = 65,536, the whole register file; past
// 256 a thread, one block.
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
// one bf16 P carries 8 (and TF32 would carry 11); P V then costs two mma
// instructions where it cost one, the kernel's products about 1.5x.  l sums
// the fp32 P.
//
// f32: `flash_fwd_kernel`, fp32 FMAs from shared memory (one block of 256
// threads, four lanes sharing a query row, K/V tiles staged as fp32; 32-key
// tiles from D 128 up, so D 256 takes 34,976 floats, 139,904 B).  This
// is a dispatch by type, not a fallback: the serving path is bf16, and
// TF32 tensor cores would miss the f32 tolerance (2e-5).
//
// Bound on an H100: operations.  At B1 H32 D128 S2048 causal the products
// are ~3.4e10 FLOP (35 us at the 989 TFLOP/s bf16 tensor-core peak) against
// ~42 MB moved (12.5 us at 3.35 TB/s).  What holds the bf16 kernel back now:
// mma.sync reaches about two thirds of Hopper's tensor-core rate at best
// (wgmma fed by TMA, with producer and consumer warps, reaches the rest),
// and each tile pays a block barrier with only 4 warps to hide it.
//
// The launcher takes PyTorch's current stream, allocates nothing and returns
// cudaGetLastError() right after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1.0e38f;     // the TPU kernel's NEG_INF

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------
constexpr int kTcThreads = 128;         // 4 warps x 16 query rows
constexpr int kTcBQ = 64;               // query rows per block
template <int D> struct TcTile {
  static constexpr int LD = D + 8;      // padded bf16 row: 16 bytes extra
  static constexpr int BK = D > 128 ? 32 : 64;   // keys per KV tile
  static constexpr bool kQReg = D <= 128;        // Q's fragments in registers
  static constexpr int smem_bytes = (kTcBQ + 4 * BK) * LD * 2;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16x16 bf16, row) * b (16x8 bf16, col), fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

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

// rows [row0, row0 + R) of a (rows, D) bf16 matrix into a padded tile,
// zero-filling rows at or past `rows`
template <int D, int R>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int row0,
                                          int rows) {
  constexpr int CPR = D / 8;            // 16-byte chunks per row
  constexpr int LD = TcTile<D>::LD;
#pragma unroll
  for (int i = threadIdx.x; i < R * CPR; i += kTcThreads) {
    const int r = i / CPR, c = (i % CPR) * 8;
    const bool ok = row0 + r < rows;
    cp_async16(dst + r * LD + c,
               src + static_cast<size_t>(ok ? row0 + r : 0) * D + c, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(kTcThreads)
flash_fwd_kernel_tc(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    __nv_bfloat16* __restrict__ o, int H, int Hkv, int Sq,
                    int Sk, int causal, int window, float scale_log2) {
  constexpr int LD = TcTile<D>::LD;
  constexpr int BK = TcTile<D>::BK;
  constexpr bool kQReg = TcTile<D>::kQReg;
  constexpr int KS = D / 16;            // k-steps of Q K^T
  constexpr int KQ = kQReg ? KS : 1;    // Q fragments held at once
  constexpr int NS = BK / 8;            // 8-key column blocks of S
  constexpr int ND = D / 8;             // 8-wide column blocks of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + kTcBQ * LD;  // [2][BK][LD]
  __nv_bfloat16* Vs = Ks + 2 * BK * LD;

  const int h = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTcBQ;   // longest first
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int q_offset = Sk - Sq;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* qg = q + (static_cast<size_t>(b) * H + h) * Sq * D;
  const __nv_bfloat16* kg = k + (static_cast<size_t>(b) * Hkv + hk) * Sk * D;
  const __nv_bfloat16* vg = v + (static_cast<size_t>(b) * Hkv + hk) * Sk * D;

  // the KV tiles some query of this tile can reach
  const int q_first = q0 + q_offset;
  const int q_last = min(q0 + kTcBQ, Sq) - 1 + q_offset;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  int k_begin = window > 0 ? max(0, q_first - window + 1) : 0;
  k_begin = (k_begin / BK) * BK;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  load_tile<D, kTcBQ>(Qs, qg, q0, Sq);
  if (n_tiles > 0) {
    load_tile<D, BK>(Ks, kg, k_begin, Sk);
    load_tile<D, BK>(Vs, vg, k_begin, Sk);
  }
  cp_async_commit();

  // this lane's two query rows: g and g + 8 of the warp's 16
  const int row0 = warp * 16 + g;
  const int qpos0 = q0 + row0 + q_offset;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};            // this lane's part of the row sums
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  uint32_t qf[KQ][4];
  const __nv_bfloat16* qrow = Qs + (warp * 16 + (lane & 15)) * LD +
                              (lane >> 4) * 8;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = k_begin + it * BK;
    const int buf = it & 1;
    // one barrier a tile: past it, tile it has landed and every warp is
    // done with tile it-1, whose buffers then take tile it+1
    cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < n_tiles) {
      load_tile<D, BK>(Ks + (buf ^ 1) * BK * LD, kg, k0 + BK, Sk);
      load_tile<D, BK>(Vs + (buf ^ 1) * BK * LD, vg, k0 + BK, Sk);
      cp_async_commit();
    }
    const __nv_bfloat16* Kt = Ks + buf * BK * LD;
    const __nv_bfloat16* Vt = Vs + buf * BK * LD;
    if constexpr (kQReg) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) ldsm_x4(qf[kk], qrow + kk * 16);
      }
    }

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      if constexpr (!kQReg) ldsm_x4(qf[0], qrow + kk * 16);
      const uint32_t (&qa)[4] = qf[kQReg ? kk : 0];
#pragma unroll
      for (int j2 = 0; j2 < NS / 2; ++j2) {
        uint32_t bk[4];
        ldsm_x4(bk, Kt + (j2 * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                        kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * j2], qa, bk[0], bk[1]);
        mma_bf16(s[2 * j2 + 1], qa, bk[2], bk[3]);
      }
    }

    // scale, mask (only on tiles that straddle an edge), online softmax
    const bool edge = k0 + BK > Sk ||
                      (causal && k0 + BK - 1 > q_first) ||
                      (window > 0 && k0 <= q_last - window);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (edge) {
          const int kpos = k0 + 8 * j + 2 * t + (e & 1);
          const int qpos = qpos0 + (e >> 1) * 8;
          const bool ok = kpos < Sk && (!causal || kpos <= qpos) &&
                          (window <= 0 || kpos > qpos - window);
          x = ok ? x : kNegInf;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = exp2_approx(m[r] - m_new);
      m[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int j = 0; j < ND; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= corr[e >> 1];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2_approx(s[j][e] - m[e >> 1]);
        s[j][e] = p;
        l[e >> 1] += p;
      }

    // O += P V: P split into two bf16 A-fragments straight from the S
    // accumulators, hi = bf16(p) and lo = bf16(p - hi), both against the
    // same V fragment into the same fp32 sums
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t ph[4], pl[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int j2 = 0; j2 < ND / 2; ++j2) {
        uint32_t bv[4];
        ldsm_x4_t(bv, Vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                               LD + j2 * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * j2], ph, bv[0], bv[1]);
        mma_bf16(acc[2 * j2], pl, bv[0], bv[1]);
        mma_bf16(acc[2 * j2 + 1], ph, bv[2], bv[3]);
        mma_bf16(acc[2 * j2 + 1], pl, bv[2], bv[3]);
      }
    }
  }
  cp_async_wait<0>();                   // no copy outlives the block

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = 1.0f / fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + row0 + 8 * r;
    if (qi >= Sq) continue;
    __nv_bfloat16* orow = o + (static_cast<size_t>(b) * H + h) * Sq * D +
                          static_cast<size_t>(qi) * D;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * t) =
          __floats2bfloat162_rn(acc[j][2 * r] * l[r],
                                acc[j][2 * r + 1] * l[r]);
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
                 const float* __restrict__ v, float* __restrict__ o, int H,
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
#pragma unroll
    for (int d = 0; d < DPT; ++d) orow[d * kRowThreads + sub] = acc[d] / denom;
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
int launch_tc(const void* q, const void* k, const void* v, void* o, int B,
              int H, int Hkv, int Sq, int Sk, int causal, int window,
              cudaStream_t stream) {
  const size_t smem = TcTile<D>::smem_bytes;
  static bool raised = false;
  cudaError_t err = raise_smem(flash_fwd_kernel_tc<D>, smem, &raised);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(H, (Sq + kTcBQ - 1) / kTcBQ, B);
  const float scale_log2 =
      1.4426950408889634f / sqrtf(static_cast<float>(D));
  flash_fwd_kernel_tc<D><<<grid, kTcThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      H, Hkv, Sq, Sk, causal, window, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B,
               int H, int Hkv, int Sq, int Sk, int causal, int window,
               cudaStream_t stream) {
  const size_t smem = sizeof(float) * Tile<D>::smem_floats;
  static bool raised = false;
  cudaError_t err = raise_smem(flash_fwd_kernel<D>, smem, &raised);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), H, Hkv, Sq, Sk,
      causal, window, 1.0f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int Hkv, int Sq, int Sk, int causal, int window, int dtype,
           cudaStream_t s) {
  if (dtype == 0)
    return launch_f32<D>(q, k, v, o, B, H, Hkv, Sq, Sk, causal, window, s);
  if (dtype == 1)
    return launch_tc<D>(q, k, v, o, B, H, Hkv, Sq, Sk, causal, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  q, k, v, o contiguous (bf16: 16-byte
// aligned); o is (B,H,Sq,D).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int B, int H, int Hkv, int Sq, int Sk,
                           int D, int causal, int window, int dtype,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(q, k, v, o, B, H, Hkv, Sq, Sk, causal, window, dtype, s);
    case 32: return launch<32>(q, k, v, o, B, H, Hkv, Sq, Sk, causal, window, dtype, s);
    case 64: return launch<64>(q, k, v, o, B, H, Hkv, Sq, Sk, causal, window, dtype, s);
    case 128: return launch<128>(q, k, v, o, B, H, Hkv, Sq, Sk, causal, window, dtype, s);
    case 256: return launch<256>(q, k, v, o, B, H, Hkv, Sq, Sk, causal, window, dtype, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
