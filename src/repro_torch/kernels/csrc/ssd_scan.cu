// Chunked gated linear recurrence (SSD / Mamba2 / mLSTM core), forward, as a
// CUDA kernel for sm_90a.
//
// Replaces the Pallas kernel src/repro/kernels/ssd_scan.py:ssd_scan (body
// `_kernel`).  Same function:
//
//     h_t = exp(log_a_t) h_{t-1} + k_t v_t^T ;   y_t = q_t . h_t
//
// computed chunkwise with the TPU kernel's arithmetic.  Per chunk of Q steps:
// an inclusive cumsum `cum` of log_a; the intra-chunk term
// sum_{s<=t} (q_t.k_s) exp(clip(cum_t - cum_s)) v_s; the inter-chunk term
// exp(clip(cum_t)) q_t.h_in; the state update
// h_out = exp(clip(tot)) h_in + sum_s exp(clip(tot - cum_s)) k_s v_s^T, every
// exponent clipped to [-60, 0]; fp32 state and accumulation whatever the
// input types.  Where it differs from the TPU kernel: it also writes the final
// fp32 (N, P) state (prefill hands it to decode); it takes any S (the tail
// chunk is masked: a padded step has log_a = 0 and k = q = v = 0, so it leaves
// the state as it is and its y is not stored); q and k may have G < H heads,
// read as head h / (H/G) and never repeated; y is written in the caller's
// type (f32 or bf16).
//
// Two kernels, a dispatch by the type of q and k (as flash_attention.cu's
// bf16 and f32 kernels are): bf16 q/k, the model path's, run on Hopper's
// warpgroup tensor cores fed by TMA (`ssd_scan_kernel_wgmma`); f32 q/k on
// fp32 FMAs and mma.sync (`ssd_scan_kernel<V_BF16>`, only the tests and the
// card checks give q/k in f32).
//
// The chain.  Blocks take their work from an atomic ticket in chunk-major
// order, so a block only ever waits for a block that took its ticket earlier
// and is running or done: no launch order is assumed, and no wait can
// deadlock.  A block first computes its chunk's state increment
// sum_s exp(clip(tot - cum_s)) k_s v_s^T, which needs nothing from other
// chunks; only then does it wait for the previous chunk's state (an acquire
// of its flag), write h_out = exp(clip(tot)) h_in + increment, and release
// its own flag; the y pass follows.  So each link of the chain is one read
// of the state from L2 and one write, and the chunks of a head run side by
// side.  The state slots, the ticket and the flags live in the buffers the
// wrapper passes.
//
// bf16 q/k: `ssd_scan_kernel_wgmma<PT, V_BF16>`.  One block per (b, h,
// chunk, P tile of PT columns): column p of the state depends only on v's
// column p, so the P tiles of a chunk are independent but for the chain,
// which runs per P tile (a flag per (chunk, b, h, P tile)).  PT is 64, or 8
// for P <= 8 (xLSTM's normaliser; wgmma's n is at least 8); the wrapper's
// launch_plan picks it and the k ring's depth.  384 threads: warpgroup 0
// produces, warpgroups 1 and 2 consume.  In the producer, one thread keeps
// a ring of 64 x 64 bf16 slabs of k (64 keys x 64 n, 8 KB) in flight by TMA
// (3-D tensor maps (N, S, B*G) swizzled over 128 bytes; rows past S land as
// zeros) and brings each 128-row query block's q (every n slab, resident
// while the block is scored).  Warps 1-3 build the tf32 operand tiles the
// consumers' products read from shared memory: v's tile of 64 keys x PT
// columns, transposed, and the previous state's n slabs, each split into
// tf32 hi and lo parts; their raw tiles land by TMA in two staging buffers
// (v's tile read by the builders where its rows are not 16-byte multiples:
// P = 1).
// setmaxnreg gives the producer 80 registers a thread and the consumers 208
// (96 and 200 at PT 8).
//
//   increment (before the wait), inc (n x p) = sum_s dk_s^T v_s, M-blocks of
//     64 n shared round robin by the two consumer warpgroups (one M-block,
//     N <= 64: each takes half of every key tile's k-steps, the halves added
//     through shared memory).  A = dk^T from registers: the consumer reads
//     k from its TMA slab, scales by es_s = exp(clip(tot - cum_s)) and
//     splits into tf32 hi and lo; B = v^T (PT rows of 64 keys, K-major).
//   y per 128-row query block I (the warpgroups take its two 64-row halves
//     in turns, so the causal work is shared evenly): the inter term q .
//     h_in with A = q from registers (bf16, exact in tf32) and B = the
//     state's n slab (h^T, PT rows of 64 n, K-major), scaled by
//     exp(clip(cum_t)); then for each key tile j the scores S = q k_j^T
//     (wgmma bf16 -> fp32, both operands K-major as TMA lands them), on the
//     fp32 accumulators w = S exp(clip(cum_t - cum_s)) masked to s <= t,
//     split in registers into tf32 hi and lo A fragments, and y += W v_j.
//
// A register that a wgmma in flight reads is never written (a group's
// fragments are rebuilt only after it lands): ptxas otherwise serialises
// every wgmma of the kernel (C7511/C7515), which cost 10-25% here.
//
// wgmma takes 32-bit operands from shared memory K-major only (no transpose
// bit for tf32).  So the states are kept as h^T (P, N) in the slots: a state
// tile is K-major as the B of q . h_in.  v (s, p) is MN-major for both its
// products, so the builders write it transposed, v^T (p, s).  A fragments
// from registers need no layout in memory.  The accumulators hold columns
// 2q, 2q + 1 of each 8-column block where a tf32 A fragment wants columns q,
// q + 4: the kernel takes logical k-step column q as key 2q and q + 4 as key
// 2q + 1, and the builders write every K-major tile's 8-column groups in
// that order (x0 x2 x4 x6 x1 x3 x5 x7), so S's accumulators are W's A
// fragments as they stand.
//
// Precision.  Every product with an fp32 operand keeps fp32 accuracy: each
// fp32 operand is split into tf32 hi = rna(x) and lo = rna(x - hi) (round to
// nearest, ties away, on the 13 low bits), and a_lo b_hi + a_hi b_lo + a_hi
// b_hi (the dropped lo . lo is ~2^-22 of the product); where one operand is
// bf16 (q in q . h_in, v in the "bf16" type), it is exact in tf32 and two
// products do: a b_lo + a b_hi or a_lo b + a_hi b.  The scores of bf16 q, k
// are exact products summed in fp32.
//
// f32 q/k: `ssd_scan_kernel<V_BF16>`, one block of 256 threads per (b, h,
// chunk); work cut into 64 x 64 tiles staged with cp.async (double-buffered);
// the scores by fp32 FMAs, each tile weighted, masked and kept in shared
// memory (every tile of the row block when P > 64); the products with an
// fp32 operand as 3xTF32 on mma.sync m16n8k8.
//
// Bound on an H100: operations.  At Zamba2's B1 H64 S2048 N = P = 64, chunk
// 256 the causal half of the products is ~6.5e9 FLOP: ~2.2e9 of bf16 scores
// at the 989 TFLOP/s bf16 rate and ~4.3e9 with an fp32 operand, at 495
// TFLOP/s three tf32 products each where both operands are fp32 and two
// where one is bf16 (q . h_in): ~0.026 ms, against ~69 MB moved (0.021 ms
// at 3.35 TB/s).  xLSTM's P 384 is 0.030 ms of operations, its P 1 0.0038
// ms of bytes.  The P split recomputes a chunk's scores for each P tile (6 at
// P 384), ~1e9 bf16 FLOP each.
//
// The launchers take PyTorch's current stream, allocate nothing and return
// cudaGetLastError() right after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;      // 16 x 16: ty = tid / 16, tx = tid % 16
constexpr int kT = 64;             // tile edge: t rows, s keys, n, p columns
constexpr int kLdF = kT + 8;       // staged f32 row: 288 bytes (tf32
                                   // fragment loads on distinct banks)
constexpr int kLdH = kT + 8;       // staged bf16 row: 144 bytes (ldmatrix
                                   // rows on distinct banks)
constexpr int kLdW = kT + 4;       // weighted-score tile row (fp32):
                                   // fragment loads on distinct banks
constexpr int kStage = kT * kLdF;  // floats of one staged tile, either type

template <typename T> struct Ld;
template <> struct Ld<float> { static constexpr int v = kLdF; };
template <> struct Ld<bf16> { static constexpr int v = kLdH; };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.0f; }
template <> __device__ __forceinline__ bf16 zero<bf16>() {
  return __float2bfloat16(0.0f);
}

__device__ __forceinline__ float ld(const void* p, int is_bf16, size_t i) {
  return is_bf16 ? __bfloat162float(static_cast<const bf16*>(p)[i])
                 : static_cast<const float*>(p)[i];
}

// exp of an exponent clipped to [-60, 0], as the TPU kernel takes it (the
// fast exp: ~2 ulp, far inside the 1e-4 tolerance)
__device__ __forceinline__ float exp_clip(float x) {
  return __expf(fminf(fmaxf(x, -60.0f), 0.0f));
}

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
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}


// x rounded to tf32 (in a b32 register, low 13 bits zero)
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both tf32: 3xTF32 keeps fp32 accuracy (the lo * lo term it
// drops is ~2^-22 of the product)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// c += a (16x8 tf32, row) * b (8x8 tf32, col), fp32 accumulate
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc += A B for this warp's 16 x 32 part (rows 16 mt .., cols 32 nh ..) of
// a 64 x 64 product over k in [0, k_end), k_end a multiple of 8, in fp32
// operands on the tensor cores as 3xTF32: a_lo b_hi + a_hi b_lo + a_hi b_hi.
// a(m, k) and b(k, n) read the operands from shared memory as fp32.
// acc[jb][e] is row 16 mt + g + 8 (e / 2), column 32 nh + 8 jb + 2 t4 + e % 2.
template <typename FA, typename FB>
__device__ __forceinline__ void mma_3xtf32(float (&acc)[4][4], int mt, int nh,
                                           int k_end, FA&& a, FB&& b) {
  const int lane = threadIdx.x % 32, g = lane >> 2, t4 = lane & 3;
  const int m = 16 * mt + g;
#pragma unroll 2
  for (int k0 = 0; k0 < k_end; k0 += 8) {
    uint32_t ah[4], al[4];
    split_tf32(a(m, k0 + t4), ah[0], al[0]);
    split_tf32(a(m + 8, k0 + t4), ah[1], al[1]);
    split_tf32(a(m, k0 + t4 + 4), ah[2], al[2]);
    split_tf32(a(m + 8, k0 + t4 + 4), ah[3], al[3]);
#pragma unroll
    for (int jb = 0; jb < 4; ++jb) {
      const int n = 32 * nh + 8 * jb + g;
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32(b(k0 + t4, n), bh0, bl0);
      split_tf32(b(k0 + t4 + 4, n), bh1, bl1);
      mma_tf32(acc[jb], al, bh0, bh1);
      mma_tf32(acc[jb], ah, bl0, bl1);
      mma_tf32(acc[jb], ah, bh0, bh1);
    }
  }
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

// a 64 x 64 tile of a row-major (rows, cols) matrix with leading dimension
// `ldg`, from (row0, col0), into shared memory in its own type; entries past
// `rows` or `cols` are zero.  With `vec` (ldg a multiple of 16 bytes and an
// aligned base) by 16-byte cp.async, else by scalar copies.
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* src, int row0,
                                      int rows, int col0, int cols, int ldg,
                                      bool vec) {
  constexpr int V = 16 / sizeof(T);
  constexpr int LDS = Ld<T>::v;
  if (vec) {
    for (int i = threadIdx.x; i < kT * (kT / V); i += kThreads) {
      const int r = i / (kT / V), c = (i % (kT / V)) * V;
      const int gr = row0 + r, gc = col0 + c;
      const bool ok = gr < rows && gc < cols;
      cp_async16(dst + r * LDS + c,
                 ok ? src + static_cast<size_t>(gr) * ldg + gc : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < kT * kT; i += kThreads) {
      const int r = i / kT, c = i % kT;
      const int gr = row0 + r, gc = col0 + c;
      dst[r * LDS + c] = (gr < rows && gc < cols)
                             ? src[static_cast<size_t>(gr) * ldg + gc]
                             : zero<T>();
    }
  }
}

// n steps, each staging up to two tiles into one of two buffers of
// `stages` and then computing on them; step s + 1's copies are in flight
// while step s computes.  One barrier a step: past it, step s's tiles have
// landed and every thread is done with step s - 1's buffer, which step
// s + 1 then fills.  Ends with a barrier, so the buffers are free.
template <typename Fetch, typename Compute>
__device__ __forceinline__ void pipeline(int n, float* stages, Fetch&& fetch,
                                         Compute&& compute) {
  if (n <= 0) return;
  fetch(0, stages);
  cp_async_commit();
  for (int s = 0; s < n; ++s) {
    cp_async_wait_all();
    __syncthreads();
    if (s + 1 < n) {
      fetch(s + 1, stages + ((s + 1) & 1) * 2 * kStage);
      cp_async_commit();
    }
    compute(s, stages + (s & 1) * 2 * kStage);
  }
  __syncthreads();
}

// one step of the y pipeline: its kind, query tile i, P tile, key tile j
// and N tile nn
enum Kind { kInter, kScore, kWv };
struct Step {
  int i, pt, j, nn;
  Kind kind;
};

template <bool V_BF16>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const void* __restrict__ q_, const void* __restrict__ k_,
                const void* __restrict__ v_, const void* __restrict__ la,
                void* __restrict__ y, float* __restrict__ states, int B,
                int H, int G, int S, int N, int P, int Q, int wt_tiles,
                int la_bf16, int y_bf16) {
  using TQ = float;                      // q and k (bf16 q/k: the wgmma kernel)
  using TV = std::conditional_t<V_BF16, bf16, float>;
  constexpr int LQ = Ld<TQ>::v, LV = Ld<TV>::v;
  const TQ* q = static_cast<const TQ*>(q_);
  const TQ* k = static_cast<const TQ*>(k_);
  const TV* v = static_cast<const TV*>(v_);

  extern __shared__ __align__(16) float smem[];
  const int Qp = (Q + kT - 1) / kT * kT;
  float* cum = smem;                     // [Qp] inclusive cumsum of log_a
  float* es = cum + Qp;                  // [Qp] exp(clip(tot - cum_s))
  float* et = es + Qp;                   // [Qp] exp(clip(cum_t))
  float* wt = et + Qp;                   // [wt_tiles][kT][kLdW] scores W[t][s]
  float* stages = wt + wt_tiles * kT * kLdW;   // [2][2][kStage]
  int* ticket_s = reinterpret_cast<int*>(stages + 4 * kStage);

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int BH = B * H;
  const int nc = (S + Q - 1) / Q;
  const size_t NP = static_cast<size_t>(N) * P;
  int* sync = reinterpret_cast<int*>(states + nc * BH * NP);
  if (tid == 0) *ticket_s = atomicAdd(sync, 1);
  __syncthreads();
  const int c = *ticket_s / BH, bh = *ticket_s % BH;   // chunk-major tickets
  const int b = bh / H, h = bh % H, hg = h / (H / G);
  const int c0 = c * Q, L = min(Q, S - c0), nT = (L + kT - 1) / kT;
  const int nN = (N + kT - 1) / kT, nP = (P + kT - 1) / kT;
  const TQ* qc = q + (static_cast<size_t>(b) * G + hg) * S * N +
                 static_cast<size_t>(c0) * N;
  const TQ* kc = k + (static_cast<size_t>(b) * G + hg) * S * N +
                 static_cast<size_t>(c0) * N;
  const TV* vc = v + (static_cast<size_t>(bh) * S + c0) * P;
  const float* h_in =
      c > 0 ? states + (static_cast<size_t>(c - 1) * BH + bh) * NP : nullptr;
  float* h_out = states + (static_cast<size_t>(c) * BH + bh) * NP;
  int* flags = sync + 1;                 // [chunk][b * H + h]
  const bool qk_vec = N % (16 / sizeof(TQ)) == 0 &&
                      reinterpret_cast<uintptr_t>(q_) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(k_) % 16 == 0;
  const bool v_vec = P % (16 / sizeof(TV)) == 0 &&
                     reinterpret_cast<uintptr_t>(v_) % 16 == 0;
  const bool h_vec = P % 4 == 0;        // 16-byte rows of the state
  const bool y_vec = P % 2 == 0 && reinterpret_cast<uintptr_t>(y) % 8 == 0;

  // -- the chunk's cumsum ----------------------------------------------------
  for (int t = tid; t < Qp; t += kThreads)
    cum[t] = t < L ? ld(la, la_bf16, static_cast<size_t>(bh) * S + c0 + t)
                   : 0.0f;
  __syncthreads();
  if (tid < 32) {                        // inclusive scan, one warp
    float carry = 0.0f;
    for (int base = 0; base < Qp; base += 32) {
      float x = cum[base + tid];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float n = __shfl_up_sync(0xffffffffu, x, off);
        if (tid >= off) x += n;
      }
      x += carry;
      cum[base + tid] = x;
      carry = __shfl_sync(0xffffffffu, x, 31);
    }
  }
  __syncthreads();
  const float tot = cum[Qp - 1];         // padded steps add 0
  for (int t = tid; t < Qp; t += kThreads) {
    es[t] = exp_clip(tot - cum[t]);
    et[t] = exp_clip(cum[t]);
  }
  __syncthreads();

  // -- 1, 2: the state, h_out = exp(tot) h_in + sum_s es_s k_s v_s^T ---------
  const float a_tot = exp_clip(tot);
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int mt = warp & 3, nh = warp >> 2;   // this warp's rows 16 mt ..,
                                             // columns (keys) 32 nh .. of a
                                             // 64 x 64 tile
  for (int u = 0; u < nN * nP; ++u) {
    const int n0 = (u / nP) * kT, p0 = (u % nP) * kT;
    float acc[4][4] = {};
    pipeline(
        nT, stages,
        [&](int j, float* st) {
          stage<TQ>(reinterpret_cast<TQ*>(st), kc, j * kT, L, n0, N, N,
                    qk_vec);
          stage<TV>(reinterpret_cast<TV*>(st + kStage), vc, j * kT, L, p0, P,
                    P, v_vec);
        },
        [&](int j, float* st) {
          const TQ* kt = reinterpret_cast<const TQ*>(st);
          const TV* vt = reinterpret_cast<const TV*>(st + kStage);
          const float* e = es + j * kT;
          // (es k)^T v: A(n, s) = es_s k[s][n], B(s, p) = v[s][p]
          mma_3xtf32(
              acc, mt, nh, kT,
              [&](int n, int s) { return e[s] * to_f(kt[s * LQ + n]); },
              [&](int s, int p) { return to_f(vt[s * LV + p]); });
        });
    if (u == 0 && c > 0) {               // the previous chunk's state
      if (tid == 0) {
        const int* f = flags + static_cast<size_t>(c - 1) * BH + bh;
        while (ld_acquire(f) == 0) __nanosleep(64);
      }
      __syncthreads();
    }
#pragma unroll
    for (int jb = 0; jb < 4; ++jb)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int n = n0 + 16 * mt + g + 8 * hr;
        const int p = p0 + 32 * nh + 8 * jb + 2 * t4;
        if (n >= N) continue;
        const size_t i = static_cast<size_t>(n) * P + p;
        if (h_vec && p + 1 < P) {        // 8 bytes at once
          const float2 hin =
              c > 0 ? __ldcg(reinterpret_cast<const float2*>(h_in + i))
                    : make_float2(0.0f, 0.0f);
          *reinterpret_cast<float2*>(h_out + i) =
              make_float2(fmaf(a_tot, hin.x, acc[jb][2 * hr]),
                          fmaf(a_tot, hin.y, acc[jb][2 * hr + 1]));
          continue;
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (p + e >= P) continue;
          const float hin = c > 0 ? __ldcg(h_in + i + e) : 0.0f;
          h_out[i + e] = fmaf(a_tot, hin, acc[jb][2 * hr + e]);
        }
      }
  }
  __syncthreads();                       // every thread's h_out is written
  if (tid == 0) {
    __threadfence();
    st_release(flags + static_cast<size_t>(c) * BH + bh, 1);
  }

  // -- 3: y = exp(cum_t) q_t.h_in + sum_{s<=t} w_ts v_s ----------------------
  // One pipeline over every step of every (query tile i, P tile) of the
  // chunk, so each step's copies overlap the step before: the inter term's
  // N tiles (q_i, h_in); then for each key tile j <= i its score N tiles
  // (q_i, k_j; skipped after the first P tile when every score tile is
  // kept) and its w.v step (v_j).
  const bool keep_all = wt_tiles > 1;    // P > 64: one score tile per j
  auto need_scores = [&](int pt) { return pt == 0 || !keep_all; };
  auto next = [&](Step k) {
    if (k.kind == kInter) {
      if (++k.nn < nN) return k;
      k.nn = 0;
      k.kind = need_scores(k.pt) ? kScore : kWv;
    } else if (k.kind == kScore) {
      if (++k.nn < nN) return k;
      k.nn = 0;
      k.kind = kWv;
    } else if (++k.j <= k.i) {
      k.kind = need_scores(k.pt) ? kScore : kWv;
    } else {
      k.j = 0;
      if (++k.pt == nP) k.pt = 0, ++k.i;
      k.kind = c > 0 ? kInter : need_scores(k.pt) ? kScore : kWv;
    }
    return k;
  };
  auto fetch = [&](const Step& k, float* st) {
    TQ* a = reinterpret_cast<TQ*>(st);
    if (k.kind == kWv) {
      stage<TV>(reinterpret_cast<TV*>(st), vc, k.j * kT, L, k.pt * kT, P, P,
                v_vec);
    } else if (k.kind == kInter) {
      stage<TQ>(a, qc, k.i * kT, L, k.nn * kT, N, N, qk_vec);
      stage<float>(st + kStage, h_in, k.nn * kT, N, k.pt * kT, P, P, h_vec);
    } else {
      stage<TQ>(a, qc, k.i * kT, L, k.nn * kT, N, N, qk_vec);
      stage<TQ>(reinterpret_cast<TQ*>(st + kStage), kc, k.j * kT, L,
                k.nn * kT, N, N, qk_vec);
    }
  };

  float acc[4][4], sc[4][4];
  int tile = -1;
  Step cur{0, 0, 0, 0, c > 0 ? kInter : kScore};
  fetch(cur, stages);
  cp_async_commit();
  // pipeline()'s loop, written out around the steps' cursor: past a step's
  // barrier its tiles have landed and the last step's buffer is free, and
  // so is w, which the last step's w.v may have read
  for (int step = 0; cur.i < nT; ++step) {
    cp_async_wait_all();
    __syncthreads();
    const Step nxt = next(cur);
    if (nxt.i < nT) {
      fetch(nxt, stages + ((step + 1) & 1) * 2 * kStage);
      cp_async_commit();
    }
    float* st = stages + (step & 1) * 2 * kStage;
    const int i = cur.i, j = cur.j, p0 = cur.pt * kT;
    if (cur.i * nP + cur.pt != tile) {   // a new output tile
      tile = cur.i * nP + cur.pt;
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) acc[r][cc] = 0.0f;
    }
    float* w = wt + (keep_all ? j : 0) * kT * kLdW;
    if (cur.kind == kInter) {
      const TQ* qt = reinterpret_cast<const TQ*>(st);
      const float* ht = st + kStage;
      mma_3xtf32(
          acc, mt, nh, kT,
          [&](int t, int n) { return to_f(qt[t * LQ + n]); },
          [&](int n, int p) { return ht[n * kLdF + p]; });
      if (cur.nn == nN - 1) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const float e = et[i * kT + 16 * mt + g + 8 * hr];
#pragma unroll
          for (int jb = 0; jb < 4; ++jb) {
            acc[jb][2 * hr] *= e;
            acc[jb][2 * hr + 1] *= e;
          }
        }
      }
    } else if (cur.kind == kScore) {
      // the weighted scores W[t][s] of query tile i, key tile j
      if (cur.nn == 0) {
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) sc[r][cc] = 0.0f;
      }
      // thread: rows ty + 16 r, keys tx + 16 c
      const float* qt = st;
      const float* kt = st + kStage;
#pragma unroll 4
      for (int n = 0; n < kT; ++n) {
        float a[4], bk[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) a[r] = qt[(ty + 16 * r) * kLdF + n];
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) bk[cc] = kt[(tx + 16 * cc) * kLdF + n];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int cc = 0; cc < 4; ++cc)
            sc[r][cc] = fmaf(a[r], bk[cc], sc[r][cc]);
      }
      if (cur.nn == nN - 1) {
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            const int t = ty + 16 * r, s = tx + 16 * cc;
            const int tg = i * kT + t, sg = j * kT + s;
            w[t * kLdW + s] =
                sg <= tg ? sc[r][cc] * exp_clip(cum[tg] - cum[sg]) : 0.0f;
          }
      }
    } else {
      // acc += W v_j; on the diagonal this warp's rows 16 mt .. + 15 need
      // only keys up to 16 mt + 15
      const TV* vt = reinterpret_cast<const TV*>(st);
      mma_3xtf32(
          acc, mt, nh, j == i ? 16 * mt + 16 : kT,
          [&](int t, int s) { return w[t * kLdW + s]; },
          [&](int s, int p) { return to_f(vt[s * LV + p]); });
      if (j == i) {                      // the tile's last step: store y
#pragma unroll
        for (int jb = 0; jb < 4; ++jb)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int t = i * kT + 16 * mt + g + 8 * hr;
            const int p = p0 + 32 * nh + 8 * jb + 2 * t4;
            if (t >= L || p >= P) continue;
            const size_t at = (static_cast<size_t>(bh) * S + c0 + t) * P + p;
            const float y0 = acc[jb][2 * hr], y1 = acc[jb][2 * hr + 1];
            if (y_vec && p + 1 < P) {    // 8 (f32) or 4 (bf16) bytes
              if (y_bf16)
                *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(y) +
                                                   at) =
                    __floats2bfloat162_rn(y0, y1);
              else
                *reinterpret_cast<float2*>(static_cast<float*>(y) + at) =
                    make_float2(y0, y1);
              continue;
            }
            if (y_bf16) {
              static_cast<bf16*>(y)[at] = __float2bfloat16(y0);
              if (p + 1 < P) static_cast<bf16*>(y)[at + 1] = __float2bfloat16(y1);
            } else {
              static_cast<float*>(y)[at] = y0;
              if (p + 1 < P) static_cast<float*>(y)[at + 1] = y1;
            }
          }
      }
    }
    cur = nxt;
  }
}

// ---------------------------------------------------------------------------
// bf16 q/k on wgmma fed by TMA
// ---------------------------------------------------------------------------
namespace wg {

constexpr int kThreads = 384;          // producer + 2 consumer warpgroups
constexpr int kConsumers = 256;
constexpr int kBuilders = 96;          // warps 1-3 of the producer warpgroup
// setmaxnreg's split, 80 x 128 + 208 x 256 <= 168 x 384; the 8-column
// tile's builders take 96 and its consumers 200 (so neither spills)
template <int PT> constexpr int kProducerRegs = PT == 8 ? 96 : 80;
template <int PT> constexpr int kConsumerRegs = PT == 8 ? 200 : 208;
constexpr int kSlab = 64 * 128;        // 64 rows x 64 bf16, 128-byte rows
constexpr int kQSlab = 2 * kSlab;      // a 128-row query block's n slab
constexpr int kFStages = 2;            // the tf32 operand tiles' ring
constexpr int kBarConsumers = 1, kBarBuilders = 2;   // named barriers

// a tf32 operand tile of the F ring: PT rows of 64 (keys or n), two
// 32-column slabs of 128-byte rows; the hi part, then the lo part
__host__ __device__ constexpr int f_part(int pt) { return pt * 256; }
__host__ __device__ constexpr int f_bytes(int pt) { return 2 * f_part(pt); }

// the cumsum arrays' length: whole 128-row query blocks
__host__ __device__ inline int q_pad(int Q) { return (Q + 127) / 128 * 128; }

// byte offsets in the dynamic shared memory past its 1024-byte alignment:
// the query block (every n slab), the k ring of ks slabs, the F ring, the
// builders'
// two staging buffers, the halves' exchange when one M-block holds N, the
// cumsum and its exponentials, the mbarriers and the block's ticket
struct Smem {
  int q, k, f, raw, red, cum, bars, end;
};

__host__ __device__ inline Smem smem_layout(int N, int Q, int pt, int ks) {
  const int nN = (N + 63) / 64;
  Smem m;
  m.q = 0;
  m.k = m.q + nN * kQSlab;
  m.f = m.k + ks * kSlab;
  m.raw = m.f + kFStages * f_bytes(pt);
  m.red = m.raw + 2 * 64 * pt * 4;
  m.cum = m.red + (nN == 1 ? 64 * pt * 4 : 0);
  m.bars = m.cum + 3 * q_pad(Q) * 4;
  m.end = m.bars + 8 * (2 * ks + 2 * kFStages + 4) + 16;
  return m;
}

// the dynamic shared memory of a block: 1024 bytes of slack to align the
// tiles on the swizzle's atoms, then the layout
__host__ __device__ inline int smem_bytes(int N, int Q, int pt, int ks) {
  return 1024 + smem_layout(N, Q, pt, ks).end;
}

// x rounded to tf32 as cvt.rna.tf32.f32 rounds it: to nearest, ties away
// from zero, on the 13 low bits of the word (finite x)
__device__ __forceinline__ uint32_t tf32_bits(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ float tf32_round(float x) {
  return __uint_as_float(tf32_bits(x));
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_bits(x);
  lo = tf32_bits(x - __uint_as_float(hi));
}

// bf16 element (row r, column c) of a 64-column slab as TMA lands it
// (128-byte rows, 16-byte chunks XOR-permuted by r % 8)
__device__ __forceinline__ float slab_bf16(const unsigned char* slab, int r,
                                           int c) {
  const unsigned short u = *reinterpret_cast<const unsigned short*>(
      slab + r * 128 + (((c >> 3) ^ (r & 7)) << 4) + ((c & 7) << 1));
  return __uint_as_float(static_cast<uint32_t>(u) << 16);
}

// 8 consecutive values x of row r, K group gk (columns 8 gk .. 8 gk + 7) of
// a K-major tf32 tile of `rows` rows, in the kernel's k order (x0 x2 x4 x6
// x1 x3 x5 x7): their tf32 hi part at `f`, and with `lo` the lo part at
// f + f_part(rows)
__device__ __forceinline__ void store_group(unsigned char* f, int rows,
                                            int r, int gk,
                                            const float (&x)[8], bool lo) {
  unsigned char* row = f + (gk >> 2) * rows * 128 + r * 128;
  const int c0 = 2 * (gk & 3), sw = r & 7;
  float h[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) h[e] = tf32_round(x[e]);
  *reinterpret_cast<float4*>(row + ((c0 ^ sw) << 4)) =
      make_float4(h[0], h[2], h[4], h[6]);
  *reinterpret_cast<float4*>(row + (((c0 + 1) ^ sw) << 4)) =
      make_float4(h[1], h[3], h[5], h[7]);
  if (!lo) return;
  float l[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) l[e] = tf32_round(x[e] - h[e]);
  row += f_part(rows);
  *reinterpret_cast<float4*>(row + ((c0 ^ sw) << 4)) =
      make_float4(l[0], l[2], l[4], l[6]);
  *reinterpret_cast<float4*>(row + (((c0 + 1) ^ sw) << 4)) =
      make_float4(l[1], l[3], l[5], l[7]);
}

// One block's work.
struct Job {
  int S, N, P, BH;
  int c, nc, bh, bhg, p0, c0, L;
  int nN, nT, nTB, ks;
  // the last key tile of query block I
  __device__ int jmax(int I) const { return min(nT - 1, 2 * I + 1); }
};

// the descriptor of k-step kk (8 columns) of an F tile's part at `part`
template <int PT>
__device__ __forceinline__ uint64_t f_desc(uint32_t part, int kk) {
  return hopper::smem_desc(part + (kk >> 2) * (PT * 128) + (kk & 3) * 32, 16,
                           1024, 128);
}

// acc += A B over k-steps kk0 .. kk0 + KK - 1 of the F tile at `fb`, A in
// tf32 hi and lo fragments: a_lo b_hi + a_hi b_lo + a_hi b_hi, or a_lo b +
// a_hi b when B is exact in tf32 (bf16 v); issued and committed
template <int PT, int KK, bool B_EXACT>
__device__ __forceinline__ void issue_split(float (&acc)[PT / 2],
                                            uint32_t (&hi)[KK][4],
                                            uint32_t (&lo)[KK][4],
                                            uint32_t fb, int kk0) {
  hopper::fence_operands(acc);
#pragma unroll
  for (int i = 0; i < KK; ++i) {
    hopper::fence_operands(hi[i]);
    hopper::fence_operands(lo[i]);
  }
  hopper::wgmma_fence();
#pragma unroll
  for (int i = 0; i < KK; ++i) {
    const uint64_t bh = f_desc<PT>(fb, kk0 + i);
    hopper::WgmmaTf32<PT>::rs(acc, lo[i], bh, 1);
    if (!B_EXACT)
      hopper::WgmmaTf32<PT>::rs(acc, hi[i],
                                f_desc<PT>(fb + f_part(PT), kk0 + i), 1);
    hopper::WgmmaTf32<PT>::rs(acc, hi[i], bh, 1);
  }
  hopper::wgmma_commit();
}

// acc += q h over the 8 k-steps of one n slab: A = q (exact in tf32), B =
// h^T's slab in hi and lo parts: q h_lo + q h_hi; issued and committed
template <int PT>
__device__ __forceinline__ void issue_inter(float (&acc)[PT / 2],
                                            uint32_t (&a)[8][4],
                                            uint32_t fb) {
  hopper::fence_operands(acc);
#pragma unroll
  for (int i = 0; i < 8; ++i) hopper::fence_operands(a[i]);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    hopper::WgmmaTf32<PT>::rs(acc, a[kk], f_desc<PT>(fb + f_part(PT), kk), 1);
    hopper::WgmmaTf32<PT>::rs(acc, a[kk], f_desc<PT>(fb, kk), 1);
  }
  hopper::wgmma_commit();
}

// S (+)= q k^T over one 64-column n slab (4 k-steps of 16), both K-major
// in 128-byte swizzled slabs; the first slab's first k-step overwrites S
// (scale-d 0), which is neither cleared nor fenced first
__device__ __forceinline__ void issue_s(float (&sc)[32], uint32_t qa,
                                        uint32_t kb, bool first) {
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    hopper::Wgmma<64>::ss<0, 0>(
        sc, hopper::smem_desc(qa + kk * 32, 16, 1024, 128),
        hopper::smem_desc(kb + kk * 32, 16, 1024, 128),
        first && kk == 0 ? 0 : 1);
  hopper::wgmma_commit();
}

// wait for a chain flag (an acquire); a flag that never comes traps after
// hopper::kWaitLimitNs rather than holding the card
__device__ __forceinline__ void wait_flag(const int* flag) {
  if (ld_acquire(flag) != 0) return;
  const uint64_t t0 = hopper::global_ns();
  while (ld_acquire(flag) == 0) {
    __nanosleep(64);
    if (hopper::global_ns() - t0 > hopper::kWaitLimitNs) __trap();
  }
}

// the producer thread: the k slabs of the increment, then per query block
// its q slabs and the k slabs of its key tiles, in the consumers' order
__device__ __forceinline__ void produce(const Job& j, const CUtensorMap* tq,
                                        const CUtensorMap* tk, uint32_t sq,
                                        uint32_t sk, uint64_t* kfull,
                                        uint64_t* kempty, uint64_t* qfull,
                                        uint64_t* qempty) {
  hopper::tma_prefetch(tq);
  hopper::tma_prefetch(tk);
  int item = 0;
  auto kload = [&](int t, int nn) {
    const int s = item % j.ks;
    if (item >= j.ks) hopper::mbar_wait(kempty + s, ((item / j.ks) - 1) & 1);
    hopper::mbar_expect_tx(kfull + s, kSlab);
    hopper::tma_load_3d(sk + s * kSlab, tk, nn * 64, j.c0 + 64 * t, j.bhg,
                        kfull + s);
    ++item;
  };
  for (int t = 0; t < j.nT; ++t)
    for (int nn = 0; nn < j.nN; ++nn) kload(t, nn);
  for (int I = 0; I < j.nTB; ++I) {
    if (I > 0) hopper::mbar_wait(qempty, (I - 1) & 1);
    hopper::mbar_expect_tx(qfull, j.nN * kQSlab);
    for (int nn = 0; nn < j.nN; ++nn)
      for (int half = 0; half < 2; ++half)
        hopper::tma_load_3d(sq + nn * kQSlab + half * kSlab, tq, nn * 64,
                            j.c0 + 128 * I + 64 * half, j.bhg, qfull);
    for (int t = 0; t <= j.jmax(I); ++t)
      for (int nn = 0; nn < j.nN; ++nn) kload(t, nn);
  }
}

// the builders (warps 1-3 of the producer warpgroup, bt = 0 .. 95): v^T of
// each key tile the consumers take, and before each query block the
// previous state's n slabs, split into tf32 hi and lo, in the consumers'
// order.  Each item's raw tile lands in one of two staging buffers (v's 64
// rows of PT columns in its type; h^T's PT rows of 64 n) by TMA, issued by
// builder 0 one item ahead, while the item before is split and written.
// Where v's rows are not 16-byte multiples (P = 1) the builders read its
// tile themselves.  The first h^T slab waits for the previous chunk's
// flag.
template <int PT, bool V_BF16>
__device__ __forceinline__ void build(const Job& j, int bt, const void* v_,
                                      const CUtensorMap* tv,
                                      const CUtensorMap* th, bool v_tma,
                                      const int* flag_in,
                                      unsigned char* fring, unsigned char* raw,
                                      uint64_t* rawfull, uint64_t* ffull,
                                      uint64_t* fempty) {
  using TV = std::conditional_t<V_BF16, bf16, float>;
  const TV* v = static_cast<const TV*>(v_);
  int total = j.nT;
  for (int I = 0; I < j.nTB; ++I)
    total += (j.c > 0 ? j.nN : 0) + j.jmax(I) + 1;
  // item x: an h^T slab (true) or a v^T tile, and its index
  auto item = [&](int x, int& idx) {
    if (x < j.nT) {
      idx = x;
      return false;
    }
    x -= j.nT;
    for (int I = 0;; ++I) {
      if (j.c > 0) {
        if (x < j.nN) {
          idx = x;
          return true;
        }
        x -= j.nN;
      }
      if (x <= j.jmax(I)) {
        idx = x;
        return false;
      }
      x -= j.jmax(I) + 1;
    }
  };
  int fetched = 0;                     // items whose copies were issued
  int uses0 = 0, uses1 = 0;            // TMA copies into each buffer
  auto issue = [&](int x) {
    int idx;
    const bool is_h = item(x, idx);
    ++fetched;
    if (!is_h && !v_tma) return;       // read at its turn
    if (x & 1)
      ++uses1;
    else
      ++uses0;
    if (bt != 0) return;
    const uint32_t dst = hopper::smem_u32(raw + (x & 1) * (64 * PT * 4));
    if (is_h) {
      hopper::mbar_expect_tx(rawfull + (x & 1), PT * 64 * 4);
      hopper::tma_load_3d(dst, th, 64 * idx, j.p0, (j.c - 1) * j.BH + j.bh,
                          rawfull + (x & 1));
    } else {
      hopper::mbar_expect_tx(rawfull + (x & 1), 64 * PT * sizeof(TV));
      hopper::tma_load_3d(dst, tv, j.p0, j.c0 + 64 * idx, j.bh,
                          rawfull + (x & 1));
    }
  };
  // item x's raw tile has landed
  auto ready = [&](int x) {
    int idx;
    const bool is_h = item(x, idx);
    if (is_h || v_tma) {
      hopper::mbar_wait(rawfull + (x & 1), ((x & 1 ? uses1 : uses0) - 1) & 1);
      return;
    }
    TV* rv = reinterpret_cast<TV*>(raw + (x & 1) * (64 * PT * 4));
#pragma unroll 1
    for (int i = bt; i < 64 * PT; i += kBuilders) {
      const int gs = 64 * idx + i / PT, gp = j.p0 + i % PT;
      rv[i] = gs < j.L && gp < j.P
                  ? v[(static_cast<size_t>(j.bh) * j.S + j.c0 + gs) * j.P + gp]
                  : zero<TV>();
    }
    hopper::bar_sync(kBarBuilders, kBuilders);
  };
  // split item x's raw tile into the next F slot (v's rows past L, which
  // TMA reads from the next chunk, as zeros)
  auto process = [&](int x) {
    int idx;
    const bool is_h = item(x, idx);
    const int s = x % kFStages;
    if (x >= kFStages)
      hopper::mbar_wait(fempty + s, ((x / kFStages) - 1) & 1);
    unsigned char* f = fring + s * f_bytes(PT);
    const unsigned char* r = raw + (x & 1) * (64 * PT * 4);
#pragma unroll 1
    for (int gi = bt; gi < 8 * PT; gi += kBuilders) {
      float e[8];
      if (is_h) {                      // row p, n 8 (gi % 8) ..
        const float4* src =
            reinterpret_cast<const float4*>(r + (gi / 8) * 256 + (gi % 8) * 32);
        const float4 a = src[0], b = src[1];
        e[0] = a.x, e[1] = a.y, e[2] = a.z, e[3] = a.w;
        e[4] = b.x, e[5] = b.y, e[6] = b.z, e[7] = b.w;
        store_group(f, PT, gi / 8, gi % 8, e, true);
      } else {                         // column p, keys 8 sg ..
        const int p = gi % PT, sg = gi / PT;
        const TV* rv = reinterpret_cast<const TV*>(r);
#pragma unroll
        for (int k = 0; k < 8; ++k)
          e[k] = 64 * idx + 8 * sg + k < j.L ? to_f(rv[(8 * sg + k) * PT + p])
                                             : 0.0f;
        store_group(f, PT, p, sg, e, !V_BF16);
      }
    }
    hopper::fence_proxy_async();
    hopper::mbar_arrive(ffull + s);
  };
  bool flag_seen = j.c == 0;
  for (int x = 0; x < total; ++x) {
    int idx;
    if (fetched == x) {                // not prefetched: the first h^T slab
      if (item(x, idx) && !flag_seen) {
        if (bt == 0) {
          wait_flag(flag_in);
          hopper::fence_proxy_async_global();
        }
        hopper::bar_sync(kBarBuilders, kBuilders);
        flag_seen = true;
      }
      issue(x);
    }
    if (x + 1 < total && (flag_seen || !item(x + 1, idx))) issue(x + 1);
    ready(x);
    process(x);
    hopper::bar_sync(kBarBuilders, kBuilders);   // raw[x & 1] is free
  }
}

// state: the final state (B, H, N, P); slots: the chunk states but the
// last, each (B, H, P, N) (h^T); sync: the block ticket, then a flag per
// (chunk, b * H + h, P tile), zeroed
template <int PT, bool V_BF16>
__global__ void __launch_bounds__(kThreads, 1)
ssd_scan_kernel_wgmma(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap th, int v_tma,
                      const void* __restrict__ v, const void* __restrict__ la,
                      void* __restrict__ y, float* __restrict__ state,
                      float* __restrict__ slots, int* __restrict__ sync,
                      int B, int H, int G, int S, int N, int P, int Q,
                      int ks, int la_bf16, int y_bf16) {
  constexpr int NA = PT / 2;           // an m64nPT accumulator, per thread
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  const Smem lay = smem_layout(N, Q, PT, ks);
  const int Qp = q_pad(Q);
  const uint32_t sbase = hopper::smem_u32(base);
  const uint32_t sq = sbase + lay.q, sk = sbase + lay.k, sf = sbase + lay.f;
  float* red = reinterpret_cast<float*>(base + lay.red);
  float* cum = reinterpret_cast<float*>(base + lay.cum);   // [Qp]
  float* es = cum + Qp;                // [Qp] exp(clip(tot - cum_s)), 0 past L
  float* et = es + Qp;                 // [Qp] exp(clip(cum_t))
  uint64_t* kfull = reinterpret_cast<uint64_t*>(base + lay.bars);
  uint64_t* kempty = kfull + ks;
  uint64_t* ffull = kempty + ks;
  uint64_t* fempty = ffull + kFStages;
  uint64_t* qfull = fempty + kFStages;
  uint64_t* qempty = qfull + 1;
  uint64_t* rawfull = qempty + 1;      // [2]
  int* ticket_s = reinterpret_cast<int*>(rawfull + 2);

  const int tid = threadIdx.x;
  const int BH = B * H, nPt = (P + PT - 1) / PT;
  if (tid == 0) {
    *ticket_s = atomicAdd(sync, 1);
    for (int s = 0; s < ks; ++s) {
      hopper::mbar_init(kfull + s, 1);
      hopper::mbar_init(kempty + s, 8);          // one arrival a warp
    }
    for (int s = 0; s < kFStages; ++s) {
      hopper::mbar_init(ffull + s, kBuilders);
      hopper::mbar_init(fempty + s, 8);
    }
    hopper::mbar_init(qfull, 1);
    hopper::mbar_init(qempty, 8);
    hopper::mbar_init(rawfull, 1);
    hopper::mbar_init(rawfull + 1, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  Job j;
  j.S = S, j.N = N, j.P = P, j.BH = B * H;
  j.ks = ks;
  const int ticket = *ticket_s;        // chunk-major
  const int pt = ticket % nPt;
  j.nc = (S + Q - 1) / Q;
  j.c = ticket / (BH * nPt);
  j.bh = ticket % (BH * nPt) / nPt;
  j.p0 = pt * PT;
  j.bhg = j.bh / H * G + j.bh % H / (H / G);
  j.c0 = j.c * Q;
  j.L = min(Q, S - j.c0);
  j.nN = (N + 63) / 64;
  j.nT = (j.L + 63) / 64;
  j.nTB = (j.L + 127) / 128;
  const size_t NP = static_cast<size_t>(N) * P;
  int* flags = sync + 1;               // [chunk][b * H + h][P tile]
  const int* flag_in =
      flags + (static_cast<size_t>(j.c - 1) * BH + j.bh) * nPt + pt;
  int* flag_out = flags + (static_cast<size_t>(j.c) * BH + j.bh) * nPt + pt;
  // the chunk states as h^T (P, N) per (b, h); the last chunk writes the
  // final state (N, P) instead
  const float* h_in =
      j.c > 0 ? slots + (static_cast<size_t>(j.c - 1) * BH + j.bh) * NP
              : nullptr;
  float* h_out = slots + (static_cast<size_t>(j.c) * BH + j.bh) * NP;

  // the warpgroup's index, warp-uniform to the compiler (setmaxnreg's
  // regions must not reconverge)
  const int wgi = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (wgi == 0) {
    hopper::setmaxnreg_dec<kProducerRegs<PT>>();
    if (tid == 0)
      produce(j, &tq, &tk, sq, sk, kfull, kempty, qfull, qempty);
    else if (tid >= 32)
      build<PT, V_BF16>(j, tid - 32, v, &tv, &th, v_tma != 0, flag_in,
                        base + lay.f, base + lay.raw, rawfull, ffull, fempty);
    return;
  }
  hopper::setmaxnreg_inc<kConsumerRegs<PT>>();

  const int ct = tid - 128, w = wgi - 1, lt = ct % 128;
  const int warp = lt / 32, lane = lt % 32, g = lane >> 2, q4 = lane & 3;

  // -- the chunk's cumsum ----------------------------------------------------
  for (int t = ct; t < Qp; t += kConsumers)
    cum[t] = t < j.L ? ld(la, la_bf16,
                          static_cast<size_t>(j.bh) * S + j.c0 + t)
                     : 0.0f;
  hopper::bar_sync(kBarConsumers, kConsumers);
  if (ct < 32) {                       // inclusive scan, one warp
    float carry = 0.0f;
    for (int b0 = 0; b0 < Qp; b0 += 32) {
      float x = cum[b0 + ct];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float n = __shfl_up_sync(0xffffffffu, x, off);
        if (ct >= off) x += n;
      }
      x += carry;
      cum[b0 + ct] = x;
      carry = __shfl_sync(0xffffffffu, x, 31);
    }
  }
  hopper::bar_sync(kBarConsumers, kConsumers);
  const float tot = cum[Qp - 1];       // padded steps add 0
  for (int t = ct; t < Qp; t += kConsumers) {
    es[t] = t < j.L ? exp_clip(tot - cum[t]) : 0.0f;
    et[t] = exp_clip(cum[t]);
  }
  hopper::bar_sync(kBarConsumers, kConsumers);

  const unsigned char* kgen = base + lay.k;
  const unsigned char* qgen = base + lay.q;
  // ring items by their index x: the k ring's slot x % ks, the F ring's
  // x % kFStages; a warp releases an item with one arrival
  int kitem = 0, fitem = 0;
  auto kwait = [&](int x) {
    hopper::mbar_wait(kfull + x % ks, (x / ks) & 1);
    return x % ks;
  };
  auto krelease = [&](int x) {
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(kempty + x % ks);
  };
  auto fwait = [&](int x) {
    hopper::mbar_wait(ffull + x % kFStages, (x / kFStages) & 1);
    return sf + (x % kFStages) * f_bytes(PT);
  };
  auto frelease = [&](int x) {
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(fempty + x % kFStages);
  };

  // -- 1: the increment, inc (n x p) = sum_s dk_s^T v_s ----------------------
  // M-block mb (n 64 mb ..) of warpgroup w: mb = w + 2 m; with one M-block
  // both take it, warpgroup w each key tile's k-steps 4 w .. 4 w + 3
  const bool halves = j.nN == 1;
  float inc[3][NA];
#pragma unroll
  for (int m = 0; m < 3; ++m)
#pragma unroll
    for (int i = 0; i < NA; ++i) inc[m][i] = 0.0f;
  {
    // dk^T's A fragments for k-steps kk0 .. kk0 + 3 of key tile t from its
    // k slab: rows n = 16 warp + g (+ 8), keys 8 kk + 2 q4 (+ 1).  A
    // group's fragments are rebuilt only once it has landed: a register a
    // wgmma in flight reads is never written (else ptxas serialises every
    // wgmma of the kernel)
    uint32_t f_hi[4][4], f_lo[4][4];
    auto group = [&](float (&acc)[NA], const unsigned char* kt, int t,
                     int kk0, uint32_t fb) {
      const int n = 16 * warp + g;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = 8 * (kk0 + i) + 2 * q4;
        const float e0 = es[64 * t + s], e1 = es[64 * t + s + 1];
        split(e0 * slab_bf16(kt, s, n), f_hi[i][0], f_lo[i][0]);
        split(e0 * slab_bf16(kt, s, n + 8), f_hi[i][1], f_lo[i][1]);
        split(e1 * slab_bf16(kt, s + 1, n), f_hi[i][2], f_lo[i][2]);
        split(e1 * slab_bf16(kt, s + 1, n + 8), f_hi[i][3], f_lo[i][3]);
      }
      issue_split<PT, 4, V_BF16>(acc, f_hi, f_lo, fb, kk0);
      hopper::wgmma_wait<0>();
    };
    for (int t = 0; t < j.nT; ++t) {
      const uint32_t fb = fwait(fitem);    // v^T of key tile t
      for (int nn = 0; nn < j.nN; ++nn) {
        const unsigned char* kt = kgen + kwait(kitem) * kSlab;
#pragma unroll
        for (int m = 0; m < 3; ++m) {
          if (halves ? m != 0 : w + 2 * m != nn) continue;
          if (halves) {
            group(inc[m], kt, t, 4 * w, fb);
          } else {
            group(inc[m], kt, t, 0, fb);
            group(inc[m], kt, t, 4, fb);
          }
        }
        krelease(kitem++);
      }
      hopper::wgmma_wait<0>();
      frelease(fitem++);
    }
#pragma unroll
    for (int m = 0; m < 3; ++m) hopper::fence_operands(inc[m]);
  }

  // -- 2: the state, h_out = exp(clip(tot)) h_in + inc ------------------------
  if (halves) {                        // warpgroup 1's half into 0's
    if (w == 1)
#pragma unroll
      for (int i = 0; i < NA; ++i) red[lt * NA + i] = inc[0][i];
    hopper::bar_sync(kBarConsumers, kConsumers);
    if (w == 0)
#pragma unroll
      for (int i = 0; i < NA; ++i) inc[0][i] += red[lt * NA + i];
  }
  if (j.c > 0) {
    if (ct == 0) wait_flag(flag_in);
    hopper::bar_sync(kBarConsumers, kConsumers);
  }
  {
    const float a_tot = exp_clip(tot);
    const bool last = j.c == j.nc - 1;
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      const int mb = halves ? (w == 0 && m == 0 ? 0 : -1) : w + 2 * m;
      if (mb < 0 || mb >= j.nN) continue;
      // every load of the M-block first, then the stores
      float hv[NA];
#pragma unroll
      for (int i = 0; i < NA; ++i) {
        const int n = 64 * mb + 16 * warp + g + 8 * ((i >> 1) & 1);
        const int p = j.p0 + 8 * (i >> 2) + 2 * q4 + (i & 1);
        hv[i] = j.c > 0 && n < N && p < P
                    ? __ldcg(h_in + static_cast<size_t>(p) * N + n)
                    : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < NA; ++i) {
        const int n = 64 * mb + 16 * warp + g + 8 * ((i >> 1) & 1);
        const int p = j.p0 + 8 * (i >> 2) + 2 * q4 + (i & 1);
        if (n >= N || p >= P) continue;
        const float out = fmaf(a_tot, hv[i], inc[m][i]);
        if (last)
          state[(static_cast<size_t>(j.bh) * N + n) * P + p] = out;
        else
          h_out[static_cast<size_t>(p) * N + n] = out;
      }
    }
    __threadfence();
    hopper::bar_sync(kBarConsumers, kConsumers);
    if (ct == 0) st_release(flag_out, 1);
  }

  // -- 3: y = exp(clip(cum_t)) q_t . h_in + sum_{s<=t} w_ts v_s --------------
  const bool y_vec = P % 2 == 0 && reinterpret_cast<uintptr_t>(y) % 8 == 0;
  uint32_t qa[8][4];
  // q's A fragments of this warpgroup's rows in n slab nn: rows 16 warp + g
  // (+ 8), n 8 kk + 2 q4 and + 1 (one 4-byte load of two bf16)
  int hw = w;                          // the block's half this warpgroup takes
  auto q_frags = [&](int nn, uint32_t (&a)[8][4]) {
    const unsigned char* qs = qgen + nn * kQSlab + hw * kSlab;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * warp + g + 8 * h;
        const uint32_t two = *reinterpret_cast<const uint32_t*>(
            qs + r * 128 + ((kk ^ (r & 7)) << 4) + (q4 << 2));
        a[kk][h] = two << 16;
        a[kk][2 + h] = two & 0xffff0000u;
      }
  };
  float sc[32];
  uint32_t w_hi[8][4], w_lo[8][4];
  for (int I = 0; I < j.nTB; ++I) {
    hopper::mbar_wait(qfull, I & 1);
    // the warpgroups take the query block's halves in turns (block I: half
    // w ^ (I & 1)), so the causal work is shared evenly
    hw = w ^ (I & 1);
    const int r0 = 128 * I + 64 * hw + 16 * warp + g;   // rows r0, r0 + 8
    float acc[NA];
#pragma unroll
    for (int i = 0; i < NA; ++i) acc[i] = 0.0f;
    if (j.c > 0) {                     // the inter term
      for (int nn = 0; nn < j.nN; ++nn) {
        q_frags(nn, qa);
        issue_inter<PT>(acc, qa, fwait(fitem + nn));
        hopper::wgmma_wait<0>();       // before qa is rebuilt
        if (nn > 0) frelease(fitem + nn - 1);
      }
      hopper::wgmma_wait<0>();
      frelease(fitem + j.nN - 1);
      fitem += j.nN;
      hopper::fence_operands(acc);
      const float e0 = et[r0], e1 = et[r0 + 8];
#pragma unroll
      for (int i = 0; i < NA; ++i) acc[i] *= (i & 2) ? e1 : e0;
    }
    // the intra term over key tiles t <= jmax(I); half hw's rows see key
    // tile t when t <= 2 I + hw
    int pending = -1;                  // the F tile whose w.v is in flight
    for (int t = 0; t <= j.jmax(I); ++t) {
      const bool see = t <= 2 * I + hw;
      for (int nn = 0; nn < j.nN; ++nn) {
        const int s = kwait(kitem + nn);
        if (!see) {
          krelease(kitem + nn);
          continue;
        }
        issue_s(sc, sq + nn * kQSlab + hw * kSlab, sk + s * kSlab, nn == 0);
        if (nn > 0) {                  // slab nn - 1's products are done
          hopper::wgmma_wait<1>();
          krelease(kitem + nn - 1);
        }
      }
      hopper::wgmma_wait<0>();
      if (see) {
        krelease(kitem + j.nN - 1);
        hopper::fence_operands(sc);
      }
      kitem += j.nN;
      if (pending >= 0) {              // the last w.v has landed
        frelease(pending);
        pending = -1;
      }
      const uint32_t fb = fwait(fitem);    // v^T of key tile t
      if (!see) {
        frelease(fitem++);
        continue;
      }
      // w = S exp(clip(cum_t - cum_s)) for s <= t (and s < L), split into
      // tf32 hi and lo: the accumulators' n8 block jb is k-step jb's A
      // fragment, columns 2 q4 and 2 q4 + 1 taken as q4 and q4 + 4
      const float ct0 = cum[r0], ct1 = cum[r0 + 8];
#pragma unroll
      for (int jb = 0; jb < 8; ++jb) {
        const int s0 = 64 * t + 8 * jb + 2 * q4;
        const float cs0 = cum[s0], cs1 = cum[s0 + 1];
        const bool in0 = s0 < j.L, in1 = s0 + 1 < j.L;
        split(in0 && s0 <= r0 ? sc[4 * jb] * exp_clip(ct0 - cs0) : 0.0f,
              w_hi[jb][0], w_lo[jb][0]);
        split(in0 && s0 <= r0 + 8 ? sc[4 * jb + 2] * exp_clip(ct1 - cs0)
                                  : 0.0f,
              w_hi[jb][1], w_lo[jb][1]);
        split(in1 && s0 + 1 <= r0 ? sc[4 * jb + 1] * exp_clip(ct0 - cs1)
                                  : 0.0f,
              w_hi[jb][2], w_lo[jb][2]);
        split(in1 && s0 + 1 <= r0 + 8
                  ? sc[4 * jb + 3] * exp_clip(ct1 - cs1)
                  : 0.0f,
              w_hi[jb][3], w_lo[jb][3]);
      }
      issue_split<PT, 8, V_BF16>(acc, w_hi, w_lo, fb, 0);
      pending = fitem++;
    }
    hopper::wgmma_wait<0>();
    if (pending >= 0) frelease(pending);
    hopper::fence_operands(acc);

    // q's block is free once every score product has landed
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(qempty);
    // y, rows r0 and r0 + 8 of the chunk
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = r0 + 8 * h;
      if (t >= j.L) continue;
      const size_t row = (static_cast<size_t>(j.bh) * S + j.c0 + t) * P;
#pragma unroll
      for (int jb = 0; jb < PT / 8; ++jb) {
        const int p = j.p0 + 8 * jb + 2 * q4;
        if (p >= P) continue;
        const float y0 = acc[4 * jb + 2 * h], y1 = acc[4 * jb + 2 * h + 1];
        const size_t at = row + p;
        if (y_vec && p + 1 < P) {
          if (y_bf16)
            *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(y) + at) =
                __floats2bfloat162_rn(y0, y1);
          else
            *reinterpret_cast<float2*>(static_cast<float*>(y) + at) =
                make_float2(y0, y1);
          continue;
        }
        if (y_bf16) {
          static_cast<bf16*>(y)[at] = __float2bfloat16(y0);
          if (p + 1 < P) static_cast<bf16*>(y)[at + 1] = __float2bfloat16(y1);
        } else {
          static_cast<float*>(y)[at] = y0;
          if (p + 1 < P) static_cast<float*>(y)[at + 1] = y1;
        }
      }
    }
  }
}

}  // namespace wg

// the dynamic shared memory a block of the current device may opt in to
cudaError_t smem_optin(int* bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                dev);
}

// raise a kernel's shared-memory limit to the opt-in maximum once per
// instance, at its first launch (never again, so a later launch may be
// captured into a CUDA graph); the launch's own size decides the occupancy
template <typename K>
cudaError_t raise_smem(K kernel, bool* raised) {
  if (*raised) return cudaSuccess;
  int optin = 0;
  cudaError_t err = smem_optin(&optin);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
  if (err == cudaSuccess) *raised = true;
  return err;
}

template <bool V_BF16>
int launch_f32(const void* q, const void* k, const void* v, const void* la,
               void* y, float* states, int B, int H, int G, int S, int N,
               int P, int Q, int wt_tiles, int smem, int la_bf16, int y_bf16,
               cudaStream_t stream) {
  static bool raised = false;
  cudaError_t err = raise_smem(ssd_scan_kernel<V_BF16>, &raised);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks =
      static_cast<unsigned>((S + Q - 1) / Q) * static_cast<unsigned>(B * H);
  ssd_scan_kernel<V_BF16><<<blocks, kThreads, smem, stream>>>(
      q, k, v, la, y, states, B, H, G, S, N, P, Q, wt_tiles, la_bf16, y_bf16);
  return static_cast<int>(cudaGetLastError());
}

template <int PT, bool V_BF16>
int launch_wgmma(const void* q, const void* k, const void* v, const void* la,
                 void* y, float* state, float* slots, int* sync, int B, int H,
                 int G, int S, int N, int P, int Q, int ks, int la_bf16,
                 int y_bf16, cudaStream_t stream) {
  static bool raised = false;
  cudaError_t err =
      raise_smem(wg::ssd_scan_kernel_wgmma<PT, V_BF16>, &raised);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap tq, tk;
  const CUtensorMapDataType t = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const uint64_t bg = static_cast<uint64_t>(B) * G;
  int e = hopper::encode_3d(&tq, t, 2, q, N, S, bg, 64, 64, 128);
  if (e == 0) e = hopper::encode_3d(&tk, t, 2, k, N, S, bg, 64, 64, 128);
  // v's tiles (64 rows of PT columns) where its rows are 16-byte multiples;
  // the chunk states' n slabs (PT rows of 64 n), h^T (P, N) a slice
  const int ev = V_BF16 ? 2 : 4;
  const int v_tma = (static_cast<long long>(P) * ev) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(v) % 16 == 0;
  const int nc = (S + Q - 1) / Q;
  CUtensorMap tv = tq, th;
  if (e == 0 && v_tma)
    e = hopper::encode_3d(&tv,
                          V_BF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                          ev, v, P, S, static_cast<uint64_t>(B) * H, PT, 64,
                          0);
  if (e == 0)
    e = hopper::encode_3d(&th, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, slots, N,
                          P, static_cast<uint64_t>(nc > 1 ? nc - 1 : 1) * B * H,
                          64, PT, 0);
  if (e != 0) return e;
  const unsigned blocks = static_cast<unsigned>((S + Q - 1) / Q) *
                          static_cast<unsigned>(B * H) *
                          static_cast<unsigned>((P + PT - 1) / PT);
  wg::ssd_scan_kernel_wgmma<PT, V_BF16>
      <<<blocks, wg::kThreads, wg::smem_bytes(N, Q, PT, ks), stream>>>(
          tq, tk, tv, th, v_tma, v, la, y, state, slots, sync, B, H, G, S, N,
          P, Q, ks, la_bf16, y_bf16);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// *bytes: the shared memory a block may opt in to on the current device,
// which bounds the chunk (f32 q/k) or N (bf16 q/k) the wrapper can take.
int ssd_scan_smem_optin(int* bytes) {
  return static_cast<int>(smem_optin(bytes));
}

// f32 q and k.  q, k (B,G,S,N); v, y (B,H,S,P); la (B,H,S); all contiguous.
// state: fp32 chunk states (ceil(S/Q), B, H, N, P), the last the final state,
// followed by 1 + ceil(S/Q)*B*H int32 words the caller zeroed (the block
// ticket, the chunk flags).  *_bf16: 1 for bfloat16, 0 for float32.
// wt_tiles: weighted score tiles kept in shared memory (1, or ceil(Q/64)
// when P > 64); smem: the dynamic shared memory in bytes (the wrapper's
// formula).
int ssd_scan_launch(const void* q, const void* k, const void* v,
                    const void* la, void* y, void* state, int B, int H, int G,
                    int S, int N, int P, int Q, int wt_tiles, int smem,
                    int v_bf16, int la_bf16, int y_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* st = static_cast<float*>(state);
  if (v_bf16)
    return launch_f32<true>(q, k, v, la, y, st, B, H, G, S, N, P, Q,
                            wt_tiles, smem, la_bf16, y_bf16, s);
  return launch_f32<false>(q, k, v, la, y, st, B, H, G, S, N, P, Q,
                           wt_tiles, smem, la_bf16, y_bf16, s);
}

// bf16 q and k, N a multiple of 8, q and k 16-byte aligned (the tensor
// maps').  state: the final state (B,H,N,P) fp32; slots: the chunk states
// but the last, (ceil(S/Q) - 1, B, H, P, N) fp32 (h^T); sync: 1 +
// ceil(S/Q)*B*H*ceil(P/p_tile) int32 words the caller zeroed (the block
// ticket, a flag per chunk, head and P tile).  p_tile: 8 or 64; k_stages:
// the k ring's stages (the shared memory is ssd_scan_wgmma_smem's).
int ssd_scan_wgmma_launch(const void* q, const void* k, const void* v,
                          const void* la, void* y, void* state, void* slots,
                          void* sync, int B, int H, int G, int S, int N,
                          int P, int Q, int p_tile, int k_stages, int v_bf16,
                          int la_bf16, int y_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* st = static_cast<float*>(state);
  float* sl = static_cast<float*>(slots);
  int* sy = static_cast<int*>(sync);
  if (N % 8 != 0 || k_stages < 2 || (p_tile != 8 && p_tile != 64))
    return static_cast<int>(cudaErrorInvalidValue);
  if (p_tile == 8)
    return v_bf16 ? launch_wgmma<8, true>(q, k, v, la, y, st, sl, sy, B, H,
                                          G, S, N, P, Q, k_stages, la_bf16,
                                          y_bf16, s)
                  : launch_wgmma<8, false>(q, k, v, la, y, st, sl, sy, B, H,
                                           G, S, N, P, Q, k_stages, la_bf16,
                                           y_bf16, s);
  return v_bf16 ? launch_wgmma<64, true>(q, k, v, la, y, st, sl, sy, B, H, G,
                                         S, N, P, Q, k_stages, la_bf16,
                                         y_bf16, s)
                : launch_wgmma<64, false>(q, k, v, la, y, st, sl, sy, B, H,
                                          G, S, N, P, Q, k_stages, la_bf16,
                                          y_bf16, s);
}

// the bf16 kernel's dynamic shared memory in bytes (launch_plan's formula)
long long ssd_scan_wgmma_smem(int N, int Q, int p_tile, int k_stages) {
  return wg::smem_bytes(N, Q, p_tile, k_stages);
}

}  // extern "C"
