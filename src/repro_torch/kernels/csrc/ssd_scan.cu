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
// Design.  The TPU grid walks the chunks as its sequential minor dimension
// with the state in VMEM scratch.  Here one block of 256 threads owns one
// (b, h, chunk), so B*H*chunks blocks fill the card (Zamba2 at B 1, S 2048,
// chunk 256: 512 blocks on 132 SMs, where one block per (b, h) left half of
// them idle), and the chunks of one head form a chain through the state:
//   1. the block's chunk state increment sum_s exp(tot - cum_s) k_s v_s^T,
//      which needs nothing from other chunks;
//   2. wait for the previous chunk's state (an acquire of its flag), write
//      h_out = exp(tot) h_in + increment into this chunk's slot, release
//      this chunk's flag;
//   3. y: the inter term from h_in (read from L2), then the intra term.
// Only step 2 is on the chain, so the chunks of a head run side by side.
// Blocks take their chunk from an atomic ticket in chunk-major order, so a
// block only ever waits for a block that took its ticket earlier and is
// running or done: no launch order is assumed, and no wait can deadlock.
// The state slots, the ticket and the flags live in the `state` buffer the
// wrapper passes (chunks x (B,H,N,P) fp32, then zeroed int32 words); the last
// slot is the final state.
//
// Work is cut into 64 x 64 tiles (t rows, s keys, n and p columns), staged
// in shared memory in their own types with cp.async (double-buffered: the
// next tile's copy overlaps this tile's products; rows past the chunk are
// zero-filled).  The q.k scores are computed once per (b, h, chunk) and
// 64 x 64 tile pair: with bf16 q/k (the model path and the "bf16" types) on
// the tensor cores, mma.sync m16n8k16 bf16 -> fp32, which is the exact
// products summed in another order; with f32 q/k by fp32 FMAs.  Each score
// tile is weighted by exp(clip(cum_t - cum_s)), masked to s <= t and kept in
// shared memory as fp32 (for P > 64, every tile of the row block is kept, so
// the scores are not recomputed for each 64-column P tile).  The products
// with an fp32 operand (w.v, q.h_in, (dk)^T.v) go to the tensor cores as
// 3xTF32: each fp32 operand is split into a tf32 high part and a tf32 low
// part, and a_lo b_hi + a_hi b_lo + a_hi b_hi (mma.sync m16n8k8 tf32 ->
// fp32) keeps fp32 accuracy (the dropped a_lo b_lo is ~2^-22 of the
// product); no fp32 operand is rounded to bf16 or to a single TF32.  Each
// warp owns a 16 x 32 part of every 64 x 64 product; shared-memory rows are
// padded so the fragment loads fall on distinct banks.
//
// Why not share the scores across the heads of a q/k group (Zamba2 has one
// group for 64 heads): on the tensor cores they cost ~2% of the block's
// work, while a block per group would leave most SMs idle or carry 64
// heads' state, and a pre-pass through L2 adds a launch and its traffic.
//
// Bound on an H100: operations.  At B1 H64 S2048 N = P = 64, chunk 256 the
// causal half of the products is ~6.5e9 FLOP: ~2.2e9 of bf16 q.k scores,
// exact in fp32, at the 989 TFLOP/s tensor-core rate, and ~4.3e9 with f32
// operands at 67 TFLOP/s, together 0.066 ms, against ~69 MB moved with
// Zamba2's one group of q/k in bf16 and v, y in fp32 (0.021 ms at 3.35
// TB/s).  With the f32 products done as 3xTF32 (three tf32 products each at
// the 495 TFLOP/s TF32 rate) the operation bound becomes ~0.028 ms.  What
// holds it back now: each 64 x 64 step is a few microseconds of work between
// block barriers with 16 warps an SM to hide them, the split of every fp32
// operand into two tf32 parts costs ALU work beside the mma, and the chunk's
// steps run one after another.

// The launcher takes PyTorch's current stream, allocates nothing and returns
// cudaGetLastError() right after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
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

template <bool QK_BF16, bool V_BF16>
__global__ void __launch_bounds__(kThreads, 2)
ssd_scan_kernel(const void* __restrict__ q_, const void* __restrict__ k_,
                const void* __restrict__ v_, const void* __restrict__ la,
                void* __restrict__ y, float* __restrict__ states, int B,
                int H, int G, int S, int N, int P, int Q, int wt_tiles,
                int la_bf16, int y_bf16) {
  using TQ = std::conditional_t<QK_BF16, bf16, float>;
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
      if constexpr (QK_BF16) {
        const bf16* qt = reinterpret_cast<const bf16*>(st);
        const bf16* kt = reinterpret_cast<const bf16*>(st + kStage);
        // on the diagonal, keys 32.. of rows ..31 are all masked
        if (j < i || 32 * nh <= 16 * mt + 15) {
#pragma unroll
          for (int kk = 0; kk < kT / 16; ++kk) {
            uint32_t a[4];
            ldsm_x4(a, qt + (16 * mt + (lane & 15)) * kLdH + kk * 16 +
                           (lane >> 4) * 8);
#pragma unroll
            for (int j2 = 0; j2 < 2; ++j2) {
              uint32_t bk[4];
              ldsm_x4(bk, kt + (32 * nh + 16 * j2 + (lane & 7) +
                                ((lane >> 4) << 3)) * kLdH +
                               kk * 16 + ((lane >> 3) & 1) * 8);
              mma_bf16(sc[2 * j2], a, bk[0], bk[1]);
              mma_bf16(sc[2 * j2 + 1], a, bk[2], bk[3]);
            }
          }
        }
        if (cur.nn == nN - 1) {
#pragma unroll
          for (int jb = 0; jb < 4; ++jb)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int t = 16 * mt + g + 8 * (e >> 1);
              const int s = 32 * nh + 8 * jb + 2 * t4 + (e & 1);
              const int tg = i * kT + t, sg = j * kT + s;
              w[t * kLdW + s] =
                  sg <= tg ? sc[jb][e] * exp_clip(cum[tg] - cum[sg]) : 0.0f;
            }
        }
      } else {
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

// the dynamic shared memory a block of the current device may opt in to
cudaError_t smem_optin(int* bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                dev);
}

template <bool QK_BF16, bool V_BF16>
int launch(const void* q, const void* k, const void* v, const void* la,
           void* y, float* states, int B, int H, int G, int S, int N, int P,
           int Q, int wt_tiles, int smem, int la_bf16, int y_bf16,
           cudaStream_t stream) {
  // raise the shared-memory limit to the opt-in maximum once per instance,
  // at the first launch (never again, so a later launch may be captured
  // into a CUDA graph); the launch's own size decides the occupancy
  static bool limit_raised = false;
  if (!limit_raised) {
    int optin = 0;
    cudaError_t err = smem_optin(&optin);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(ssd_scan_kernel<QK_BF16, V_BF16>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 optin);
    if (err != cudaSuccess) return static_cast<int>(err);
    limit_raised = true;
  }
  const unsigned blocks =
      static_cast<unsigned>((S + Q - 1) / Q) * static_cast<unsigned>(B * H);
  ssd_scan_kernel<QK_BF16, V_BF16><<<blocks, kThreads, smem, stream>>>(
      q, k, v, la, y, states, B, H, G, S, N, P, Q, wt_tiles, la_bf16, y_bf16);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// *bytes: the shared memory a block may opt in to on the current device,
// which bounds the chunk the wrapper can take.
int ssd_scan_smem_optin(int* bytes) {
  return static_cast<int>(smem_optin(bytes));
}

// q, k (B,G,S,N); v, y (B,H,S,P); la (B,H,S); all contiguous.  state: fp32
// chunk states (ceil(S/Q), B, H, N, P), the last the final state, followed
// by 1 + ceil(S/Q)*B*H int32 words the caller zeroed (the block ticket, the
// chunk flags).  *_bf16: 1 for bfloat16, 0 for float32.  wt_tiles: weighted
// score tiles kept in shared memory (1, or ceil(Q/64) when P > 64); smem: the
// dynamic shared memory in bytes (the wrapper's formula).
int ssd_scan_launch(const void* q, const void* k, const void* v,
                    const void* la, void* y, void* state, int B, int H, int G,
                    int S, int N, int P, int Q, int wt_tiles, int smem,
                    int qk_bf16, int v_bf16, int la_bf16, int y_bf16,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* st = static_cast<float*>(state);
  if (qk_bf16 && v_bf16)
    return launch<true, true>(q, k, v, la, y, st, B, H, G, S, N, P, Q,
                              wt_tiles, smem, la_bf16, y_bf16, s);
  if (qk_bf16)
    return launch<true, false>(q, k, v, la, y, st, B, H, G, S, N, P, Q,
                               wt_tiles, smem, la_bf16, y_bf16, s);
  if (v_bf16)
    return launch<false, true>(q, k, v, la, y, st, B, H, G, S, N, P, Q,
                               wt_tiles, smem, la_bf16, y_bf16, s);
  return launch<false, false>(q, k, v, la, y, st, B, H, G, S, N, P, Q,
                              wt_tiles, smem, la_bf16, y_bf16, s);
}

}  // extern "C"
