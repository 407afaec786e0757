// What the two designs of attention's backward share (flash_attention_bwd.cu
// on mma.sync and the FMA units, flash_attention_bwd_wgmma.cu on wgmma fed
// by TMA): the launcher's arguments, the masks and the loop bounds they
// imply, the no-key rows' share of dv and the split of an fp32 operand into
// two bf16 halves.  The function itself is in flash_attention_bwd.cu's
// header.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fa_bwd {

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

// (a, b) -> their bf16 pair hi and the bf16 pair of what hi leaves out
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// a key's dk and dv (columns c, c + 1 of the row at `base`, (bhk Sk + key)
// D) at the end of query head j of a group of G: rounded to bf16 into the
// group's fp32 sums (dk's at a.sums, dv's `plane` = B Hkv Sk D floats on;
// each element owned by one thread), or for the group's last head into the
// outputs
__device__ __forceinline__ void round_into(const Args& a, size_t base,
                                           size_t plane, int c, int j, int G,
                                           float k0, float k1, float v0,
                                           float v1) {
  const __nv_bfloat162 rk = __floats2bfloat162_rn(k0, k1);
  const __nv_bfloat162 rv = __floats2bfloat162_rn(v0, v1);
  bf16* ok = static_cast<bf16*>(a.dk) + base + c;
  bf16* ov = static_cast<bf16*>(a.dv) + base + c;
  if (G == 1) {
    *reinterpret_cast<__nv_bfloat162*>(ok) = rk;
    *reinterpret_cast<__nv_bfloat162*>(ov) = rv;
    return;
  }
  float2* sk = reinterpret_cast<float2*>(a.sums + base + c);
  float2* sv = reinterpret_cast<float2*>(a.sums + plane + base + c);
  float2 fk = __bfloat1622float2(rk), fv = __bfloat1622float2(rv);
  if (j > 0) {
    const float2 pk = *sk, pv = *sv;
    fk.x += pk.x, fk.y += pk.y, fv.x += pv.x, fv.y += pv.y;
  }
  if (j < G - 1) {
    *sk = fk;
    *sv = fv;
  } else {
    *reinterpret_cast<__nv_bfloat162*>(ok) = __floats2bfloat162_rn(fk.x, fk.y);
    *reinterpret_cast<__nv_bfloat162*>(ov) = __floats2bfloat162_rn(fv.x, fv.y);
  }
}

}  // namespace fa_bwd
