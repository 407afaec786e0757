// The all-to-all hop of the device graph path, as two CUDA kernels for sm_90a.
//
// Replaces the Pallas kernel src/repro/kernels/a2a_fused.py:a2a_fused (body
// `_kernel`).  That kernel routes each token (softmax + top-1), claims its
// first-come position in its expert's lane from per-expert cursors carried
// across the sequential token-block grid, runs every expert function on the
// block and *selects* the routed output, zero-filling tokens past capacity.
// A CUDA kernel cannot call the user's expert functions, so the hop is split:
//
//   a2a_route    logits (T,E) f32 -> idx (T,) i32, pos (T,) i32, keep (T,) u8
//   (experts)    PyTorch, every expert on every token: Y (E,T,*out)
//   a2a_combine  out[t] = keep[t] ? Y[idx[t], t] : 0, byte for byte
//
// a2a_route.  Bound: bytes (T*E*4 read, T*9 written); the softmax is a few
// operations per byte.  Design: first-come positions need the tokens in
// stream order, and CUDA blocks run in no order, so ONE block walks the token
// tiles in order -- the loop takes the place of the TPU's sequential grid --
// and keeps the E lane cursors in shared memory.  Inside a tile each thread
// owns one token: it takes its rank among same-expert lanes of its warp with
// __match_any_sync, the per-warp expert counts go to shared memory, and the
// rank among earlier warps is a sum over them.  One block is latency-bound,
// not bandwidth-bound; a multi-block form (per-block histograms plus a scan
// over blocks) is the step that makes it fast.
//
// a2a_combine.  Bound: bytes (the kept rows of Y read once, T rows written).
// Design: a grid-stride copy over the output in the widest unit (16, 8, 4, 2
// or 1 bytes) that divides the row and both base addresses; neighbouring
// threads take neighbouring units, so loads and stores coalesce.  It moves
// bits and does no arithmetic, so it equals its plain version byte for byte
// in every dtype.
//
// Both launchers take PyTorch's current stream, allocate nothing, and return
// cudaGetLastError() right after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRouteThreads = 512;              // 16 warps per token tile
constexpr int kRouteWarps = kRouteThreads / 32;

__global__ void __launch_bounds__(kRouteThreads)
a2a_route_kernel(const float* __restrict__ logits, int T, int E, int capacity,
                 int* __restrict__ idx_out, int* __restrict__ pos_out,
                 unsigned char* __restrict__ keep_out) {
  extern __shared__ int smem[];
  int* cursor = smem;          // [E]               lane write cursors
  int* wcount = smem + E;      // [kRouteWarps][E]  this tile's per-warp counts
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int i = tid; i < E * (kRouteWarps + 1); i += blockDim.x) smem[i] = 0;
  __syncthreads();

  for (int base = 0; base < T; base += kRouteThreads) {
    const int t = base + tid;
    int e = -1;
    if (t < T) {
      // softmax in f32 as JAX computes it: exp(x - max) / sum, then the
      // argmax of the probabilities, first index on ties (NaN counts as max)
      const float* row = logits + static_cast<size_t>(t) * E;
      float m = row[0];
      for (int j = 1; j < E; ++j) m = fmaxf(m, row[j]);
      float s = 0.0f;
      for (int j = 0; j < E; ++j) s += expf(row[j] - m);
      float best = expf(row[0] - m) / s;
      e = 0;
      for (int j = 1; j < E; ++j) {
        const float p = expf(row[j] - m) / s;
        if (p > best || (p != p && best == best)) {
          best = p;
          e = j;
        }
      }
    }
    // rank among the lanes of this warp routed to the same expert
    const unsigned peers = __match_any_sync(0xffffffffu, e);
    const int wrank = __popc(peers & ((1u << lane) - 1u));
    if (e >= 0 && lane == __ffs(peers) - 1) wcount[warp * E + e] = __popc(peers);
    __syncthreads();
    if (e >= 0) {
      int p = cursor[e] + wrank;
      for (int w = 0; w < warp; ++w) p += wcount[w * E + e];
      idx_out[t] = e;
      pos_out[t] = p;
      keep_out[t] = p < capacity ? 1 : 0;
    }
    __syncthreads();
    // advance the cursors past this tile and clear its counts
    for (int j = tid; j < E; j += blockDim.x) {
      int c = 0;
      for (int w = 0; w < kRouteWarps; ++w) {
        c += wcount[w * E + j];
        wcount[w * E + j] = 0;
      }
      cursor[j] += c;
    }
    __syncthreads();
  }
}

template <typename U>
__global__ void a2a_combine_kernel(const U* __restrict__ ys,
                                   const int* __restrict__ idx,
                                   const unsigned char* __restrict__ keep,
                                   U* __restrict__ out, long long T,
                                   long long units_per_row) {
  const long long n = T * units_per_row;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const long long t = i / units_per_row;
    const long long j = i - t * units_per_row;
    U v{};
    if (keep[t]) v = ys[(static_cast<long long>(idx[t]) * T + t) * units_per_row + j];
    out[i] = v;
  }
}

template <typename U>
void launch_combine(const void* ys, const int* idx, const unsigned char* keep,
                    void* out, long long T, long long row_bytes,
                    cudaStream_t stream) {
  const long long upr = row_bytes / static_cast<long long>(sizeof(U));
  const long long n = T * upr;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 65535) blocks = 65535;
  a2a_combine_kernel<U><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      static_cast<const U*>(ys), idx, keep, static_cast<U*>(out), T, upr);
}

}  // namespace

extern "C" {

// Shared memory the route kernel needs for E experts, in bytes.
long long a2a_route_smem_bytes(int E) {
  return static_cast<long long>(E) * (kRouteWarps + 1) * sizeof(int);
}

int a2a_route_launch(const float* logits, int T, int E, int capacity,
                     int* idx, int* pos, unsigned char* keep, void* stream) {
  const long long smem = a2a_route_smem_bytes(E);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        a2a_route_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  a2a_route_kernel<<<1, kRouteThreads, static_cast<size_t>(smem),
                     static_cast<cudaStream_t>(stream)>>>(
      logits, T, E, capacity, idx, pos, keep);
  return static_cast<int>(cudaGetLastError());
}

// `unit` is the copy width in bytes (16, 8, 4, 2 or 1); it must divide
// row_bytes and both base addresses.  ys is (E, T, row_bytes) contiguous.
int a2a_combine_launch(const void* ys, const int* idx,
                       const unsigned char* keep, void* out, long long T,
                       long long row_bytes, int unit, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (unit) {
    case 16: launch_combine<uint4>(ys, idx, keep, out, T, row_bytes, s); break;
    case 8: launch_combine<uint2>(ys, idx, keep, out, T, row_bytes, s); break;
    case 4: launch_combine<uint32_t>(ys, idx, keep, out, T, row_bytes, s); break;
    case 2: launch_combine<uint16_t>(ys, idx, keep, out, T, row_bytes, s); break;
    case 1: launch_combine<uint8_t>(ys, idx, keep, out, T, row_bytes, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
