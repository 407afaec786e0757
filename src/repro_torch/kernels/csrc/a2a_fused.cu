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
// operations per byte.  Design: route_scan.cuh, the top-1 case of the
// router's multi-block scan with a2a's argmax rule (NaN counts as the
// maximum): ceil(T / tt) blocks route and rank their tiles of tokens with
// no dependence on each other, and a decoupled look-back over the tiles'
// per-expert histograms adds the tokens of earlier tiles to each position.
//
// a2a_combine.  Bound: bytes (the kept rows of Y read once, T rows written).
// Design: a grid-stride copy over the output in the widest unit (16, 8, 4, 2
// or 1 bytes) that divides the row and both base addresses; neighbouring
// threads take neighbouring units, so loads and stores coalesce.  It moves
// bits and does no arithmetic, so it equals its plain version byte for byte
// in every dtype.
//
// Both launchers take PyTorch's current stream, allocate nothing (the route
// wrapper passes its workspace), and return cudaGetLastError() right after
// the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "route_scan.cuh"

namespace {

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

// Shared memory of a route block of `threads` over `tt` tokens, bytes.
long long a2a_route_smem_bytes(int tt, int E, int threads) {
  return route::route_smem_words(tt, E, 1, threads) * 4;
}

int a2a_route_launch(const float* logits, int T, int E, int capacity,
                     int blocks, int tt, int threads, int* idx, int* pos,
                     unsigned char* keep, int* workspace, void* stream) {
  return route::launch<true>(logits, T, E, 1, capacity, blocks, tt, threads,
                             nullptr, idx, pos, keep, workspace,
                             static_cast<cudaStream_t>(stream));
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
