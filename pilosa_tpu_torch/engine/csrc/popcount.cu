// Popcount reductions over packed bitmap words, hand-written for Hopper
// (sm_90a).  Device words are 32-bit lanes carrying the bits of the
// reference's uint32 words; the tensors are int32 and every popcount runs
// on an unsigned reinterpretation.
//
// The four kernels replace the Pallas kernels of
// pilosa_tpu/engine/pallas_kernels.py:
//
//   row_counts_kernel          <- row_counts           (pallas_call :136)
//   selected_row_counts_kernel <- selected_row_counts  (pallas_call :234)
//   count_kernel               <- count                (pallas_call :181)
//   intersect_count_kernel     <- intersect_count      (pallas_call :78)
//
// What bounds them: device-memory bytes.  Each output element is the sum
// of __popc over one 32768-word row (128 KiB), so every word is read once
// and costs a handful of integer instructions: the H100 moves 3.35 TB/s
// and retires far more popcounts than that feeds.  The design therefore
// only has to keep enough 16-byte loads in flight:
//
//   - one thread block per output element ((shard, row), (shard, slot) or
//     shard), so a 954 x 32 plane launches 30528 independent blocks;
//   - the block walks its row with 16-byte (int4) loads, consecutive
//     threads on consecutive addresses, and a loop inside the block takes
//     the place of the TPU kernel's sequential word-block grid axis and
//     its pl.when(k == 0) accumulator;
//   - the partial sums reduce with warp shuffles plus one shared-memory
//     pass, and thread 0 writes the block's count;
//   - a row whose start is not 16-byte aligned (any width that is not a
//     multiple of 4 words) takes the scalar loop, and the words past the
//     last full int4 are a masked scalar tail, so no width is assumed;
//   - the filter row of row_counts is re-read by every row of its shard
//     and is left to the 50 MB L2;
//   - selected_row_counts reads its slot from the index array inside the
//     kernel (the TPU kernel's scalar prefetch); repeated slots are fine.
//
// Each entry point first makes the given device current in this library's
// own runtime (nvcc links cudart statically, so the library does not share
// PyTorch's notion of the current device), launches on the given stream of
// that device and returns cudaGetLastError(), so a refused launch reaches
// the Python wrapper.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int popc4(int4 v) {
  return __popc(static_cast<unsigned>(v.x)) + __popc(static_cast<unsigned>(v.y)) +
         __popc(static_cast<unsigned>(v.z)) + __popc(static_cast<unsigned>(v.w));
}

// This thread's share of popcount(row[0:w] & filt[0:w]) (no AND when
// kFilter is false).
template <bool kFilter>
__device__ __forceinline__ int row_popcount(const int* __restrict__ row,
                                            const int* __restrict__ filt,
                                            long long w) {
  int acc = 0;
  long long done = 0;
  uintptr_t addr = reinterpret_cast<uintptr_t>(row);
  if (kFilter) addr |= reinterpret_cast<uintptr_t>(filt);
  if ((addr & 15) == 0) {
    const long long n4 = w >> 2;
    const int4* r4 = reinterpret_cast<const int4*>(row);
    const int4* f4 = reinterpret_cast<const int4*>(filt);
#pragma unroll 4
    for (long long i = threadIdx.x; i < n4; i += kThreads) {
      int4 v = __ldg(r4 + i);
      if (kFilter) {
        const int4 f = __ldg(f4 + i);
        v.x &= f.x;
        v.y &= f.y;
        v.z &= f.z;
        v.w &= f.w;
      }
      acc += popc4(v);
    }
    done = n4 << 2;
  }
  for (long long i = done + threadIdx.x; i < w; i += kThreads) {
    int v = __ldg(row + i);
    if (kFilter) v &= __ldg(filt + i);
    acc += __popc(static_cast<unsigned>(v));
  }
  return acc;
}

// Sum of v over the block; the result is valid in thread 0.
__device__ __forceinline__ int block_sum(int v) {
  __shared__ int warp_sums[kThreads / 32];
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kThreads / 32 ? warp_sums[lane] : 0;
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

// plane int32[S, R, W] (& filt int32[S, W]) -> out int32[S, R]; block = s * R + r.
template <bool kFilter>
__global__ void __launch_bounds__(kThreads)
    row_counts_kernel(const int* __restrict__ plane, const int* __restrict__ filt,
                      int* __restrict__ out, long long r, long long w) {
  const long long o = blockIdx.x;
  const long long s = o / r;
  const int c = block_sum(row_popcount<kFilter>(plane + o * w,
                                                kFilter ? filt + s * w : nullptr, w));
  if (threadIdx.x == 0) out[o] = c;
}

// plane int32[S, R, W], idx int32[N] -> out int32[S, N]; block = s * N + j.
__global__ void __launch_bounds__(kThreads)
    selected_row_counts_kernel(const int* __restrict__ plane, const int* __restrict__ idx,
                               int* __restrict__ out, long long r, long long w,
                               long long n) {
  const long long o = blockIdx.x;
  const long long s = o / n;
  const long long slot = __ldg(idx + (o - s * n));
  // the wrapper refuses out-of-range slots; never read outside the plane
  const int c = (slot >= 0 && slot < r)
                    ? block_sum(row_popcount<false>(plane + (s * r + slot) * w, nullptr, w))
                    : 0;
  if (threadIdx.x == 0) out[o] = c;
}

// words int32[S, W] -> out int32[S]; block = s.
__global__ void __launch_bounds__(kThreads)
    count_kernel(const int* __restrict__ words, int* __restrict__ out, long long w) {
  const long long s = blockIdx.x;
  const int c = block_sum(row_popcount<false>(words + s * w, nullptr, w));
  if (threadIdx.x == 0) out[s] = c;
}

// a, b int32[S, W] -> out int32[S] = popcount(a & b) per shard; block = s.
__global__ void __launch_bounds__(kThreads)
    intersect_count_kernel(const int* __restrict__ a, const int* __restrict__ b,
                           int* __restrict__ out, long long w) {
  const long long s = blockIdx.x;
  const int c = block_sum(row_popcount<true>(a + s * w, b + s * w, w));
  if (threadIdx.x == 0) out[s] = c;
}

}  // namespace

extern "C" {

// The wrapper guarantees blocks >= 1 and blocks <= 2^31 - 1, and that every
// pointer and the stream belong to ``device``.
int pt_row_counts(int device, const int* plane, const int* filt, int* out, long long s,
                  long long r, long long w, void* stream) {
  if (const cudaError_t e = cudaSetDevice(device)) return static_cast<int>(e);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>(s * r);
  if (filt != nullptr) {
    row_counts_kernel<true><<<blocks, kThreads, 0, st>>>(plane, filt, out, r, w);
  } else {
    row_counts_kernel<false><<<blocks, kThreads, 0, st>>>(plane, nullptr, out, r, w);
  }
  return static_cast<int>(cudaGetLastError());
}

int pt_selected_row_counts(int device, const int* plane, const int* idx, int* out,
                           long long s, long long r, long long w, long long n,
                           void* stream) {
  if (const cudaError_t e = cudaSetDevice(device)) return static_cast<int>(e);
  const unsigned blocks = static_cast<unsigned>(s * n);
  selected_row_counts_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      plane, idx, out, r, w, n);
  return static_cast<int>(cudaGetLastError());
}

int pt_count(int device, const int* words, int* out, long long s, long long w,
             void* stream) {
  if (const cudaError_t e = cudaSetDevice(device)) return static_cast<int>(e);
  count_kernel<<<static_cast<unsigned>(s), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      words, out, w);
  return static_cast<int>(cudaGetLastError());
}

int pt_intersect_count(int device, const int* a, const int* b, int* out, long long s,
                       long long w, void* stream) {
  if (const cudaError_t e = cudaSetDevice(device)) return static_cast<int>(e);
  intersect_count_kernel<<<static_cast<unsigned>(s), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(a, b, out, w);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
