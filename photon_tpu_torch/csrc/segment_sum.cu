// Segment sum over sorted int32 ids, written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel photon_tpu/ops/segment_reduce.py:
// _windowed_sum (body _kernel). It computes the same function:
//   out[s] = sum of values[i] over every i with ids[i] == s,  0 <= s < n
// for ids sorted ascending; ids outside [0, n) are dropped. Values are f32
// or bf16; every sum is taken in f32 and out is f32. The caller zero-fills
// out, so a segment no id names stays 0.
//
// Design: a segmented run reduction. The TPU kernel's windowed one-hot
// contraction exists for its matrix unit and needs a coverage window sized
// by the caller; here none is needed. One thread per input element: the
// thread whose element starts a run (i == 0 or ids[i-1] != ids[i]) and whose
// id is in range sums the run in index order and writes out[id] once. So
// every output is written by exactly one thread, there are no atomics, and
// two runs on the same input give bit-identical output (the reference
// declares this reduce deterministic: NUMERICS_AUDIT, segment_reduce.py
// :94-111).
//
// What bounds it: bytes. Each id and value is read about once (a run's
// values by its first thread, the ids once more by their neighbours, from
// cache) and each written output once: (m * (4 + esize) + n * 4) bytes, at
// 3.35 TB/s on an H100. A long run is summed by one thread in sequence, so
// a segment of many elements costs its length in dependent loads; the runs
// of the port's callers are short (at most the rows of one entity).
//
// The kernel allocates nothing and does not synchronise. The launcher returns
// cudaGetLastError() and the Python wrapper raises when it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFloat32 = 0;
constexpr int kBfloat16 = 1;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    segment_sum_kernel(const T* __restrict__ values, const int* __restrict__ ids,
                       long long m, int n, float* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= m) return;
  const int id = ids[i];
  if (id < 0 || id >= n) return;
  if (i > 0 && ids[i - 1] == id) return;
  float acc = 0.0f;
  long long j = i;
  do {
    acc += to_f32(values[j]);
    ++j;
  } while (j < m && ids[j] == id);
  out[id] = acc;
}

}  // namespace

extern "C" {

// out[s] = sum of values[i] with ids[i] == s for m sorted ids, on `stream`.
// value_kind 0: f32 values, 1: bf16 values. out must hold n zeros: only the
// segments some id names are written.
int photon_segment_sum(const void* values, int value_kind, const int* ids,
                       long long m, int n, float* out, void* stream) {
  if (m <= 0 || m > 0x7fffffffLL || n <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned int blocks = static_cast<unsigned int>((m + kThreads - 1) / kThreads);
  if (value_kind == kFloat32) {
    segment_sum_kernel<float><<<blocks, kThreads, 0, st>>>(
        static_cast<const float*>(values), ids, m, n, out);
  } else if (value_kind == kBfloat16) {
    segment_sum_kernel<__nv_bfloat16><<<blocks, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(values), ids, m, n, out);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
