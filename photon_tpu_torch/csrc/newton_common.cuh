// Pieces shared by the two designs of the Newton-step kernel
// (newton_step.cu: S <= 128; newton_step_wide.cu: S > 128).

#pragma once

#include <cuda_runtime.h>

namespace photon_newton {

constexpr int kMaxTrials = 16;
constexpr int kMaxSub = 128;    // the widest S of the narrow design
constexpr int kMaxRS = 16384;   // the reference's gate, R * S
constexpr size_t kSmemPerBlock = 232448;  // H100: 227 KB opt-in per block
constexpr int kLogistic = 0;
constexpr int kPoisson = 1;
constexpr unsigned kFull = 0xffffffffu;

// The operands of one launch, as photon_newton_step receives them.
struct StepArgs {
  const float* x;
  const float* w;
  const float* y;
  const float* wt;
  const float* off;
  const float* l2;
  const float* mt;
  const float* vm;
  const float* f;
  float* w_out;
  float* f_out;
  float* g_out;
  unsigned char* imp_out;
  long long b;
  int r;
  int s;
  int trials;
};

template <int TASK>
__device__ __forceinline__ void loss_terms(float z, float y, float& loss, float& dz,
                                           float& dzz) {
  if (TASK == kLogistic) {
    const float ind = y > 0.5f ? 1.f : 0.f;
    const float p = 1.f / (1.f + expf(-z));
    loss = log1pf(expf(-fabsf(z))) + fmaxf(z, 0.f) - z * ind;
    dz = p - ind;
    dzz = p * (1.f - p);
  } else {
    const float zc = fminf(z, 30.f);
    const float ez = expf(zc);
    loss = ez - y * zc;
    dz = ez - y;
    dzz = ez;
  }
}

template <int TASK>
__device__ __forceinline__ float loss_only(float z, float y) {
  if (TASK == kLogistic) {
    const float ind = y > 0.5f ? 1.f : 0.f;
    return log1pf(expf(-fabsf(z))) + fmaxf(z, 0.f) - z * ind;
  }
  const float zc = fminf(z, 30.f);
  return expf(zc) - y * zc;
}

// Sum over the warp by a butterfly; every lane gets the same bits (each
// level adds the same two partials, in either order).
__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off /= 2) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// Raise a kernel's dynamic shared memory opt-in above 48 KB once, to the
// largest size asked for, so a launch inside a CUDA-graph capture makes no
// attribute call.
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, size_t bytes, size_t& opted_in) {
  if (bytes <= opted_in) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (e == cudaSuccess) opted_in = bytes;
  return e;
}

// Streaming multiprocessors of the current device, read once.
inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        n <= 0) {
      n = 1;
    }
  }
  return n;
}

// Resident blocks of a kernel per SM (at least one), asked of the runtime
// once per block shape, so a launch inside a CUDA-graph capture makes no
// query.
struct BlocksPerSM {
  int threads = 0;
  size_t smem = 0;
  int blocks = 0;
  template <typename Kernel>
  int get(Kernel kernel, int t, size_t bytes) {
    if (blocks == 0 || t != threads || bytes != smem) {
      int n = 0;
      if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, t, bytes) !=
              cudaSuccess ||
          n < 1) {
        n = 1;
      }
      threads = t;
      smem = bytes;
      blocks = n;
    }
    return blocks;
  }
};

// The wide design's launcher (newton_step_wide.cu); `ws` as for
// photon_newton_step.
long long wide_workspace_floats(int r, int s);
template <int TASK>
int launch_wide(const StepArgs& a, float* ws, cudaStream_t stream);

}  // namespace photon_newton
