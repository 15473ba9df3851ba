// Fused serve score for one padded request rung, written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel photon_tpu/ops/serve_kernel.py:fused_score
// (body _make_kernel). It computes the same function, not the same grid:
// one warp per request row, kRowsPerBlock rows per block. Per row it adds
//   - each fixed coordinate's dense dot, or its sparse-ELL gather-dot;
//   - each random coordinate's table row and projector row, gathered at the
//     row's entity code, projected against the dense features
//     (xg[s] = x[proj[s]] when 0 <= proj[s] < d) or matched against the ELL
//     ids (contrib[s] = sum_k val[k] * [idx[k] == proj[s]]).
// Cold rows (code -1, or a code past the table) gather row 0 and multiply the
// contribution by 0, as the TPU kernel does. Lanes stride over d, k or S and
// the row's f32 partials meet in one warp-shuffle reduction.
//
// Rounding follows the TPU kernel exactly (serve_kernel.py:220-285), so bf16
// tables give the same products:
//   dense FE   round_w(round_w(x) * w), summed in f32;
//   sparse FE  round_w(round_w(val) * w[idx]), summed in f32;
//   dense RE   round_w(w * round_w(x[proj])), summed in f32;
//   sparse RE  round_w(contrib) * w in f32, contrib summed in f32.
// round_w is the identity for f32 tables. A product of two bf16 values is
// exact in f32, so rounding the f32 product once equals a bf16 multiply.
//
// What bounds it: bytes. At rung 512 on the serving model (d = 64 fixed,
// 17 + 9 random slots) a launch reads about 0.3 MB: 90 f32 features per row
// plus 26 gathered slots of (weight, projector) per row. That is ~0.1 us at
// 3.35 TB/s, so the kernel is launch-bound. The design answers with one
// launch per rung for every coordinate together, and no intermediate in
// device memory: gathered rows live in registers only.
//
// The kernel allocates nothing and does not synchronise. The launcher returns
// cudaGetLastError() and the Python wrapper raises when it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

constexpr int kMaxCoords = 8;
constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 4;

// One coordinate of the model. Mirrored field for field by
// photon_tpu_torch/ops/serve_kernel.py (_Coord); every field is 64 bits wide
// so the two layouts cannot drift through padding.
struct Coord {
  const void* w;       // fixed: [d] weights; random: [e, s] table
  const int* proj;     // random: [e, s] feature id per slot, -1 pad
  const int* codes;    // random: [rung] entity row, -1 cold
  const float* x;      // dense: [rung, d] features; ELL: [rung, k] values
  const int* idx;      // ELL: [rung, k] feature ids; dense: nullptr
  long long d;         // shard width
  long long k;         // ELL width (0 for dense)
  long long s;         // random: slots per entity
  long long e;         // random: entities
  long long random;    // 1 for a random-effect coordinate
};

struct ServeParams {
  Coord c[kMaxCoords];
  long long n_coords;
  long long rung;
  float* out;          // [rung] f32 scores
};

template <typename T>
struct Storage;

template <>
struct Storage<float> {
  __device__ __forceinline__ static float load(const float* p, long long i) { return p[i]; }
  __device__ __forceinline__ static float round(float v) { return v; }
};

template <>
struct Storage<__nv_bfloat16> {
  __device__ __forceinline__ static float load(const __nv_bfloat16* p, long long i) {
    return __bfloat162float(p[i]);
  }
  __device__ __forceinline__ static float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

template <typename T>
__global__ void __launch_bounds__(kWarp * kRowsPerBlock)
serve_score_kernel(const ServeParams p) {
  using S = Storage<T>;
  const int lane = threadIdx.x % kWarp;
  const long long row =
      static_cast<long long>(blockIdx.x) * kRowsPerBlock + threadIdx.x / kWarp;
  // The whole warp shares one row, so this exit is warp-uniform and the
  // shuffles below always see all 32 lanes.
  if (row >= p.rung) return;

  float acc = 0.f;
  for (int ci = 0; ci < p.n_coords; ++ci) {
    const Coord& c = p.c[ci];
    const T* w = static_cast<const T*>(c.w);
    if (!c.random) {
      if (c.idx == nullptr) {
        const float* x = c.x + row * c.d;
        for (long long j = lane; j < c.d; j += kWarp) {
          acc += S::round(S::round(x[j]) * S::load(w, j));
        }
      } else {
        const int* idx = c.idx + row * c.k;
        const float* val = c.x + row * c.k;
        for (long long j = lane; j < c.k; j += kWarp) {
          const int f = idx[j];
          const float g = (f >= 0 && f < c.d) ? S::load(w, f) : 0.f;
          acc += S::round(S::round(val[j]) * g);
        }
      }
      continue;
    }
    const int code = c.codes[row];
    const bool known = code >= 0 && code < c.e;
    const long long base = static_cast<long long>(known ? code : 0) * c.s;
    float z = 0.f;
    if (c.idx == nullptr) {
      const float* x = c.x + row * c.d;
      for (long long s = lane; s < c.s; s += kWarp) {
        const int f = c.proj[base + s];
        const float xg = (f >= 0 && f < c.d) ? x[f] : 0.f;
        z += S::round(S::load(w, base + s) * S::round(xg));
      }
    } else {
      const int* idx = c.idx + row * c.k;
      const float* val = c.x + row * c.k;
      for (long long s = lane; s < c.s; s += kWarp) {
        const int f = c.proj[base + s];
        float contrib = 0.f;
        if (f >= 0) {
          for (long long j = 0; j < c.k; ++j) {
            if (idx[j] == f) contrib += val[j];
          }
        }
        z += S::round(contrib) * S::load(w, base + s);
      }
    }
    acc += (known ? 1.f : 0.f) * z;
  }
  for (int off = kWarp / 2; off > 0; off /= 2) {
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  }
  if (lane == 0) p.out[row] = acc;
}

extern "C" {

// Size of ServeParams, so the Python side can check its mirror.
long long photon_serve_params_size() { return sizeof(ServeParams); }

// Launch one rung on `stream`. bf16 != 0 selects bf16 tables, else f32.
int photon_serve_score(const ServeParams* params, int bf16, void* stream) {
  const ServeParams p = *params;
  if (p.rung <= 0 || p.n_coords < 1 || p.n_coords > kMaxCoords) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>((p.rung + kRowsPerBlock - 1) / kRowsPerBlock));
  const dim3 block(kWarp * kRowsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    serve_score_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(p);
  } else {
    serve_score_kernel<float><<<grid, block, 0, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
