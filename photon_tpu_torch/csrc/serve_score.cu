// Fused serve score for one padded request rung, written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel photon_tpu/ops/serve_kernel.py:fused_score
// (body _make_kernel). It computes the same function, not the same grid:
// one warp per request row, kRowsPerBlock rows per block. Per row it adds
//   - each fixed coordinate's dense dot, or its sparse-ELL gather-dot;
//   - each random coordinate's table row and projector row, gathered at the
//     row's entity code, projected against the dense features
//     (xg[s] = x[proj[s]] when 0 <= proj[s] < d) or matched against the ELL
//     ids (contrib[s] = sum_k val[k] * [idx[k] == proj[s]], k in order).
// Cold rows (code -1, or a code past the table) contribute exactly 0, as in
// the TPU kernel.
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
// What bounds it: latency. At rung 512 on the serving model (d = 64 fixed,
// 17 + 9 random slots) a launch reads about 0.3 MB, ~0.1 us at 3.35 TB/s,
// well under the time of a launch. What a row waits for is its chain of
// dependent loads: code -> projector and weight at code * S -> the feature
// the projector names. The design puts every load of a row that does not
// depend on another in flight together, so a row waits on three memory
// round trips, not one chain per coordinate:
//   1. lane l takes the l-th (coordinate, slot) pair of the row's random
//      coordinates and loads that coordinate's entity code; the fixed
//      effect's features and weights are loaded beside the codes;
//   2. every lane loads its pair's projector and weight;
//   3. every lane gathers the feature its projector names (or scans the
//      row's ELL ids for it), and one warp reduction sums the row.
// Pairs past the warp's 32 lanes take further rounds. The code stays compact
// (runtime loops, no per-coordinate unrolling): a launch at rung 1 is mostly
// latency, and instruction fetch is part of it. At rung 512 the grid is 256
// blocks of 2 rows, all resident at once.
//
// The kernel allocates nothing and does not synchronise. The launcher returns
// cudaGetLastError() and the Python wrapper raises when it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

constexpr int kMaxCoords = 8;
constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 2;

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
};

// The fixed coordinates come first in c, then the random ones.
struct ServeParams {
  Coord c[kMaxCoords];
  long long pair_base[kMaxCoords];  // first pair of random coordinate r;
                                    // past n_pairs for absent ones
  long long n_coords;
  long long n_fixed;
  long long n_pairs;   // slots over all random coordinates
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

// One random coordinate's term for slot weight wv and projector f.
template <typename T>
__device__ __forceinline__ float slot_term(const Coord& c, long long row,
                                           int f, float wv) {
  using S = Storage<T>;
  if (c.idx == nullptr) {
    const float xg = (f >= 0 && f < c.d) ? c.x[row * c.d + f] : 0.f;
    return S::round(wv * S::round(xg));
  }
  const float* val = c.x + row * c.k;
  const int* idx = c.idx + row * c.k;
  float contrib = 0.f;
  if (f >= 0) {
    for (long long j = 0; j < c.k; ++j) {
      if (idx[j] == f) contrib += val[j];
    }
  }
  return S::round(contrib) * wv;
}

// The coordinate (index into c) and slot of random pair pi, or ci = -1.
struct Pair {
  int ci;
  long long s;
};

__device__ __forceinline__ Pair pair_of(const ServeParams& p, long long pi) {
  Pair out{-1, 0};
  if (pi >= p.n_pairs) return out;
  int r = 0;
#pragma unroll
  for (int j = 1; j < kMaxCoords; ++j) r += pi >= p.pair_base[j];
  out.ci = static_cast<int>(p.n_fixed) + r;
  out.s = pi - p.pair_base[r];
  return out;
}

template <typename T>
__global__ void __launch_bounds__(kWarp * kRowsPerBlock)
serve_score_kernel(const __grid_constant__ ServeParams p) {
  using S = Storage<T>;
  const int lane = threadIdx.x % kWarp;
  const long long row =
      static_cast<long long>(blockIdx.x) * kRowsPerBlock + threadIdx.x / kWarp;
  // The whole warp shares one row, so this exit is warp-uniform and the
  // shuffles below always see all 32 lanes.
  if (row >= p.rung) return;

  float acc = 0.f;
  for (long long pb = 0; pb == 0 || pb < p.n_pairs; pb += kWarp) {
    // 1. The code of this lane's pair.
    const Pair pr = pair_of(p, pb + lane);
    const int code = pr.ci >= 0 ? p.c[pr.ci].codes[row] : -1;
    if (pb == 0) {  // the fixed effect, its loads beside the codes'
      for (int ci = 0; ci < p.n_fixed; ++ci) {
        const Coord& c = p.c[ci];
        const T* w = static_cast<const T*>(c.w);
        if (c.idx == nullptr) {
          const float* x = c.x + row * c.d;
#pragma unroll 4
          for (long long j = lane; j < c.d; j += kWarp) {
            acc += S::round(S::round(x[j]) * S::load(w, j));
          }
        } else {
          const int* idx = c.idx + row * c.k;
          const float* val = c.x + row * c.k;
#pragma unroll 4
          for (long long j = lane; j < c.k; j += kWarp) {
            const int fi = idx[j];
            const float g = (fi >= 0 && fi < c.d) ? S::load(w, fi) : 0.f;
            acc += S::round(S::round(val[j]) * g);
          }
        }
      }
    }
    // 2. Its projector and weight; a cold pair (code -1, or past the table)
    // adds nothing.
    int f = -1;
    float wv = 0.f;
    bool live = false;
    if (pr.ci >= 0) {
      const Coord& c = p.c[pr.ci];
      if (code >= 0 && code < c.e) {
        const long long at = static_cast<long long>(code) * c.s + pr.s;
        f = c.proj[at];
        wv = S::load(static_cast<const T*>(c.w), at);
        live = true;
      }
    }
    // 3. The feature the projector names.
    if (live) acc += slot_term<T>(p.c[pr.ci], row, f, wv);
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
  const ServeParams& p = *params;
  if (p.rung <= 0 || p.n_coords < 1 || p.n_coords > kMaxCoords ||
      p.n_fixed < 0 || p.n_fixed > p.n_coords || p.n_pairs < 0) {
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
