// One damped Newton/IRLS step per entity of a random-effect bucket, written
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel photon_tpu/ops/newton_kernel.py:
// newton_step_lanes (body _make_kernel, losses _loss_terms). It computes the
// same function in the port's natural layout: x [B, R, S] f32 contiguous,
// w, l2, mt, vm [B, S], y, wt, off [B, R], f [B]. The TPU kernel's 128-lane
// entity transpose is not carried over. Per entity b:
//   z = off + x w;  c = wt dzz(z);  H = x^T diag(c) x + diag(l2 + 1 - vm)
//   g = (x^T (wt dz(z)) + l2 (w - mt)) vm
//   d = S steps of CG on H d = -g, then d *= vm; if g.d >= 0, d = -g
//   trial k = 0..T-1, t_k = 2^-k:
//     f_k = sum wt loss(z + t_k x d) + 0.5 sum l2 (w + t_k d - mt)^2
//   the first (largest) t_k with f_k <= f + 1e-4 t_k g.d is taken;
//   improved = a step was taken and f_k < f; w_new = improved ? w + t d : w
//   f_new, g_new are the objective and masked gradient at w_new.
// Denominators in CG are floored at 1e-30, as in the TPU kernel. Logistic
// loss terms are written as _loss_terms writes them; Poisson uses the
// clamped objective of ops/losses.py (margin capped at 30), as the port's
// plain version does.
//
// Two designs share the gate R * S <= 16384 (the reference's), chosen by S.
//
// S <= 128 (newton_step_kernel): one warp per entity, up to four entities
// per block, and no barrier wider than the warp. The entity's [R, S] slab
// is staged in the warp's part of shared memory once and read from there
// by every pass (margins, Hessian, gradient, trial margins, refresh), so
// device memory sees each slab byte once. The slab, H [S, S], two row
// vectors and the S vectors fit within 200 KB; the launcher puts as many
// entities in a block as fit. Lanes go across rows for the margins and the
// trials. For R <= 256 each Hessian and gradient entry is one lane's sum
// over the rows; for longer entities, one warp reduction each. The lanes
// run the S-step CG together, each owning slots lane, lane + 32, ....
// Every lane accumulates all trials of its rows in registers; after one
// warp reduction per trial every lane holds every trial's objective and
// makes the same Armijo choice, so the line search needs no shared state.
//
// S > 128 (newton_step_wide_kernel, a wide bucket densified for its solve,
// so R < 128): one block of 256 threads per entity. H [S, S] would not fit
// in shared memory (S = 256 alone is 256 KB), so the CG never forms it:
// each of its S steps applies H p = x^T (c * (x p)) + (l2 + 1 - vm) p from
// the staged slab, 4 R S flops against the 2 S^2 of a formed H. The slab
// (at most 64 KB by the gate) and the row vectors are always in shared
// memory; the ten S vectors are too where they fit, else (S above ~4,800,
// R <= 3) in a global workspace the wrapper allocates. Row dot products go
// one warp per row, column sums one thread per slot; every reduction over
// the block is summed in the same order by every thread, so all threads
// take the same CG scalars and the same Armijo choice.
//
// What bounds it: bytes. At the bench's user bucket (~100,000 entities x
// 64 rows x 17 slots) a step must read the 435 MB slab plus ~0.1 GB of row
// and slot vectors: ~0.17 ms at 3.35 TB/s; its f32 operations (Hessian
// ~R S^2, trials ~16 R) and transcendentals (two per row per trial) take
// less at the card's peaks. The warp's serial CG (S dependent steps, two
// warp reductions each) and the accurate expf/log1pf of 16 trials per row
// keep it above that bound.
//
// The kernel allocates nothing and does not synchronise. The launcher returns
// cudaGetLastError() and the Python wrapper raises when it is not 0.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxWarpsPerBlock = 4;
constexpr int kMaxTrials = 16;
constexpr int kMaxSub = 128;
constexpr int kMaxRS = 16384;
constexpr int kVectors = 10;
constexpr int kLaneRowsMax = 256;  // up to this R, one lane sums an entry
constexpr size_t kSmemPerBlock = 232448;  // H100: 227 KB opt-in per block
constexpr int kWideThreads = 256;
constexpr int kWideWarps = kWideThreads / 32;
constexpr int kLogistic = 0;
constexpr int kPoisson = 1;

// Shared floats for one entity: slab, two row vectors, H, the S vectors and
// the trials' penalties, rounded up to 16 bytes so each entity's slab starts
// aligned for 16-byte stores.
__host__ __device__ long long entity_floats(int r, int s) {
  const long long n = static_cast<long long>(r) * s + 2LL * r +
                      static_cast<long long>(s) * s +
                      static_cast<long long>(kVectors) * s + kMaxTrials;
  return (n + 3) / 4 * 4;
}

// Shared floats of the wide kernel's block: slab, three row vectors, the
// per-warp partial sums and the trials' penalties, then, when
// `vectors_shared`, the S vectors.
__host__ __device__ long long wide_floats(int r, int s, bool vectors_shared) {
  long long n = static_cast<long long>(r) * s + 3LL * r + kWideWarps + kMaxTrials;
  n = (n + 3) / 4 * 4;
  return vectors_shared ? n + static_cast<long long>(kVectors) * s : n;
}

bool wide_vectors_shared(int r, int s) {
  return sizeof(float) * static_cast<size_t>(wide_floats(r, s, true)) <= kSmemPerBlock;
}

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

// Sum over the warp; every lane gets the result.
__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off /= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Lower-triangle entry p of an [S, S] matrix, row-major: (i, t), t <= i.
__device__ __forceinline__ void pair_index(int p, int& i, int& t) {
  i = static_cast<int>((sqrtf(8.f * p + 1.f) - 1.f) * 0.5f);
  while (i * (i + 1) / 2 > p) --i;
  while ((i + 1) * (i + 2) / 2 <= p) ++i;
  t = p - i * (i + 1) / 2;
}

// sum_r xs[r, i] * c[r] * xs[r, t] (t = -1: sum_r xs[r, i] * c[r]), by one
// lane over all rows or by the warp when the entity is long.
__device__ __forceinline__ float row_sum(const float* xs, const float* c, int R, int S,
                                         int i, int t, int lane, bool by_lane) {
  float acc = 0.f;
  if (by_lane) {
    if (t < 0) {
      for (int r = 0; r < R; ++r) acc += xs[r * S + i] * c[r];
    } else {
      for (int r = 0; r < R; ++r) acc += xs[r * S + i] * c[r] * xs[r * S + t];
    }
    return acc;
  }
  if (t < 0) {
    for (int r = lane; r < R; r += 32) acc += xs[r * S + i] * c[r];
  } else {
    for (int r = lane; r < R; r += 32) acc += xs[r * S + i] * c[r] * xs[r * S + t];
  }
  return warp_sum(acc);
}

// x^T c + l2 (w - mt), masked, into out[S] (shared or global).
__device__ __forceinline__ void gradient(const float* xs, const float* c, int R, int S,
                                         const float* w_s, const float* l2_s,
                                         const float* mt_s, const float* vm_s, float* out,
                                         int lane, bool by_lane) {
  if (by_lane) {
    for (int i = lane; i < S; i += 32) {
      const float acc = row_sum(xs, c, R, S, i, -1, lane, true);
      out[i] = (acc + l2_s[i] * (w_s[i] - mt_s[i])) * vm_s[i];
    }
  } else {
    for (int i = 0; i < S; ++i) {
      const float acc = row_sum(xs, c, R, S, i, -1, lane, false);
      if (lane == 0) out[i] = (acc + l2_s[i] * (w_s[i] - mt_s[i])) * vm_s[i];
    }
  }
}

template <int TASK>
__global__ void __launch_bounds__(kMaxWarpsPerBlock * 32)
newton_step_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ y, const float* __restrict__ wt,
                   const float* __restrict__ off, const float* __restrict__ l2,
                   const float* __restrict__ mt, const float* __restrict__ vm,
                   const float* __restrict__ f, float* __restrict__ w_out,
                   float* __restrict__ f_out, float* __restrict__ g_out,
                   unsigned char* __restrict__ imp_out, long long B, int R, int S,
                   int trials) {
  extern __shared__ float4 sm4[];  // float4: 16-byte aligned
  float* sm = reinterpret_cast<float*>(sm4);
  const int lane = threadIdx.x % 32;
  const int slot = threadIdx.x / 32;
  const long long b = static_cast<long long>(blockIdx.x) * (blockDim.x / 32) + slot;
  // A whole warp leaves together; no barrier spans warps.
  if (b >= B) return;

  float* xs = sm + slot * entity_floats(R, S);  // [R, S]
  float* zb = xs + R * S;                       // [R] margins
  float* cb = zb + R;                           // [R] curvature, then wt * dz
  float* H = cb + R;                            // [S, S]
  float* w_s = H + S * S;                       // the S vectors
  float* l2_s = w_s + S;
  float* mt_s = l2_s + S;
  float* vm_s = mt_s + S;
  float* g_s = vm_s + S;
  float* d_s = g_s + S;
  float* p_s = d_s + S;
  float* r_s = p_s + S;
  float* hp_s = r_s + S;
  float* x_cg = hp_s + S;
  float* pen = x_cg + S;                        // [kMaxTrials]

  const bool by_lane = R <= kLaneRowsMax;
  const float* xg = x + b * R * S;
  const float* yb = y + b * R;
  const float* wtb = wt + b * R;
  const float* offb = off + b * R;

  // Stage the slab: 16-byte loads when the entity's slab is aligned for
  // them, several in flight per lane.
  const int n = R * S;
  if ((n % 4) == 0 && (reinterpret_cast<unsigned long long>(xg) % 16) == 0) {
    const float4* src = reinterpret_cast<const float4*>(xg);
    float4* dst = reinterpret_cast<float4*>(xs);
#pragma unroll 4
    for (int i = lane; i < n / 4; i += 32) dst[i] = src[i];
  } else {
#pragma unroll 4
    for (int i = lane; i < n; i += 32) xs[i] = xg[i];
  }
  for (int i = lane; i < S; i += 32) {
    w_s[i] = w[b * S + i];
    l2_s[i] = l2[b * S + i];
    mt_s[i] = mt[b * S + i];
    vm_s[i] = vm[b * S + i];
  }
  __syncwarp();

  // Margins and curvature.
  for (int r = lane; r < R; r += 32) {
    float z = offb[r];
    for (int s = 0; s < S; ++s) z += xs[r * S + s] * w_s[s];
    float loss, dz, dzz;
    loss_terms<TASK>(z, yb[r], loss, dz, dzz);
    zb[r] = z;
    cb[r] = wtb[r] * dzz;
  }
  __syncwarp();

  // Hessian, lower triangle mirrored.
  const int npairs = S * (S + 1) / 2;
  for (int p = by_lane ? lane : 0; p < npairs; p += by_lane ? 32 : 1) {
    int i, t;
    pair_index(p, i, t);
    float acc = row_sum(xs, cb, R, S, i, t, lane, by_lane);
    if (by_lane || lane == 0) {
      if (i == t) acc = acc + l2_s[i] + (1.f - vm_s[i]);
      H[i * S + t] = acc;
      H[t * S + i] = acc;
    }
  }
  __syncwarp();

  for (int r = lane; r < R; r += 32) {
    float loss, dz, dzz;
    loss_terms<TASK>(zb[r], yb[r], loss, dz, dzz);
    cb[r] = wtb[r] * dz;
  }
  __syncwarp();
  gradient(xs, cb, R, S, w_s, l2_s, mt_s, vm_s, g_s, lane, by_lane);
  __syncwarp();

  // S-step CG on H d = -g; each lane owns slots lane, lane + 32, ...
  float rr = 0.f;
  for (int i = lane; i < S; i += 32) {
    x_cg[i] = 0.f;
    r_s[i] = -g_s[i];
    p_s[i] = -g_s[i];
    rr += r_s[i] * r_s[i];
  }
  float rs = warp_sum(rr);
  __syncwarp();
  for (int step = 0; step < S; ++step) {
    float ph = 0.f;
    for (int i = lane; i < S; i += 32) {
      float acc = H[i * S] * p_s[0];
      for (int t = 1; t < S; ++t) acc += H[i * S + t] * p_s[t];
      hp_s[i] = acc;
      ph += p_s[i] * acc;
    }
    const float denom = warp_sum(ph);
    const float alpha = rs / fmaxf(denom, 1e-30f);
    float r2 = 0.f;
    for (int i = lane; i < S; i += 32) {
      x_cg[i] += alpha * p_s[i];
      r_s[i] -= alpha * hp_s[i];
      r2 += r_s[i] * r_s[i];
    }
    const float rs2 = warp_sum(r2);
    const float beta = rs2 / fmaxf(rs, 1e-30f);
    __syncwarp();
    for (int i = lane; i < S; i += 32) p_s[i] = r_s[i] + beta * p_s[i];
    rs = rs2;
    __syncwarp();
  }
  float gd = 0.f;
  for (int i = lane; i < S; i += 32) {
    d_s[i] = x_cg[i] * vm_s[i];
    gd += g_s[i] * d_s[i];
  }
  gd = warp_sum(gd);
  if (gd >= 0.f) {
    float gg = 0.f;
    for (int i = lane; i < S; i += 32) {
      d_s[i] = -g_s[i];
      gg += g_s[i] * g_s[i];
    }
    gd = -warp_sum(gg);
  }
  __syncwarp();

  // The L2 penalty of every trial point, one lane per trial.
  for (int k = lane; k < trials; k += 32) {
    const float tk = ldexpf(1.f, -k);
    float acc = 0.f;
    for (int s = 0; s < S; ++s) {
      const float dw = w_s[s] + tk * d_s[s] - mt_s[s];
      acc += l2_s[s] * dw * dw;
    }
    pen[k] = acc;
  }

  // Every trial of this lane's rows, in registers.
  float part[kMaxTrials];
#pragma unroll
  for (int k = 0; k < kMaxTrials; ++k) part[k] = 0.f;
  for (int r = lane; r < R; r += 32) {
    float zd = 0.f;
    for (int s = 0; s < S; ++s) zd += xs[r * S + s] * d_s[s];
    const float z = zb[r];
    const float yr = yb[r];
    const float wr = wtb[r];
    float tk = 1.f;
#pragma unroll
    for (int k = 0; k < kMaxTrials; ++k) {
      if (k < trials) part[k] += wr * loss_only<TASK>(z + tk * zd, yr);
      tk *= 0.5f;
    }
  }
  __syncwarp();
  // Every lane reduces every trial and makes the same choice.
  const float f_prev = f[b];
  float t_sel = 0.f, f_sel = f_prev, tk = 1.f;
#pragma unroll
  for (int k = 0; k < kMaxTrials; ++k) {
    const float loss_k = warp_sum(part[k]);
    if (k < trials) {
      const float fk = loss_k + 0.5f * pen[k];
      if (fk <= f_prev + 1e-4f * tk * gd && t_sel == 0.f) {
        t_sel = tk;
        f_sel = fk;
      }
    }
    tk *= 0.5f;
  }
  const bool improved = t_sel > 0.f && f_sel < f_prev;
  if (lane == 0) imp_out[b] = improved ? 1 : 0;
  for (int i = lane; i < S; i += 32) {
    const float wn = improved ? w_s[i] + t_sel * d_s[i] : w_s[i];
    w_s[i] = wn;
    w_out[b * S + i] = wn;
  }
  __syncwarp();

  // Objective and gradient at the accepted point.
  float lsum = 0.f;
  for (int r = lane; r < R; r += 32) {
    float z = offb[r];
    for (int s = 0; s < S; ++s) z += xs[r * S + s] * w_s[s];
    float loss, dz, dzz;
    loss_terms<TASK>(z, yb[r], loss, dz, dzz);
    lsum += wtb[r] * loss;
    cb[r] = wtb[r] * dz;
  }
  const float total = warp_sum(lsum);
  float pen0 = 0.f;
  for (int s = lane; s < S; s += 32) {
    const float dw = w_s[s] - mt_s[s];
    pen0 += l2_s[s] * dw * dw;
  }
  pen0 = warp_sum(pen0);
  __syncwarp();
  gradient(xs, cb, R, S, w_s, l2_s, mt_s, vm_s, g_out + b * S, lane, by_lane);
  if (lane == 0) f_out[b] = total + 0.5f * pen0;
}

// Sum over the block (kWideThreads threads); every thread gets the same
// value, the per-warp partials added in one order.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int k = 0; k < kWideWarps; ++k) t += red[k];
  __syncthreads();  // red is written again by the next call
  return t;
}

// out[r] = x[r, :] . v (times scale[r] when given), one warp per row.
__device__ __forceinline__ void row_dots(const float* xs, const float* v,
                                         const float* scale, int R, int S,
                                         float* out) {
  const int lane = threadIdx.x % 32;
  for (int r = threadIdx.x / 32; r < R; r += kWideWarps) {
    float acc = 0.f;
    for (int s = lane; s < S; s += 32) acc += xs[r * S + s] * v[s];
    acc = warp_sum(acc);
    if (lane == 0) out[r] = scale == nullptr ? acc : scale[r] * acc;
  }
}

// sum_r x[r, i] * c[r], by the thread that owns slot i.
__device__ __forceinline__ float col_sum(const float* xs, const float* c, int R,
                                         int S, int i) {
  float acc = 0.f;
  for (int r = 0; r < R; ++r) acc += xs[r * S + i] * c[r];
  return acc;
}

template <int TASK>
__global__ void __launch_bounds__(kWideThreads)
newton_step_wide_kernel(const float* __restrict__ x, const float* __restrict__ w,
                        const float* __restrict__ y, const float* __restrict__ wt,
                        const float* __restrict__ off, const float* __restrict__ l2,
                        const float* __restrict__ mt, const float* __restrict__ vm,
                        const float* __restrict__ f, float* __restrict__ w_out,
                        float* __restrict__ f_out, float* __restrict__ g_out,
                        unsigned char* __restrict__ imp_out, int R, int S,
                        int trials, float* __restrict__ ws) {
  extern __shared__ float4 sm4[];  // float4: 16-byte aligned
  float* sm = reinterpret_cast<float*>(sm4);
  const int tid = threadIdx.x;
  const long long b = blockIdx.x;

  float* xs = sm;        // [R, S]
  float* zb = xs + R * S;  // [R] margins
  float* cb = zb + R;    // [R] curvature wt * dzz
  float* qb = cb + R;    // [R] row products (c * x p, x d, wt * dz)
  float* red = qb + R;   // [kWideWarps] partial sums
  float* pen = red + kWideWarps;  // [kMaxTrials]
  float* vec = ws != nullptr ? ws + b * kVectors * S : sm + wide_floats(R, S, false);
  float* w_s = vec;      // the S vectors
  float* l2_s = w_s + S;
  float* mt_s = l2_s + S;
  float* vm_s = mt_s + S;
  float* g_s = vm_s + S;
  float* d_s = g_s + S;
  float* p_s = d_s + S;
  float* r_s = p_s + S;
  float* hp_s = r_s + S;
  float* x_cg = hp_s + S;

  const float* xg = x + b * R * S;
  const float* yb = y + b * R;
  const float* wtb = wt + b * R;
  const float* offb = off + b * R;

  // Stage the slab, 16-byte loads where it is aligned for them.
  const int n = R * S;
  if ((n % 4) == 0 && (reinterpret_cast<unsigned long long>(xg) % 16) == 0) {
    const float4* src = reinterpret_cast<const float4*>(xg);
    float4* dst = reinterpret_cast<float4*>(xs);
#pragma unroll 4
    for (int i = tid; i < n / 4; i += kWideThreads) dst[i] = src[i];
  } else {
#pragma unroll 4
    for (int i = tid; i < n; i += kWideThreads) xs[i] = xg[i];
  }
  for (int i = tid; i < S; i += kWideThreads) {
    w_s[i] = w[b * S + i];
    l2_s[i] = l2[b * S + i];
    mt_s[i] = mt[b * S + i];
    vm_s[i] = vm[b * S + i];
  }
  __syncthreads();

  // Margins, curvature and the gradient's row weights.
  row_dots(xs, w_s, nullptr, R, S, zb);
  __syncthreads();
  for (int r = tid; r < R; r += kWideThreads) {
    const float z = offb[r] + zb[r];
    float loss, dz, dzz;
    loss_terms<TASK>(z, yb[r], loss, dz, dzz);
    zb[r] = z;
    cb[r] = wtb[r] * dzz;
    qb[r] = wtb[r] * dz;
  }
  __syncthreads();

  // Gradient, and CG on H d = -g from d = 0. Each thread owns slots tid,
  // tid + kWideThreads, ... of every S vector.
  float part = 0.f;
  for (int i = tid; i < S; i += kWideThreads) {
    const float g = (col_sum(xs, qb, R, S, i) + l2_s[i] * (w_s[i] - mt_s[i])) * vm_s[i];
    g_s[i] = g;
    x_cg[i] = 0.f;
    r_s[i] = -g;
    p_s[i] = -g;
    part += g * g;
  }
  float rs = block_sum(part, red);
  for (int step = 0; step < S; ++step) {
    row_dots(xs, p_s, cb, R, S, qb);  // c * (x p)
    __syncthreads();
    part = 0.f;
    for (int i = tid; i < S; i += kWideThreads) {
      const float hp = col_sum(xs, qb, R, S, i) + (l2_s[i] + (1.f - vm_s[i])) * p_s[i];
      hp_s[i] = hp;
      part += p_s[i] * hp;
    }
    const float alpha = rs / fmaxf(block_sum(part, red), 1e-30f);
    part = 0.f;
    for (int i = tid; i < S; i += kWideThreads) {
      x_cg[i] += alpha * p_s[i];
      r_s[i] -= alpha * hp_s[i];
      part += r_s[i] * r_s[i];
    }
    const float rs2 = block_sum(part, red);
    const float beta = rs2 / fmaxf(rs, 1e-30f);
    for (int i = tid; i < S; i += kWideThreads) p_s[i] = r_s[i] + beta * p_s[i];
    rs = rs2;
    __syncthreads();
  }
  part = 0.f;
  for (int i = tid; i < S; i += kWideThreads) {
    d_s[i] = x_cg[i] * vm_s[i];
    part += g_s[i] * d_s[i];
  }
  float gd = block_sum(part, red);
  if (gd >= 0.f) {
    part = 0.f;
    for (int i = tid; i < S; i += kWideThreads) {
      d_s[i] = -g_s[i];
      part += g_s[i] * g_s[i];
    }
    gd = -block_sum(part, red);
  }

  // The L2 penalty of every trial point, one warp per trial, and the
  // direction's row products.
  const int lane = tid % 32;
  for (int k = tid / 32; k < trials; k += kWideWarps) {
    const float tk = ldexpf(1.f, -k);
    float acc = 0.f;
    for (int s = lane; s < S; s += 32) {
      const float dw = w_s[s] + tk * d_s[s] - mt_s[s];
      acc += l2_s[s] * dw * dw;
    }
    acc = warp_sum(acc);
    if (lane == 0) pen[k] = acc;
  }
  row_dots(xs, d_s, nullptr, R, S, qb);
  __syncthreads();

  // Every trial of this thread's rows in registers, then one block sum
  // per trial; every thread makes the same choice.
  float part_t[kMaxTrials];
#pragma unroll
  for (int k = 0; k < kMaxTrials; ++k) part_t[k] = 0.f;
  for (int r = tid; r < R; r += kWideThreads) {
    const float zd = qb[r];
    const float z = zb[r];
    const float yr = yb[r];
    const float wr = wtb[r];
    float tk = 1.f;
#pragma unroll
    for (int k = 0; k < kMaxTrials; ++k) {
      if (k < trials) part_t[k] += wr * loss_only<TASK>(z + tk * zd, yr);
      tk *= 0.5f;
    }
  }
  const float f_prev = f[b];
  float t_sel = 0.f, f_sel = f_prev, tk = 1.f;
#pragma unroll
  for (int k = 0; k < kMaxTrials; ++k) {
    if (k < trials) {  // the same for every thread
      const float fk = block_sum(part_t[k], red) + 0.5f * pen[k];
      if (fk <= f_prev + 1e-4f * tk * gd && t_sel == 0.f) {
        t_sel = tk;
        f_sel = fk;
      }
    }
    tk *= 0.5f;
  }
  const bool improved = t_sel > 0.f && f_sel < f_prev;
  if (tid == 0) imp_out[b] = improved ? 1 : 0;
  for (int i = tid; i < S; i += kWideThreads) {
    const float wn = improved ? w_s[i] + t_sel * d_s[i] : w_s[i];
    w_s[i] = wn;
    w_out[b * S + i] = wn;
  }
  __syncthreads();

  // Objective and gradient at the accepted point.
  row_dots(xs, w_s, nullptr, R, S, zb);
  __syncthreads();
  part = 0.f;
  for (int r = tid; r < R; r += kWideThreads) {
    float loss, dz, dzz;
    loss_terms<TASK>(offb[r] + zb[r], yb[r], loss, dz, dzz);
    part += wtb[r] * loss;
    qb[r] = wtb[r] * dz;
  }
  const float total = block_sum(part, red);
  part = 0.f;
  for (int i = tid; i < S; i += kWideThreads) {
    const float dw = w_s[i] - mt_s[i];
    part += l2_s[i] * dw * dw;
  }
  const float pen0 = block_sum(part, red);
  for (int i = tid; i < S; i += kWideThreads) {
    g_out[b * S + i] =
        (col_sum(xs, qb, R, S, i) + l2_s[i] * (w_s[i] - mt_s[i])) * vm_s[i];
  }
  if (tid == 0) f_out[b] = total + 0.5f * pen0;
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

template <int TASK>
int launch(const float* x, const float* w, const float* y, const float* wt,
           const float* off, const float* l2, const float* mt, const float* vm,
           const float* f, float* w_out, float* f_out, float* g_out,
           unsigned char* imp_out, long long b, int r, int s, int trials,
           float* ws, cudaStream_t stream) {
  if (s > kMaxSub) {
    const bool shared = wide_vectors_shared(r, s);
    if (!shared && ws == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const size_t bytes = sizeof(float) * static_cast<size_t>(wide_floats(r, s, shared));
    static size_t wide_opted_in = 48 * 1024;
    const cudaError_t e = opt_in(newton_step_wide_kernel<TASK>, bytes, wide_opted_in);
    if (e != cudaSuccess) return static_cast<int>(e);
    newton_step_wide_kernel<TASK><<<static_cast<unsigned>(b), kWideThreads, bytes, stream>>>(
        x, w, y, wt, off, l2, mt, vm, f, w_out, f_out, g_out, imp_out, r, s, trials,
        shared ? nullptr : ws);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t per_entity = sizeof(float) * static_cast<size_t>(entity_floats(r, s));
  int warps = kMaxWarpsPerBlock;
  while (warps > 1 && warps * per_entity > kSmemPerBlock) warps /= 2;
  const size_t bytes = warps * per_entity;
  static size_t opted_in = 48 * 1024;
  const cudaError_t e = opt_in(newton_step_kernel<TASK>, bytes, opted_in);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long blocks = (b + warps - 1) / warps;
  newton_step_kernel<TASK><<<static_cast<unsigned>(blocks), warps * 32, bytes, stream>>>(
      x, w, y, wt, off, l2, mt, vm, f, w_out, f_out, g_out, imp_out, b, r, s, trials);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Floats of global workspace per entity that photon_newton_step needs for
// an [R, S] bucket: 0 unless the wide kernel's S vectors do not fit in
// shared memory.
long long photon_newton_step_workspace_floats(int r, int s) {
  if (s <= kMaxSub || wide_vectors_shared(r, s)) return 0;
  return static_cast<long long>(kVectors) * s;
}

// One Newton step for b entities on `stream`; task 0 logistic, 1 Poisson.
// `ws` holds b * photon_newton_step_workspace_floats(r, s) floats, or is
// null when that is 0.
int photon_newton_step(const float* x, const float* w, const float* y,
                       const float* wt, const float* off, const float* l2,
                       const float* mt, const float* vm, const float* f,
                       float* w_out, float* f_out, float* g_out,
                       unsigned char* imp_out, long long b, int r, int s, int task,
                       int trials, float* ws, void* stream) {
  if (b <= 0 || b > 0x7fffffffLL || r <= 0 || s <= 0 ||
      static_cast<long long>(r) * s > kMaxRS || trials < 1 || trials > kMaxTrials) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (task == kLogistic) {
    return launch<kLogistic>(x, w, y, wt, off, l2, mt, vm, f, w_out, f_out, g_out,
                             imp_out, b, r, s, trials, ws, st);
  }
  if (task == kPoisson) {
    return launch<kPoisson>(x, w, y, wt, off, l2, mt, vm, f, w_out, f_out, g_out,
                            imp_out, b, r, s, trials, ws, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
