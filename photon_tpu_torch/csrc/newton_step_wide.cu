// The wide design of the Newton-step kernel (S > 128): one block of 256
// threads per entity. The function, the gate and the entry point are in
// newton_step.cu. H [S, S] would not fit in shared memory (S = 256 alone
// is 256 KB), so the CG never forms it: each of its S steps applies
// H p = x^T (c * (x p)) + (l2 + 1 - vm) p from the slab, 4 R S flops
// against the 2 S^2 of a formed H.
//
// Tile kernel (R <= 64, S <= 256: the densified 64-row buckets of a wide
// materialized coordinate). The slab lives in registers as a 2-D tile per
// thread: warp w holds rows 8w .. 8w + 7, lane l the columns l, l + 32, ...
// (CPL = ceil(S / 32) of them, a template parameter), 8 x CPL floats
// (48 at S = 173). In each CG step
// - x p is a per-thread partial over its columns for its 8 rows, reduced
//   across the lanes by a reduce-scatter (9 shuffles for 8 rows, each row's
//   sum landing in four lanes) and gathered back after the curvature
//   multiply (8 shuffles);
// - x^T q is a per-thread partial over its rows for its columns, written to
//   one [8 warps, S] shared buffer; after one barrier the thread owning
//   column t adds the 8 partials and the diagonal term, and after a second
//   the threads read H p for their columns;
// - every warp holds every column of the S vectors, so p.Hp and r.r are
//   warp reductions with no barrier, and every warp takes the same alpha
//   and beta (the same lanes add the same values in the same order).
// Neither pass rereads the slab. Two barriers per step, against six in the
// first port of this design, and no thread idles on a column loop.
// Blocks are persistent: the grid is the blocks the card holds at once
// (two per SM at 128 registers a thread), each walking over entities. The
// line search evaluates trials in order and stops at the first that passes,
// as the narrow design does.
//
// Generic kernel (every other wide shape in the gate: R > 64, or S > 256
// up to 16384 with R <= 64): the slab staged in shared memory, row dot
// products one warp per row, column sums one thread per slot, block sums
// with one barrier each over alternating buffers. The ten S vectors sit
// in shared memory where they fit, else (S above ~4,800, R <= 3) in a
// global workspace the wrapper allocates.
//
// What bounds it: operations in principle. At [665 x 64 x 173] the S CG
// steps take 4 R S^2 = 7.7 MFLOP per entity, 0.077 ms for the bucket at
// the H100's 67 TFLOP/s f32. In practice each step's latency does: two
// barriers, two dependent 5-level warp reductions and two divisions, with
// only two blocks per SM to hide them; a bucket of 665 entities is 2.5
// waves and runs as three rounds.

#include <algorithm>

#include "newton_common.cuh"

namespace photon_newton {
namespace {

constexpr int kWideThreads = 256;
constexpr int kWideWarps = kWideThreads / 32;
constexpr int kTileRows = 8;                         // rows per warp
constexpr int kTileMaxR = kWideWarps * kTileRows;    // 64
constexpr int kTileMaxS = kWideThreads;              // one column per owner
constexpr int kVectors = 10;

// Reduce 8 per-row partials across the warp: the sum of row (lane >> 2)
// lands in lanes 4 (lane >> 2) .. + 3, the same bits in each.
__device__ __forceinline__ float row_reduce8(const float (&v)[kTileRows], int lane) {
  float u[4], u2[2];
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float send = b4 ? v[i] : v[i + 4];
    const float keep = b4 ? v[i + 4] : v[i];
    u[i] = keep + __shfl_xor_sync(kFull, send, 16);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float send = b3 ? u[i] : u[i + 2];
    const float keep = b3 ? u[i + 2] : u[i];
    u2[i] = keep + __shfl_xor_sync(kFull, send, 8);
  }
  const float send = b2 ? u2[0] : u2[1];
  const float keep = b2 ? u2[1] : u2[0];
  float s = keep + __shfl_xor_sync(kFull, send, 4);
  s += __shfl_xor_sync(kFull, s, 2);
  s += __shfl_xor_sync(kFull, s, 1);
  return s;
}

// Row i's value of a per-row scalar held by lanes 4i .. 4i + 3.
__device__ __forceinline__ void row_gather8(float v, float (&out)[kTileRows]) {
#pragma unroll
  for (int i = 0; i < kTileRows; ++i) out[i] = __shfl_sync(kFull, v, 4 * i);
}

// v[j] for j == k, k uniform over the unrolled loop's range.
template <int CPL>
__device__ __forceinline__ float pick(const float (&v)[CPL], int k) {
  float out = 0.f;
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    if (j == k) out = v[j];
  }
  return out;
}

// Sum of one value per warp (the same in every lane of the warp), in warp
// order; one barrier, over two alternating buffers.
__device__ __forceinline__ float block_sum_warps(float v, float* red2, int& par) {
  float* red = red2 + par * kWideWarps;
  par ^= 1;
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int k = 0; k < kWideWarps; ++k) t += red[k];
  return t;
}

template <int TASK, int CPL>
__global__ void __launch_bounds__(kWideThreads, 2)
newton_wide_tile_kernel(StepArgs a) {
  constexpr int kCols = 32 * CPL;
  __shared__ float part[kWideWarps][kCols];  // x^T q partials
  __shared__ float hpv[kCols];               // reduced column sums
  __shared__ float wv[kCols], l2v[kCols], mtv[kCols], vmv[kCols], gv[kCols];
  __shared__ float bsum[2 * kWideWarps];
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int R = a.r, S = a.s;
  const int row = warp * kTileRows + (lane >> 2);  // the row this lane reduces
  int par = 0;

  for (long long b = blockIdx.x; b < a.b; b += gridDim.x) {
    __syncthreads();  // the previous entity is done with shared memory
    for (int t = tid; t < kCols; t += kWideThreads) {
      const bool live = t < S;
      const long long o = b * S + t;
      wv[t] = live ? __ldg(a.w + o) : 0.f;
      l2v[t] = live ? __ldg(a.l2 + o) : 0.f;
      mtv[t] = live ? __ldg(a.mt + o) : 0.f;
      vmv[t] = live ? __ldg(a.vm + o) : 0.f;
    }
    float xt[kTileRows][CPL];
    const float* xg = a.x + b * R * S;
#pragma unroll
    for (int i = 0; i < kTileRows; ++i) {
      const int r = warp * kTileRows + i;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const int c = lane + 32 * j;
        xt[i][j] = (r < R && c < S) ? __ldg(xg + r * S + c) : 0.f;
      }
    }
    const bool live_row = row < R;
    const float yl = live_row ? __ldg(a.y + b * R + row) : 0.f;
    const float wtl = live_row ? __ldg(a.wt + b * R + row) : 0.f;
    const float offl = live_row ? __ldg(a.off + b * R + row) : 0.f;
    __syncthreads();

    // x^T v for this thread's columns from the per-row values q (lanes 4i
    // hold row i's), reduced over the block into the column owner
    // (thread t owns column t); returns the owner's sum.
    auto col_reduce = [&](float ql) {
      float q[kTileRows];
      row_gather8(ql, q);
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < kTileRows; ++i) acc = fmaf(xt[i][j], q[i], acc);
        part[warp][lane + 32 * j] = acc;
      }
      __syncthreads();
      float s = 0.f;
      if (tid < S) {
        // A tree over the 8 warps' partials, in one order for every column.
        float t[kWideWarps];
#pragma unroll
        for (int w = 0; w < kWideWarps; ++w) t[w] = part[w][tid];
#pragma unroll
        for (int h = kWideWarps / 2; h > 0; h /= 2) {
#pragma unroll
          for (int w = 0; w < h; ++w) t[w] += t[w + h];
        }
        s = t[0];
      }
      return s;
    };
    // x v for the 8 rows of this warp, v given per column; each lane gets
    // row (lane >> 2)'s sum.
    auto row_dot = [&](const float (&v)[CPL]) {
      float acc[kTileRows];
#pragma unroll
      for (int i = 0; i < kTileRows; ++i) {
        acc[i] = 0.f;
#pragma unroll
        for (int j = 0; j < CPL; ++j) acc[i] = fmaf(xt[i][j], v[j], acc[i]);
      }
      return row_reduce8(acc, lane);
    };

    // Margins, curvature and the gradient.
    float vcol[CPL];
#pragma unroll
    for (int j = 0; j < CPL; ++j) vcol[j] = wv[lane + 32 * j];
    const float zl = row_dot(vcol) + offl;
    float cl, ql;
    {
      float loss, dz, dzz;
      loss_terms<TASK>(zl, yl, loss, dz, dzz);
      cl = wtl * dzz;
      ql = wtl * dz;
    }
    {
      const float s = col_reduce(ql);
      if (tid < S) gv[tid] = (s + l2v[tid] * (wv[tid] - mtv[tid])) * vmv[tid];
    }
    __syncthreads();

    // S-step CG on H d = -g from d = 0, every warp on every column.
    float g[CPL], xc[CPL], rr[CPL], p[CPL], dg[CPL];
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int c = lane + 32 * j;
      g[j] = c < S ? gv[c] : 0.f;
      dg[j] = c < S ? l2v[c] + (1.f - vmv[c]) : 0.f;
      xc[j] = 0.f;
      rr[j] = -g[j];
      p[j] = -g[j];
      acc += rr[j] * rr[j];
    }
    float rs = warp_sum(acc);
    for (int step = 0; step < S; ++step) {
      const float cq = cl * row_dot(p);
      const float s = col_reduce(cq);
      if (tid < S) hpv[tid] = s + pick(dg, warp) * pick(p, warp);
      __syncthreads();
      float hp[CPL];
      acc = 0.f;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        hp[j] = lane + 32 * j < S ? hpv[lane + 32 * j] : 0.f;
        acc += p[j] * hp[j];
      }
      const float alpha = rs / fmaxf(warp_sum(acc), 1e-30f);
      acc = 0.f;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        xc[j] = fmaf(alpha, p[j], xc[j]);
        rr[j] = fmaf(-alpha, hp[j], rr[j]);
        acc += rr[j] * rr[j];
      }
      const float rs2 = warp_sum(acc);
      const float beta = rs2 / fmaxf(rs, 1e-30f);
#pragma unroll
      for (int j = 0; j < CPL; ++j) p[j] = fmaf(beta, p[j], rr[j]);
      rs = rs2;
    }

    // Direction, with the -g fallback when it is not a descent.
    float d[CPL];
    acc = 0.f;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      d[j] = xc[j] * vmv[lane + 32 * j];
      acc += g[j] * d[j];
    }
    float gd = warp_sum(acc);
    if (gd >= 0.f) {
      acc = 0.f;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        d[j] = -g[j];
        acc += g[j] * g[j];
      }
      gd = -warp_sum(acc);
    }
    const float zdl = row_dot(d);

    // Trials in order; the first that passes Armijo is taken, as when every
    // trial is evaluated. Lanes 4i carry row i's loss.
    const float f_prev = __ldg(a.f + b);
    float t_sel = 0.f, f_sel = f_prev, tk = 1.f;
    for (int kt = 0; kt < a.trials; ++kt, tk *= 0.5f) {
      const float lp =
          (lane & 3) == 0 ? wtl * loss_only<TASK>(fmaf(tk, zdl, zl), yl) : 0.f;
      float pp = 0.f;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const int c = lane + 32 * j;
        const float dw = fmaf(tk, d[j], wv[c]) - mtv[c];
        pp += l2v[c] * (dw * dw);
      }
      const float fk = block_sum_warps(warp_sum(lp), bsum, par) + 0.5f * warp_sum(pp);
      if (fk <= __fadd_rn(f_prev, __fmul_rn(__fmul_rn(1e-4f, tk), gd))) {
        t_sel = tk;
        f_sel = fk;
        break;
      }
    }
    const bool improved = t_sel > 0.f && f_sel < f_prev;
    if (tid == 0) a.imp_out[b] = improved ? 1 : 0;
    float wn[CPL];
    float pen = 0.f;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int c = lane + 32 * j;
      wn[j] = improved ? fmaf(t_sel, d[j], wv[c]) : wv[c];
      const float dw = wn[j] - mtv[c];
      pen += l2v[c] * (dw * dw);
      if (warp == 0 && c < S) a.w_out[b * S + c] = wn[j];
    }

    // Objective and gradient at the accepted point.
    const float z2 = row_dot(wn) + offl;
    float loss, dz, dzz;
    loss_terms<TASK>(z2, yl, loss, dz, dzz);
    const float lsum = block_sum_warps(warp_sum((lane & 3) == 0 ? wtl * loss : 0.f), bsum, par);
    const float pen_sum = warp_sum(pen);
    if (tid == 0) a.f_out[b] = lsum + 0.5f * pen_sum;
    const float s = col_reduce(wtl * dz);
    if (tid < S) {
      a.g_out[b * S + tid] =
          (s + l2v[tid] * (pick(wn, warp) - mtv[tid])) * vmv[tid];
    }
  }
}

// Shared floats of the generic kernel's block: slab, three row vectors,
// the alternating per-warp partial sums and the trials' penalties, then,
// when `vectors_shared`, the S vectors.
__host__ __device__ long long generic_floats(int r, int s, bool vectors_shared) {
  long long n = static_cast<long long>(r) * s + 3LL * r + 2 * kWideWarps + kMaxTrials;
  n = (n + 3) / 4 * 4;
  return vectors_shared ? n + static_cast<long long>(kVectors) * s : n;
}

bool generic_vectors_shared(int r, int s) {
  return sizeof(float) * static_cast<size_t>(generic_floats(r, s, true)) <= kSmemPerBlock;
}

bool tile_shape(int r, int s) { return r <= kTileMaxR && s <= kTileMaxS; }

// Sum over the block; every thread gets the same value, the per-warp
// partials added in one order. One barrier: calls alternate between the
// two halves of red2, and a thread reaching call n + 2 has passed call
// n + 1's barrier, after every thread's read of call n.
__device__ __forceinline__ float block_sum(float v, float* red2, int& par) {
  return block_sum_warps(warp_sum(v), red2, par);
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
newton_wide_generic_kernel(StepArgs a, float* __restrict__ ws) {
  extern __shared__ float4 sm4[];  // float4: 16-byte aligned
  float* sm = reinterpret_cast<float*>(sm4);
  const int tid = threadIdx.x;
  const long long b = blockIdx.x;
  const int R = a.r, S = a.s;
  int par = 0;

  float* xs = sm;          // [R, S]
  float* zb = xs + R * S;  // [R] margins
  float* cb = zb + R;      // [R] curvature wt * dzz
  float* qb = cb + R;      // [R] row products (c * x p, x d, wt * dz)
  float* red = qb + R;     // [2][kWideWarps] partial sums
  float* pen = red + 2 * kWideWarps;  // [kMaxTrials]
  float* vec = ws != nullptr ? ws + b * kVectors * S : sm + generic_floats(R, S, false);
  float* w_s = vec;  // the S vectors
  float* l2_s = w_s + S;
  float* mt_s = l2_s + S;
  float* vm_s = mt_s + S;
  float* g_s = vm_s + S;
  float* d_s = g_s + S;
  float* p_s = d_s + S;
  float* r_s = p_s + S;
  float* hp_s = r_s + S;
  float* x_cg = hp_s + S;

  const float* xg = a.x + b * R * S;
  const float* yb = a.y + b * R;
  const float* wtb = a.wt + b * R;
  const float* offb = a.off + b * R;

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
    w_s[i] = a.w[b * S + i];
    l2_s[i] = a.l2[b * S + i];
    mt_s[i] = a.mt[b * S + i];
    vm_s[i] = a.vm[b * S + i];
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
  float rs = block_sum(part, red, par);
  for (int step = 0; step < S; ++step) {
    row_dots(xs, p_s, cb, R, S, qb);  // c * (x p)
    __syncthreads();
    part = 0.f;
    for (int i = tid; i < S; i += kWideThreads) {
      const float hp = col_sum(xs, qb, R, S, i) + (l2_s[i] + (1.f - vm_s[i])) * p_s[i];
      hp_s[i] = hp;
      part += p_s[i] * hp;
    }
    const float alpha = rs / fmaxf(block_sum(part, red, par), 1e-30f);
    part = 0.f;
    for (int i = tid; i < S; i += kWideThreads) {
      x_cg[i] += alpha * p_s[i];
      r_s[i] -= alpha * hp_s[i];
      part += r_s[i] * r_s[i];
    }
    const float rs2 = block_sum(part, red, par);
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
  float gd = block_sum(part, red, par);
  if (gd >= 0.f) {
    part = 0.f;
    for (int i = tid; i < S; i += kWideThreads) {
      d_s[i] = -g_s[i];
      part += g_s[i] * g_s[i];
    }
    gd = -block_sum(part, red, par);
  }

  // The L2 penalty of every trial point, one warp per trial, and the
  // direction's row products.
  const int lane = tid % 32;
  for (int k = tid / 32; k < a.trials; k += kWideWarps) {
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

  // Trials in order; the first that passes Armijo is taken.
  const float f_prev = a.f[b];
  float t_sel = 0.f, f_sel = f_prev, tk = 1.f;
  for (int k = 0; k < a.trials; ++k, tk *= 0.5f) {
    part = 0.f;
    for (int r = tid; r < R; r += kWideThreads) {
      part += wtb[r] * loss_only<TASK>(zb[r] + tk * qb[r], yb[r]);
    }
    const float fk = block_sum(part, red, par) + 0.5f * pen[k];
    if (fk <= __fadd_rn(f_prev, __fmul_rn(__fmul_rn(1e-4f, tk), gd))) {
      t_sel = tk;
      f_sel = fk;
      break;
    }
  }
  const bool improved = t_sel > 0.f && f_sel < f_prev;
  if (tid == 0) a.imp_out[b] = improved ? 1 : 0;
  for (int i = tid; i < S; i += kWideThreads) {
    const float wn = improved ? w_s[i] + t_sel * d_s[i] : w_s[i];
    w_s[i] = wn;
    a.w_out[b * S + i] = wn;
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
  const float total = block_sum(part, red, par);
  part = 0.f;
  for (int i = tid; i < S; i += kWideThreads) {
    const float dw = w_s[i] - mt_s[i];
    part += l2_s[i] * dw * dw;
  }
  const float pen0 = block_sum(part, red, par);
  for (int i = tid; i < S; i += kWideThreads) {
    a.g_out[b * S + i] =
        (col_sum(xs, qb, R, S, i) + l2_s[i] * (w_s[i] - mt_s[i])) * vm_s[i];
  }
  if (tid == 0) a.f_out[b] = total + 0.5f * pen0;
}

template <int TASK, int CPL>
int launch_tile(const StepArgs& a, cudaStream_t stream) {
  auto kernel = newton_wide_tile_kernel<TASK, CPL>;
  static BlocksPerSM occupancy;
  const long long blocks = std::min(
      a.b, static_cast<long long>(occupancy.get(kernel, kWideThreads, 0)) * sm_count());
  kernel<<<static_cast<unsigned>(blocks), kWideThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

long long wide_workspace_floats(int r, int s) {
  if (tile_shape(r, s) || generic_vectors_shared(r, s)) return 0;
  return static_cast<long long>(kVectors) * s;
}

template <int TASK>
int launch_wide(const StepArgs& a, float* ws, cudaStream_t stream) {
  if (tile_shape(a.r, a.s)) {
    switch ((a.s + 31) / 32) {
      case 5: return launch_tile<TASK, 5>(a, stream);
      case 6: return launch_tile<TASK, 6>(a, stream);
      case 7: return launch_tile<TASK, 7>(a, stream);
      default: return launch_tile<TASK, 8>(a, stream);
    }
  }
  const bool shared = generic_vectors_shared(a.r, a.s);
  if (!shared && ws == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = sizeof(float) * static_cast<size_t>(generic_floats(a.r, a.s, shared));
  static size_t opted_in = 48 * 1024;
  const cudaError_t e = opt_in(newton_wide_generic_kernel<TASK>, bytes, opted_in);
  if (e != cudaSuccess) return static_cast<int>(e);
  newton_wide_generic_kernel<TASK><<<static_cast<unsigned>(a.b), kWideThreads, bytes, stream>>>(
      a, shared ? nullptr : ws);
  return static_cast<int>(cudaGetLastError());
}

template int launch_wide<kLogistic>(const StepArgs&, float*, cudaStream_t);
template int launch_wide<kPoisson>(const StepArgs&, float*, cudaStream_t);

}  // namespace photon_newton
