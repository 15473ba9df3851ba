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
// plain version does. Everything is f32 FMA arithmetic; no tensor cores.
//
// Two designs, chosen by S. This file holds the narrow one (S <= 128) and
// the entry point; the wide one (S > 128) is in newton_step_wide.cu. The
// wide design keeps the reference's gate, R * S <= 16384. The narrow design
// takes any [R, S] whose warp's shared memory (below) fits in a block's
// 227 KB with the row vectors left in global memory: every bucket of the
// reference's gate, and longer ones past it, such as the 1024-row bucket
// at 17 slots (R * S = 17408) that a 512-row cap on an entity's rows gives.
//
// Narrow design (newton_narrow_kernel): one warp per entity, one warp per
// block, persistent. The launcher starts as many blocks as the card holds
// at once (24 per SM at most: registers are capped at 80 a thread) and
// each walks over entities b, b + W, ... The entity's slab (rows padded to
// an odd stride), its y, wt, off and its w, l2, mt, vm, f are staged into
// shared memory with cp.async, 16-byte copies where the rows need no
// padding. One buffer: a warp stages entity b + W once it has finished
// entity b, and the other resident warps' compute covers the copy. A
// second buffer, staged while the warp computes, costs a third of the
// resident warps at the bench's buckets and was measured slower there on
// an H100. No barrier is wider than the warp.
//
// What replaces what, against the first port of this kernel (one warp per
// entity, four per block, one entry of H per lane at a time, H and every
// S vector in shared memory, y, wt, off re-read from global memory in
// every pass, all trials evaluated):
// - Hessian: a lane owns a 4 x 4 tile of H's lower triangle and keeps its
//   16 sums in registers; per row it reads 8 slab values and c for 16
//   FMAs (one entry per lane read 3 values for 2). Where the triangle has
//   fewer tiles than lanes (S = 9: 6 tiles, S = 17: 15), the lanes split
//   the rows into groups and add the groups' tiles by a shuffle tree, so 30
//   of 32 lanes work. Lanes that walk rows (margins, trial margins) read
//   the odd-stride rows from distinct banks.
// - CG: for S <= 32 lane i holds row i of H in registers (templated on
//   ceil(S / 4) quads) and reads p as 16-byte broadcasts from a double
//   buffer, one warp barrier per step; the row product runs in four partial
//   sums. For 32 < S <= 128 H stays in shared memory, read as 16-byte
//   vectors at a stride whose quad count is odd. The S steps and both dot
//   products per step stay: they are the function.
// - Line search: trials are evaluated in order and the loop stops at the
//   first passing one. Taking the first passing trial is the contract, so
//   the result is the same as evaluating all T; the common case costs one
//   trial's exp and log1p per row instead of sixteen.
// - z and c (then x d, then wt dz) stay in shared memory, two [R] vectors.
//   Only where staging them would not fit (R in the thousands: 16384 x 1,
//   or 2048 x 17) do y, wt, off stay in global memory, so that one warp
//   still fits. A long bucket's warp takes up to the whole 227 KB, so as
//   few as one warp an SM runs; such buckets hold the few most active
//   entities.
//
// What bounds it: bytes in principle. At the bench's user bucket (~100,000
// entities x 64 rows x 17 slots) a step must read the 435 MB slab plus the
// row and slot vectors once: ~0.17 ms at the H100's 3.35 TB/s. The warp
// issues some 3,500 instructions per entity there (Hessian ~1,000, CG
// ~1,250, the passes over the rows, the losses' exp and log1p), and the
// CG's S steps are a serial chain of two warp reductions and two
// divisions each, so the issue rate and that chain keep the kernel above
// the byte bound.
//
// The kernel allocates nothing and does not synchronise. The launcher returns
// cudaGetLastError() and the Python wrapper raises when it is not 0.

#include <algorithm>

#include "newton_common.cuh"

namespace photon_newton {
namespace {

constexpr int kNarrowWarpsPerSM = 24;  // register cap: 80 per thread

__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) / 4 * 4; }

// Shared floats of one warp (one block) for an [R, S] bucket.
struct NarrowLayout {
  int sp;    // slab row stride: S rounded up to odd
  int sv;    // S rounded up to a multiple of 4
  int r4;    // R rounded up to a multiple of 4
  int slab;  // R * sp + 4 (a tile reads up to 3 floats past a row), rounded
  bool rows; // y, wt, off staged too (all but the longest entities)
  int vo;    // offset of w, l2, mt, vm [sv] each, then f
  int buf;   // the entity's staged operands
  int hst;   // H's row stride
  int hs;    // H's floats
  __host__ __device__ NarrowLayout(int r, int s, bool reg_h, bool rows_staged) {
    sp = s | 1;
    sv = round4(s);
    r4 = round4(r);
    slab = round4(r * sp + 4);
    rows = rows_staged;
    vo = slab + (rows ? 3 * r4 : 0);
    buf = vo + 4 * sv + 4;
    // Register design: H goes through shared memory once, at an odd stride.
    // Shared design: rows of whole quads, an odd number of them.
    hst = reg_h ? (s | 1) : (((s + 3) / 4) | 1) * 4;
    hs = round4(s * hst);
  }
  // The staged operands, z and c [R], p twice and g [S], H.
  __host__ __device__ int warp_floats() const { return buf + 2 * r4 + 3 * sv + hs; }
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Issue the copies of entity b's slab (rows padded to L.sp), its y, wt,
// off where L.rows, and its w, l2, mt, vm and f into `buf`. vec16: the
// slab needs no padding and every entity's slab is 16-byte aligned.
__device__ __forceinline__ void stage(const StepArgs& a, long long b, float* buf,
                                      const NarrowLayout& L, bool vec16, int lane) {
  const int R = a.r, S = a.s;
  const int n = R * S;
  const float* xg = a.x + b * n;
  if (vec16) {
#pragma unroll 4
    for (int i = lane; i < n / 4; i += 32) cp_async16(buf + 4 * i, xg + 4 * i);
  } else if (L.sp == S) {
#pragma unroll 4
    for (int i = lane; i < n; i += 32) cp_async4(buf + i, xg + i);
  } else {
    // Element i of the slab goes to row i / S, column i % S.
    int r = lane / S, c = lane % S;
    const int dr = 32 / S, dc = 32 % S;
    for (int i = lane; i < n; i += 32) {
      cp_async4(buf + r * L.sp + c, xg + i);
      c += dc;
      r += dr;
      if (c >= S) {
        c -= S;
        ++r;
      }
    }
  }
  if (L.rows) {
    float* rv = buf + L.slab;
    for (int r = lane; r < R; r += 32) {
      const long long o = b * R + r;
      cp_async4(rv + r, a.y + o);
      cp_async4(rv + L.r4 + r, a.wt + o);
      cp_async4(rv + 2 * L.r4 + r, a.off + o);
    }
  }
  float* v = buf + L.vo;
  for (int i = lane; i < S; i += 32) {
    const long long o = b * S + i;
    cp_async4(v + i, a.w + o);
    cp_async4(v + L.sv + i, a.l2 + o);
    cp_async4(v + 2 * L.sv + i, a.mt + o);
    cp_async4(v + 3 * L.sv + i, a.vm + o);
  }
  if (lane == 0) cp_async4(v + 4 * L.sv, a.f + b);
}

// x[r, :] . v over S slots: v in registers (NQ quads) or in shared memory.
template <int NQ>
__device__ __forceinline__ float row_dot(const float* xr, const float* vreg,
                                         const float* vs, int S) {
  float a0 = 0.f, a1 = 0.f;
  if constexpr (NQ > 0) {
#pragma unroll
    for (int t = 0; t < 4 * NQ; t += 2) {
      if (t < S) a0 = fmaf(xr[t], vreg[t], a0);
      if (t + 1 < S) a1 = fmaf(xr[t + 1], vreg[t + 1], a1);
    }
  } else {
    int t = 0;
    for (; t + 1 < S; t += 2) {
      a0 = fmaf(xr[t], vs[t], a0);
      a1 = fmaf(xr[t + 1], vs[t + 1], a1);
    }
    if (t < S) a0 = fmaf(xr[t], vs[t], a0);
  }
  return a0 + a1;
}

// The masked gradient (x^T q + l2 (w - mt)) vm into out[S] (global): lanes
// split the slots into quads and the rows into groups, and add the groups
// with shuffles. `wv` is w in shared memory.
__device__ __forceinline__ void gradient(const float* xs, const float* q, int R, int S,
                                         int sp, const float* wv, const float* l2v,
                                         const float* mtv, const float* vmv, float* out,
                                         int lane) {
  const int nq = (S + 3) / 4;
  const int groups = 32 / nq;  // nq <= 32
  const int quad = lane % nq, grp = lane / nq;
  const int c0 = 4 * quad;
  float ga[4] = {0.f, 0.f, 0.f, 0.f};
  if (grp < groups) {
    for (int r = grp; r < R; r += groups) {
      const float* xr = xs + r * sp + c0;
      const float qr = q[r];
#pragma unroll
      for (int k = 0; k < 4; ++k) ga[k] = fmaf(xr[k], qr, ga[k]);
    }
  }
  // Tree over the groups; group 0 ends with the sum.
  for (int off = 1; off < groups; off *= 2) {
    const int src = (lane + off * nq) & 31;
    const bool take = grp % (2 * off) == 0 && grp + off < groups;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float other = __shfl_sync(kFull, ga[k], src);
      if (take) ga[k] += other;
    }
  }
  if (lane < nq) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = c0 + k;
      if (i < S) out[i] = (ga[k] + l2v[i] * (wv[i] - mtv[i])) * vmv[i];
    }
  }
}

// H = x^T diag(c) x + diag(l2 + 1 - vm) into hs[S, hst], both triangles.
// Lane tiles of 4 x 4 over the lower triangle of nq x nq quads; with fewer
// tiles than lanes, groups of lanes split the rows.
template <int NQ>
__device__ __forceinline__ void hessian(const float* xs, const float* c, int R, int S,
                                        int sp, const float* l2v, const float* vmv,
                                        float* hs, int hst, int lane) {
  const int nq = NQ > 0 ? NQ : (S + 3) / 4;
  const int nt = nq * (nq + 1) / 2;
  const int groups = nt < 32 ? 32 / nt : 1;
  const int grp = groups > 1 ? lane / nt : 0;
  for (int tl = groups > 1 ? lane % nt : lane; tl < nt; tl += 32) {
    int I = 0;
    while ((I + 1) * (I + 2) / 2 <= tl) ++I;
    const int T = tl - I * (I + 1) / 2;
    const int i0 = 4 * I, t0 = 4 * T;
    float acc[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[u][v] = 0.f;
    if (grp < groups) {
#pragma unroll 2
      for (int r = grp; r < R; r += groups) {
        const float* xr = xs + r * sp;
        const float cr = c[r];
        float xi[4], xt[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          xi[k] = xr[i0 + k];
          xt[k] = xr[t0 + k];
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float ci = xi[u] * cr;
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(ci, xt[v], acc[u][v]);
        }
      }
    }
    // Tree over the groups, group 0 ending with the sum. Uniform across
    // the warp: with groups > 1 every lane has one tile.
    for (int off = 1; off < groups; off *= 2) {
      const int src = (lane + off * nt) & 31;
      const bool take = grp % (2 * off) == 0 && grp + off < groups;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const float other = __shfl_sync(kFull, acc[u][v], src);
          if (take) acc[u][v] += other;
        }
      }
    }
    if (grp == 0) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int i = i0 + u, t = t0 + v;
          if (i < S && t <= i) {
            float h = acc[u][v];
            if (i == t) h += l2v[i] + (1.f - vmv[i]);
            hs[i * hst + t] = h;
            hs[t * hst + i] = h;
          }
        }
      }
    }
  }
}

template <int TASK, int NQ>
__global__ void __launch_bounds__(32, kNarrowWarpsPerSM)
newton_narrow_kernel(StepArgs a, bool rows_staged) {
  constexpr bool kRegH = NQ > 0;
  constexpr int kSlots = kRegH ? 1 : kMaxSub / 32;  // slots a lane owns
  constexpr int kV = kRegH ? 4 * NQ : 1;             // broadcast vector in registers
  extern __shared__ float4 sm4[];  // float4: 16-byte aligned
  const int lane = threadIdx.x;
  const int R = a.r, S = a.s;
  const NarrowLayout L(R, S, kRegH, rows_staged);
  float* xs = reinterpret_cast<float*>(sm4);  // the staged operands
  float* zb = xs + L.buf;      // [R] margins
  float* cb = zb + L.r4;       // [R] curvature, then x d, then wt dz
  float* pv = cb + L.r4;       // [2][sv] CG p; w, d, w_new broadcasts
  float* gv = pv + 2 * L.sv;   // [sv] gradient
  float* hs = gv + L.sv;       // H
  const long long W = gridDim.x;
  long long b = blockIdx.x;  // the grid never exceeds B
  const bool vec16 = L.sp == S && (R * S) % 4 == 0 &&
                     (reinterpret_cast<unsigned long long>(a.x) % 16) == 0;
  stage(a, b, xs, L, vec16, lane);
  cp_async_commit();

  for (; b < a.b; b += W) {
    cp_async_wait_all();
    __syncwarp();
    const float* wv = xs + L.vo;  // w, l2, mt, vm [sv] each, then f
    const float* l2v = wv + L.sv;
    const float* mtv = l2v + L.sv;
    const float* vmv = mtv + L.sv;
    const float f_prev = vmv[L.sv];
    // Row vectors: staged, or (the longest entities) read from L2.
    const float* yb = L.rows ? xs + L.slab : a.y + b * R;
    const float* wtb = L.rows ? yb + L.r4 : a.wt + b * R;
    const float* offb = L.rows ? yb + 2 * L.r4 : a.off + b * R;

    // Margins and curvature, one lane per row.
    float vreg[kV];
    if constexpr (kRegH) {
#pragma unroll
      for (int t = 0; t < kV; ++t) vreg[t] = t < S ? wv[t] : 0.f;
    }
    for (int r = lane; r < R; r += 32) {
      const float z = row_dot<NQ>(xs + r * L.sp, vreg, wv, S) + offb[r];
      float loss, dz, dzz;
      loss_terms<TASK>(z, yb[r], loss, dz, dzz);
      zb[r] = z;
      cb[r] = wtb[r] * dzz;
    }
    __syncwarp();
    hessian<NQ>(xs, cb, R, S, L.sp, l2v, vmv, hs, L.hst, lane);
    if constexpr (!kRegH) {
      // The CG reads whole quads of a row: zero the columns past S.
      for (int i = lane; i < S; i += 32) {
        for (int t = S; t < L.sv; ++t) hs[i * L.hst + t] = 0.f;
      }
    }
    __syncwarp();
    for (int r = lane; r < R; r += 32) {
      float loss, dz, dzz;
      loss_terms<TASK>(zb[r], yb[r], loss, dz, dzz);
      cb[r] = wtb[r] * dz;
    }
    __syncwarp();
    gradient(xs, cb, R, S, L.sp, wv, l2v, mtv, vmv, gv, lane);
    __syncwarp();

    // S-step CG on H d = -g; lane owns slots lane, lane + 32, ...
    float g[kSlots], xc[kSlots], rr[kSlots], p[kSlots];
    float part = 0.f;
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const int i = lane + 32 * j;
      g[j] = i < S ? gv[i] : 0.f;
      xc[j] = 0.f;
      rr[j] = -g[j];
      p[j] = -g[j];
      part += rr[j] * rr[j];
    }
    float rs = warp_sum(part);
    float hrow[kV];
    if constexpr (kRegH) {
#pragma unroll
      for (int t = 0; t < kV; ++t) hrow[t] = (lane < S && t < S) ? hs[lane * L.hst + t] : 0.f;
    }
    const int nq = (S + 3) / 4;
    for (int step = 0; step < S; ++step) {
      float* pb = pv + (step & 1) * L.sv;
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        const int i = lane + 32 * j;
        if (i < L.sv) pb[i] = p[j];
      }
      __syncwarp();
      const float4* p4 = reinterpret_cast<const float4*>(pb);
      float hp[kSlots];
      if constexpr (kRegH) {
        float h0 = 0.f, h1 = 0.f, h2 = 0.f, h3 = 0.f;
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const float4 pq = p4[q];
          h0 = fmaf(hrow[4 * q], pq.x, h0);
          h1 = fmaf(hrow[4 * q + 1], pq.y, h1);
          h2 = fmaf(hrow[4 * q + 2], pq.z, h2);
          h3 = fmaf(hrow[4 * q + 3], pq.w, h3);
        }
        hp[0] = (h0 + h1) + (h2 + h3);
      } else {
        const float4* rows[kSlots];
#pragma unroll
        for (int j = 0; j < kSlots; ++j) {
          hp[j] = 0.f;
          rows[j] = reinterpret_cast<const float4*>(hs + min(lane + 32 * j, S - 1) * L.hst);
        }
        for (int q = 0; q < nq; ++q) {
          const float4 pq = p4[q];
#pragma unroll
          for (int j = 0; j < kSlots; ++j) {
            if (32 * j < S) {
              const float4 hq = rows[j][q];
              hp[j] = fmaf(hq.x, pq.x, hp[j]);
              hp[j] = fmaf(hq.y, pq.y, hp[j]);
              hp[j] = fmaf(hq.z, pq.z, hp[j]);
              hp[j] = fmaf(hq.w, pq.w, hp[j]);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < kSlots; ++j) {
          if (lane + 32 * j >= S) hp[j] = 0.f;
        }
      }
      part = 0.f;
#pragma unroll
      for (int j = 0; j < kSlots; ++j) part += p[j] * hp[j];
      const float alpha = rs / fmaxf(warp_sum(part), 1e-30f);
      part = 0.f;
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        xc[j] = fmaf(alpha, p[j], xc[j]);
        rr[j] = fmaf(-alpha, hp[j], rr[j]);
        part += rr[j] * rr[j];
      }
      const float rs2 = warp_sum(part);
      const float beta = rs2 / fmaxf(rs, 1e-30f);
#pragma unroll
      for (int j = 0; j < kSlots; ++j) p[j] = fmaf(beta, p[j], rr[j]);
      rs = rs2;
    }

    // Direction, with the -g fallback when it is not a descent.
    float d[kSlots], wl[kSlots], l2l[kSlots], mtl[kSlots];
    part = 0.f;
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const int i = lane + 32 * j;
      const bool live = i < S;
      d[j] = live ? xc[j] * vmv[i] : 0.f;
      wl[j] = live ? wv[i] : 0.f;
      l2l[j] = live ? l2v[i] : 0.f;
      mtl[j] = live ? mtv[i] : 0.f;
      part += g[j] * d[j];
    }
    float gd = warp_sum(part);
    if (gd >= 0.f) {
      part = 0.f;
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        d[j] = -g[j];
        part += g[j] * g[j];
      }
      gd = -warp_sum(part);
    }
    // Broadcast d (buffer 0; the CG's last step wrote buffer (S - 1) & 1,
    // and every lane has passed that step's barrier).
    __syncwarp();
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const int i = lane + 32 * j;
      if (i < L.sv) pv[i] = d[j];
    }
    __syncwarp();
    if constexpr (kRegH) {
#pragma unroll
      for (int t = 0; t < kV; ++t) vreg[t] = pv[t];
    }
    for (int r = lane; r < R; r += 32) cb[r] = row_dot<NQ>(xs + r * L.sp, vreg, pv, S);

    // Trials in order; the first that passes Armijo is taken, as when every
    // trial is evaluated. fk is the same in every lane.
    float t_sel = 0.f, f_sel = f_prev, tk = 1.f;
    for (int kt = 0; kt < a.trials; ++kt, tk *= 0.5f) {
      float lp = 0.f;
      for (int r = lane; r < R; r += 32) {
        lp += wtb[r] * loss_only<TASK>(fmaf(tk, cb[r], zb[r]), yb[r]);
      }
      float pp = 0.f;
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        const float dw = fmaf(tk, d[j], wl[j]) - mtl[j];
        pp += l2l[j] * (dw * dw);
      }
      const float fk = warp_sum(lp) + 0.5f * warp_sum(pp);
      if (fk <= __fadd_rn(f_prev, __fmul_rn(__fmul_rn(1e-4f, tk), gd))) {
        t_sel = tk;
        f_sel = fk;
        break;
      }
    }
    const bool improved = t_sel > 0.f && f_sel < f_prev;
    if (lane == 0) a.imp_out[b] = improved ? 1 : 0;
    float* wn_s = pv + L.sv;  // w_new, broadcast
    float pen = 0.f;
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const int i = lane + 32 * j;
      const float wn = improved ? fmaf(t_sel, d[j], wl[j]) : wl[j];
      const float dw = wn - mtl[j];
      pen += l2l[j] * (dw * dw);
      if (i < S) a.w_out[b * S + i] = wn;
      if (i < L.sv) wn_s[i] = wn;
    }
    __syncwarp();

    // Objective and gradient at the accepted point.
    if constexpr (kRegH) {
#pragma unroll
      for (int t = 0; t < kV; ++t) vreg[t] = wn_s[t];
    }
    float lsum = 0.f;
    for (int r = lane; r < R; r += 32) {
      const float z = row_dot<NQ>(xs + r * L.sp, vreg, wn_s, S) + offb[r];
      float loss, dz, dzz;
      loss_terms<TASK>(z, yb[r], loss, dz, dzz);
      const float wr = wtb[r];
      lsum += wr * loss;
      cb[r] = wr * dz;
    }
    const float total = warp_sum(lsum) + 0.5f * warp_sum(pen);
    __syncwarp();
    gradient(xs, cb, R, S, L.sp, wn_s, l2v, mtv, vmv, a.g_out + b * S, lane);
    if (lane == 0) a.f_out[b] = total;
    __syncwarp();
    if (b + W < a.b) {
      stage(a, b + W, xs, L, vec16, lane);
      cp_async_commit();
    }
  }
}


// Bytes of one warp's shared memory.
size_t narrow_bytes(int r, int s, bool reg_h, bool rows) {
  return sizeof(float) * static_cast<size_t>(NarrowLayout(r, s, reg_h, rows).warp_floats());
}

// Whether the kernel takes an [R, S] bucket (the gate at the top of this
// file; ops/newton_kernel.py's kernel_supported computes the same).
bool shape_supported(int r, int s) {
  if (s > kMaxSub) return static_cast<long long>(r) * s <= kMaxRS;
  // The slab alone is R * S floats: rule out what would overflow the layout.
  if (static_cast<long long>(r) * s * sizeof(float) > kSmemPerBlock) return false;
  return narrow_bytes(r, s, s <= 32, false) <= kSmemPerBlock;
}

template <int TASK, int NQ>
int launch_narrow(const StepArgs& a, cudaStream_t stream) {
  constexpr bool reg_h = NQ > 0;
  // One warp per block, so the SM packs as many as fit. The row vectors are
  // staged unless that leaves no room (R in the thousands, S tiny).
  const bool rows = narrow_bytes(a.r, a.s, reg_h, true) <= kSmemPerBlock;
  const size_t bytes = narrow_bytes(a.r, a.s, reg_h, rows);
  auto kernel = newton_narrow_kernel<TASK, NQ>;
  static size_t opted_in = 48 * 1024;
  const cudaError_t e = opt_in(kernel, bytes, opted_in);
  if (e != cudaSuccess) return static_cast<int>(e);
  static BlocksPerSM occupancy;
  const long long resident =
      static_cast<long long>(occupancy.get(kernel, 32, bytes)) * sm_count();
  const long long blocks = std::min(a.b, resident);
  kernel<<<static_cast<unsigned>(blocks), 32, bytes, stream>>>(a, rows);
  return static_cast<int>(cudaGetLastError());
}

template <int TASK>
int launch(const StepArgs& a, float* ws, cudaStream_t stream) {
  if (a.s > kMaxSub) return launch_wide<TASK>(a, ws, stream);
  switch ((a.s + 3) / 4) {
    case 1: return launch_narrow<TASK, 1>(a, stream);
    case 2: return launch_narrow<TASK, 2>(a, stream);
    case 3: return launch_narrow<TASK, 3>(a, stream);
    case 4: return launch_narrow<TASK, 4>(a, stream);
    case 5: return launch_narrow<TASK, 5>(a, stream);
    case 6: return launch_narrow<TASK, 6>(a, stream);
    case 7: return launch_narrow<TASK, 7>(a, stream);
    case 8: return launch_narrow<TASK, 8>(a, stream);
    default: return launch_narrow<TASK, 0>(a, stream);
  }
}

}  // namespace
}  // namespace photon_newton

extern "C" {

// Floats of global workspace per entity that photon_newton_step needs for
// an [R, S] bucket: 0 unless the wide design's S vectors do not fit in
// shared memory.
long long photon_newton_step_workspace_floats(int r, int s) {
  if (s <= photon_newton::kMaxSub) return 0;
  return photon_newton::wide_workspace_floats(r, s);
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
  using namespace photon_newton;
  if (b <= 0 || b > 0x7fffffffLL || r <= 0 || s <= 0 || !shape_supported(r, s) ||
      trials < 1 || trials > kMaxTrials) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const StepArgs a{x, w, y, wt, off, l2, mt, vm, f, w_out, f_out, g_out, imp_out,
                   b, r, s, trials};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (task == kLogistic) return launch<kLogistic>(a, ws, st);
  if (task == kPoisson) return launch<kPoisson>(a, ws, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
