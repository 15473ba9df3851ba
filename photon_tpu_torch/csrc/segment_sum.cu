// Segment sum over sorted int32 ids, written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel photon_tpu/ops/segment_reduce.py:
// _windowed_sum (body _kernel). It computes the same function:
//   out[s] = sum of values[i] over every i with ids[i] == s,  0 <= s < n
// for ids sorted ascending; ids outside [0, n) are dropped. Values are f32
// or bf16; every sum is taken in f32 and out is f32. The kernel writes every
// output, zeros included, so the caller need not initialise out.
//
// Design: tiled by output, as the TPU kernel writes whole output windows.
// The output is cut into tiles of T segments (T a power of two chosen by the
// launcher, at most kMaxTile), and each block, resident for the whole
// launch, owns a contiguous run of tiles. It keeps a tile's sums in shared
// memory:
//   1. it finds where its first tile's input starts in the sorted ids, once,
//      by a 256-ary search: each round every thread probes one position and
//      the count of probes below the target narrows the range 256 times, so
//      57 M ids take 4 or 5 rounds of one load each. Every later tile starts
//      where the one before it stopped, so the search is paid once per block;
//   2. it streams a tile's elements in chunks of kChunk, loaded coalesced
//      into shared memory; each thread sums the runs of its kItems
//      consecutive elements, a segmented scan over the block's threads
//      (warp shuffles, then the 8 warp totals in order) carries a run across
//      threads, and the thread in which a run ends adds its sum into the
//      segment's shared slot. A run has one such thread per chunk, so no two
//      threads add into one slot, and a long run costs its length over kChunk
//      block steps, not its length in dependent loads. The first element past
//      the tile ends the stream and is where the next tile starts;
//   3. it writes the whole tile to out, 16 bytes a thread where aligned. A
//      tile that no id names (known from the id that ended the last stream)
//      only writes its zeros.
// Every sum is taken in an order fixed by the input alone, with no atomics,
// so two runs on the same input give bit-identical output (the reference
// declares this reduce deterministic: NUMERICS_AUDIT, segment_reduce.py
// :94-111), and sums of integer values below 2**24 are exact.
//
// What bounds it: bytes. Each id and value is read once (a tile's stream
// also reads up to one chunk past its end, which the next tile reads again
// from cache, and the search a few rounds of 256 ids per block) and each
// output written once: m * (4 + esize) + n * 4 bytes, at 3.35 TB/s on an
// H100. At the port's gram and densify sites the output, mostly zeros, is
// most of those bytes. The tile (16 K segments, 64 KB of sums) and the
// chunk (1,024 elements) are sized so that three blocks fit an SM.
//
// The kernel allocates nothing and does not synchronise. The launcher returns
// cudaGetLastError() and the Python wrapper raises when it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 4;                     // elements per thread per chunk
constexpr int kChunk = kThreads * kItems;     // elements per block step
constexpr int kChunkPadded = kChunk + kChunk / 32;
constexpr int kMinTile = 1024;
constexpr int kMaxTile = 16384;
constexpr int kFloat32 = 0;
constexpr int kBfloat16 = 1;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Shared-memory index of chunk element e, padded so that a thread reading
// its kItems consecutive elements meets no bank conflict.
__device__ __forceinline__ int pad(int e) { return e + (e >> 5); }

// Writes get(s) to out[s] for s in [0, len): 16-byte stores where out is
// 16-byte aligned.
template <typename Get>
__device__ __forceinline__ void write_tile(float* __restrict__ out, int len,
                                           Get get) {
  int i = 0;
  if ((reinterpret_cast<std::uintptr_t>(out) & 15) == 0) {
    float4* out4 = reinterpret_cast<float4*>(out);
    for (int q = threadIdx.x; q < len / 4; q += kThreads) {
      out4[q] = make_float4(get(4 * q), get(4 * q + 1), get(4 * q + 2),
                            get(4 * q + 3));
    }
    i = len / 4 * 4;
  }
  for (int s = i + threadIdx.x; s < len; s += kThreads) out[s] = get(s);
}

// The first i with ids[i] >= target, found by the whole block; every
// thread returns it.
__device__ long long lower_bound(const int* __restrict__ ids, long long m,
                                 long long target) {
  __shared__ long long range[2];
  __shared__ int below[kWarps];
  if (threadIdx.x == 0) {
    range[0] = 0;
    range[1] = m;
  }
  __syncthreads();
  while (true) {
    const long long a = range[0];
    const long long b = range[1];
    if (a >= b) break;  // block-uniform: every thread read the same range
    const long long step = (b - a + kThreads - 1) / kThreads;
    const long long pos = a + threadIdx.x * step;
    const int lt = __reduce_add_sync(0xffffffffu, pos < b && ids[pos] < target);
    if (threadIdx.x % 32 == 0) below[threadIdx.x / 32] = lt;
    __syncthreads();
    if (threadIdx.x == 0) {
      int cnt = 0;
      for (int w = 0; w < kWarps; ++w) cnt += below[w];
      if (cnt == 0) {
        range[1] = a;
      } else {
        range[0] = a + (cnt - 1) * step + 1;
        range[1] = min(a + cnt * step, b);
      }
    }
    __syncthreads();
  }
  const long long lo = range[0];
  __syncthreads();  // range is reused by the next call
  return lo;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    segment_sum_kernel(const T* __restrict__ values, const int* __restrict__ ids,
                       long long m, int n, int tile, int tiles_per_block,
                       float* __restrict__ out) {
  extern __shared__ float smem[];
  float* acc = smem;                                          // [tile]
  int* sh_id = reinterpret_cast<int*>(smem + tile);           // [kChunkPadded]
  float* sh_v = reinterpret_cast<float*>(sh_id + kChunkPadded);
  __shared__ float warp_x[kWarps];
  __shared__ int warp_head[kWarps];
  __shared__ int stop;      // chunk index of the first element past the tile
  __shared__ int stop_id;   // its id (INT_MAX past the last element)

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long num_tiles = (n + tile - 1) / tile;
  const long long t0 = static_cast<long long>(blockIdx.x) * tiles_per_block;
  const long long t1 = min(num_tiles, t0 + tiles_per_block);
  if (t0 >= t1) return;  // block-uniform

  // 1. Where the first tile's input starts, and the id found there.
  long long lo = lower_bound(ids, m, t0 * tile);
  int next_id = lo < m ? ids[lo] : INT_MAX;

  for (long long t = t0; t < t1; ++t) {
    const long long s0 = t * tile;
    const int len = static_cast<int>(min(static_cast<long long>(tile), n - s0));
    const long long end = s0 + len;
    float* tile_out = out + s0;
    if (next_id >= end) {  // no id in this tile
      write_tile(tile_out, len, [](int) { return 0.f; });
      continue;
    }
    for (int s = tid; s < len; s += kThreads) acc[s] = 0.f;

    // 2. Stream the tile from lo. Local ids are id - s0 in [0, len); an
    // element past the tile, or past the last element, takes len, which no
    // slot has. Ids from lo on are >= s0.
    for (long long c = lo;; c += kChunk) {
      const int cnt = static_cast<int>(min(static_cast<long long>(kChunk), m - c));
      __syncthreads();  // the previous chunk's readers are done
      if (tid == 0) stop = kChunk;
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        const int e = tid + k * kThreads;
        int lid = len;
        float v = 0.f;
        if (e < cnt) {
          // Both loads are issued before either is used.
          const int id = ids[c + e];
          const float value = to_f32(values[c + e]);
          if (id < end) {
            lid = static_cast<int>(id - s0);
            v = value;
          }
        }
        sh_id[pad(e)] = lid;
        sh_v[pad(e)] = v;
      }
      __syncthreads();

      const int e0 = tid * kItems;
      int id[kItems];
      float v[kItems];
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        id[k] = sh_id[pad(e0 + k)];
        v[k] = sh_v[pad(e0 + k)];
      }
      // The tile's elements are a prefix of the chunk: the one thread that
      // holds its end records it.
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        const int e = e0 + k;
        const int before = k > 0 ? id[k - 1] : (e > 0 ? sh_id[pad(e - 1)] : 0);
        if (id[k] == len && (e == 0 || before != len)) {
          stop = e;
          stop_id = e < cnt ? ids[c + e] : INT_MAX;
        }
      }
      // Runs inside the thread: the first (head), the last (tail) and the
      // middle ones, which end here and are added at once.
      float run = v[0];
      float head = 0.f;
      bool split = false;
#pragma unroll
      for (int k = 1; k < kItems; ++k) {
        if (id[k] != id[k - 1]) {
          if (!split) {
            head = run;
            split = true;
          } else if (id[k - 1] < len) {
            acc[id[k - 1]] += run;
          }
          run = v[k];
        } else {
          run += v[k];
        }
      }
      const float tail = run;
      if (!split) head = run;
      const bool uniform = !split;  // one run over all kItems elements
      const bool from_prev = tid > 0 && sh_id[pad(e0 - 1)] == id[0];
      const bool to_next =
          tid + 1 < kThreads && sh_id[pad(e0 + kItems)] == id[kItems - 1];

      // x = the sum so far of the run open at this thread's end: its tail,
      // plus the previous thread's x where one run covers this whole thread.
      // A segmented inclusive scan, heads where the chain restarts.
      float x = tail;
      bool head_flag = !(uniform && from_prev);
#pragma unroll
      for (int off = 1; off < 32; off *= 2) {
        const float x_up = __shfl_up_sync(0xffffffffu, x, off);
        const bool h_up = __shfl_up_sync(0xffffffffu, head_flag, off);
        if (lane >= off) {
          if (!head_flag) x = x_up + x;
          head_flag = head_flag || h_up;
        }
      }
      if (lane == 31) {
        warp_x[warp] = x;
        warp_head[warp] = head_flag;
      }
      __syncthreads();
      float carry_warp = 0.f;  // x at the end of the previous warp
      for (int w = 0; w < warp; ++w) {
        carry_warp = warp_head[w] ? warp_x[w] : carry_warp + warp_x[w];
      }
      if (!head_flag) x = carry_warp + x;
      const float x_prev_lane = __shfl_up_sync(0xffffffffu, x, 1);
      const float x_prev = lane > 0 ? x_prev_lane : carry_warp;
      const float carry_in = from_prev ? x_prev : 0.f;

      // The thread in which a run ends adds it.
      if (uniform) {
        if (!to_next && id[0] < len) acc[id[0]] += carry_in + head;
      } else {
        if (id[0] < len) acc[id[0]] += carry_in + head;
        if (!to_next && id[kItems - 1] < len) acc[id[kItems - 1]] += tail;
      }
      const int chunk_stop = stop;  // written before the barrier above
      if (chunk_stop < kChunk) {
        lo = c + chunk_stop;
        next_id = stop_id;
        break;
      }
    }
    __syncthreads();

    // 3. The whole tile, once.
    write_tile(tile_out, len, [acc](int s) { return acc[s]; });
    __syncthreads();  // the next tile zeroes acc
  }
}

// Segments per tile: the largest power of two in [kMinTile, kMaxTile] that
// leaves at least four tiles per SM.
int choose_tile(int n, int sms) {
  int tile = kMaxTile;
  while (tile > kMinTile && n / tile < 4 * sms) tile /= 2;
  return tile;
}

template <typename T>
int launch(const T* values, const int* ids, long long m, int n, float* out,
           cudaStream_t st) {
  static int sms = 0;  // set once the kernel may take kMaxTile's memory
  if (sms == 0) {
    int device = 0;
    int count = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, device);
    }
    const size_t most =
        sizeof(float) * kMaxTile + (sizeof(int) + sizeof(float)) * kChunkPadded;
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(segment_sum_kernel<T>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(most));
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    sms = count;
  }
  const int tile = choose_tile(n, sms);
  const size_t smem =
      sizeof(float) * tile + (sizeof(int) + sizeof(float)) * kChunkPadded;
  int per_sm = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, segment_sum_kernel<T>, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // One resident wave of blocks, each owning an equal run of tiles.
  const long long num_tiles = (n + tile - 1) / tile;
  const long long waves = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sms;
  const int tiles_per_block = static_cast<int>((num_tiles + waves - 1) / waves);
  const unsigned int blocks =
      static_cast<unsigned int>((num_tiles + tiles_per_block - 1) / tiles_per_block);
  segment_sum_kernel<T><<<blocks, kThreads, smem, st>>>(
      values, ids, m, n, tile, tiles_per_block, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out[s] = sum of values[i] with ids[i] == s for m sorted ids, on `stream`.
// value_kind 0: f32 values, 1: bf16 values. Every one of the n outputs is
// written; out need not be initialised.
int photon_segment_sum(const void* values, int value_kind, const int* ids,
                       long long m, int n, float* out, void* stream) {
  if (m <= 0 || m > 0x7fffffffLL || n <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (value_kind == kFloat32) {
    return launch(static_cast<const float*>(values), ids, m, n, out, st);
  }
  if (value_kind == kBfloat16) {
    return launch(static_cast<const __nv_bfloat16*>(values), ids, m, n, out, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
