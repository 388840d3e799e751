// Sorted segment sum on Hopper: out[s, :] = sum of the data rows of segment s.
//
// Replaces the TPU kernel `segment_sum_pallas` + `_kernel` of the JAX package
// (src/repro/kernels/segment_sum.py), which pads the destination-sorted rows
// into 512-edge chunks per 128-row output block and accumulates
// one_hot^T @ data on the MXU, steered by scalar-prefetched chunk ranges.
//
// Bound: memory. It must read E*D input values (4 bytes each in f32, 2 in
// f16) plus S+1 offsets and write S*D floats; at 3.35 TB/s the engine's
// pagerank gather (E = 2m ~ 705,000, D = 1) is ~1 us of traffic, the
// triangle round (D = 256) ~0.23 ms. At D = 1 the traffic is shorter than a
// launch, so the design keeps to one launch and a short chain of dependent
// loads.
//
// Design: one launch, balanced over rows and segments, no float atomics.
// The host plan (kernels/segment_sum.py, segment_layout) cuts the merged
// list of the E rows and the S segment ends ("markers"; segment s's marker
// follows its last row) into tiles of kTileItems = 2048 items, merge-path style,
// and stores each tile's first row and first segment, so no block searches
// global memory. One block owns one tile (and one 256-column tile of D):
//   - it reads its rows and the offsets of the segments that end in it into
//     shared memory. At D == 1 the rows come in as 16-byte vectors when the
//     data pointer is 16-byte aligned (the first vector starts at or before
//     the tile's first row), as scalars when it is not.
//   - D == 1: each thread takes kTileItems / 256 consecutive items and sums
//     them in order; D > 1: each warp takes kTileItems / 8 consecutive
//     items, its lanes covering the columns (8 per lane, four rows' loads in
//     flight). A segment that ends inside one worker is written directly.
//   - the block joins its workers in a fixed order: a segmented scan over
//     warp shuffles and then shared memory (D == 1), or a walk over the 8
//     warps through shared memory, one thread per column (D > 1).
//   - segments wholly inside the tile are written to `out`; an empty segment
//     is written as zero by the tile that holds its marker.
// A segment whose rows cross tiles (a hub) is finished in the same launch:
// each of its tiles writes its partial to a slot of the layout and adds one
// to the segment's int counter: at D == 1 the one thread that wrote the
// slot, with an acquire-release atomic; at D > 1 the block, after
// __threadfence() and a barrier. The arrival that completes the count adds the slots in tile
// order, writes `out` and resets the counter to 0, so the next call and
// every CUDA-graph replay start clean. The order of every add depends only
// on the layout, so the same input gives the same output bits on every run.
// Accumulation is fp32 for f32 and f16 input.
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileItems = 2048;        // items (rows + segment ends) per tile
constexpr int kPer = kTileItems / kThreads;  // items a thread (D == 1)
constexpr int kWarps = kThreads / 32;
constexpr int kColsPerLane = 8;
constexpr int kTileCols = 32 * kColsPerLane;
constexpr int kUnroll = 4;  // rows whose loads are issued together (D > 1)
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

// V values of type T, loaded as one 16-byte access when V * sizeof(T) == 16.
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T x[V];
};

// Lower bound of the merge path: the number of markers among the first
// `diag` items of a tile with `nrows` rows and `nsegs` markers, where
// ends[b] is the tile-relative row at which segment s0 + b ends.
__device__ __forceinline__ int markers_before(const int* ends, int nrows, int nsegs, int diag) {
  int lo = max(0, diag - nrows), hi = min(diag, nsegs);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (ends[mid] + mid < diag) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// Crossing segments. cross[m] = {segment, first tile, last tile, slots};
// slot i < slots - 1 is the tail partial of tile first + i, the last one the
// head partial of the last tile. Each contributing tile arrives on the
// segment's counter once its slot is written; the arrival that completes
// the count adds the slots in tile order, writes `out` and resets the
// counter.

// atomicAdd with acquire-release order at device scope: this thread's
// earlier writes are visible to the thread that reads its increment, and
// the writes released by earlier increments are visible to this thread.
__device__ __forceinline__ int atomic_add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.add.acq_rel.gpu.global.s32 %0, [%1], %2;"
               : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

// D == 1: one thread writes a slot and arrives itself, with an
// acquire-release atomic in place of two __threadfence()s; the finisher
// reads the other tiles' slots from L2 (__ldcg).
__device__ void arrive_one(
    int m, const int4* __restrict__ cross, int* counters, const float* slots,
    int num_tiles, float* out)
{
  const int4 c = cross[m];
  if (atomic_add_acq_rel(counters + m, 1) != c.w - 1) return;
  // The head slot and up to 32 tail slots in one round of loads.
  const int n = c.w - 1;  // tail slots before the head slot
  const float* tail = slots + c.y;
  const float head = __ldcg(slots + num_tiles + c.z);
  float acc = 0.f;
  for (int i = 0; i < n; i += 32) {
    float v[32];
#pragma unroll
    for (int r = 0; r < 32; ++r) v[r] = i + r < n ? __ldcg(tail + i + r) : 0.f;
#pragma unroll
    for (int r = 0; r < 32; ++r)
      if (i + r < n) acc += v[r];
  }
  out[c.x] = acc + head;
  counters[m] = 0;
}

// D > 1: every column tile of the grid arrives, after the whole block has
// written its slots (fence, barrier, one atomic per segment from two warps
// at once); the last arrival finishes all D columns.
__device__ void arrive_block(
    int m_in, int m_out, const int4* __restrict__ cross, int* counters,
    const float* slots, int num_tiles, int D, float* out, int* last)
{
  __threadfence();
  __syncthreads();
  if (threadIdx.x % 32 == 0 && threadIdx.x < 64) {
    const int k = threadIdx.x / 32, m = k == 0 ? m_in : m_out;
    last[k] = m >= 0 && atomicAdd(counters + m, 1) == cross[m].w * (int)gridDim.y - 1;
  }
  __syncthreads();
  for (int k = 0; k < 2; ++k) {
    if (!last[k]) continue;
    __threadfence();
    const int m = k == 0 ? m_in : m_out;
    const int4 c = cross[m];
    const int n = c.w - 1;
    const float* tail = slots + (size_t)c.y * D;
    const float* head = slots + ((size_t)num_tiles + c.z) * D;
    for (int d = threadIdx.x; d < D; d += kThreads) {
      float acc = 0.f;
      int i = 0;
      for (; i + kUnroll <= n; i += kUnroll) {
        float v[kUnroll];
#pragma unroll
        for (int r = 0; r < kUnroll; ++r) v[r] = __ldcg(tail + (size_t)(i + r) * D + d);
#pragma unroll
        for (int r = 0; r < kUnroll; ++r) acc += v[r];
      }
      for (; i < n; ++i) acc += __ldcg(tail + (size_t)i * D + d);
      out[(size_t)c.x * D + d] = acc + __ldcg(head + d);
    }
    if (threadIdx.x == 0) counters[m] = 0;
  }
}

// D == 1: kPer items a thread.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads) segsum_rows_kernel(
    const T* __restrict__ data, int E,
    const int32_t* __restrict__ offsets, const int4* __restrict__ tiles, int num_tiles,
    const int4* __restrict__ cross, int* counters, float* slots, float* __restrict__ out)
{
  constexpr int V = kVec ? 16 / (int)sizeof(T) : 1;
  constexpr int kVecs = (kTileItems / V + 2 + kThreads - 1) / kThreads;
  __shared__ int ends[kTileItems];
  __shared__ float vals[kTileItems + 32];
  __shared__ float warp_v[kWarps];
  __shared__ int warp_f[kWarps];
  const int t = blockIdx.x;
  const int4 a4 = tiles[t], b4 = tiles[t + 1];
  const int r0 = a4.x, s0 = a4.y, m_in = a4.z, m_out = a4.w;
  const int nrows = b4.x - r0, nsegs = b4.y - s0;

  // The tile's rows r0 .. r0 + nrows, staged at vals[shift ..], and the
  // ends of its segments: every load is issued before the first store.
  const int base = r0 & ~(V - 1), shift = r0 - base;
  const int nvec = nrows > 0 ? (nrows + shift + V - 1) / V : 0;
  Pack<T, V> v[kVecs];
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const int q = k * kThreads + threadIdx.x, e = base + q * V;
    if (q >= nvec) continue;
    if (kVec && e + V <= E) {
      v[k] = *reinterpret_cast<const Pack<T, V>*>(data + e);
    } else {  // the last vector of the array, or unaligned data
#pragma unroll
      for (int j = 0; j < V; ++j) v[k].x[j] = data[min(e + j, E - 1)];
    }
  }
  int ov[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = j * kThreads + threadIdx.x;
    ov[j] = i < nsegs ? offsets[s0 + 1 + i] : 0;
  }
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const int q = k * kThreads + threadIdx.x;
    if (q >= nvec) continue;
#pragma unroll
    for (int j = 0; j < V; ++j) vals[q * V + j] = to_f32(v[k].x[j]);
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = j * kThreads + threadIdx.x;
    if (i < nsegs) ends[i] = ov[j] - r0;
  }
  __syncthreads();

  // This thread's items, summed in order: its rows are at most kPer, from
  // row a0 on. A segment that ends here after this thread's first marker
  // is complete and goes straight to `out`.
  const int n_items = nrows + nsegs;
  const int i0 = min((int)threadIdx.x * kPer, n_items);
  const int cnt = min(kPer, n_items - i0);
  int b = markers_before(ends, nrows, nsegs, i0);
  const int a0 = i0 - b;
  float x[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) x[j] = vals[min(shift + a0 + j, kTileItems + 31)];
  int next_end = b < nsegs ? ends[b] : INT32_MAX;
  float acc = 0.f, head = 0.f;
  int head_b = -1, used = 0;
  auto close = [&](int a) {  // the markers before row a, within this thread's items
    for (; used < cnt && next_end <= a; ++used) {
      if (head_b < 0) {
        head_b = b;
        head = acc;
      } else {
        out[s0 + b] = acc;
      }
      acc = 0.f;
      ++b;
      next_end = b < nsegs ? ends[b] : INT32_MAX;
    }
  };
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    close(a0 + j);
    if (used < cnt) {
      acc += x[j];
      ++used;
    }
  }
  close(INT32_MAX);

  // Segmented scan of the threads' open sums, in thread order: an inclusive
  // scan over the warp's shuffles, then the warps' totals through shared
  // memory. A thread with a marker starts a new segment.
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float sv = acc;
  int f = head_b >= 0;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float v2 = __shfl_up_sync(kFull, sv, off);
    const int f2 = __shfl_up_sync(kFull, f, off);
    if (lane >= off) {
      if (!f) sv = v2 + sv;
      f |= f2;
    }
  }
  float ev = __shfl_up_sync(kFull, sv, 1);
  int ef = __shfl_up_sync(kFull, f, 1);
  if (lane == 0) ev = 0.f, ef = 0;
  if (lane == 31) warp_v[warp] = sv, warp_f[warp] = f;
  __syncthreads();
  float pv = 0.f;
  for (int w = 0; w < warp; ++w) pv = warp_f[w] ? warp_v[w] : pv + warp_v[w];
  const float carry = ef ? ev : pv + ev;  // this segment's sum before this thread
  if (head_b >= 0) {
    const float total = carry + head;
    if (head_b == 0 && m_in >= 0) {
      slots[num_tiles + t] = total;
      arrive_one(m_in, cross, counters, slots, num_tiles, out);
    } else {
      out[s0 + head_b] = total;
    }
  }
  if (threadIdx.x == kThreads - 1 && m_out >= 0) {
    slots[t] = f ? sv : pv + sv;
    arrive_one(m_out, cross, counters, slots, num_tiles, out);
  }
}

// D > 1: blockIdx.y picks 256 columns; lane l holds columns d0 + 32 c.
template <typename T>
__global__ void __launch_bounds__(kThreads) segsum_cols_kernel(
    const T* __restrict__ data, int D,
    const int32_t* __restrict__ offsets, const int4* __restrict__ tiles, int num_tiles,
    const int4* __restrict__ cross, int* counters, float* slots, float* __restrict__ out)
{
  __shared__ int ends[kTileItems];
  __shared__ float heads[kWarps * kTileCols];  // each warp's head and tail sums
  __shared__ float tails[kWarps * kTileCols];
  __shared__ int warp_head[kWarps];
  __shared__ int last[2];
  // tiles[t] = {first row, first segment, crossing segment that ends in t
  // or -1, crossing segment open at t's end or -1}.
  const int t = blockIdx.x;
  const int4 a4 = tiles[t], b4 = tiles[t + 1];
  const int r0 = a4.x, s0 = a4.y, m_in = a4.z, m_out = a4.w;
  const int nrows = b4.x - r0, nsegs = b4.y - s0;
  for (int i = threadIdx.x; i < nsegs; i += kThreads) ends[i] = offsets[s0 + 1 + i] - r0;
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col0 = blockIdx.y * kTileCols;
  const int d0 = col0 + lane;
  const int n_items = nrows + nsegs;
  const int per = kTileItems / kWarps;
  const int i0 = min(warp * per, n_items), i1 = min(i0 + per, n_items);
  int b = markers_before(ends, nrows, nsegs, i0);
  const int b1 = markers_before(ends, nrows, nsegs, i1);
  const int a0 = i0 - b, a1 = i1 - b1;
  float acc[kColsPerLane] = {}, head[kColsPerLane] = {};
  int head_b = -1;
  // Close every segment that ends at or before tile-relative row `a`.
  auto close = [&](int a) {
    for (; b < b1 && ends[b] <= a; ++b) {
      if (head_b < 0) {
        head_b = b;
#pragma unroll
        for (int c = 0; c < kColsPerLane; ++c) head[c] = acc[c];
      } else {
        float* dst = out + (size_t)(s0 + b) * D;
#pragma unroll
        for (int c = 0; c < kColsPerLane; ++c)
          if (d0 + 32 * c < D) dst[d0 + 32 * c] = acc[c];
      }
#pragma unroll
      for (int c = 0; c < kColsPerLane; ++c) acc[c] = 0.f;
    }
  };
  // Rows and columns past the end are clamped, not masked, so the loads
  // carry no predicate and all issue before the first use; what they bring
  // past the end is never added (rows) or stored (columns).
  for (int a = a0; a < a1; a += kUnroll) {
    T v[kUnroll][kColsPerLane];
#pragma unroll
    for (int r = 0; r < kUnroll; ++r) {
      const T* row = data + (size_t)(r0 + min(a + r, a1 - 1)) * D;
#pragma unroll
      for (int c = 0; c < kColsPerLane; ++c) v[r][c] = row[min(d0 + 32 * c, D - 1)];
    }
#pragma unroll
    for (int r = 0; r < kUnroll; ++r) {
      if (a + r >= a1) break;
      close(a + r);
#pragma unroll
      for (int c = 0; c < kColsPerLane; ++c) acc[c] += to_f32(v[r][c]);
    }
  }
  close(INT32_MAX);
#pragma unroll
  for (int c = 0; c < kColsPerLane; ++c) {
    heads[warp * kTileCols + 32 * c + lane] = head[c];
    tails[warp * kTileCols + 32 * c + lane] = acc[c];
  }
  if (lane == 0) warp_head[warp] = head_b;
  __syncthreads();

  // Join the warps in order, one thread per column.
  const int d = col0 + threadIdx.x;
  if (d < D) {
    float carry = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const int hb = warp_head[w];
      const float tail = tails[w * kTileCols + threadIdx.x];
      if (hb >= 0) {
        const float total = carry + heads[w * kTileCols + threadIdx.x];
        if (hb == 0 && m_in >= 0) slots[((size_t)num_tiles + t) * D + d] = total;
        else out[(size_t)(s0 + hb) * D + d] = total;
        carry = tail;
      } else {
        carry = carry + tail;
      }
    }
    if (m_out >= 0) slots[(size_t)t * D + d] = carry;
  }
  if (m_in >= 0 || m_out >= 0)
    arrive_block(m_in, m_out, cross, counters, slots, num_tiles, D, out, last);
}

template <typename T>
int launch(const void* data, int E, int D, const int32_t* offsets, const int4* tiles,
           int num_tiles, const int4* cross, int* counters, float* slots, float* out,
           cudaStream_t st)
{
  if (D == 1) {
    const T* x = (const T*)data;
    if (((uintptr_t)data & 15) == 0)
      segsum_rows_kernel<T, true><<<num_tiles, kThreads, 0, st>>>(
          x, E, offsets, tiles, num_tiles, cross, counters, slots, out);
    else
      segsum_rows_kernel<T, false><<<num_tiles, kThreads, 0, st>>>(
          x, E, offsets, tiles, num_tiles, cross, counters, slots, out);
  } else {
    const dim3 grid(num_tiles, (D + kTileCols - 1) / kTileCols);
    segsum_cols_kernel<T><<<grid, kThreads, 0, st>>>(
        (const T*)data, D, offsets, tiles, num_tiles, cross, counters, slots, out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// One launch on `stream`. dtype: 0 = float32, 1 = float16. tiles: (T + 1)
// int4 of a plan of kTileItems-item tiles; cross: (M,) int4; counters: (M,)
// int32, all 0 between calls; slots: (2, T, D) floats. Returns
// cudaGetLastError() (0 on success).
extern "C" int segment_sum_launch(
    const void* data, int dtype, int E, int D,
    const int32_t* offsets, const int32_t* tiles, int num_tiles,
    const int32_t* cross, int32_t* counters, float* slots, float* out, void* stream)
{
  if (D <= 0 || E < 0 || num_tiles <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int4* t4 = (const int4*)tiles;
  const int4* c4 = (const int4*)cross;
  if (dtype == 0)
    return launch<float>(data, E, D, offsets, t4, num_tiles, c4, counters, slots, out, st);
  if (dtype == 1)
    return launch<__half>(data, E, D, offsets, t4, num_tiles, c4, counters, slots, out, st);
  return (int)cudaErrorInvalidValue;
}
