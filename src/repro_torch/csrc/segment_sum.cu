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
// triangle round (D = 256) ~0.23 ms.
//
// Design: a sorted-run reduction with no atomics, in two passes over a host
// layout built once per graph (kernels/segment_sum.py, segment_layout). The
// layout cuts every segment's contiguous run into chunks of at most
// CHUNK_ROWS rows (an empty segment gets one empty chunk), so a hub vertex
// is spread over many warps instead of being walked by one.
//   pass 1: one warp per (chunk, tile of 256 columns). D == 1: the lanes
//           stride over the chunk's rows, then a fixed butterfly shuffle
//           reduces the 32 lanes. D > 1: the lanes cover the tile's
//           columns, 8 per lane in registers, and walk the rows in order,
//           four rows' loads in flight at a time, so each row is read once,
//           coalesced. A segment with one chunk is written to `out`
//           directly; the chunks of a longer segment go to consecutive rows
//           of `partial`.
//   pass 2: one block of 32 warps per (split segment, column tile). Warp w
//           adds partial rows w, w + 32, ... in order (D == 1: every thread
//           one row in turn, then the shuffle); the block then adds the 32
//           warps' sums in warp order through shared memory and writes
//           `out`. The hub's 1,159 partial rows at the full brain_like
//           layout are 37 rows a warp.
// Accumulation is fp32 for f32 and f16 input. The order of every add
// depends only on the layout, so the same input gives the same output bits
// on every run.
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr int kColsPerLane = 8;
constexpr int kTileCols = 32 * kColsPerLane;
constexpr int kWarps2 = 32;  // warps per block of pass 2
constexpr int kUnroll = 4;   // rows whose loads are issued together

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

__device__ __forceinline__ float warp_sum(float acc) {
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  return acc;
}

// acc[c] += src[e, d0 + 32 c] for rows e = lo, lo + step, ... < hi, in that
// order; columns at or past D are left alone.
template <typename T>
__device__ __forceinline__ void add_rows(
    const T* __restrict__ src, int lo, int hi, int step, int D, int d0,
    float (&acc)[kColsPerLane])
{
  int e = lo;
  for (; e + (kUnroll - 1) * step < hi; e += kUnroll * step) {
    float v[kUnroll][kColsPerLane];
#pragma unroll
    for (int r = 0; r < kUnroll; ++r) {
      const T* row = src + (size_t)(e + r * step) * D;
#pragma unroll
      for (int c = 0; c < kColsPerLane; ++c) {
        const int d = d0 + c * 32;
        v[r][c] = d < D ? to_f32(row[d]) : 0.f;
      }
    }
#pragma unroll
    for (int r = 0; r < kUnroll; ++r) {
#pragma unroll
      for (int c = 0; c < kColsPerLane; ++c) acc[c] += v[r][c];
    }
  }
  for (; e < hi; e += step) {
    const T* row = src + (size_t)e * D;
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c) {
      const int d = d0 + c * 32;
      if (d < D) acc[c] += to_f32(row[d]);
    }
  }
}

template <typename T>
__global__ void chunk_sum_kernel(
    const T* __restrict__ data,             // (E, D), rows sorted by segment
    const int32_t* __restrict__ chunk_row,  // (C + 1,) row bounds per chunk
    const int32_t* __restrict__ chunk_out,  // (C,) out row, or -(partial row + 1)
    int C, int D,
    float* __restrict__ partial,            // (P, D)
    float* __restrict__ out)                // (S, D)
{
  const int c = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (c >= C) return;
  const int lane = threadIdx.x & 31;
  const int o = chunk_out[c];
  float* dst = o >= 0 ? out + (size_t)o * D : partial + (size_t)(-o - 1) * D;
  const int lo = chunk_row[c], hi = chunk_row[c + 1];
  if (D == 1) {
    float acc = 0.f;
    for (int e = lo + lane; e < hi; e += 32) acc += to_f32(data[e]);
    acc = warp_sum(acc);
    if (lane == 0) *dst = acc;
    return;
  }
  const int d0 = blockIdx.y * kTileCols + lane;
  float acc[kColsPerLane] = {};
  add_rows(data, lo, hi, 1, D, d0, acc);
#pragma unroll
  for (int k = 0; k < kColsPerLane; ++k) {
    const int d = d0 + k * 32;
    if (d < D) dst[d] = acc[k];
  }
}

__global__ void partial_sum_kernel(
    const float* __restrict__ partial,      // (P, D)
    const int32_t* __restrict__ multi_seg,  // (M,) segments split into chunks
    const int32_t* __restrict__ multi_ptr,  // (M + 1,) their partial rows
    int D,
    float* __restrict__ out)                // (S, D)
{
  __shared__ float red[kWarps2][kTileCols];
  const int m = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int lo = multi_ptr[m], hi = multi_ptr[m + 1];
  float* dst = out + (size_t)multi_seg[m] * D;
  if (D == 1) {
    float acc = 0.f;
    for (int p = lo + threadIdx.x; p < hi; p += kWarps2 * 32) acc += partial[p];
    acc = warp_sum(acc);
    if (lane == 0) red[warp][0] = acc;
    __syncthreads();
    if (threadIdx.x == 0) {
      float s = 0.f;
      for (int w = 0; w < kWarps2; ++w) s += red[w][0];
      *dst = s;
    }
    return;
  }
  const int d0 = blockIdx.y * kTileCols + lane;
  float acc[kColsPerLane] = {};
  add_rows(partial, lo + warp, hi, kWarps2, D, d0, acc);
#pragma unroll
  for (int k = 0; k < kColsPerLane; ++k) red[warp][k * 32 + lane] = acc[k];
  __syncthreads();
  for (int col = threadIdx.x; col < kTileCols; col += kWarps2 * 32) {
    const int d = blockIdx.y * kTileCols + col;
    if (d >= D) continue;
    float s = 0.f;
    for (int w = 0; w < kWarps2; ++w) s += red[w][col];
    dst[d] = s;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = float16. `partial` holds multi_ptr[M] rows of D
// floats (unused when M == 0). Launches both passes on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int segment_sum_launch(
    const void* data, int dtype, int D,
    const int32_t* chunk_row, const int32_t* chunk_out, int C,
    const int32_t* multi_seg, const int32_t* multi_ptr, int M,
    float* partial, float* out, void* stream)
{
  if (C <= 0 || D <= 0 || M < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned tiles = D == 1 ? 1u : (unsigned)((D + kTileCols - 1) / kTileCols);
  const dim3 grid1((C + kWarpsPerBlock - 1) / kWarpsPerBlock, tiles);
  if (dtype == 0) {
    chunk_sum_kernel<float><<<grid1, kThreads, 0, st>>>(
        (const float*)data, chunk_row, chunk_out, C, D, partial, out);
  } else if (dtype == 1) {
    chunk_sum_kernel<__half><<<grid1, kThreads, 0, st>>>(
        (const __half*)data, chunk_row, chunk_out, C, D, partial, out);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (M > 0) {
    partial_sum_kernel<<<dim3(M, tiles), kWarps2 * 32, 0, st>>>(
        partial, multi_seg, multi_ptr, D, out);
  }
  return (int)cudaGetLastError();
}
