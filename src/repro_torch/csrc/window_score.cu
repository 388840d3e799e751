// ADWISE window scoring on Hopper: g(e,p) = lambda*B(p) + R(e,p) + CS(e,p).
//
// Replaces the TPU kernel `window_score_pallas` + `_kernel` of the JAX
// package (src/repro/kernels/window_score.py), which phrases the clustering
// term as two (128, W) x (W, K) MXU matmuls over W and K padded to 128.
//
// What it computes, for window row i and partition p:
//   psi_x = deg_x / (2 * max(max_deg, 1))
//   R     = rep_u[i,p] * (2 - psi_u) + rep_v[i,p] * (2 - psi_v)
//   CS    = (sum_j A[i,j] rep_v[j,p] + B[i,j] rep_u[j,p]) / max(|A_i| + |B_i|, 1)
//           A[i,j] = u_j in {u_i, v_i},  B[i,j] = v_j in {u_i, v_i},
//           over valid columns j != i
//   full op: g = R + CS + lambda * bal[p], -1e30 where !valid[i] || !allowed[p]
//   row op : R + CS for the selected slots rows[r] (no lambda*B, no mask) —
//            what the ADWISE step rescores under lazy traversal.
// The full op reads rep_u / rep_v / deg_u / deg_v as (W, K) / (W,) rows of
// the window's slots. The row op reads the step's vertex tables instead —
// replicas (V+1, K) and deg (V+1,) — at the window's vertex ids, so the
// step gathers nothing before the call: rep_u[j] is replicas[u_j].
//
// The row op scores a batch of z independent instances (spotlight's
// partitioner instances) in one launch: every input gains a leading
// instance axis — uv (z, W, 2), valid (z, W), replicas (z, V+1, K), deg
// (z, V+1), max_deg (z,), rows (z, R) — and out is (z, R, K). blockIdx.y
// is the instance; a block offsets every pointer by its instance's stride
// and then runs the single-instance body unchanged, so each instance's rows
// are bit-equal to a launch over that instance alone. One instance is the
// z = 1 case of the same launch; the full op is always z = 1.
//
// Bound: at the step's shapes (R = 32 rows of W = 256, K = 32) the function
// needs ~20 KB (the window's ids, the selected and matched replica rows of
// the 1.3 MB table, the output) and a few hundred thousand operations: well
// under a microsecond of HBM time. What bounds it is the launch latency
// plus one chain of dependent reads — the window's ids, then the replica
// rows of the matched columns (L2-resident), then the epilogue.
//
// Design. One block per scored row and instance, one thread per window
// column (W <= 1024 in one pass; longer windows loop). Each thread
// computes its column's 2-bit match code; __ballot_sync gives each warp the
// matched columns of its 32, and the warp walks only those set bits: lane p (32 partitions per
// pass; more loop) reads replicas[v_j][p] / replicas[u_j][p] — one
// coalesced 32-byte row segment per matched column — four columns at a time
// so the loads are independent. Counts are int32 and the warps' partials
// meet in shared memory through integer atomics: exact in any order, as the
// 0/1 matmul is. The epilogue uses __fmul_rn / __fadd_rn / __fdiv_rn in the
// JAX order, so nothing contracts into an FMA and the result is bit-equal
// to the plain torch version. A vertex id outside the table, or a row
// outside the window, yields a NaN row (the plain version raises there).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxThreads = 1024;

// Sum over the set bits b of `m` of tab[id_b * K + p], where id_b is the
// table row held by lane b; four bits per round, so four loads are in
// flight at once. Every lane of the warp runs it (the shuffles need all).
__device__ __forceinline__ int walk(unsigned m, int id, const uint8_t* __restrict__ tab,
                                    int K, int p, bool p_ok)
{
  int acc = 0;
  while (m) {
    int bit[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      bit[q] = m ? __ffs(m) - 1 : -1;
      m &= m - 1;  // 0 stays 0
    }
    uint8_t x[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int row = __shfl_sync(kFull, id, bit[q] < 0 ? 0 : bit[q]);
      x[q] = (bit[q] >= 0 && p_ok) ? tab[(size_t)row * K + p] : (uint8_t)0;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) acc += x[q] != 0;
  }
  return acc;
}

__global__ void window_score_kernel(
    const int32_t* __restrict__ uv,        // (W, 2)
    const uint8_t* __restrict__ valid,     // (W,)
    const uint8_t* __restrict__ rep_u,     // full op: (W, K); row op: (n_tab, K) table
    const uint8_t* __restrict__ rep_v,     // full op: (W, K); row op: the same table
    const int32_t* __restrict__ deg_u,     // full op: (W,); row op: (n_tab,) table
    const int32_t* __restrict__ deg_v,     // full op: (W,); row op: the same table
    const int32_t* __restrict__ max_deg,   // ()
    const float* __restrict__ bal,         // (K,) or null (row op)
    const uint8_t* __restrict__ allowed,   // (K,) or null
    const float* __restrict__ lam,         // () or null
    const void* __restrict__ rows,         // (R,) int32 / int64, or null (full op: r -> r)
    int rows_64, int n_rows, int n_tab, int W, int K, int use_cs,
    float* __restrict__ out)               // (R, K)
{
  extern __shared__ int snum[];  // (K,) clustering numerators
  __shared__ int s_den;
  __shared__ int s_bad;

  // This block's instance: every pointer moves to its slice.
  const size_t inst = blockIdx.y;
  uv += inst * W * 2;
  valid += inst * W;
  rep_u += inst * n_tab * K;
  rep_v += inst * n_tab * K;
  deg_u += inst * n_tab;
  deg_v += inst * n_tab;
  max_deg += inst;
  out += inst * n_rows * K;

  const int r = blockIdx.x;
  const long long i_raw = !rows ? r
      : rows_64 ? static_cast<const int64_t*>(rows)[inst * n_rows + r]
                : (long long)static_cast<const int32_t*>(rows)[inst * n_rows + r];
  const int lane = threadIdx.x & 31;
  if (i_raw < 0 || i_raw >= W) {
    for (int p = threadIdx.x; p < K; p += blockDim.x)
      out[(size_t)r * K + p] = __int_as_float(0x7fc00000);
    return;
  }
  const int i = (int)i_raw;
  const bool by_vertex = rows != nullptr;  // row op: the tables are indexed by vertex id
  const int32_t ui = uv[2 * i], vi = uv[2 * i + 1];
  // Table rows of the scored edge's endpoints.
  const int tu = by_vertex ? ui : i;
  const int tv = by_vertex ? vi : i;

  for (int p = threadIdx.x; p < K; p += blockDim.x) snum[p] = 0;
  if (threadIdx.x == 0) {
    s_den = 0;
    s_bad = tu < 0 || tu >= n_tab || tv < 0 || tv >= n_tab;
  }
  __syncthreads();

  if (use_cs) {
    int den = 0;
    for (int j0 = 0; j0 < W; j0 += blockDim.x) {
      const int j = j0 + threadIdx.x;
      int32_t uj = 0, vj = 0;
      bool a = false, b = false;
      if (j < W) {
        uj = uv[2 * j];
        vj = uv[2 * j + 1];
        const bool keep = valid[j] && j != i;
        a = keep && (uj == ui || uj == vi);
        b = keep && (vj == ui || vj == vi);
      }
      // a: this column adds rep_v[j] (replicas of v_j); b: rep_u[j].
      const int id_v = by_vertex ? vj : j;
      const int id_u = by_vertex ? uj : j;
      if ((a && (id_v < 0 || id_v >= n_tab)) || (b && (id_u < 0 || id_u >= n_tab))) s_bad = 1;
      const unsigned ma = __ballot_sync(kFull, a);
      const unsigned mb = __ballot_sync(kFull, b);
      if (!(ma | mb)) continue;  // warp-uniform
      den += __popc(ma) + __popc(mb);
      const int sa = (a && id_v >= 0 && id_v < n_tab) ? id_v : 0;
      const int sb = (b && id_u >= 0 && id_u < n_tab) ? id_u : 0;
      for (int p0 = 0; p0 < K; p0 += 32) {
        const int p = p0 + lane;
        const bool p_ok = p < K;
        const int acc = walk(ma, sa, rep_v, K, p, p_ok) + walk(mb, sb, rep_u, K, p, p_ok);
        if (p_ok && acc) atomicAdd(&snum[p], acc);
      }
    }
    if (lane == 0 && den) atomicAdd(&s_den, den);
    __syncthreads();
  }

  if (s_bad) {
    for (int p = threadIdx.x; p < K; p += blockDim.x)
      out[(size_t)r * K + p] = __int_as_float(0x7fc00000);
    return;
  }
  const int32_t md = *max_deg;
  const float denom = __fmul_rn(2.0f, (float)(md > 1 ? md : 1));
  const float wu = __fsub_rn(2.0f, __fdiv_rn((float)deg_u[tu], denom));
  const float wv = __fsub_rn(2.0f, __fdiv_rn((float)deg_v[tv], denom));
  const float lam_v = lam ? *lam : 0.0f;
  const bool row_ok = valid[i] != 0;
  const float d = (float)s_den;
  const float cs_den = d > 1.0f ? d : 1.0f;

  for (int p = threadIdx.x; p < K; p += blockDim.x) {
    const float ru = rep_u[(size_t)tu * K + p] ? 1.0f : 0.0f;
    const float rv = rep_v[(size_t)tv * K + p] ? 1.0f : 0.0f;
    float g = __fadd_rn(__fmul_rn(ru, wu), __fmul_rn(rv, wv));
    if (use_cs) g = __fadd_rn(g, __fdiv_rn((float)snum[p], cs_den));
    if (bal) {
      g = __fadd_rn(g, __fmul_rn(lam_v, bal[p]));
      if (!(row_ok && allowed[p])) g = kNegInf;
    }
    out[(size_t)r * K + p] = g;
  }
}

__global__ void empty_kernel() {}

}  // namespace

// Full op when rows == nullptr (n_inst must be 1; n_rows must equal W;
// bal/allowed/lam set; n_tab = W); row op otherwise (bal/allowed/lam null;
// rep_u == rep_v is the (n_inst, n_tab, K) replica table and deg_u == deg_v
// the (n_inst, n_tab) degree table, read at each instance's window vertex
// ids; rows is (n_inst, n_rows)). rows_64: rows is int64, else int32.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int window_score_launch(
    const int32_t* uv, const uint8_t* valid, const uint8_t* rep_u,
    const uint8_t* rep_v, const int32_t* deg_u, const int32_t* deg_v,
    const int32_t* max_deg, const float* bal, const uint8_t* allowed,
    const float* lam, const void* rows, int rows_64, int n_inst, int n_tab,
    int n_rows, int W, int K, int use_cs, float* out, void* stream)
{
  if (n_rows <= 0 || W <= 0 || K <= 0 || n_tab <= 0 || n_inst <= 0 || n_inst > 65535)
    return (int)cudaErrorInvalidValue;
  if (!rows && n_inst != 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)K * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        window_score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int threads = W >= kMaxThreads ? kMaxThreads : (W + 31) / 32 * 32;
  window_score_kernel<<<dim3(n_rows, n_inst), threads, smem, (cudaStream_t)stream>>>(
      uv, valid, rep_u, rep_v, deg_u, deg_v, max_deg, bal, allowed, lam,
      rows, rows_64, n_rows, n_tab, W, K, use_cs, out);
  return (int)cudaGetLastError();
}

// An empty kernel on the row op's grid (n_blocks x 32 threads): the launch
// floor the row op's time is read against. Returns cudaGetLastError().
extern "C" int window_score_floor_launch(int n_blocks, void* stream)
{
  if (n_blocks <= 0) return (int)cudaErrorInvalidValue;
  empty_kernel<<<n_blocks, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
