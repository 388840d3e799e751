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
//
// Bound: it reads about 2*W*K replica bytes plus 4 int32 per window row and
// writes R*K floats; at the step's shapes (R = 32 of W = 256, K = 32) that is
// ~20 KB, well under a microsecond of HBM time and a few MFLOP, so the launch
// latency bounds it, not bytes or operations.
//
// Design (simple first): one block per scored row. The block stages the
// window's u, v and valid into shared memory and marks which columns match
// the row's endpoints (a 2-bit code per column); then each thread owns
// partitions p and counts matches and replica hits in int32 — exact, as the
// 0/1 matmul is. The epilogue uses __fmul_rn / __fadd_rn / __fdiv_rn, in the
// JAX order, so nothing contracts into an FMA and the result is bit-equal to
// the plain torch version. Tensor cores (wgmma) and a fused gather of the
// replica rows from the (V+1, K) table are for a later change.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;

__global__ void window_score_kernel(
    const int32_t* __restrict__ uv,        // (W, 2)
    const uint8_t* __restrict__ valid,     // (W,)
    const uint8_t* __restrict__ rep_u,     // (W, K) bool
    const uint8_t* __restrict__ rep_v,     // (W, K) bool
    const int32_t* __restrict__ deg_u,     // (W,)
    const int32_t* __restrict__ deg_v,     // (W,)
    const int32_t* __restrict__ max_deg,   // ()
    const float* __restrict__ bal,         // (K,) or null (row op)
    const uint8_t* __restrict__ allowed,   // (K,) or null
    const float* __restrict__ lam,         // () or null
    const int32_t* __restrict__ rows,      // (R,) or null (full op: r -> r)
    int W, int K, int use_cs,
    float* __restrict__ out)               // (R, K)
{
  extern __shared__ unsigned char smem[];
  int32_t* su = reinterpret_cast<int32_t*>(smem);
  int32_t* sv = su + W;
  uint8_t* sval = reinterpret_cast<uint8_t*>(sv + W);
  uint8_t* code = sval + W;

  const int r = blockIdx.x;
  const int i = rows ? rows[r] : r;
  const bool in_range = i >= 0 && i < W;

  for (int j = threadIdx.x; j < W; j += blockDim.x) {
    su[j] = uv[2 * j];
    sv[j] = uv[2 * j + 1];
    sval[j] = valid[j];
  }
  __syncthreads();
  if (!in_range) {
    for (int p = threadIdx.x; p < K; p += blockDim.x) out[(size_t)r * K + p] = __int_as_float(0x7fc00000);
    return;
  }
  const int32_t ui = su[i], vi = sv[i];
  if (use_cs) {
    for (int j = threadIdx.x; j < W; j += blockDim.x) {
      const bool keep = sval[j] && j != i;
      const bool a = keep && (su[j] == ui || su[j] == vi);
      const bool b = keep && (sv[j] == ui || sv[j] == vi);
      code[j] = (uint8_t)(a | (b << 1));
    }
    __syncthreads();
  }

  const int32_t md = *max_deg;
  const float denom = __fmul_rn(2.0f, (float)(md > 1 ? md : 1));
  const float wu = __fsub_rn(2.0f, __fdiv_rn((float)deg_u[i], denom));
  const float wv = __fsub_rn(2.0f, __fdiv_rn((float)deg_v[i], denom));
  const float lam_v = lam ? *lam : 0.0f;
  const bool row_ok = sval[i] != 0;

  for (int p = threadIdx.x; p < K; p += blockDim.x) {
    const float ru = rep_u[(size_t)i * K + p] ? 1.0f : 0.0f;
    const float rv = rep_v[(size_t)i * K + p] ? 1.0f : 0.0f;
    float g = __fadd_rn(__fmul_rn(ru, wu), __fmul_rn(rv, wv));
    if (use_cs) {
      int num = 0, den = 0;
      for (int j = 0; j < W; ++j) {
        const uint8_t c = code[j];
        if (c & 1) { num += rep_v[(size_t)j * K + p] != 0; ++den; }
        if (c & 2) { num += rep_u[(size_t)j * K + p] != 0; ++den; }
      }
      const float d = (float)den;
      g = __fadd_rn(g, __fdiv_rn((float)num, d > 1.0f ? d : 1.0f));
    }
    if (bal) {
      g = __fadd_rn(g, __fmul_rn(lam_v, bal[p]));
      if (!(row_ok && allowed[p])) g = kNegInf;
    }
    out[(size_t)r * K + p] = g;
  }
}

}  // namespace

// Full op when rows == nullptr (n_rows must equal W; bal/allowed/lam set);
// row op otherwise (bal/allowed/lam null). Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int window_score_launch(
    const int32_t* uv, const uint8_t* valid, const uint8_t* rep_u,
    const uint8_t* rep_v, const int32_t* deg_u, const int32_t* deg_v,
    const int32_t* max_deg, const float* bal, const uint8_t* allowed,
    const float* lam, const int32_t* rows, int n_rows, int W, int K,
    int use_cs, float* out, void* stream)
{
  if (n_rows <= 0 || W <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)W * (2 * sizeof(int32_t) + 2);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        window_score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  window_score_kernel<<<n_rows, kThreads, smem, (cudaStream_t)stream>>>(
      uv, valid, rep_u, rep_v, deg_u, deg_v, max_deg, bal, allowed, lam,
      rows, W, K, use_cs, out);
  return (int)cudaGetLastError();
}
