// Causal / non-causal GQA flash attention (forward) on Hopper.
//
// Replaces the TPU kernel `flash_attention_pallas` + `_kernel` of the JAX
// package (src/repro/kernels/flash_attention.py), which walks a grid
// (B, Hq, Tq/128, Tk/128) with the KV axis innermost, so fp32 accumulators in
// VMEM scratch carry the online softmax from one KV block to the next.
//
// What it computes, per batch b and query head h (KV head h / (Hq / Hkv)):
//   out[r] = softmax_c(scale * q[r] . k[c], masked) @ v
// with fp32 running max, sum and accumulator, and the output in q's dtype.
// Causality is aligned to the end of KV: query row r sits at absolute
// position Tk - Tq + r and sees the columns c <= that position; columns at
// or past Tk are masked in the kernel (no padding in the wrapper). Masked
// scores are -1e30, not -inf, as in the JAX kernel, so exp(m_prev - m_new)
// never meets inf - inf; the final divide is by max(l, 1e-30).
//
// Bound: at the serving shape (B = 4, Hq = 24, Hkv = 8, T = 2048, Dh = 128,
// bf16, causal) it reads 33.6 MB and writes 50.3 MB — 0.025 ms at 3.35 TB/s —
// and does 1.03e11 causal operations, 0.104 ms on the tensor cores at the
// bf16 peak (989 TFLOP/s): operations bound it, so the tensor cores must do
// the products.
//
// Design. Blocks run in no order, so the sequential KV grid axis of the TPU
// kernel becomes a loop inside the block: one block per (q tile of 64 rows,
// query head, batch), which stages its q tile and each 64-row K and V tile
// in shared memory (the ragged Tq / Tk edges filled with zeros) and skips
// the KV tiles that lie wholly above the diagonal. The q tiles are taken
// last-first, so the long causal rows start first. Two bodies:
//
//  * fp16 / bf16 (the serving path): tensor cores through mma.sync
//    m16n8k16 with fp32 accumulation. Four warps, 16 query rows each; a
//    warp keeps its q rows as A fragments in registers, computes its
//    16 x 64 score tile against K (B fragments read straight from the
//    row-major tile), runs the online softmax on the accumulator fragments
//    in log2 units (one exp2 per probability; row max and sum over the 4
//    lanes of a row with shuffles; the mask only on tiles that cross the
//    diagonal or Tk), packs the probabilities into the A fragments of
//    P @ V in registers, rounded to the input type as flash attention does,
//    and reads V's B fragments with ldmatrix.trans. K and V tiles are
//    double-buffered: cp.async fetches tile t + 1 while tile t is used.
//    Row strides are padded by 8 elements so the fragment reads hit
//    distinct banks. wgmma, TMA and warp specialisation are the next steps.
//  * fp32: 256 threads, each owning 4 rows x 4 score columns and
//    4 x Dh/16 accumulators, fp32 FMA from shared memory (rows padded by one
//    float) — exact fp32 products, at the fp32 FMA rate.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // key / value rows per tile
constexpr int kThreads = 256;  // a 16 x 16 grid
constexpr int kRows = kBQ / 16;  // rows per thread
constexpr int kCols = kBK / 16;  // score columns per thread
constexpr int kPLd = kBK + 1;    // row stride of the probability tile
constexpr float kNegInf = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  // Element strides of (batch, head, row); the last axis is contiguous.
  long long q_sb, q_sh, q_st;
  long long k_sb, k_sh, k_st;
  long long v_sb, v_sh, v_st;
  long long o_sb, o_sh, o_st;
  int group, tq, tk;
  float scale;
  int causal;
};

template <int DH>
constexpr int smem_floats() {
  return 2 * kBQ * (DH + 1) + kBK * DH + kBQ * kPLd;
}

// ---------------------------------------------------------------------------
// fp32: FMA from shared memory
// ---------------------------------------------------------------------------

// Copies a 64 x DH tile starting at row r0 of a (T, DH) slab into shared
// memory with row stride ld, times mul; rows at or past T are zeros.
template <int DH>
__device__ __forceinline__ void stage_tile(
    const float* __restrict__ src, long long st, int r0, int T_, float mul,
    float* __restrict__ dst, int ld)
{
  for (int e = threadIdx.x; e < kBK * DH; e += kThreads) {
    const int r = e / DH;
    const int c = e - r * DH;
    const int row = r0 + r;
    dst[r * ld + c] = row < T_ ? src[(long long)row * st + c] * mul : 0.f;
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads) flash_fp32_kernel(const Args a)
{
  static_assert(kBQ == kBK, "stage_tile assumes square tiles");
  constexpr int LD = DH + 1;
  constexpr int NC = DH / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;             // kBQ x LD
  float* ks = qs + kBQ * LD;    // kBK x LD
  float* vs = ks + kBK * LD;    // kBK x DH
  float* ps = vs + kBK * DH;    // kBQ x kPLd

  const int iq = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / a.group;
  const int q0 = iq * kBQ;
  const int offset = a.tk - a.tq;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;

  const float* q = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* k = static_cast<const float*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const float* v = static_cast<const float*>(a.v) + b * a.v_sb + hk * a.v_sh;
  float* o = static_cast<float*>(a.o) + b * a.o_sb + h * a.o_sh;

  stage_tile<DH>(q, a.q_st, q0, a.tq, a.scale, qs, LD);

  int n_tiles = (a.tk + kBK - 1) / kBK;
  if (a.causal) {
    const int last_row = offset + min(q0 + kBQ, a.tq) - 1;  // >= 0: Tq <= Tk
    n_tiles = min(n_tiles, last_row / kBK + 1);
  }

  float m[kRows], l[kRows], acc[kRows][NC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's K, V and P are no longer read
    stage_tile<DH>(k, a.k_st, k0, a.tk, 1.f, ks, LD);
    stage_tile<DH>(v, a.v_st, k0, a.tk, 1.f, vs, DH);
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = qs[(4 * ty + i) * LD + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = q0 + 4 * ty + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool live = col < a.tk && (!a.causal || offset + row >= col);
        if (!live) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        ps[(4 * ty + i) * kPLd + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[kRows], vv[NC];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = ps[(4 * ty + i) * kPLd + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = vs[kk * DH + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= a.tq) continue;
    const float inv_l = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      o[(long long)row * a.o_st + tx + 16 * c] = acc[i][c] * inv_l;
  }
}

// ---------------------------------------------------------------------------
// fp16 / bf16: tensor cores (mma.sync m16n8k16, fp32 accumulation)
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;  // four warps of 16 query rows

template <typename T> struct Mma;

template <> struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ void run(float (&d)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

template <> struct Mma<__half> {
  static __device__ __forceinline__ void run(float (&d)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

__device__ __forceinline__ uint32_t ld32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Four 8 x 8 b16 matrices, transposed: thread t gives the row address of
// matrix t / 8, and r[i] receives its fragment of matrix i.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Starts the copy of a 64 x DH tile from row r0 of a (T, DH) slab into
// shared memory (row stride LD) as 16-byte cp.async transfers; rows at or
// past T are zero-filled (source size 0). Rows must start on 16 bytes (the
// wrapper checks).
template <typename T, int DH>
__device__ __forceinline__ void load_tile_async(
    const T* __restrict__ src, long long st, int r0, int T_, T* __restrict__ dst)
{
  constexpr int LD = DH + 8;
  constexpr int kChunks = DH / 8;  // 16-byte vectors per row
  for (int e = threadIdx.x; e < kBK * kChunks; e += kMmaThreads) {
    const int r = e / kChunks;
    const int c = (e - r * kChunks) * 8;
    const int row = r0 + r;
    const bool in = row < T_;
    const T* g = src + (long long)(in ? row : 0) * st + c;
    const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst + r * LD + c));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(g), "r"(in ? 16 : 0));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits until at most one committed group of this thread is in flight.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

template <int DH>
constexpr int mma_smem_bytes() {
  return 4 * kBK * (DH + 8) * 2;  // K and V, two buffers each
}

template <typename T, int DH>
__global__ void __launch_bounds__(kMmaThreads) flash_mma_kernel(const Args a)
{
  constexpr int LD = DH + 8;     // row stride in elements: 16-byte rows, no bank conflicts
  constexpr int KS = DH / 16;    // k-steps of q k^T
  constexpr int NS = kBK / 8;    // 8-column tiles of the score tile
  constexpr int ND = DH / 8;     // 8-column tiles of the output
  constexpr float kLog2e = 1.4426950408889634f;
  constexpr int kTile = kBK * LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // Buffer i holds K at smem + 2i tiles and V right after it.
  T* const smem = reinterpret_cast<T*>(smem_raw);

  const int iq = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / a.group;
  const int q0 = iq * kBQ;
  const int offset = a.tk - a.tq;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;         // fragment row (and row + 8)
  const int c2 = (lane & 3) * 2;   // fragment column pair
  const int r0 = warp * 16;        // this warp's rows in the tile

  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;
  T* o = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;

  int n_tiles = (a.tk + kBK - 1) / kBK;
  if (a.causal) {
    const int last_row = offset + min(q0 + kBQ, a.tq) - 1;  // >= 0: Tq <= Tk
    n_tiles = min(n_tiles, last_row / kBK + 1);
  }

  // Prologue: the q tile through buffer 1 (free until tile 1 is fetched),
  // then tile 0's K and V into buffer 0, in flight while q goes to registers.
  load_tile_async<T, DH>(q, a.q_st, q0, a.tq, smem + 2 * kTile);
  cp_async_commit();
  load_tile_async<T, DH>(k, a.k_st, 0, a.tk, smem);
  load_tile_async<T, DH>(v, a.v_st, 0, a.tk, smem + kTile);
  cp_async_commit();
  cp_async_wait_one();
  __syncthreads();
  uint32_t qf[KS][4];
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    const T* base = smem + 2 * kTile + (r0 + g) * LD + 16 * s + c2;
    qf[s][0] = ld32(base);
    qf[s][1] = ld32(base + 8 * LD);
    qf[s][2] = ld32(base + 8);
    qf[s][3] = ld32(base + 8 * LD + 8);
  }
  __syncthreads();  // every warp holds its q before buffer 1 is refilled

  // Scores are kept in log2 units, y = q.k * scale * log2(e), so each
  // probability is one exp2.
  const float sl2 = a.scale * kLog2e;
  const int row_a = q0 + r0 + g;  // rows of accumulator elements 0, 1
  const int row_b = row_a + 8;    // rows of elements 2, 3
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};        // this lane's share of the row sums
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    if (t + 1 < n_tiles) {  // fetch the next tile while this one is used
      T* next = smem + 2 * ((t + 1) & 1) * kTile;
      load_tile_async<T, DH>(k, a.k_st, k0 + kBK, a.tk, next);
      load_tile_async<T, DH>(v, a.v_st, k0 + kBK, a.tk, next + kTile);
    }
    cp_async_commit();
    cp_async_wait_one();  // tile t has landed
    __syncthreads();
    const T* ks = smem + 2 * (t & 1) * kTile;
    const T* vs = ks + kTile;

    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int st = 0; st < KS; ++st)
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const T* kb = ks + (8 * j + g) * LD + 16 * st + c2;
        Mma<T>::run(s[j], qf[st], ld32(kb), ld32(kb + 8));
      }

    // Only a tile that reaches past Tk or above this warp's first row's
    // diagonal has masked entries.
    const bool masked = k0 + kBK > a.tk || (a.causal && k0 + kBK - 1 > offset + q0 + r0);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float y = s[j][e] * sl2;
        if (masked) {
          const int row = e < 2 ? row_a : row_b;
          const int col = k0 + 8 * j + c2 + (e & 1);
          if (col >= a.tk || (a.causal && offset + row < col)) y = kNegInf;
        }
        s[j][e] = y;
        mx[e >> 1] = fmaxf(mx[e >> 1], y);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // P as the A fragments of P @ V: k-step kk covers score tiles 2kk, 2kk+1.
    uint32_t pf[kBK / 16][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = exp2f(s[j][e] - m[e >> 1]);
        l[e >> 1] += p[e];
      }
      pf[j / 2][(j & 1) * 2 + 0] = Mma<T>::pack(p[0], p[1]);
      pf[j / 2][(j & 1) * 2 + 1] = Mma<T>::pack(p[2], p[3]);
    }

#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
      for (int jp = 0; jp < ND / 2; ++jp) {
        uint32_t vb[4];
        ldsm_x4_t(vb, vs + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * LD
                          + 16 * jp + (lane >> 4) * 8);
        Mma<T>::run(acc[2 * jp], pf[kk], vb[0], vb[1]);
        Mma<T>::run(acc[2 * jp + 1], pf[kk], vb[2], vb[3]);
      }
    __syncthreads();  // every warp is done with buffer t & 1 before it is refilled
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  const float inv_a = 1.f / fmaxf(l[0], 1e-30f);
  const float inv_b = 1.f / fmaxf(l[1], 1e-30f);
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    const int col = 8 * j + c2;
    if (row_a < a.tq)
      *reinterpret_cast<uint32_t*>(o + (long long)row_a * a.o_st + col) =
          Mma<T>::pack(acc[j][0] * inv_a, acc[j][1] * inv_a);
    if (row_b < a.tq)
      *reinterpret_cast<uint32_t*>(o + (long long)row_b * a.o_st + col) =
          Mma<T>::pack(acc[j][2] * inv_b, acc[j][3] * inv_b);
  }
}

template <typename T, int DH>
int launch_mma(const Args& a, int b, int hq, cudaStream_t st)
{
  constexpr int bytes = mma_smem_bytes<DH>();
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_mma_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const dim3 grid((a.tq + kBQ - 1) / kBQ, hq, b);
  flash_mma_kernel<T, DH><<<grid, kMmaThreads, bytes, st>>>(a);
  return (int)cudaGetLastError();
}

template <int DH>
int launch_fp32(const Args& a, int b, int hq, cudaStream_t st)
{
  constexpr int bytes = smem_floats<DH>() * (int)sizeof(float);
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fp32_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const dim3 grid((a.tq + kBQ - 1) / kBQ, hq, b);
  flash_fp32_kernel<DH><<<grid, kThreads, bytes, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int DH>
int launch(const Args& a, int b, int hq, cudaStream_t st)
{
  if constexpr (sizeof(T) == 2) return launch_mma<T, DH>(a, b, hq, st);
  else return launch_fp32<DH>(a, b, hq, st);
}

template <typename T>
int launch_dh(const Args& a, int b, int hq, int dh, cudaStream_t st)
{
  switch (dh) {
    case 32: return launch<T, 32>(a, b, hq, st);
    case 64: return launch<T, 64>(a, b, hq, st);
    case 96: return launch<T, 96>(a, b, hq, st);
    case 128: return launch<T, 128>(a, b, hq, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 float16, 2 bfloat16. q (B, Hq, Tq, Dh), k and v
// (B, Hkv, Tk, Dh), o (B, Hq, Tq, Dh), each given by its element strides of
// (batch, head, row) with a contiguous last axis. Requires Hq % Hkv == 0,
// 1 <= Tk, 1 <= Tq, and Tq <= Tk when causal. Returns a cudaError_t.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int dtype,
    int b, int hq, int hkv, int tq, int tk, int dh,
    long long q_sb, long long q_sh, long long q_st,
    long long k_sb, long long k_sh, long long k_st,
    long long v_sb, long long v_sh, long long v_st,
    long long o_sb, long long o_sh, long long o_st,
    float scale, int causal, void* stream)
{
  if (b <= 0 || hq <= 0 || hkv <= 0 || hq % hkv != 0 || tq <= 0 || tk <= 0 ||
      (causal && tq > tk) || hq > 65535 || b > 65535)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q; a.k = k; a.v = v; a.o = o;
  a.q_sb = q_sb; a.q_sh = q_sh; a.q_st = q_st;
  a.k_sb = k_sb; a.k_sh = k_sh; a.k_st = k_st;
  a.v_sb = v_sb; a.v_sh = v_sh; a.v_st = v_st;
  a.o_sb = o_sb; a.o_sh = o_sh; a.o_st = o_st;
  a.group = hq / hkv;
  a.tq = tq;
  a.tk = tk;
  a.scale = scale;
  a.causal = causal;
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return launch_dh<float>(a, b, hq, dh, st);
    case 1: return launch_dh<__half>(a, b, hq, dh, st);
    case 2: return launch_dh<__nv_bfloat16>(a, b, hq, dh, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
