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
// or past Tk are masked in the kernel (no padding in the wrapper), on every
// body and whether or not the call is causal, so a non-causal call takes any
// Tk >= 1 and any Tq >= 1 (an encoder over an odd number of frames, a
// cross-attention from one decoded token); the TPU kernel needs Tk % 128 == 0
// there. Masked scores are -1e30, not -inf, as in the JAX kernel, so
// exp(m_prev - m_new) never meets inf - inf; the final divide is by
// max(l, 1e-30).
//
// Bound: at the serving shape (B = 4, Hq = 24, Hkv = 8, T = 2048, Dh = 128,
// bf16, causal) it reads 33.6 MB and writes 50.3 MB — 0.025 ms at 3.35 TB/s —
// and does 1.03e11 causal operations, 0.104 ms on the tensor cores at the
// bf16 peak (989 TFLOP/s): operations bound it, so the tensor cores must do
// the products, at the rate only wgmma reaches.
//
// Design. Blocks run in no order, so the sequential KV grid axis of the TPU
// kernel becomes a loop inside the block: one block per (q tile, query
// head, batch) walks the KV tiles and skips those wholly above the
// diagonal; the q tiles are taken last-first, so the long causal rows start
// first. Three bodies, one per (type, Dh) — the launcher picks it, and
// kernels/flash_attention.py::body_for names the same choice:
//
//  * "wgmma" — fp16 / bf16 at Dh 64 and 128 (the serving path). 128 query
//    rows per block, 128-row KV tiles, three warpgroups. Warpgroup 0 is
//    the producer: it gives up registers (setmaxnreg 24) and one thread
//    starts TMA loads — the q tile once, then K and V tiles into a ring of
//    2 stages (3 at Dh 64) with a full barrier per tile and an empty
//    barrier per stage. TMA reads the strided (B, T, H, Dh) views through
//    rank-4 tensor maps built on the host per call, swizzles 128 bytes
//    (a 128-column row is two 64-column panels), and zero-fills rows past
//    Tq / Tk. Warpgroups 1 and 2 (setmaxnreg 240) own 64 query rows each:
//    S = Q K^T with wgmma m64n128k16 from shared memory (both operands
//    K-major), the online softmax on the accumulator fragments in log2
//    units (one exp2 per probability; row max and sum over the 4 lanes of a
//    row; the mask only on tiles that cross the diagonal or Tk), P packed to
//    the input type in registers as wgmma's A operand, and O += P V with
//    wgmma m64nDhk16, V read from shared memory as an MN-major operand (the
//    descriptor's transpose bit), so no ldmatrix. A consumer releases a
//    stage only after its P V wgmma has retired.
//  * "mma_sync" — fp16 / bf16 at Dh 32, 96 and 112: mma.sync m16n8k16 with
//    fp32 accumulation (Dh / 16 k-steps of q k^T, Dh / 16 ldmatrix.x4 loads
//    of V per 16 keys), 64-row q tiles on four warps of 16 rows, P in
//    registers, V's fragments through ldmatrix.trans, K / V double-buffered
//    with cp.async in 16-byte chunks (Dh / 8 a row; rows padded by 8
//    elements, so 8 consecutive rows fall on distinct banks at every Dh).
//  * "fma" — fp32: 256 threads, each owning 4 rows x 4 score columns and
//    4 x Dh/16 accumulators, fp32 FMA from shared memory (rows padded by one
//    float) — exact fp32 products, at the fp32 FMA rate.
#include <cuda.h>  // CUtensorMap and its enums; the encoder comes through the runtime
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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
// fp16 / bf16 at Dh 32, 96 and 112 (any multiple of 16 on request): tensor cores through
// mma.sync m16n8k16, fp32 accumulation
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

// ---------------------------------------------------------------------------
// fp16 / bf16 at Dh 64 and 128: wgmma + TMA, warp-specialised
// ---------------------------------------------------------------------------

constexpr int kWgRows = 128;         // query rows per block, KV rows per tile
constexpr int kWgThreads = 384;      // producer warpgroup + two consumers
constexpr int kPanelBytes = 128 * 128;  // 128 rows of one 128-byte panel (64 columns)

template <int DH>
struct WgLayout {  // byte offsets from a 1024-byte aligned base
  static constexpr int kStages = DH == 64 ? 3 : 2;
  static constexpr int kTileBytes = kWgRows * DH * 2;  // DH / 64 panels
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kTileBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBar = kV + kStages * kTileBytes;  // q_full, k_full[S], v_full[S], empty[S]
  static constexpr int kBytes = kBar + 8 * (1 + 3 * kStages) + 1024;  // + alignment slack
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// Spins until the phase of parity `parity` of the barrier has completed. A
// wait that lasts more than ~2 s of SM clock traps, so a broken pipeline
// fails the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n" : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - t0 > 4000000000ll) __trap();
  }
}

// One box of a rank-4 tensor map (Dh, T, H, B) into shared memory at dst;
// the barrier counts the box's bytes.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor for a 128-byte swizzled operand whose
// 8-row groups of 128-byte rows start at `addr` (1024-byte aligned atoms).
// lbo: bytes between 64-column panels (read for MN-major operands only);
// sbo: bytes between 8-row groups.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_wait0() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// Pins register arrays in place around wgmma: the compiler may not move
// their reads or writes across this point (wgmma writes them
// asynchronously, behind the compiler's back).
template <int N>
__device__ __forceinline__ void keep(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N, int M>
__device__ __forceinline__ void keep(uint32_t (&r)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
}

#define WG_F8(d, i) "+f"(d[(i) + 0]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3]), \
                    "+f"(d[(i) + 4]), "+f"(d[(i) + 5]), "+f"(d[(i) + 6]), "+f"(d[(i) + 7])
#define WG_F32(d) WG_F8(d, 0), WG_F8(d, 8), WG_F8(d, 16), WG_F8(d, 24)
#define WG_F64(d) WG_F32(d), WG_F8(d, 32), WG_F8(d, 40), WG_F8(d, 48), WG_F8(d, 56)
#define WG_R32 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
               "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define WG_R64 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
               "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
               "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
               "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d (64 x 128, fp32) += A (64 x 16) B (16 x 128): both operands in shared
// memory, K-major (ss); or A from registers, B MN-major (rs, N = 128 / 64).
#define WG_DEFINE(T, TY)                                                                   \
  template <> struct Wg<T> {                                                               \
    static __device__ __forceinline__ void ss(float (&d)[64], uint64_t da, uint64_t db) {  \
      asm volatile(                                                                        \
          "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                                     \
          "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " WG_R64              \
          ", %64, %65, p, 1, 1, 0, 0;\n}\n"                                                \
          : WG_F64(d) : "l"(da), "l"(db), "r"(1));                                         \
    }                                                                                      \
    static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4],      \
                                              uint64_t db) {                               \
      asm volatile(                                                                        \
          "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                                     \
          "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " WG_R64              \
          ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                                  \
          : WG_F64(d) : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));      \
    }                                                                                      \
    static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4],      \
                                              uint64_t db) {                               \
      asm volatile(                                                                        \
          "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                                     \
          "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " WG_R32               \
          ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                                  \
          : WG_F32(d) : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));      \
    }                                                                                      \
  };

template <typename T> struct Wg;
WG_DEFINE(__nv_bfloat16, "bf16")
WG_DEFINE(__half, "f16")

template <typename T, int DH>
__global__ void __launch_bounds__(kWgThreads, 1) flash_wgmma_kernel(
    const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
    const __grid_constant__ CUtensorMap mv, const Args a)
{
  using L = WgLayout<DH>;
  constexpr int S = L::kStages;
  constexpr int NP = DH / 64;    // 64-column panels per row
  constexpr int KS = DH / 16;    // k-steps of Q K^T
  constexpr int NS = kWgRows / 8;  // 8-column groups of the score tile
  constexpr int ND = DH / 8;     // 8-column groups of the output
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  const uint32_t base = (smem_u32(wg_smem) + 1023u) & ~1023u;
  const uint32_t sQ = base + L::kQ;
  const uint32_t sK = base + L::kK;
  const uint32_t sV = base + L::kV;
  const uint32_t q_full = base + L::kBar;
  const uint32_t k_full = q_full + 8;            // + 8 s
  const uint32_t v_full = k_full + 8 * S;        // + 8 s
  const uint32_t empty = v_full + 8 * S;         // + 8 s

  const int iq = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / a.group;
  const int q0 = iq * kWgRows;
  const int offset = a.tk - a.tq;
  int n_tiles = (a.tk + kWgRows - 1) / kWgRows;
  if (a.causal) {
    const int last_row = offset + min(q0 + kWgRows, a.tq) - 1;  // >= 0: Tq <= Tk
    n_tiles = min(n_tiles, last_row / kWgRows + 1);
  }

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2 * 128);  // every consumer thread releases
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // Producer: one thread keeps the ring full.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, L::kTileBytes);
#pragma unroll
      for (int p = 0; p < NP; ++p) tma_load(sQ + p * kPanelBytes, &mq, q_full, 64 * p, q0, h, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % S;
        if (t >= S) mbar_wait(empty + 8 * s, ((t / S) & 1) ^ 1);  // released last round
        const uint32_t kb = k_full + 8 * s, vb = v_full + 8 * s;
        mbar_expect_tx(kb, L::kTileBytes);
#pragma unroll
        for (int p = 0; p < NP; ++p)
          tma_load(sK + s * L::kTileBytes + p * kPanelBytes, &mk, kb, 64 * p, t * kWgRows, hk, b);
        mbar_expect_tx(vb, L::kTileBytes);
#pragma unroll
        for (int p = 0; p < NP; ++p)
          tma_load(sV + s * L::kTileBytes + p * kPanelBytes, &mv, vb, 64 * p, t * kWgRows, hk, b);
      }
    }
    return;
  }

  // Consumers: warpgroup c owns query rows q0 + 64c .. q0 + 64c + 63.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int c = wg - 1;
  const int tid = threadIdx.x - 128 * wg;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;          // accumulator row (and row + 8)
  const int c2 = (lane & 3) * 2;    // accumulator column pair
  const int r_first = q0 + 64 * c + 16 * warp;  // this warp's first row
  const int row_a = r_first + g;    // rows of accumulator elements 4j, 4j + 1
  const int row_b = row_a + 8;      // rows of elements 4j + 2, 4j + 3
  const float sl2 = a.scale * kLog2e;  // scores in log2 units: one exp2 each
  const uint64_t dq = sw128_desc(sQ + c * 64 * 128, 16, 1024);

  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};          // this lane's share of the row sums
  float o[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;

  mbar_wait(q_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % S;
    const uint32_t ph = (t / S) & 1;
    const int k0 = t * kWgRows;
    const uint64_t dk = sw128_desc(sK + s * L::kTileBytes, 16, 1024);
    const uint64_t dv = sw128_desc(sV + s * L::kTileBytes, kPanelBytes, 1024);

    // S = Q K^T: k-step ks reads 16 columns of Dh, 32 bytes into its panel.
    float sc[NS * 4];
#pragma unroll
    for (int i = 0; i < NS * 4; ++i) sc[i] = 0.f;
    mbar_wait(k_full + 8 * s, ph);
    keep(sc);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const uint32_t off = ((ks / 4) * kPanelBytes + (ks % 4) * 32) >> 4;
      Wg<T>::ss(sc, dq + off, dk + off);
    }
    wg_commit();
    wg_wait0();
    keep(sc);

    // Only a tile that reaches past Tk or above this warp's first row's
    // diagonal has masked entries.
    const bool masked = k0 + kWgRows > a.tk || (a.causal && k0 + kWgRows - 1 > offset + r_first);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float y = sc[4 * j + e] * sl2;
        if (masked) {
          const int row = e < 2 ? row_a : row_b;
          const int col = k0 + 8 * j + c2 + (e & 1);
          if (col >= a.tk || (a.causal && offset + row < col)) y = kNegInf;
        }
        sc[4 * j + e] = y;
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
      o[4 * j + 0] *= alpha[0];
      o[4 * j + 1] *= alpha[0];
      o[4 * j + 2] *= alpha[1];
      o[4 * j + 3] *= alpha[1];
    }

    // P as wgmma's A fragments: k-step kk covers score groups 2kk, 2kk + 1.
    uint32_t pf[kWgRows / 16][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = exp2f(sc[4 * j + e] - m[e >> 1]);
        l[e >> 1] += p[e];
      }
      pf[j / 2][(j & 1) * 2 + 0] = Mma<T>::pack(p[0], p[1]);
      pf[j / 2][(j & 1) * 2 + 1] = Mma<T>::pack(p[2], p[3]);
    }

    // O += P V: k-step kk reads V rows 16kk .. 16kk + 15, two 8-row groups.
    mbar_wait(v_full + 8 * s, ph);
    keep(o);
    keep(pf);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kWgRows / 16; ++kk) Wg<T>::rs(o, pf[kk], dv + ((kk * 2048) >> 4));
    wg_commit();
    wg_wait0();
    keep(o);
    mbar_arrive(empty + 8 * s);  // this stage's K and V are no longer read
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  const float inv_a = 1.f / fmaxf(l[0], 1e-30f);
  const float inv_b = 1.f / fmaxf(l[1], 1e-30f);
  T* out = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    const int col = 8 * j + c2;
    if (row_a < a.tq)
      *reinterpret_cast<uint32_t*>(out + (long long)row_a * a.o_st + col) =
          Mma<T>::pack(o[4 * j + 0] * inv_a, o[4 * j + 1] * inv_a);
    if (row_b < a.tq)
      *reinterpret_cast<uint32_t*>(out + (long long)row_b * a.o_st + col) =
          Mma<T>::pack(o[4 * j + 2] * inv_b, o[4 * j + 3] * inv_b);
  }
}

// cuTensorMapEncodeTiled, reached through the runtime so the library needs
// no -lcuda.
typedef CUresult (*EncodeTiledFn)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
    CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encoder()
{
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (EncodeTiledFn)p;
  }
  return fn;
}

// Codes above every cudaError_t: a failed tensor-map encode, offset by its
// CUresult, and a missing encoder.
constexpr int kErrEncode = 100000;
constexpr int kErrNoEncoder = 200000;

// A rank-4 map over (Dh, T, H, B) with element strides (st_t, st_h, st_b)
// and 64 x 128 boxes (one 128-byte swizzled panel of 128 rows). A dim of
// extent 1 gets a stride of its own (its stride is never used, and TMA
// wants every stride a multiple of 16 bytes).
template <typename T>
int encode_map(CUtensorMap* map, const void* ptr, int dh, int t, int h, int b,
               long long st_t, long long st_h, long long st_b)
{
  EncodeTiledFn enc = encoder();
  if (!enc) return kErrNoEncoder;
  const CUtensorMapDataType ty = std::is_same<T, __half>::value
      ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const cuuint64_t row = (cuuint64_t)dh * 2;
  cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)t, (cuuint64_t)h, (cuuint64_t)b};
  cuuint64_t strides[3];
  strides[0] = t > 1 ? (cuuint64_t)st_t * 2 : row;
  strides[1] = h > 1 ? (cuuint64_t)st_h * 2 : strides[0] * (cuuint64_t)t;
  strides[2] = b > 1 ? (cuuint64_t)st_b * 2 : strides[1] * (cuuint64_t)h;
  cuuint32_t box[4] = {64, (cuuint32_t)kWgRows, 1, 1};
  cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, ty, 4, const_cast<void*>(ptr), dims, strides, box, estr,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode + (int)r;
}

template <typename T, int DH>
int launch_wgmma(const Args& a, int b, int hq, int hkv, cudaStream_t st)
{
  CUtensorMap mq, mk, mv;
  int err = encode_map<T>(&mq, a.q, DH, a.tq, hq, b, a.q_st, a.q_sh, a.q_sb);
  if (!err) err = encode_map<T>(&mk, a.k, DH, a.tk, hkv, b, a.k_st, a.k_sh, a.k_sb);
  if (!err) err = encode_map<T>(&mv, a.v, DH, a.tk, hkv, b, a.v_st, a.v_sh, a.v_sb);
  if (err) return err;
  constexpr int bytes = WgLayout<DH>::kBytes;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_wgmma_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const dim3 grid((a.tq + kWgRows - 1) / kWgRows, hq, b);
  flash_wgmma_kernel<T, DH><<<grid, kWgThreads, bytes, st>>>(mq, mk, mv, a);
  return (int)cudaGetLastError();
}

enum Body { kFma = 0, kMmaSync = 1, kWgmma = 2 };

// The body is fixed by the type and Dh; *body reports the one launched.
template <typename T, int DH>
int launch(const Args& a, int b, int hq, int hkv, cudaStream_t st, int* body)
{
  if constexpr (sizeof(T) == 4) {
    *body = kFma;
    return launch_fp32<DH>(a, b, hq, st);
  } else if constexpr (DH == 64 || DH == 128) {
    *body = kWgmma;
    return launch_wgmma<T, DH>(a, b, hq, hkv, st);
  } else {
    *body = kMmaSync;
    return launch_mma<T, DH>(a, b, hq, st);
  }
}

template <typename T>
int launch_dh(const Args& a, int b, int hq, int hkv, int dh, cudaStream_t st, int* body)
{
  switch (dh) {
    case 32: return launch<T, 32>(a, b, hq, hkv, st, body);
    case 64: return launch<T, 64>(a, b, hq, hkv, st, body);
    case 96: return launch<T, 96>(a, b, hq, hkv, st, body);
    case 112: return launch<T, 112>(a, b, hq, hkv, st, body);
    case 128: return launch<T, 128>(a, b, hq, hkv, st, body);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 float16, 2 bfloat16. The body follows from dtype and
// Dh — fma for float32, wgmma for 16-bit at Dh 64 / 128 (every row and the
// base on 16 bytes), mma_sync for 16-bit at Dh 32 / 96 / 112 — and is written to
// *body (0 fma, 1 mma_sync, 2 wgmma) before the launch. q (B, Hq, Tq, Dh), k and v (B, Hkv, Tk, Dh), o (B, Hq, Tq,
// Dh), each given by its element strides of (batch, head, row) with a
// contiguous last axis. Requires Hq % Hkv == 0, 1 <= Tk, 1 <= Tq, and
// Tq <= Tk when causal. Returns a cudaError_t, or kErrEncode + a CUresult
// when a tensor map cannot be encoded (kErrNoEncoder: no encoder found).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int dtype,
    int b, int hq, int hkv, int tq, int tk, int dh,
    long long q_sb, long long q_sh, long long q_st,
    long long k_sb, long long k_sh, long long k_st,
    long long v_sb, long long v_sh, long long v_st,
    long long o_sb, long long o_sh, long long o_st,
    float scale, int causal, void* stream, int* body)
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
    case 0: return launch_dh<float>(a, b, hq, hkv, dh, st, body);
    case 1: return launch_dh<__half>(a, b, hq, hkv, dh, st, body);
    case 2: return launch_dh<__nv_bfloat16>(a, b, hq, hkv, dh, st, body);
    default: return (int)cudaErrorInvalidValue;
  }
}
