// SMPL vertex kernels for Hopper (sm_90a), plain C interface for ctypes.
//
// K2 smpl_verts   replaces humaniflow_tpu/models/pallas_lbs.py
//                 _smpl_verts_kernel (wrapper smpl_verts_fused).
// K1 smpl_moments replaces humaniflow_tpu/models/pallas_lbs.py
//                 _smpl_moments_kernel (wrapper smpl_verts_moments_fused).
// K2's backward   smpl_verts_bwd: the per-vertex part of the adjoints of
//                 smpl_verts_fused's custom VJP (_fused_bwd, _lbs_bwd), which
//                 the JAX package computes with XLA einsums.
//
// Both compute, for each sample row b and vertex v,
//   p[c]   = v_template[c,v] + sum_l shapedirs[l,c,v]*beta[b,l]
//                            + sum_k posedirs[k,c,v]*pose_feature[b,k]
//   T12[q] = sum_j W[v,j] * A12[b,j,q]            (q: R row-major 0..8, t 9..11)
//   out[c] = T12[3c]*p[0] + T12[3c+1]*p[1] + T12[3c+2]*p[2] + T12[9+c]
// K2 writes out as (B, 3, V).  K1 sums out and out^2 over each group's N
// rows inside the block and writes only (G, 2, 3, V).
//
// Bound on an H100: per (row, vertex) 3*(nb+207) + 288 + 12 = 951 FMAs at
// nb=10, so 3200 rows x 6890 vertices are 42 GFLOP, 0.63 ms at the 67 TFLOP/s
// float32 peak outside the tensor cores.  K2 moves ~290 MB (its 265 MB output
// dominates), 0.09 ms at 3.35 TB/s; K1 moves ~30 MB.  Both are bound by
// operations.  The arithmetic stays in float32 FMAs: the TPU kernel needed
// HIGHEST precision, and TF32 or bf16 tensor cores would put ~1 mm of error
// into the vertices.
//
// K2's forward: one thread per vertex, 128 vertices per block, and a row
// group of 16, 8 or 4 sample rows per block chosen per call
// (models/cuda_lbs.py::forward_plan: the largest group whose grid gives each
// SM three blocks).  The rows' A12, betas and pose features are staged in
// shared memory once (read as broadcasts); each basis value a thread loads
// (posedirs is 17 MB and stays in the 50 MB L2) is reused for all the
// group's rows, whose posed vertices stay in registers for the skinning.  At
// 32 and 72 rows the small groups fill the card that one 16-row group per
// 128 vertices left a third busy; at 320 rows and more the 16-row group
// reads the basis ceil(B/16) times, and the kernel is bound by those loads
// and its occupancy, not by its FMAs.  (A register-tiled blend with
// skinning in its epilogue, which reads the basis ceil(B/64) times, measured
// slower at every row count: PERF.md, Findings.)
//
// K1 (bound by operations, like K2's forward: 0.63 ms at (G, N) = (32, 100)
// on an H100 at its float32 peak; it writes only 5 MB).  Its first design
// staged each 16-row pass's posed vertices in shared memory, with a barrier
// per pass, left 12% of its row slots empty at N = 100, held 4 blocks an SM
// at 127 registers, and read the basis ceil(N/16) times per group: 1.67 ms
// on an `NVIDIA H100 80GB HBM3, 700.00 W`.  Now it takes K2's forward's
// structure (smpl_moments_kernel): one thread per vertex, a chunk of rows
// staged once per block, the chunk's posed vertices in registers, skinned
// from them, and six sums per thread in shared memory across the chunks,
// written once.  The chunks are 16 rows, then the remainder as chunks of 8,
// 4, 2 and 1 (moments_chunk), so that no FMA is spent on an empty slot.  A
// pass over the basis costs half as much for 4 rows as for 16 (the kernel
// waits on the basis loads from L2 more than on its FMAs; utils/
// profiling.py --plans times N = 96, 100 and 112), so when 1 <= N % 16 <=
// 4 the last N % 16 rows of four groups share one chunk in a block of their
// own (tail_out, then moments_tail_add): 200 passes over the basis per
// vertex tile at (32, 100) instead of 224.  All sums are taken in a fixed order:
// the same bits on every launch.  Slower alternatives, measured on that
// card (PERF.md, Findings): 8-row chunks; 6 blocks an SM (spills); a
// block of 8 warps sharing 32 vertices with their basis slice streamed
// through shared memory by cp.async; a cp.async ring prefetching each
// thread's own basis values.
//
// K2's backward: one thread per vertex, 128 vertices per block, 16 sample
// rows per pass.  The rows' betas, pose features and A12 are staged in
// shared memory (read as broadcasts); each model value a thread loads from
// global memory is reused for all 16 rows held in registers.  The posed
// vertices then go to shared memory.
//
// K2's backward.  Every adjoint of the vertices follows from two per-vertex
// tensors: dp[b,i,v] = sum_c T12[3c+i] g[b,c,v] (B, 3, V) and
// G12[b,r,v] = [g (x) p, g] (B, 12, V).  smpl_verts_bwd_kernel computes them
// with the forward's staging and blend in registers: it reads the cotangent
// g once, writes dp and G12 once each (only those some adjoint needs), and
// never writes T12 or p.  The reductions over V (dA12 = G12 W, dW, dbeta,
// dpose_feature, ...) are float32 matrix products in models/cuda_lbs.py, as
// the JAX package leaves them to XLA.  Bound: per (row, vertex) 3*(nb+207)
// FMAs for p, 216 for T12's rotation part, 9 for dp; the outputs (60 bytes a
// (row, vertex)) are read again by the products.

#include <cuda_runtime.h>

namespace {

constexpr int kJoints = 24;
constexpr int kA12 = kJoints * 12;
constexpr int kPoseFeat = 207;
constexpr int kMaxBetas = 16;
constexpr int kVT = 128;
constexpr int kRows = 16;

struct __align__(16) Stage {
  float a12[kRows][kA12];
  union __align__(16) {
    struct {
      float beta[kMaxBetas][kRows];
      float pf[kPoseFeat][kRows];
    } in;                        // blend-shape coefficients, [feature][row]
    float p[3][kRows][kVT];      // posed vertices, [channel][row][thread]
  } u;
};

// Copy rows [row0, row0 + nrows) of the per-row inputs into shared memory;
// rows past nrows are zero.
__device__ __forceinline__ void stage_rows(Stage& s, const float* __restrict__ a12,
                                           const float* __restrict__ betas,
                                           const float* __restrict__ pf, int nb,
                                           long long row0, int nrows) {
  for (int i = threadIdx.x; i < kRows * kA12; i += blockDim.x) {
    const int r = i / kA12, q = i - r * kA12;
    s.a12[r][q] = r < nrows ? a12[(row0 + r) * kA12 + q] : 0.f;
  }
  for (int i = threadIdx.x; i < kRows * kMaxBetas; i += blockDim.x) {
    const int r = i / kMaxBetas, l = i - r * kMaxBetas;
    s.u.in.beta[l][r] = (r < nrows && l < nb) ? betas[(row0 + r) * nb + l] : 0.f;
  }
  for (int i = threadIdx.x; i < kRows * kPoseFeat; i += blockDim.x) {
    const int r = i / kPoseFeat, k = i - r * kPoseFeat;
    s.u.in.pf[k][r] = r < nrows ? pf[(row0 + r) * kPoseFeat + k] : 0.f;
  }
}

template <int R>
__device__ __forceinline__ void fma_rows4(float (&p)[3][R], int r0, float4 q, float d0, float d1,
                                          float d2) {
  const float qs[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    p[0][r0 + i] = fmaf(d0, qs[i], p[0][r0 + i]);
    p[1][r0 + i] = fmaf(d1, qs[i], p[1][r0 + i]);
    p[2][r0 + i] = fmaf(d2, qs[i], p[2][r0 + i]);
  }
}

// Blend-shaped vertex v of every staged row into s.u.p[.][.][threadIdx.x].
// Every thread of the block must call it (it synchronises once).
__device__ __forceinline__ void blend_rows(Stage& s, int v, int V, int nb,
                                           const float* __restrict__ vt,
                                           const float* __restrict__ sd,
                                           const float* __restrict__ pd) {
  float p[3][kRows];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float base = __ldg(vt + c * V + v);
#pragma unroll
    for (int r = 0; r < kRows; ++r) p[c][r] = base;
  }
  for (int l = 0; l < nb; ++l) {
    const size_t o = (size_t)l * 3 * V + v;
    const float d0 = __ldg(sd + o), d1 = __ldg(sd + o + V), d2 = __ldg(sd + o + 2 * V);
    const float4* q4 = reinterpret_cast<const float4*>(s.u.in.beta[l]);
#pragma unroll
    for (int r4 = 0; r4 < kRows / 4; ++r4) fma_rows4(p, 4 * r4, q4[r4], d0, d1, d2);
  }
#pragma unroll 3
  for (int k = 0; k < kPoseFeat; ++k) {
    const size_t o = (size_t)k * 3 * V + v;
    const float d0 = __ldg(pd + o), d1 = __ldg(pd + o + V), d2 = __ldg(pd + o + 2 * V);
    const float4* q4 = reinterpret_cast<const float4*>(s.u.in.pf[k]);
#pragma unroll
    for (int r4 = 0; r4 < kRows / 4; ++r4) fma_rows4(p, 4 * r4, q4[r4], d0, d1, d2);
  }
  __syncthreads();  // all reads of s.u.in are done before s.u.p overwrites it
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int r = 0; r < kRows; ++r) s.u.p[c][r][threadIdx.x] = p[c][r];
}

// The skinned vertex of posed vertex (p0, p1, p2) for one row's A12 (in
// shared memory): T12 = sum_j W[v,j] A12[j,:], then out = R p + t.
__device__ __forceinline__ void skin(const float* a12_row, const float (&w)[kJoints], float p0,
                                     float p1, float p2, float (&out)[3]) {
  float t[12];
#pragma unroll
  for (int q = 0; q < 12; ++q) t[q] = 0.f;
#pragma unroll
  for (int j = 0; j < kJoints; ++j) {
    const float4* a = reinterpret_cast<const float4*>(a12_row + j * 12);
    const float4 a0 = a[0], a1 = a[1], a2 = a[2];
    const float av[12] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y,
                          a1.z, a1.w, a2.x, a2.y, a2.z, a2.w};
#pragma unroll
    for (int q = 0; q < 12; ++q) t[q] = fmaf(w[j], av[q], t[q]);
  }
#pragma unroll
  for (int c = 0; c < 3; ++c)
    out[c] = fmaf(t[3 * c], p0, fmaf(t[3 * c + 1], p1, fmaf(t[3 * c + 2], p2, t[9 + c])));
}

__device__ __forceinline__ void load_weights(const float* __restrict__ lbs_w, int v,
                                             float (&w)[kJoints]) {
  const float4* w4 = reinterpret_cast<const float4*>(lbs_w + (size_t)v * kJoints);
#pragma unroll
  for (int i = 0; i < kJoints / 4; ++i) {
    const float4 x = __ldg(w4 + i);
    w[4 * i] = x.x;
    w[4 * i + 1] = x.y;
    w[4 * i + 2] = x.z;
    w[4 * i + 3] = x.w;
  }
}

// K2's forward: the rows' inputs of one row group, staged once.
template <int ROWS>
struct FwdStage {
  float a12[ROWS][kA12];
  float beta[kMaxBetas][ROWS];  // [feature][row]
  float pf[kPoseFeat][ROWS];
};

// Grid (ceil(V/kVT), ceil(B/ROWS)), kVT threads, sizeof(FwdStage<ROWS>) of
// dynamic shared memory; out (B, 3, V).  One thread per vertex: the blend
// of all ROWS rows in registers (each basis value loaded once for ROWS
// rows), then the skinning of each row from the same registers.  MINB
// blocks an SM bound the registers: the 16-row group at the compiler's
// choice (140) kept 3 blocks an SM and left the basis loads' latency
// unhidden; at 5 (96 registers, no spills) it ran 7-17% faster at 320 to
// 3,200 rows (utils/profiling.py --plans on the H100).
template <int ROWS, int MINB>
__global__ void __launch_bounds__(kVT, MINB) smpl_verts_kernel(
    const float* __restrict__ a12, const float* __restrict__ betas,
    const float* __restrict__ pf, const float* __restrict__ vt,
    const float* __restrict__ sd, const float* __restrict__ pd,
    const float* __restrict__ lbs_w, float* __restrict__ out, int B, int V, int nb) {
  extern __shared__ float4 dyn[];
  FwdStage<ROWS>& s = *reinterpret_cast<FwdStage<ROWS>*>(dyn);
  const int v_raw = blockIdx.x * kVT + threadIdx.x;
  const int v = min(v_raw, V - 1);  // threads past V compute a copy, store nothing
  const long long row0 = (long long)blockIdx.y * ROWS;
  const int nrows = min(ROWS, B - (int)row0);
  for (int i = threadIdx.x; i < ROWS * kA12; i += kVT) {
    const int r = i / kA12;
    s.a12[r][i - r * kA12] = r < nrows ? a12[row0 * kA12 + i] : 0.f;
  }
  for (int i = threadIdx.x; i < ROWS * kMaxBetas; i += kVT) {
    const int r = i / kMaxBetas, l = i - r * kMaxBetas;
    s.beta[l][r] = (r < nrows && l < nb) ? betas[(row0 + r) * nb + l] : 0.f;
  }
  for (int i = threadIdx.x; i < ROWS * kPoseFeat; i += kVT) {
    const int r = i / kPoseFeat;
    s.pf[i - r * kPoseFeat][r] = r < nrows ? pf[row0 * kPoseFeat + i] : 0.f;
  }
  __syncthreads();

  float p[3][ROWS];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float base = __ldg(vt + (long long)c * V + v);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) p[c][r] = base;
  }
  for (int l = 0; l < nb; ++l) {
    const size_t o = (size_t)l * 3 * V + v;
    const float d0 = __ldg(sd + o), d1 = __ldg(sd + o + V), d2 = __ldg(sd + o + 2 * V);
    const float4* q4 = reinterpret_cast<const float4*>(s.beta[l]);
#pragma unroll
    for (int r4 = 0; r4 < ROWS / 4; ++r4) fma_rows4(p, 4 * r4, q4[r4], d0, d1, d2);
  }
#pragma unroll 4
  for (int k = 0; k < kPoseFeat; ++k) {
    const size_t o = (size_t)k * 3 * V + v;
    const float d0 = __ldg(pd + o), d1 = __ldg(pd + o + V), d2 = __ldg(pd + o + 2 * V);
    const float4* q4 = reinterpret_cast<const float4*>(s.pf[k]);
#pragma unroll
    for (int r4 = 0; r4 < ROWS / 4; ++r4) fma_rows4(p, 4 * r4, q4[r4], d0, d1, d2);
  }
  if (v_raw >= V) return;
  float w[kJoints];
  load_weights(lbs_w, v, w);
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (r >= nrows) break;
    float o[3];
    skin(s.a12[r], w, p[0][r], p[1][r], p[2][r], o);
#pragma unroll
    for (int c = 0; c < 3; ++c) out[((row0 + r) * 3 + c) * V + v] = o[c];
  }
}

template <int ROWS, int MINB>
int launch_verts(const float* a12, const float* betas, const float* pf, const float* vt,
                 const float* sd, const float* pd, const float* lbs_w, float* out, int B, int V,
                 int nb, cudaStream_t stream) {
  const dim3 grid((V + kVT - 1) / kVT, (B + ROWS - 1) / ROWS);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  const int bytes = (int)sizeof(FwdStage<ROWS>);
  static bool sized = false;  // the attribute is the kernel's, set once per process
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(smpl_verts_kernel<ROWS, MINB>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  smpl_verts_kernel<ROWS, MINB><<<grid, kVT, bytes, stream>>>(a12, betas, pf, vt, sd, pd, lbs_w,
                                                              out, B, V, nb);
  return (int)cudaGetLastError();
}

// ---- K1: per-group moments.  Rows of group g are g*N .. g*N+N-1; out
// (G, 2, 3, V) = (sum x, sum x^2) over each group's rows.

// K1 takes rows in chunks of ROWS, then the remainder in chunks of ROWS/2,
// ROWS/4, ..., 1, each present at most once, so that no FMA is spent on an
// empty row slot.  models/cuda_lbs.py::moments_chunks is the same rule.
// Returns the row count of chunk ci of n rows (0 past the last) and sets its
// first row.
template <int ROWS>
__device__ __forceinline__ int moments_chunk(int n, int ci, int& start) {
  const int full = n / ROWS;
  start = min(ci, full) * ROWS;
  if (ci < full) return ROWS;
  int k = full;
#pragma unroll
  for (int r = ROWS / 2; r >= 1; r >>= 1) {
    if (n & r) {
      if (k == ci) return r;
      start += r;
      ++k;
    }
  }
  return 0;
}

// p[.][0..R) += d * q[0..R), q a row of R features in shared memory.
template <int R, int S>
__device__ __forceinline__ void fma_feature(float (&p)[3][S], const float* q, float d0, float d1,
                                            float d2) {
  if constexpr (R % 4 == 0) {
    const float4* q4 = reinterpret_cast<const float4*>(q);
#pragma unroll
    for (int r4 = 0; r4 < R / 4; ++r4) fma_rows4(p, 4 * r4, q4[r4], d0, d1, d2);
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      p[0][r] = fmaf(d0, q[r], p[0][r]);
      p[1][r] = fmaf(d1, q[r], p[1][r]);
      p[2][r] = fmaf(d2, q[r], p[2][r]);
    }
  }
}

// A block's rows: a group's first `n` rows (tail = 0), or the last `tail`
// rows (1 <= tail <= 4) of each of kTailGroups consecutive groups from g0,
// whose row j belongs to the block's group j / tail.
constexpr int kTailGroups = 4;

struct MomentRows {
  long long g0;
  int N, tail;
  __device__ __forceinline__ long long row(int j) const {
    return tail ? (g0 + j / tail) * N + (N - tail) + j % tail : g0 * N + j;
  }
};

// A chunk's inputs: its rows' blend-shape coefficients for the blend, then
// in the same space their A12 for the skinning (ROWS rows, R <= ROWS used).
template <int ROWS>
struct MomentStage {
  union __align__(16) {
    struct {
      float beta[kMaxBetas][ROWS];  // [feature][row]
      float pf[kPoseFeat][ROWS];
    } in;
    float a12[ROWS][kA12];
  } u;
};

// Rows j0 .. j0 + R - 1 of the block (rows.row) for vertex v: staged in s,
// blended in registers, skinned, and added to the thread's sums in acc (a
// group's block: slot 0, per chunk; a tail block: slot j / tail, per row).
// Every thread of the block calls it.
template <int ROWS, int R>
__device__ __forceinline__ void moments_rows(MomentStage<ROWS>& s, const MomentRows& rows, int j0, int v,
                                             int V, int nb, const float* __restrict__ a12,
                                             const float* __restrict__ betas,
                                             const float* __restrict__ pf,
                                             const float* __restrict__ vt,
                                             const float* __restrict__ sd,
                                             const float* __restrict__ pd,
                                             const float* __restrict__ lbs_w,
                                             float (&acc)[kTailGroups][6][kVT]) {
  __syncthreads();  // the previous chunk is done with s
  for (int i = threadIdx.x; i < R * nb; i += kVT) {
    const int r = i / nb;
    s.u.in.beta[i - r * nb][r] = betas[rows.row(j0 + r) * nb + (i - r * nb)];
  }
  for (int i = threadIdx.x; i < R * kPoseFeat; i += kVT) {
    const int r = i / kPoseFeat;
    s.u.in.pf[i - r * kPoseFeat][r] = pf[rows.row(j0 + r) * kPoseFeat + (i - r * kPoseFeat)];
  }
  __syncthreads();

  float p[3][R];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float base = __ldg(vt + (long long)c * V + v);
#pragma unroll
    for (int r = 0; r < R; ++r) p[c][r] = base;
  }
  for (int l = 0; l < nb; ++l) {
    const size_t o = (size_t)l * 3 * V + v;
    fma_feature<R>(p, s.u.in.beta[l], __ldg(sd + o), __ldg(sd + o + V), __ldg(sd + o + 2 * V));
  }
#pragma unroll 4
  for (int k = 0; k < kPoseFeat; ++k) {
    const size_t o = (size_t)k * 3 * V + v;
    fma_feature<R>(p, s.u.in.pf[k], __ldg(pd + o), __ldg(pd + o + V), __ldg(pd + o + 2 * V));
  }
  __syncthreads();  // every thread is done with the coefficients
  for (int i = threadIdx.x; i < R * kA12; i += kVT) {
    const int r = i / kA12;
    s.u.a12[r][i - r * kA12] = a12[rows.row(j0 + r) * kA12 + (i - r * kA12)];
  }
  __syncthreads();
  float w[kJoints];
  load_weights(lbs_w, v, w);
  float s1[3] = {0.f, 0.f, 0.f}, s2[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float o[3];
    skin(s.u.a12[r], w, p[0][r], p[1][r], p[2][r], o);
    if (rows.tail) {  // the row's own group; this thread's own column: no barrier needed
      float(&a)[6][kVT] = acc[(j0 + r) / rows.tail];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        a[c][threadIdx.x] += o[c];
        a[3 + c][threadIdx.x] = fmaf(o[c], o[c], a[3 + c][threadIdx.x]);
      }
    } else {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        s1[c] += o[c];
        s2[c] = fmaf(o[c], o[c], s2[c]);
      }
    }
  }
  if (!rows.tail) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      acc[0][c][threadIdx.x] += s1[c];
      acc[0][3 + c][threadIdx.x] += s2[c];
    }
  }
}

// The chunk of r rows, r one of ROWS, ROWS/2, ..., 1, through the
// instantiation for r.
template <int ROWS, int R>
__device__ __forceinline__ void moments_rows_of(int r, MomentStage<ROWS>& s, const MomentRows& rows, int j0,
                                                int v, int V, int nb, const float* __restrict__ a12,
                                                const float* __restrict__ betas,
                                                const float* __restrict__ pf,
                                                const float* __restrict__ vt,
                                                const float* __restrict__ sd,
                                                const float* __restrict__ pd,
                                                const float* __restrict__ lbs_w,
                                                float (&acc)[kTailGroups][6][kVT]) {
  if (r == R)
    moments_rows<ROWS, R>(s, rows, j0, v, V, nb, a12, betas, pf, vt, sd, pd, lbs_w, acc);
  else if constexpr (R > 1)
    moments_rows_of<ROWS, R / 2>(r, s, rows, j0, v, V, nb, a12, betas, pf, vt, sd, pd, lbs_w, acc);
}

// K1 on K2's forward design.  Grid (ceil(V/kVT), G + tail blocks), kVT
// threads, one thread per vertex.  Block y < G takes group y's first N -
// tail rows (all N when tail is 0) in chunks (moments_chunk), each staged
// once, blended in registers (each basis value loaded once for the chunk's
// rows) and skinned from the same registers; its sums (in shared memory, so
// that they hold no registers during the blend) go to out once.  When 1 <=
// N % 16 <= 4 the wrapper sets tail = N % 16, and block G + b takes the
// last `tail` rows of groups 4b .. 4b + 3 as one chunk (16 rows at N =
// 100, where each group's own 4-row chunk would read the whole basis for 4
// rows) and writes their sums to tail_out, which moments_tail_add adds to
// out.  Every sum is taken in a fixed order: the same bits on every launch.
template <int ROWS, int MINB>
__global__ void __launch_bounds__(kVT, MINB) smpl_moments_kernel(
    const float* __restrict__ a12, const float* __restrict__ betas,
    const float* __restrict__ pf, const float* __restrict__ vt,
    const float* __restrict__ sd, const float* __restrict__ pd,
    const float* __restrict__ lbs_w, float* __restrict__ out, float* __restrict__ tail_out, int G,
    int N, int V, int nb, int tail) {
  __shared__ MomentStage<ROWS> s;
  __shared__ float acc[kTailGroups][6][kVT];
  const int v_raw = blockIdx.x * kVT + threadIdx.x;
  const int v = min(v_raw, V - 1);  // threads past V compute a copy, store nothing
  const bool tail_block = (int)blockIdx.y >= G;
  const MomentRows rows{tail_block ? (long long)(blockIdx.y - G) * kTailGroups : (long long)blockIdx.y, N,
                        tail_block ? tail : 0};
  const int groups = tail_block ? min(kTailGroups, G - (int)rows.g0) : 1;
  const int n = tail_block ? groups * tail : N - tail;
#pragma unroll
  for (int q = 0; q < kTailGroups * 6; ++q) acc[q / 6][q % 6][threadIdx.x] = 0.f;
  int start = 0;
  for (int ci = 0;; ++ci) {
    const int r = moments_chunk<ROWS>(n, ci, start);
    if (r == 0) break;
    moments_rows_of<ROWS, ROWS>(r, s, rows, start, v, V, nb, a12, betas, pf, vt, sd, pd, lbs_w, acc);
  }
  if (v_raw >= V) return;
  float* dst = tail_block ? tail_out : out;
  for (int gl = 0; gl < groups; ++gl)
#pragma unroll
    for (int q = 0; q < 6; ++q)
      dst[(((rows.g0 + gl) * 2 + q / 3) * 3 + q % 3) * V + v] = acc[gl][q][threadIdx.x];
}

// out += tail_out, element by element: the groups' tail sums after their
// other rows' sums.
__global__ void moments_tail_add(float* __restrict__ out, const float* __restrict__ tail_out, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] += tail_out[i];
}

// The rotation part of T12 for staged row r: t[3c+i] = sum_j W[v,j] R_j[c,i].
__device__ __forceinline__ void rot_row(const Stage& s, int r, const float (&w)[kJoints],
                                        float (&t)[9]) {
#pragma unroll
  for (int q = 0; q < 9; ++q) t[q] = 0.f;
#pragma unroll
  for (int j = 0; j < kJoints; ++j) {
    const float4* a = reinterpret_cast<const float4*>(&s.a12[r][j * 12]);
    const float4 a0 = a[0], a1 = a[1], a2 = a[2];
    const float av[9] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w, a2.x};
#pragma unroll
    for (int q = 0; q < 9; ++q) t[q] = fmaf(w[j], av[q], t[q]);
  }
}

// Grid (ceil(V/kVT), ceil(B/rows)), rows <= kRows sample rows a block (fewer
// than kRows when B is small, so that the blocks fill the card).  g is read
// at g[b*gsb + c*gsc + v*gsv]; dp (B, 3, V) and g12 (B, 12, V) are written
// when not null.
__global__ void __launch_bounds__(kVT) smpl_verts_bwd_kernel(
    const float* __restrict__ a12, const float* __restrict__ betas,
    const float* __restrict__ pf, const float* __restrict__ vt,
    const float* __restrict__ sd, const float* __restrict__ pd,
    const float* __restrict__ lbs_w, const float* __restrict__ g, long long gsb,
    long long gsc, long long gsv, float* __restrict__ dp, float* __restrict__ g12, int B,
    int V, int nb, int rows) {
  __shared__ Stage s;
  const int v_raw = blockIdx.x * kVT + threadIdx.x;
  const int v = min(v_raw, V - 1);  // threads past V compute a copy, store nothing
  const long long row0 = (long long)blockIdx.y * rows;
  const int nrows = min(rows, B - (int)row0);
  stage_rows(s, a12, betas, pf, nb, row0, nrows);
  __syncthreads();
  if (g12 != nullptr) blend_rows(s, v, V, nb, vt, sd, pd);  // the same branch in every thread
  if (v_raw >= V) return;
  float w[kJoints];
  if (dp != nullptr) load_weights(lbs_w, v, w);
#pragma unroll 1
  for (int r = 0; r < nrows; ++r) {
    const long long b = row0 + r;
    const float* gb = g + b * gsb + (long long)v * gsv;
    const float gc[3] = {__ldg(gb), __ldg(gb + gsc), __ldg(gb + 2 * gsc)};
    if (dp != nullptr) {
      float t[9];
      rot_row(s, r, w, t);
#pragma unroll
      for (int i = 0; i < 3; ++i)
        dp[(b * 3 + i) * V + v] = fmaf(t[6 + i], gc[2], fmaf(t[3 + i], gc[1], t[i] * gc[0]));
    }
    if (g12 != nullptr) {
      const float p[3] = {s.u.p[0][r][threadIdx.x], s.u.p[1][r][threadIdx.x],
                          s.u.p[2][r][threadIdx.x]};
      float* o = g12 + b * 12 * V + v;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
#pragma unroll
        for (int i = 0; i < 3; ++i) o[(3 * c + i) * V] = gc[c] * p[i];
        o[(9 + c) * V] = gc[c];
      }
    }
  }
}

}  // namespace

// All pointers are device pointers to contiguous float32 arrays:
// a12 (rows, 24, 12), betas (rows, nb), pf (rows, 207), vt (3, V),
// sd (nb, 3, V), pd (207, 3, V), lbs_w (V, 24).  plan selects the
// forward's row group (sample rows a block): 0 = 16, 1 = 8, 2 = 4
// (models/cuda_lbs.py FORWARD_PLANS).  Launch on `stream`; return cudaGetLastError() (0 on
// success).
extern "C" int smpl_verts_launch(const void* a12, const void* betas, const void* pf,
                                 const void* vt, const void* sd, const void* pd,
                                 const void* lbs_w, void* out, int B, int V, int nb, int plan,
                                 void* stream) {
  if (B <= 0 || V <= 0) return 0;
  if (nb < 0 || nb > kMaxBetas) return (int)cudaErrorInvalidValue;
  const float *A = (const float*)a12, *be = (const float*)betas, *P = (const float*)pf,
              *T = (const float*)vt, *S = (const float*)sd, *D = (const float*)pd,
              *W = (const float*)lbs_w;
  float* o = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (plan) {
    case 0: return launch_verts<16, 5>(A, be, P, T, S, D, W, o, B, V, nb, st);
    case 1: return launch_verts<8, 1>(A, be, P, T, S, D, W, o, B, V, nb, st);
    case 2: return launch_verts<4, 1>(A, be, P, T, S, D, W, o, B, V, nb, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Rows are G groups of N; out (G, 2, 3, V) = (sum x, sum x^2) over each
// group.  tail_out: (G, 2, 3, V) scratch, used when 1 <= N % 16 <= 4 (the
// groups' last N % 16 rows taken four groups a chunk,
// models/cuda_lbs.py::moments_blocks); else each group's block takes all its
// rows.  Launch on `stream`; return the first CUDA error.
extern "C" int smpl_moments_launch(const void* a12, const void* betas, const void* pf,
                                   const void* vt, const void* sd, const void* pd,
                                   const void* lbs_w, void* out, void* tail_out, int G, int N, int V,
                                   int nb, void* stream) {
  if (G <= 0 || V <= 0) return 0;
  if (nb < 0 || nb > kMaxBetas || N <= 0) return (int)cudaErrorInvalidValue;
  const int tail = (N % 16 >= 1 && N % 16 <= 4) ? N % 16 : 0;
  if (tail && tail_out == nullptr) return (int)cudaErrorInvalidValue;
  const long long rows_y = G + (tail ? (G + kTailGroups - 1) / kTailGroups : 0);
  if (rows_y > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  smpl_moments_kernel<16, 5><<<dim3((V + kVT - 1) / kVT, (unsigned)rows_y), kVT, 0, st>>>(
      (const float*)a12, (const float*)betas, (const float*)pf, (const float*)vt, (const float*)sd,
      (const float*)pd, (const float*)lbs_w, (float*)out, (float*)tail_out, G, N, V, nb, tail);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !tail) return (int)err;
  const long long n = (long long)G * 6 * V;
  moments_tail_add<<<(unsigned)((n + 255) / 256), 256, 0, st>>>((float*)out, (const float*)tail_out, n);
  return (int)cudaGetLastError();
}

// K2's backward, per-vertex part: inputs as smpl_verts_launch, the cotangent
// g (B, 3, V) with element strides (gsb, gsc, gsv); dp (B, 3, V) and g12
// (B, 12, V) contiguous, each written unless null (not both null).
extern "C" int smpl_verts_bwd_launch(const void* a12, const void* betas, const void* pf,
                                     const void* vt, const void* sd, const void* pd,
                                     const void* lbs_w, const void* g, long long gsb,
                                     long long gsc, long long gsv, void* dp, void* g12, int B,
                                     int V, int nb, void* stream) {
  if (B <= 0 || V <= 0 || (dp == nullptr && g12 == nullptr)) return 0;
  if (nb < 0 || nb > kMaxBetas) return (int)cudaErrorInvalidValue;
  // Halve the rows a block takes (to 4 at least) while the grid would not
  // give each SM two blocks: the blend's loads, not its FMAs, bound a small
  // batch.
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int vtiles = (V + kVT - 1) / kVT;
  int rows = kRows;
  while (rows > 4 && (long long)vtiles * ((B + rows - 1) / rows) < 2LL * sms) rows /= 2;
  const dim3 grid(vtiles, (B + rows - 1) / rows);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  smpl_verts_bwd_kernel<<<grid, kVT, 0, (cudaStream_t)stream>>>(
      (const float*)a12, (const float*)betas, (const float*)pf, (const float*)vt,
      (const float*)sd, (const float*)pd, (const float*)lbs_w, (const float*)g, gsb, gsc, gsv,
      (float*)dp, (float*)g12, B, V, nb, rows);
  return (int)cudaGetLastError();
}
