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
// Design: one thread per vertex, 128 vertices per block, 16 sample rows per
// pass.  The rows' betas, pose features and A12 are staged in shared memory
// (read as broadcasts); each model value a thread loads from global memory
// (posedirs is 17 MB and stays in the 50 MB L2) is reused for all 16 rows held
// in registers.  The posed vertices then go to shared memory, so the skinning
// loop over rows needs no unrolling.  K1's block owns one (vertex tile,
// group) pair and loops over all of the group's rows, so its sums need no
// atomics and no second pass and are deterministic.
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

__device__ __forceinline__ void fma_rows4(float (&p)[3][kRows], int r0, float4 q,
                                          float d0, float d1, float d2) {
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

// Skinned vertex of staged row r; reads the posed vertex this thread wrote.
__device__ __forceinline__ void skin_row(const Stage& s, int r, const float (&w)[kJoints],
                                         float (&out)[3]) {
  float t[12];
#pragma unroll
  for (int q = 0; q < 12; ++q) t[q] = 0.f;
#pragma unroll
  for (int j = 0; j < kJoints; ++j) {
    const float4* a = reinterpret_cast<const float4*>(&s.a12[r][j * 12]);
    const float4 a0 = a[0], a1 = a[1], a2 = a[2];
    const float av[12] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y,
                          a1.z, a1.w, a2.x, a2.y, a2.z, a2.w};
#pragma unroll
    for (int q = 0; q < 12; ++q) t[q] = fmaf(w[j], av[q], t[q]);
  }
  const float p0 = s.u.p[0][r][threadIdx.x];
  const float p1 = s.u.p[1][r][threadIdx.x];
  const float p2 = s.u.p[2][r][threadIdx.x];
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

// Grid (ceil(V/kVT), ceil(B/kRows)); out (B, 3, V).
__global__ void __launch_bounds__(kVT) smpl_verts_kernel(
    const float* __restrict__ a12, const float* __restrict__ betas,
    const float* __restrict__ pf, const float* __restrict__ vt,
    const float* __restrict__ sd, const float* __restrict__ pd,
    const float* __restrict__ lbs_w, float* __restrict__ out, int B, int V, int nb) {
  __shared__ Stage s;
  const int v_raw = blockIdx.x * kVT + threadIdx.x;
  const int v = min(v_raw, V - 1);  // threads past V compute a copy, store nothing
  const long long row0 = (long long)blockIdx.y * kRows;
  const int nrows = min(kRows, B - (int)row0);
  stage_rows(s, a12, betas, pf, nb, row0, nrows);
  __syncthreads();
  blend_rows(s, v, V, nb, vt, sd, pd);
  if (v_raw >= V) return;
  float w[kJoints];
  load_weights(lbs_w, v, w);
#pragma unroll 1
  for (int r = 0; r < nrows; ++r) {
    float o[3];
    skin_row(s, r, w, o);
#pragma unroll
    for (int c = 0; c < 3; ++c) out[((row0 + r) * 3 + c) * V + v] = o[c];
  }
}

// Grid (ceil(V/kVT), G); rows of group g are g*N .. g*N+N-1; out (G, 2, 3, V).
__global__ void __launch_bounds__(kVT) smpl_moments_kernel(
    const float* __restrict__ a12, const float* __restrict__ betas,
    const float* __restrict__ pf, const float* __restrict__ vt,
    const float* __restrict__ sd, const float* __restrict__ pd,
    const float* __restrict__ lbs_w, float* __restrict__ out, int N, int V, int nb) {
  __shared__ Stage s;
  const int v_raw = blockIdx.x * kVT + threadIdx.x;
  const int v = min(v_raw, V - 1);
  const long long g = blockIdx.y;
  float w[kJoints];
  load_weights(lbs_w, v, w);
  float s1[3] = {0.f, 0.f, 0.f}, s2[3] = {0.f, 0.f, 0.f};
  for (int row0 = 0; row0 < N; row0 += kRows) {
    const int nrows = min(kRows, N - row0);
    __syncthreads();  // the previous pass is done with the shared buffers
    stage_rows(s, a12, betas, pf, nb, g * N + row0, nrows);
    __syncthreads();
    blend_rows(s, v, V, nb, vt, sd, pd);
#pragma unroll 1
    for (int r = 0; r < nrows; ++r) {
      float o[3];
      skin_row(s, r, w, o);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        s1[c] += o[c];
        s2[c] = fmaf(o[c], o[c], s2[c]);
      }
    }
  }
  if (v_raw >= V) return;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    out[((g * 2 + 0) * 3 + c) * V + v] = s1[c];
    out[((g * 2 + 1) * 3 + c) * V + v] = s2[c];
  }
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
// sd (nb, 3, V), pd (207, 3, V), lbs_w (V, 24).  Launch on `stream`; return
// cudaGetLastError() (0 on success).
extern "C" int smpl_verts_launch(const void* a12, const void* betas, const void* pf,
                                 const void* vt, const void* sd, const void* pd,
                                 const void* lbs_w, void* out, int B, int V, int nb,
                                 void* stream) {
  if (B <= 0 || V <= 0) return 0;
  if (nb < 0 || nb > kMaxBetas) return (int)cudaErrorInvalidValue;
  const dim3 grid((V + kVT - 1) / kVT, (B + kRows - 1) / kRows);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  smpl_verts_kernel<<<grid, kVT, 0, (cudaStream_t)stream>>>(
      (const float*)a12, (const float*)betas, (const float*)pf, (const float*)vt,
      (const float*)sd, (const float*)pd, (const float*)lbs_w, (float*)out, B, V, nb);
  return (int)cudaGetLastError();
}

// Rows are G groups of N; out (G, 2, 3, V) = (sum x, sum x^2) over each group.
extern "C" int smpl_moments_launch(const void* a12, const void* betas, const void* pf,
                                   const void* vt, const void* sd, const void* pd,
                                   const void* lbs_w, void* out, int G, int N, int V,
                                   int nb, void* stream) {
  if (G <= 0 || V <= 0) return 0;
  if (nb < 0 || nb > kMaxBetas || N <= 0 || G > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((V + kVT - 1) / kVT, G);
  smpl_moments_kernel<<<grid, kVT, 0, (cudaStream_t)stream>>>(
      (const float*)a12, (const float*)betas, (const float*)pf, (const float*)vt,
      (const float*)sd, (const float*)pd, (const float*)lbs_w, (float*)out, N, V, nb);
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
