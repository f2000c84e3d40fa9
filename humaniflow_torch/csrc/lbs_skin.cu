// Kernel K7: linear blend skinning of channel-major posed vertices.
//
// Replaces the TPU kernel `_lbs_kernel` of humaniflow_tpu/models/pallas_lbs.py
// (called through `lbs_skin_pallas_cm`):
//
//   out[b, c, v] = sum_j W[v, j] * (sum_i R_j[c, i] * p[b, i, v] + t_j[c])
//
// with a12[b, j] = [R_j (row-major 9) | t_j (3)].  The TPU kernel ran 12 MXU
// dots per (32-row, 1024-vertex) block on a (B, 4, V) layout padded for
// Mosaic; here one block owns 128 vertices and 8 rows: the 8 rows' a12
// (8 x 288 floats) sit in shared memory, each thread holds its vertex's 24
// skinning weights in registers, forms the 12 transform entries
// T[r] = sum_j W[v, j] * a12[b, j, r] with float32 FMAs (read from shared
// memory 4 floats at a time, the same address for the whole warp) and
// applies them to its posed vertex.  No padding rows, no padded vertices.
//
// Bound: 12*24 + 12 FMAs per (row, vertex), against the read of the posed
// vertices and the write of the output: at B*N = 3200 rows and V = 6890,
// 13.2 GFLOP (0.197 ms at the float32 peak) against 0.53 GB (0.158 ms at
// 3.35 TB/s).  The skinning weights (0.66 MB) are read once per 8 rows,
// from L2.  No path of the JAX package or of the port calls it: the SMPL
// forward fuses skinning into K1 and K2.

#include <cuda_runtime.h>

namespace {

constexpr int kVT = 128;   // vertices per block
constexpr int kRows = 8;   // rows per block
constexpr int kJ = 24;     // joints
constexpr int kA = kJ * 12;

__global__ void __launch_bounds__(kVT) lbs_skin_kernel(const float* __restrict__ w,
                                                       const float* __restrict__ a12,
                                                       const float* __restrict__ posed,
                                                       float* __restrict__ out, int B, int V) {
  __shared__ float4 s_a[kRows * kA / 4];
  const int b0 = blockIdx.y * kRows;
  const int nb = min(kRows, B - b0);
  const float4* src = reinterpret_cast<const float4*>(a12 + (long long)b0 * kA);
  for (int i = threadIdx.x; i < nb * kA / 4; i += kVT) s_a[i] = src[i];
  __syncthreads();
  const int v = blockIdx.x * kVT + threadIdx.x;
  if (v >= V) return;

  float wv[kJ];
  const float4* w4 = reinterpret_cast<const float4*>(w + (long long)v * kJ);
#pragma unroll
  for (int q = 0; q < kJ / 4; ++q) {
    const float4 t = w4[q];
    wv[4 * q] = t.x;
    wv[4 * q + 1] = t.y;
    wv[4 * q + 2] = t.z;
    wv[4 * q + 3] = t.w;
  }
  for (int r = 0; r < nb; ++r) {
    const float4* a = s_a + r * kA / 4;
    float t[12];
#pragma unroll
    for (int i = 0; i < 12; ++i) t[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const float4 q0 = a[3 * j], q1 = a[3 * j + 1], q2 = a[3 * j + 2];
      t[0] = fmaf(wv[j], q0.x, t[0]);
      t[1] = fmaf(wv[j], q0.y, t[1]);
      t[2] = fmaf(wv[j], q0.z, t[2]);
      t[3] = fmaf(wv[j], q0.w, t[3]);
      t[4] = fmaf(wv[j], q1.x, t[4]);
      t[5] = fmaf(wv[j], q1.y, t[5]);
      t[6] = fmaf(wv[j], q1.z, t[6]);
      t[7] = fmaf(wv[j], q1.w, t[7]);
      t[8] = fmaf(wv[j], q2.x, t[8]);
      t[9] = fmaf(wv[j], q2.y, t[9]);
      t[10] = fmaf(wv[j], q2.z, t[10]);
      t[11] = fmaf(wv[j], q2.w, t[11]);
    }
    const long long base = (long long)(b0 + r) * 3 * V + v;
    const float px = posed[base], py = posed[base + V], pz = posed[base + 2 * (long long)V];
#pragma unroll
    for (int c = 0; c < 3; ++c)
      out[base + c * (long long)V] =
          fmaf(t[3 * c], px, fmaf(t[3 * c + 1], py, fmaf(t[3 * c + 2], pz, t[9 + c])));
  }
}

}  // namespace

// w: (V, 24) float32; a12: (B, 24, 12) float32; posed: (B, 3, V) float32;
// out: (B, 3, V) float32.  All device pointers, contiguous, 16-byte
// aligned.  Launch on `stream`; return cudaGetLastError().
extern "C" int lbs_skin_launch(const void* w, const void* a12, const void* posed, void* out, int B,
                               int V, void* stream) {
  if (B <= 0 || V <= 0) return 0;
  const int row_blocks = (B + kRows - 1) / kRows;
  if (row_blocks > 65535) return (int)cudaErrorInvalidValue;
  lbs_skin_kernel<<<dim3((V + kVT - 1) / kVT, row_blocks), kVT, 0, (cudaStream_t)stream>>>(
      (const float*)w, (const float*)a12, (const float*)posed, (float*)out, B, V);
  return (int)cudaGetLastError();
}
