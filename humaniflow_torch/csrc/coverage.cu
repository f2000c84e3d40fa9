// Kernel K3: silhouette coverage of a (back-face culled) triangle set.
//
// Replaces the TPU kernels `_make_coverage_table_kernel` and
// `_make_coverage_kernel` of humaniflow_tpu/render/binned_rasterizer.py
// (called through `rasterize_binned_coverage`).  The TPU sorted faces into
// per-strip bins because it has no scatter; a strip holding more candidates
// than its capacity dropped some, and the mask was exact only at overflow 0.
// Here one thread owns one (mesh, face): it computes the face's edge-plane
// coefficients [a0 b0 c0 a1 b1 c1] (w0 = a0 x + b0 y + c0, w1 = a1 x + b1 y
// + c1, w2 = 1 - w0 - w1), tests the pixel centres (col + 0.5, row + 0.5) of
// its bounding box widened by one pixel and clipped to the image, and
// stores 1 into the zeroed mask where min(w0, w1, w2) >= 0.  Concurrent
// stores of the same value are benign.  There is no capacity, so nothing is
// dropped for lack of room; the only dropped candidates are faces with a
// vertex index outside [0, V), counted per mesh in `overflow`.
//
// Bound: at the SSP-3D shape (3,232 meshes of 13,774 faces at 256²) the
// mask write (0.21 GB) and the screen vertices (0.30 GB) cost ~0.15 ms at
// 3.35 TB/s; the edge tests of the widened boxes cost about as much at the
// float32 peak.  This first design is simple rather than fast: a stretched
// face makes its thread walk a large box, and a warp waits for its slowest
// thread.  A tiled shared-memory design is later work.
//
// Numerics: every operation is written with the round-to-nearest
// intrinsics in the order of `_edge_plane_coeffs` and of the plain PyTorch
// twin (render/cuda_coverage.py::coverage_plain), so nvcc cannot contract a
// multiply and an add into an FMA, and the mask equals the twin's bit for
// bit.  A face is kept only if all six screen coordinates are finite, its
// signed area a satisfies |a| > 1e-9, and a * cull_sign > 0 when cull_sign
// is not 0.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__global__ void coverage_kernel(const float* __restrict__ verts, const int* __restrict__ faces,
                                uint8_t* __restrict__ mask, int* __restrict__ overflow, int M,
                                int V, int F, int H, int W, int cull_sign) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)M * F) return;
  const int m = (int)(idx / F);
  const int f = (int)(idx % F);

  const int i0 = faces[3 * f], i1 = faces[3 * f + 1], i2 = faces[3 * f + 2];
  if (i0 < 0 || i0 >= V || i1 < 0 || i1 >= V || i2 < 0 || i2 >= V) {
    atomicAdd(overflow + m, 1);
    return;
  }
  const float* vm = verts + (long long)m * V * 3;
  const float x0 = vm[3 * i0], y0 = vm[3 * i0 + 1];
  const float x1 = vm[3 * i1], y1 = vm[3 * i1 + 1];
  const float x2 = vm[3 * i2], y2 = vm[3 * i2 + 1];
  if (!(isfinite(x0) && isfinite(y0) && isfinite(x1) && isfinite(y1) && isfinite(x2) &&
        isfinite(y2)))
    return;

  const float area = __fsub_rn(__fmul_rn(__fsub_rn(x1, x0), __fsub_rn(y2, y0)),
                               __fmul_rn(__fsub_rn(x2, x0), __fsub_rn(y1, y0)));
  if (!(fabsf(area) > 1e-9f)) return;  // degenerate: never inside (c0 = -1)
  if (cull_sign != 0 && !(__fmul_rn(area, (float)cull_sign) > 0.f)) return;

  const float inv = __fdiv_rn(1.0f, area);
  const float a0 = __fmul_rn(-__fsub_rn(y2, y1), inv);
  const float b0 = __fmul_rn(__fsub_rn(x2, x1), inv);
  const float c0 = __fmul_rn(
      __fsub_rn(__fmul_rn(__fsub_rn(y2, y1), x1), __fmul_rn(__fsub_rn(x2, x1), y1)), inv);
  const float a1 = __fmul_rn(-__fsub_rn(y0, y2), inv);
  const float b1 = __fmul_rn(__fsub_rn(x0, x2), inv);
  const float c1 = __fmul_rn(
      __fsub_rn(__fmul_rn(__fsub_rn(y0, y2), x2), __fmul_rn(__fsub_rn(x0, x2), y2)), inv);

  // Bounding box widened by one pixel, clipped to the image; the clipped
  // bounds are whole numbers, so the int conversions are exact.
  const float cx_lo = fmaxf(floorf(fminf(fminf(x0, x1), x2)) - 1.f, 0.f);
  const float cx_hi = fminf(ceilf(fmaxf(fmaxf(x0, x1), x2)) + 1.f, (float)(W - 1));
  const float cy_lo = fmaxf(floorf(fminf(fminf(y0, y1), y2)) - 1.f, 0.f);
  const float cy_hi = fminf(ceilf(fmaxf(fmaxf(y0, y1), y2)) + 1.f, (float)(H - 1));
  if (cx_lo > cx_hi || cy_lo > cy_hi) return;
  const int col_lo = (int)cx_lo, col_hi = (int)cx_hi;
  const int row_lo = (int)cy_lo, row_hi = (int)cy_hi;

  uint8_t* mm = mask + (long long)m * H * W;
  for (int row = row_lo; row <= row_hi; ++row) {
    const float gy = __fadd_rn((float)row, 0.5f);
    const float by0 = __fmul_rn(b0, gy), by1 = __fmul_rn(b1, gy);
    for (int col = col_lo; col <= col_hi; ++col) {
      const float gx = __fadd_rn((float)col, 0.5f);
      const float w0 = __fadd_rn(__fadd_rn(__fmul_rn(a0, gx), by0), c0);
      const float w1 = __fadd_rn(__fadd_rn(__fmul_rn(a1, gx), by1), c1);
      const float w2 = __fsub_rn(__fsub_rn(1.0f, w0), w1);
      if (w0 >= 0.f && w1 >= 0.f && w2 >= 0.f) mm[(long long)row * W + col] = 1;
    }
  }
}

}  // namespace

// verts: (M, V, 3) float32 screen coordinates (x = column, y = row; the
// third is unused); faces: (F, 3) int32; mask: (M, H, W) uint8, zeroed by
// the caller; overflow: (M,) int32, zeroed by the caller.  All device
// pointers, contiguous.  Launch on `stream`; return cudaGetLastError().
extern "C" int coverage_launch(const void* verts, const void* faces, void* mask, void* overflow,
                               int M, int V, int F, int H, int W, int cull_sign, void* stream) {
  if (M <= 0 || F <= 0 || H <= 0 || W <= 0) return 0;
  if (V <= 0 || cull_sign < -1 || cull_sign > 1) return (int)cudaErrorInvalidValue;
  const long long n = (long long)M * F;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  coverage_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)verts, (const int*)faces, (uint8_t*)mask, (int*)overflow, M, V, F, H, W,
      cull_sign);
  return (int)cudaGetLastError();
}
