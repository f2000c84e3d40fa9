// Kernel K4: exact z-buffer with in-kernel attribute interpolation.
//
// Replaces the TPU kernel `_make_kernel` of
// humaniflow_tpu/render/binned_rasterizer.py (called through
// `_rasterize_binned_impl`, `rasterize_binned_with_attrs` and
// `rasterize_binned`).  The TPU binned faces into 8x128-pixel strips of fixed
// capacity because it has no scatter and no atomics: a grid step z-tested one
// strip against its face window held in registers, and candidates beyond a
// strip's capacity were dropped.  None of that is carried over.  Here:
//
//   pass 1 (raster_kernel): one thread per (mesh, face).  It computes the
//     face's edge-plane coefficients [a0 b0 c0 a1 b1 c1 za zb zc]
//     (w0 = a0 x + b0 y + c0, w1 = a1 x + b1 y + c1, w2 = 1 - w0 - w1,
//     z = za x + zb y + zc), walks the pixel centres (col + 0.5, row + 0.5)
//     of its bounding box widened by one pixel and clipped to the image, and
//     where min(w0, w1, w2) >= 0 and z is finite and below BIG_DEPTH does a
//     64-bit atomicMin of (order-preserving bits of z) << 32 | face id into a
//     per-pixel key buffer.  The smallest z wins, and of equal z the lowest
//     face id, as in the exact scan (render/rasterizer.py in both packages).
//   pass 2 (resolve_kernel): one thread per pixel.  It decodes the winner,
//     recomputes the winner's coefficients with the same operations as pass
//     1 (so w0 and w1 are the values pass 1 tested), and writes the depth,
//     optionally the face id and (w0, w1), then the n_lin interpolated
//     attribute planes (d0 w0 + d1 w1 + c), the n_const constant planes and,
//     with z_grads, the winner's (za, zb).  Empty pixels get depth BIG_DEPTH,
//     face -1 and zeros.
//
// A face is kept when its nine screen coordinates are finite, its vertex
// indices lie in [0, V), |signed area| > 1e-9, and signed area * cull_sign > 0
// unless cull_sign is 0.  There is no capacity, so nothing is dropped for lack
// of room: `overflow` counts per mesh only the faces with an out-of-range
// index.
//
// Bound on an H100 at the training shape (72 meshes of 13,774 faces, 256^2,
// four constant planes): the key buffer (38 MB, written by a memset and read
// once), the outputs (5 planes, 94 MB) and the screen vertices (6.8 MB) cost
// ~0.04 ms at 3.35 TB/s; the edge tests of the widened boxes (~13 operations
// each) cost about as much at the 67 TFLOP/s float32 peak.  This first design
// is simple rather than fast: a stretched face makes its thread walk a large
// box while its warp waits, and the atomics of neighbouring faces contend on
// shared pixels.  A tiled shared-memory design is later work.
//
// Numerics: every operation is written with the round-to-nearest intrinsics
// in the order of `_edge_plane_coeffs` and of the plain PyTorch twin
// (render/cuda_raster.py::raster_plain), so that nvcc cannot contract a
// multiply and an add into an FMA, and depth, winners and planes equal the
// twin's bit for bit.  64-bit offsets throughout.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr float kBigDepth = 1e9f;
constexpr unsigned long long kEmpty = ~0ull;

struct Face {
  float c[9];  // a0 b0 c0 a1 b1 c1 za zb zc
};

// Order-preserving map of a float's bits to an unsigned int: negative floats
// below positive ones, and within a sign by value.
__device__ __forceinline__ unsigned int order_bits(float z) {
  const unsigned int u = __float_as_uint(z);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float unorder_bits(unsigned int k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// Vertex positions of face f of one mesh; false if an index is out of range.
__device__ __forceinline__ bool load_face(const float* __restrict__ vm, const int* __restrict__ faces, int f,
                                          int V, float p[9]) {
  const int i[3] = {faces[3 * (long long)f], faces[3 * (long long)f + 1], faces[3 * (long long)f + 2]};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    if (i[k] < 0 || i[k] >= V) return false;
    p[3 * k] = vm[3 * (long long)i[k]];
    p[3 * k + 1] = vm[3 * (long long)i[k] + 1];
    p[3 * k + 2] = vm[3 * (long long)i[k] + 2];
  }
  return true;
}

__device__ __forceinline__ float signed_area(const float p[9]) {
  const float x0 = p[0], y0 = p[1], x1 = p[3], y1 = p[4], x2 = p[6], y2 = p[7];
  return __fsub_rn(__fmul_rn(__fsub_rn(x1, x0), __fsub_rn(y2, y0)),
                   __fmul_rn(__fsub_rn(x2, x0), __fsub_rn(y1, y0)));
}

// Edge-plane coefficients in the order of `_edge_plane_coeffs`.
__device__ __forceinline__ Face coefficients(const float p[9], float area) {
  const float x0 = p[0], y0 = p[1], z0 = p[2], x1 = p[3], y1 = p[4], z1 = p[5];
  const float x2 = p[6], y2 = p[7], z2 = p[8];
  const float inv = __fdiv_rn(1.0f, area);
  Face f;
  f.c[0] = __fmul_rn(-__fsub_rn(y2, y1), inv);
  f.c[1] = __fmul_rn(__fsub_rn(x2, x1), inv);
  f.c[2] = __fmul_rn(__fsub_rn(__fmul_rn(__fsub_rn(y2, y1), x1), __fmul_rn(__fsub_rn(x2, x1), y1)), inv);
  f.c[3] = __fmul_rn(-__fsub_rn(y0, y2), inv);
  f.c[4] = __fmul_rn(__fsub_rn(x0, x2), inv);
  f.c[5] = __fmul_rn(__fsub_rn(__fmul_rn(__fsub_rn(y0, y2), x2), __fmul_rn(__fsub_rn(x0, x2), y2)), inv);
  const float dz0 = __fsub_rn(z0, z2), dz1 = __fsub_rn(z1, z2);
  f.c[6] = __fadd_rn(__fmul_rn(f.c[0], dz0), __fmul_rn(f.c[3], dz1));
  f.c[7] = __fadd_rn(__fmul_rn(f.c[1], dz0), __fmul_rn(f.c[4], dz1));
  f.c[8] = __fadd_rn(__fadd_rn(__fmul_rn(f.c[2], dz0), __fmul_rn(f.c[5], dz1)), z2);
  return f;
}

// (a x + b y) + c, as the twin computes a plane.
__device__ __forceinline__ float plane(float a, float b, float c, float gx, float gy) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, gx), __fmul_rn(b, gy)), c);
}

__global__ void raster_kernel(const float* __restrict__ verts, const int* __restrict__ faces,
                              unsigned long long* __restrict__ zbuf, int* __restrict__ overflow, int M, int V,
                              int F, int H, int W, int cull_sign) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)M * F) return;
  const int m = (int)(idx / F);
  const int f = (int)(idx % F);

  float p[9];
  if (!load_face(verts + (long long)m * V * 3, faces, f, V, p)) {
    atomicAdd(overflow + m, 1);
    return;
  }
#pragma unroll
  for (int k = 0; k < 9; ++k)
    if (!isfinite(p[k])) return;
  const float area = signed_area(p);
  if (!(fabsf(area) > 1e-9f)) return;
  if (cull_sign != 0 && !(__fmul_rn(area, (float)cull_sign) > 0.f)) return;
  const Face fc = coefficients(p, area);

  // Bounding box widened by one pixel, clipped to the image; the clipped
  // bounds are whole numbers, so the int conversions are exact.
  const float cx_lo = fmaxf(floorf(fminf(fminf(p[0], p[3]), p[6])) - 1.f, 0.f);
  const float cx_hi = fminf(ceilf(fmaxf(fmaxf(p[0], p[3]), p[6])) + 1.f, (float)(W - 1));
  const float cy_lo = fmaxf(floorf(fminf(fminf(p[1], p[4]), p[7])) - 1.f, 0.f);
  const float cy_hi = fminf(ceilf(fmaxf(fmaxf(p[1], p[4]), p[7])) + 1.f, (float)(H - 1));
  if (cx_lo > cx_hi || cy_lo > cy_hi) return;
  const int col_lo = (int)cx_lo, col_hi = (int)cx_hi, row_lo = (int)cy_lo, row_hi = (int)cy_hi;

  unsigned long long* zm = zbuf + (long long)m * H * W;
  for (int row = row_lo; row <= row_hi; ++row) {
    const float gy = __fadd_rn((float)row, 0.5f);
    for (int col = col_lo; col <= col_hi; ++col) {
      const float gx = __fadd_rn((float)col, 0.5f);
      const float w0 = plane(fc.c[0], fc.c[1], fc.c[2], gx, gy);
      const float w1 = plane(fc.c[3], fc.c[4], fc.c[5], gx, gy);
      const float w2 = __fsub_rn(__fsub_rn(1.0f, w0), w1);
      if (!(w0 >= 0.f && w1 >= 0.f && w2 >= 0.f)) continue;
      const float z = plane(fc.c[6], fc.c[7], fc.c[8], gx, gy);
      if (!(isfinite(z) && z < kBigDepth)) continue;
      const unsigned long long key = ((unsigned long long)order_bits(z) << 32) | (unsigned int)f;
      atomicMin(zm + (long long)row * W + col, key);
    }
  }
}

__global__ void resolve_kernel(const float* __restrict__ verts, const int* __restrict__ faces,
                               const float* __restrict__ attrs, long long attr_mesh_stride,
                               const unsigned long long* __restrict__ zbuf, float* __restrict__ depth,
                               int* __restrict__ face_out, float* __restrict__ b0_out, float* __restrict__ b1_out,
                               float* __restrict__ planes, int M, int V, int F, int H, int W, int n_lin,
                               int n_const, int z_grads) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long hw = (long long)H * W;
  if (idx >= (long long)M * hw) return;
  const int m = (int)(idx / hw);
  const int pix = (int)(idx % hw);
  const int n_attr = n_lin + n_const + (z_grads ? 2 : 0);
  float* out = n_attr > 0 ? planes + idx * n_attr : nullptr;
  const unsigned long long key = zbuf[idx];
  if (key == kEmpty) {
    depth[idx] = kBigDepth;
    if (face_out != nullptr) {
      face_out[idx] = -1;
      b0_out[idx] = 0.f;
      b1_out[idx] = 0.f;
    }
    for (int k = 0; k < n_attr; ++k) out[k] = 0.f;
    return;
  }
  const int f = (int)(key & 0xffffffffull);
  float p[9];
  load_face(verts + (long long)m * V * 3, faces, f, V, p);  // the winner's indices are in range
  const Face fc = coefficients(p, signed_area(p));
  const float gx = __fadd_rn((float)(pix % W), 0.5f);
  const float gy = __fadd_rn((float)(pix / W), 0.5f);
  const float w0 = plane(fc.c[0], fc.c[1], fc.c[2], gx, gy);
  const float w1 = plane(fc.c[3], fc.c[4], fc.c[5], gx, gy);
  depth[idx] = unorder_bits((unsigned int)(key >> 32));
  if (face_out != nullptr) {
    face_out[idx] = f;
    b0_out[idx] = w0;
    b1_out[idx] = w1;
  }
  int k = 0;
  if (n_lin + n_const > 0) {
    const float* row = attrs + m * attr_mesh_stride + (long long)f * (3 * n_lin + n_const);
    for (int j = 0; j < n_lin; ++j)
      out[k++] = __fadd_rn(__fadd_rn(__fmul_rn(row[3 * j], w0), __fmul_rn(row[3 * j + 1], w1)), row[3 * j + 2]);
    for (int j = 0; j < n_const; ++j) out[k++] = row[3 * n_lin + j];
  }
  if (z_grads) {
    out[k++] = fc.c[6];
    out[k++] = fc.c[7];
  }
}

}  // namespace

// verts: (M, V, 3) float32 screen coordinates (x = column, y = row, depth);
// faces: (F, 3) int32; attrs: (M or 1, F, 3 n_lin + n_const) float32 rows
// [d0 d1 c] per linear attribute then the constants, or null when there are
// none; attr_mesh_stride: F (3 n_lin + n_const) or 0 for one shared table;
// zbuf: (M, H, W) uint64 scratch; depth: (M, H, W) float32; face_out, b0_out,
// b1_out: (M, H, W) int32 / float32 / float32, or all null; planes: (M, H, W,
// n_lin + n_const + 2 z_grads) float32, or null when that is 0; overflow:
// (M,) int32.  All device pointers, contiguous.  The launch fills zbuf with
// the empty key and zeroes overflow itself.  Launch on `stream`; return the
// first CUDA error.
extern "C" int raster_launch(const void* verts, const void* faces, const void* attrs,
                             long long attr_mesh_stride, void* zbuf, void* depth, void* face_out, void* b0_out,
                             void* b1_out, void* planes, void* overflow, int M, int V, int F, int H, int W,
                             int n_lin, int n_const, int z_grads, int cull_sign, void* stream) {
  if (M <= 0 || H <= 0 || W <= 0) return 0;
  if (V <= 0 || F < 0 || n_lin < 0 || n_const < 0 || cull_sign < -1 || cull_sign > 1)
    return (int)cudaErrorInvalidValue;
  if ((n_lin + n_const > 0) != (attrs != nullptr)) return (int)cudaErrorInvalidValue;
  if ((n_lin + n_const + (z_grads ? 2 : 0) > 0) != (planes != nullptr)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const long long pixels = (long long)M * H * W;
  cudaError_t err = cudaMemsetAsync(zbuf, 0xff, pixels * sizeof(unsigned long long), s);
  if (err == cudaSuccess) err = cudaMemsetAsync(overflow, 0, (size_t)M * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  const long long faces_total = (long long)M * F;
  if (faces_total > 0) {
    const long long blocks = (faces_total + kThreads - 1) / kThreads;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    raster_kernel<<<(unsigned)blocks, kThreads, 0, s>>>((const float*)verts, (const int*)faces,
                                                        (unsigned long long*)zbuf, (int*)overflow, M, V, F, H,
                                                        W, cull_sign);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (pixels + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  resolve_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
      (const float*)verts, (const int*)faces, (const float*)attrs, attr_mesh_stride,
      (const unsigned long long*)zbuf, (float*)depth, (int*)face_out, (float*)b0_out, (float*)b1_out,
      (float*)planes, M, V, F, H, W, n_lin, n_const, z_grads);
  return (int)cudaGetLastError();
}
