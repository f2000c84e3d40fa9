// Kernel K6: exact z-buffered rasterization over tile-culled 64-face chunks.
//
// Replaces the TPU kernel `_raster_kernel` of
// humaniflow_tpu/render/pallas_rasterizer.py (called through
// `rasterize_pallas`).  The TPU walked a grid of (mesh, 32x128 pixel tile,
// 64-face chunk) in order, keeping the tile's running (depth, face,
// barycentrics) in VMEM across the chunk axis, and skipped a chunk whose
// screen bounds miss the tile.  Here nothing carries over between blocks:
//
// * `setup_kernel`, one block of 64 threads per (mesh, chunk), gathers each
//   face's screen vertices, computes its signed area and 1/area, and packs
//   16 floats per face [x1 y1 x2 y2 (x2-x1) (y2-y1) (x0-x2) (y0-y2) z0 z1 z2
//   inv valid 0 0 0] and 12 floats of cull constants (below); it reduces
//   the chunk's bounds [ymin ymax xmin xmax] over its real faces (padding
//   and faces with an out-of-range vertex index excluded; NaN propagates,
//   as jnp.min does, so a chunk holding a NaN coordinate is culled
//   everywhere, as on the TPU).
// * `raster_kernel`, one block of 1024 threads per (mesh, 8x128 pixel
//   band).  Each warp owns a 4x8 sub-block of the band, one pixel a lane.
//   The block lists, in order, the chunks whose bounds overlap the band's
//   32x128 culling tile (the TPU kernel's test: the chunks walked are
//   exactly the TPU kernel's).  It streams them through shared memory in
//   batches of 14 live chunks (cp.async, the next batch loading while this
//   one is walked), and for each chunk decides which faces may cover which
//   warp's sub-block: warp w evaluates faces w and w + 32 with lane i on
//   sub-block i, and a ballot packs each face's 32 bits.  Each warp then
//   walks, in increasing index order, only the chunk's faces whose bit for
//   its sub-block is set: the skip is uniform across the warp, and two
//   faces are tested at a time (independent tests, taken in order).  The
//   running (depth, face, w0, w1, w2) stays in registers; take = z < depth
//   (strict), so the lowest face index wins a tie.  Two barriers a batch:
//   a warp's walk of one chunk waits on no other warp's.
//
// The cull is proved safe against the rounded per-pixel formula, not the
// face's geometry: a nearly degenerate face can be claimed by the rounding
// at pixel centres outside its box (a sliver's edge functions beyond its tip
// are far below the rounding of the edge terms), so a box test could drop a
// pixel the twin keeps.  The per-pixel formula (float32, one rounding per
// operation, u = 2^-24, and gx, gy exact):
//   w0 = fl(fl(fl(DX0 fl(gy-Y1)) - fl(DY0 fl(gx-X1))) INV),  E0 = DX0(gy-Y1) - DY0(gx-X1)
//   w1 likewise with (DX1, DY1, X2, Y2);   w2 = fl(fl(1 - w0) - w1).
// A face is skipped for a sub-block R (centres cx +- 3.5, cy +- 1.5) only if
// one of these holds at every centre of R:
//   w0 < 0.  |fl-chain of E0 - E0| <= 3.01u A0 + 4h(1+|DX0|+|DY0|), with
//     A0 = |DX0||gy-Y1| + |DY0||gx-X1| <= a0 = |DX0|(H+1+|Y1|) + |DY0|(W+1+|X1|)
//     and h <= 2^-126 (underflow, also under flush-to-zero).  With s =
//     sign(INV), w0 < 0 follows from s E0 + 3.01u a0 + ... <= -2^-124/|INV|
//     (so that fl(E0^ INV) is a negative normal number, never -0).  s E0 is
//     linear in (gx, gy): its maximum over R is s E0(cx, cy) + |DY0| 3.5 +
//     |DX0| 1.5.  Test: a0 cx + (b0 cy + k0) < 0 in float32 with
//     a0 = -s DY0, b0 = s DX0 (exact) and
//     k0 = s C0 + |DY0| 3.5 + |DX0| 1.5 + 2^-17 a0 + 2^-100 (1+|DX0|+|DY0|) + 2^-84,
//     C0 = DY0 X1 - DX0 Y1.  The float32 evaluation (four roundings) and the
//     rounding of k0 to float32 add at most ~12.2u a0, the formula 3.01u a0:
//     2^-17 = 128u leaves a safety factor above 8.  2^-84 covers the
//     underflow guard, since skippable faces have |INV| >= 2^-40.
//   w1 < 0: the same with index 1.
//   w2 < 0.  fl(1 - w0) - w1 <= 1 - INV(E0+E1) + 5.1u (|INV|(a0+a1)) + u +
//     2^-122 (1+|INV|)(1+sum|D|), so w2 < 0 when INV(E0+E1) exceeds 1 by
//     that at every centre.  -INV(E0+E1) + 1 is linear: a2 = fl32(INV(DY0+DY1)),
//     b2 = fl32(-INV(DX0+DX1)), k2 = 1 - INV(C0+C1) + |a2| 3.5 + |b2| 1.5 +
//     2^-17 (1 + |INV|(a0+a1)) + 2^-100 (1+|INV|)(1+sum|D|); the rounding
//     of a2, b2 and the evaluation add ~13.2u |INV|(a0+a1) + 4.1u: the
//     safety factor is above 7.
// The constants are computed once per face in float64 (each product of two
// floats exact, one rounding per sum) with the _rn intrinsics in the order
// of the plain version (render/cuda_tiled.py::cull_constants, may_cover), so
// the two decide alike.  A face that is never inside (|area| <= 1e-9, a NaN
// coordinate, an index out of range) gets k = -1 and is always skipped; one
// with a coordinate beyond 2^40, or |area| beyond 2^40, gets k = +inf and is
// never skipped.  Every v is finite, so no NaN reaches the comparison.
//
// Bound: at the visualisation shape (32 meshes of 13,774 faces at 256²)
// the outputs (five planes, 42 MB) and the screen vertices cost ~0.013 ms
// at 3.35 TB/s, and the z-buffer's own work, each face against the pixels
// of its box (~220 tests a face, 13 operations each), ~0.02 ms at the
// float32 peak.  The cull leaves about twice the box's tests (a face of a
// ~15x15 px box meets ~14 sub-blocks of 32 pixels); the cull itself costs
// ~15 operations per (face, sub-block) of a live chunk.
//
// Numerics: every per-pixel operation is written with the round-to-nearest
// intrinsics in the order of the plain PyTorch twin
// (render/cuda_tiled.py::rasterize_tiled_plain), so nvcc cannot contract a
// multiply and an add into an FMA, and depth, face ids and barycentrics
// equal the twin's bit for bit.  A face is inside at a pixel centre when
// w0, w1, w2 >= 0 and |area| > 1e-9; a NaN depth never wins.

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 64;      // faces per chunk
constexpr int kTileRows = 32;   // the culling tile
constexpr int kTileCols = 128;
constexpr int kBandRows = 8;    // rows of one block (a quarter of a tile)
constexpr int kSubRows = 4;     // a warp's sub-block
constexpr int kSubCols = 8;
constexpr int kSubPerRow = kTileCols / kSubCols;                  // 16
constexpr int kWarps = (kBandRows / kSubRows) * kSubPerRow;       // 32
constexpr int kThreads = 32 * kWarps;                             // 1024
constexpr int kPack = 16;       // floats per packed face
constexpr int kCull = 12;       // floats of cull constants per face
constexpr int kTriVec = kChunk * kPack / 4;   // float4s of a chunk's packed faces
constexpr int kCullVec = kChunk * kCull / 4;  // float4s of a chunk's cull constants
constexpr float kBigDepth = 1e9f;
constexpr double kHX = 0.5 * (kSubCols - 1);  // half extents of a sub-block's centres
constexpr double kHY = 0.5 * (kSubRows - 1);

__device__ __forceinline__ float nan_min(float a, float b) { return (a != a || a < b) ? a : b; }
__device__ __forceinline__ float nan_max(float a, float b) { return (a != a || a > b) ? a : b; }
__device__ __forceinline__ double dmul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double dadd(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double dsub(double a, double b) { return __dsub_rn(a, b); }

// The cull constants of one face (see the header), in the order of
// render/cuda_tiled.py::cull_constants.
__device__ void cull_constants(float x1f, float y1f, float x2f, float y2f, float dx0f, float dy0f,
                               float dx1f, float dy1f, float invf, bool valid, int H, int W,
                               float (&q)[kCull]) {
#pragma unroll
  for (int i = 0; i < kCull; ++i) q[i] = 0.f;
  if (!valid) {
    q[2] = q[5] = q[8] = -1.f;
    return;
  }
  const double X1 = x1f, Y1 = y1f, X2 = x2f, Y2 = y2f;
  const double DX0 = dx0f, DY0 = dy0f, DX1 = dx1f, DY1 = dy1f, I = invf;
  const double ai = fabs(I), lim = 0x1p40, dlim = 0x1p41;
  const bool ok = ai >= 0x1p-40 && fabs(X1) <= lim && fabs(Y1) <= lim && fabs(X2) <= lim &&
                  fabs(Y2) <= lim && fabs(DX0) <= dlim && fabs(DY0) <= dlim && fabs(DX1) <= dlim &&
                  fabs(DY1) <= dlim;
  if (!ok) {
    q[2] = q[5] = q[8] = __int_as_float(0x7f800000);  // +inf: never skipped
    return;
  }
  const double s = I > 0.0 ? 1.0 : -1.0;
  const double h1 = (double)(H + 1), w1 = (double)(W + 1);
  const double c0 = dsub(dmul(DY0, X1), dmul(DX0, Y1));
  const double c1 = dsub(dmul(DY1, X2), dmul(DX1, Y2));
  const double a0 = dadd(dmul(fabs(DX0), dadd(h1, fabs(Y1))), dmul(fabs(DY0), dadd(w1, fabs(X1))));
  const double a1 = dadd(dmul(fabs(DX1), dadd(h1, fabs(Y2))), dmul(fabs(DY1), dadd(w1, fabs(X2))));
  const double f0 = dadd(dmul(0x1p-100, dadd(dadd(1.0, fabs(DX0)), fabs(DY0))), 0x1p-84);
  const double f1 = dadd(dmul(0x1p-100, dadd(dadd(1.0, fabs(DX1)), fabs(DY1))), 0x1p-84);
  const double k0 = dadd(dadd(dadd(dmul(s, c0), dmul(fabs(DY0), kHX)), dmul(fabs(DX0), kHY)),
                         dadd(dmul(0x1p-17, a0), f0));
  const double k1 = dadd(dadd(dadd(dmul(s, c1), dmul(fabs(DY1), kHX)), dmul(fabs(DX1), kHY)),
                         dadd(dmul(0x1p-17, a1), f1));
  const double al2 = (double)__double2float_rn(dmul(I, dadd(DY0, DY1)));
  const double be2 = (double)__double2float_rn(-dmul(I, dadd(DX0, DX1)));
  const double g2 = dsub(1.0, dmul(I, dadd(c0, c1)));
  const double sumd = dadd(dadd(dadd(dadd(1.0, fabs(DX0)), fabs(DY0)), fabs(DX1)), fabs(DY1));
  const double m2 = dadd(dmul(0x1p-17, dadd(1.0, dmul(ai, dadd(a0, a1)))),
                         dmul(0x1p-100, dmul(dadd(1.0, ai), sumd)));
  const double k2 = dadd(dadd(dadd(g2, dmul(fabs(al2), kHX)), dmul(fabs(be2), kHY)), m2);
  q[0] = (float)dmul(-s, DY0);
  q[1] = (float)dmul(s, DX0);
  q[2] = __double2float_rn(k0);
  q[3] = (float)dmul(-s, DY1);
  q[4] = (float)dmul(s, DX1);
  q[5] = __double2float_rn(k1);
  q[6] = (float)al2;
  q[7] = (float)be2;
  q[8] = __double2float_rn(k2);
}

__global__ void __launch_bounds__(kChunk) setup_kernel(const float* __restrict__ verts,
                                                       const int* __restrict__ faces,
                                                       float* __restrict__ tri,
                                                       float* __restrict__ cull,
                                                       float* __restrict__ bounds, int V, int F,
                                                       int C, int H, int W) {
  __shared__ float s_red[4][kChunk];
  const int c = blockIdx.x, m = blockIdx.y, k = threadIdx.x;
  const int f = c * kChunk + k;
  float pack[kPack] = {0.f};
  float q[kCull];
#pragma unroll
  for (int i = 0; i < kCull; ++i) q[i] = 0.f;
  q[2] = q[5] = q[8] = -1.f;  // padding: always skipped
  float ymin = kBigDepth, ymax = -kBigDepth, xmin = kBigDepth, xmax = -kBigDepth;
  if (f < F) {
    const int i0 = faces[3 * f], i1 = faces[3 * f + 1], i2 = faces[3 * f + 2];
    if (i0 >= 0 && i0 < V && i1 >= 0 && i1 < V && i2 >= 0 && i2 < V) {
      const float* vm = verts + (long long)m * V * 3;
      const float x0 = vm[3 * i0], y0 = vm[3 * i0 + 1], z0 = vm[3 * i0 + 2];
      const float x1 = vm[3 * i1], y1 = vm[3 * i1 + 1], z1 = vm[3 * i1 + 2];
      const float x2 = vm[3 * i2], y2 = vm[3 * i2 + 1], z2 = vm[3 * i2 + 2];
      const float area = __fsub_rn(__fmul_rn(__fsub_rn(x1, x0), __fsub_rn(y2, y0)),
                                   __fmul_rn(__fsub_rn(x2, x0), __fsub_rn(y1, y0)));
      const bool valid = fabsf(area) > 1e-9f;
      pack[0] = x1;
      pack[1] = y1;
      pack[2] = x2;
      pack[3] = y2;
      pack[4] = __fsub_rn(x2, x1);
      pack[5] = __fsub_rn(y2, y1);
      pack[6] = __fsub_rn(x0, x2);
      pack[7] = __fsub_rn(y0, y2);
      pack[8] = z0;
      pack[9] = z1;
      pack[10] = z2;
      pack[11] = valid ? __fdiv_rn(1.0f, area) : 0.f;
      pack[12] = valid ? 1.f : 0.f;
      cull_constants(x1, y1, x2, y2, pack[4], pack[5], pack[6], pack[7], pack[11], valid, H, W, q);
      ymin = nan_min(nan_min(y0, y1), y2);
      ymax = nan_max(nan_max(y0, y1), y2);
      xmin = nan_min(nan_min(x0, x1), x2);
      xmax = nan_max(nan_max(x0, x1), x2);
    }
  }
  const long long face = (long long)m * C * kChunk + f;
  float4* dst = reinterpret_cast<float4*>(tri + face * kPack);
#pragma unroll
  for (int i = 0; i < kPack / 4; ++i)
    dst[i] = make_float4(pack[4 * i], pack[4 * i + 1], pack[4 * i + 2], pack[4 * i + 3]);
  float4* cdst = reinterpret_cast<float4*>(cull + face * kCull);
#pragma unroll
  for (int i = 0; i < kCull / 4; ++i)
    cdst[i] = make_float4(q[4 * i], q[4 * i + 1], q[4 * i + 2], q[4 * i + 3]);

  s_red[0][k] = ymin;
  s_red[1][k] = ymax;
  s_red[2][k] = xmin;
  s_red[3][k] = xmax;
  __syncthreads();
  for (int s = kChunk / 2; s > 0; s >>= 1) {
    if (k < s) {
      s_red[0][k] = nan_min(s_red[0][k], s_red[0][k + s]);
      s_red[1][k] = nan_max(s_red[1][k], s_red[1][k + s]);
      s_red[2][k] = nan_min(s_red[2][k], s_red[2][k + s]);
      s_red[3][k] = nan_max(s_red[3][k], s_red[3][k + s]);
    }
    __syncthreads();
  }
  if (k < 4) bounds[((long long)m * C + c) * 4 + k] = s_red[k][0];
}

constexpr int kBatch = 14;  // live chunks per barrier
constexpr int kBatchTri = kBatch * kTriVec, kBatchCull = kBatch * kCullVec;

struct __align__(16) Stage {
  float4 tri[2][kBatchTri];    // packed faces of two batches of chunks
  float4 cull[2][kBatchCull];  // their cull constants
  unsigned mask[kBatch][kChunk];  // per face of the current batch: which warps' sub-blocks it may cover
  int list[kThreads];          // the live chunks of the current group, in order
  int warp_count[kWarps];
  int warp_off[kWarps];
  int n;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// Start copying the live chunks list[first .. first + count) into buffer b.
__device__ __forceinline__ void stage_batch(Stage& s, int b, const float4* __restrict__ tm,
                                            const float4* __restrict__ cm, int first, int count) {
  for (int e = threadIdx.x; e < count * (kTriVec + kCullVec); e += kThreads) {
    const int i = e / (kTriVec + kCullVec), r = e - i * (kTriVec + kCullVec);
    const long long c = s.list[first + i];
    if (r < kTriVec)
      cp_async16(&s.tri[b][i * kTriVec + r], tm + c * kTriVec + r);
    else
      cp_async16(&s.cull[b][i * kCullVec + r - kTriVec], cm + c * kCullVec + (r - kTriVec));
  }
}

// Which warps' sub-blocks each face of the batch may cover, into s.mask:
// warp w decides faces w and w + 32 of every chunk, lane i for sub-block i
// at centre (cx, cy); v < 0 for one test skips (see the header).
__device__ __forceinline__ void cull_masks(Stage& s, int b, int count, float cx, float cy) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = 0; i < count; ++i) {
#pragma unroll
    for (int h = 0; h < kChunk / kWarps; ++h) {
      const int f = warp + kWarps * h;
      const float4* q = &s.cull[b][i * kCullVec + 3 * f];
      const float4 q0 = q[0], q1 = q[1], q2 = q[2];
      const float v0 = __fadd_rn(__fmul_rn(q0.x, cx), __fadd_rn(__fmul_rn(q0.y, cy), q0.z));
      const float v1 = __fadd_rn(__fmul_rn(q0.w, cx), __fadd_rn(__fmul_rn(q1.x, cy), q1.y));
      const float v2 = __fadd_rn(__fmul_rn(q1.z, cx), __fadd_rn(__fmul_rn(q1.w, cy), q2.x));
      const unsigned bits = __ballot_sync(0xffffffffu, !(v0 < 0.f || v1 < 0.f || v2 < 0.f));
      if (lane == 0) s.mask[i][f] = bits;
    }
  }
}

// The per-pixel test of packed face p against this lane's centre.
struct Hit {
  float w0, w1, w2, z;
  bool inside;
};
__device__ __forceinline__ Hit pixel_test(const float4* __restrict__ p, float gx, float gy) {
  const float4 p0 = p[0], p1 = p[1], p2 = p[2], p3 = p[3];
  // p0 = (x1, y1, x2, y2), p1 = (x2-x1, y2-y1, x0-x2, y0-y2), p2 = (z0, z1, z2, inv),
  // p3.x = valid
  Hit h;
  h.w0 = __fmul_rn(__fsub_rn(__fmul_rn(p1.x, __fsub_rn(gy, p0.y)), __fmul_rn(p1.y, __fsub_rn(gx, p0.x))),
                   p2.w);
  h.w1 = __fmul_rn(__fsub_rn(__fmul_rn(p1.z, __fsub_rn(gy, p0.w)), __fmul_rn(p1.w, __fsub_rn(gx, p0.z))),
                   p2.w);
  h.w2 = __fsub_rn(__fsub_rn(1.0f, h.w0), h.w1);
  h.z = __fadd_rn(__fadd_rn(__fmul_rn(h.w0, p2.x), __fmul_rn(h.w1, p2.y)), __fmul_rn(h.w2, p2.z));
  h.inside = p3.x != 0.f && h.w0 >= 0.f && h.w1 >= 0.f && h.w2 >= 0.f;
  return h;
}

__global__ void __launch_bounds__(kThreads, 1)
    raster_kernel(const float* __restrict__ tri, const float* __restrict__ cull,
                  const float* __restrict__ bounds, float* __restrict__ depth_out,
                  int* __restrict__ face_out, float* __restrict__ bary_out, int C, int H, int W) {
  extern __shared__ float4 dyn[];
  Stage& s = *reinterpret_cast<Stage*>(dyn);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m = blockIdx.z;
  const int band0 = blockIdx.y * kBandRows, col0 = blockIdx.x * kTileCols;
  const float tile_row0 = (float)(band0 / kTileRows * kTileRows), tile_col0 = (float)col0;
  // this lane's pixel, in its warp's sub-block
  const int row = band0 + (warp / kSubPerRow) * kSubRows + lane / kSubCols;
  const int col = col0 + (warp % kSubPerRow) * kSubCols + lane % kSubCols;
  const float gx = __fadd_rn((float)col, 0.5f);
  const float gy = __fadd_rn((float)row, 0.5f);
  // the centre of sub-block `lane`, for the cull
  const float cx = (float)(col0 + (lane % kSubPerRow) * kSubCols + kSubCols / 2);
  const float cy = (float)(band0 + (lane / kSubPerRow) * kSubRows + kSubRows / 2);
  const float* bm = bounds + (long long)m * C * 4;
  const float4* tm = reinterpret_cast<const float4*>(tri + (long long)m * C * kChunk * kPack);
  const float4* cm = reinterpret_cast<const float4*>(cull + (long long)m * C * kChunk * kCull);

  float best = kBigDepth, b0 = 0.f, b1 = 0.f, b2 = 0.f;
  int best_f = -1;
  // the running winner takes the candidate (w0, w1, w2, z) of face f when strictly nearer
  auto take = [&](const Hit& h, int f) {
    if (h.inside && h.z < best) {
      best = h.z;
      best_f = f;
      b0 = h.w0;
      b1 = h.w1;
      b2 = h.w2;
    }
  };
  for (int base = 0; base < C; base += kThreads) {
    __syncthreads();  // the previous group's list and buffers are no longer read
    const int i = base + tid;
    bool live = false;
    if (i < C) {
      const float* bc = bm + (long long)i * 4;
      live = (bc[1] >= tile_row0) & (bc[0] <= tile_row0 + (float)kTileRows) & (bc[3] >= tile_col0) &
             (bc[2] <= tile_col0 + (float)kTileCols);
    }
    const unsigned ball = __ballot_sync(0xffffffffu, live);
    if (lane == 0) s.warp_count[warp] = __popc(ball);
    __syncthreads();
    if (warp == 0) {
      const int cnt = s.warp_count[lane];
      int incl = cnt;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += y;
      }
      s.warp_off[lane] = incl - cnt;
      if (lane == 31) s.n = incl;
    }
    __syncthreads();
    if (live) s.list[s.warp_off[warp] + __popc(ball & ((1u << lane) - 1u))] = i;
    __syncthreads();
    const int n = s.n;
    if (n == 0) continue;
    stage_batch(s, 0, tm, cm, 0, min(kBatch, n));
    cp_async_commit();
    for (int first = 0, bi = 0; first < n; first += kBatch, bi ^= 1) {
      const int count = min(kBatch, n - first);
      cp_async_wait_all();  // this batch has landed
      __syncthreads();      // ... for every thread; the previous batch's walk is done
      if (first + kBatch < n) stage_batch(s, bi ^ 1, tm, cm, first + kBatch, min(kBatch, n - first - kBatch));
      cp_async_commit();
      cull_masks(s, bi, count, cx, cy);
      __syncthreads();  // the batch's masks are visible
      for (int ci = 0; ci < count; ++ci) {
        // walk the chunk's faces that may cover this warp's sub-block, in
        // increasing order, two at a time (independent tests, taken in order)
        const unsigned* mk = s.mask[ci];
        const unsigned lo = __ballot_sync(0xffffffffu, (mk[lane] >> warp) & 1u);
        const unsigned hi = __ballot_sync(0xffffffffu, (mk[lane + 32] >> warp) & 1u);
        unsigned long long todo = (unsigned long long)lo | ((unsigned long long)hi << 32);
        const float4* st = &s.tri[bi][ci * kTriVec];
        const int face0 = s.list[first + ci] * kChunk;
        while (todo) {
          const int k = __ffsll((long long)todo) - 1;
          todo &= todo - 1;
          if (todo) {
            const int k2 = __ffsll((long long)todo) - 1;
            todo &= todo - 1;
            const Hit h = pixel_test(st + 4 * k, gx, gy);
            const Hit h2 = pixel_test(st + 4 * k2, gx, gy);
            take(h, face0 + k);
            take(h2, face0 + k2);
          } else {
            take(pixel_test(st + 4 * k, gx, gy), face0 + k);
          }
        }
      }
    }
  }
  if (row < H && col < W) {
    const long long px = ((long long)m * H + row) * W + col;
    depth_out[px] = best;
    face_out[px] = best_f;
    bary_out[3 * px] = b0;
    bary_out[3 * px + 1] = b1;
    bary_out[3 * px + 2] = b2;
  }
}

}  // namespace

// verts: (M, V, 3) float32 screen coordinates (x = column, y = row, depth);
// faces: (F, 3) int32; tri: (M, C·64, 16) and cull: (M, C·64, 12) float32
// scratch, 16-byte aligned; bounds: (M, C, 4) float32 scratch; depth:
// (M, H, W) float32; face: (M, H, W) int32; bary: (M, H, W, 3) float32;
// C = ceil(F / 64); H a multiple of 32 and W of 128.  All device pointers,
// contiguous.  Launch on `stream`; return cudaGetLastError().
extern "C" int tiled_raster_launch(const void* verts, const void* faces, void* tri, void* cull,
                                   void* bounds, void* depth, void* face, void* bary, int M, int V,
                                   int F, int H, int W, void* stream) {
  if (M <= 0 || H <= 0 || W <= 0) return 0;
  if (V <= 0 || F <= 0 || H % kTileRows != 0 || W % kTileCols != 0 || M > 65535)
    return (int)cudaErrorInvalidValue;
  const int C = (F + kChunk - 1) / kChunk;
  cudaStream_t s = (cudaStream_t)stream;
  setup_kernel<<<dim3(C, M), kChunk, 0, s>>>((const float*)verts, (const int*)faces, (float*)tri,
                                             (float*)cull, (float*)bounds, V, F, C, H, W);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  static bool sized = false;  // the kernel's attribute, set once per process
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        raster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sizeof(Stage));
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  raster_kernel<<<dim3(W / kTileCols, H / kBandRows, M), kThreads, sizeof(Stage), s>>>(
      (const float*)tri, (const float*)cull, (const float*)bounds, (float*)depth, (int*)face,
      (float*)bary, C, H, W);
  return (int)cudaGetLastError();
}
