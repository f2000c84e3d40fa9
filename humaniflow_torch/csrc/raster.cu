// Kernel K4: exact z-buffer with in-kernel attribute interpolation.
//
// Replaces the TPU kernel `_make_kernel` of
// humaniflow_tpu/render/binned_rasterizer.py (called through
// `_rasterize_binned_impl`, `rasterize_binned_with_attrs` and
// `rasterize_binned`).  The TPU binned faces into 8x128-pixel strips of fixed
// capacity because it has no scatter and no atomics: a grid step z-tested one
// strip against its face window held in registers, and candidates beyond a
// strip's capacity were dropped.  None of that is carried over.
//
// The function: a face is kept when its nine screen coordinates are finite,
// its vertex indices lie in [0, V), |signed area| > 1e-9, and signed area *
// cull_sign > 0 unless cull_sign is 0.  With the edge-plane coefficients
// [a0 b0 c0 a1 b1 c1 za zb zc] (w0 = a0 x + b0 y + c0, w1 = a1 x + b1 y + c1,
// w2 = 1 - w0 - w1, z = za x + zb y + zc) every pixel centre (col + 0.5,
// row + 0.5) of the face's bounding box widened by one pixel is tested; where
// min(w0, w1, w2) >= 0 and z is finite and below BIG_DEPTH, the key
// (order-preserving bits of z) << 32 | face id competes for the pixel.  The
// smallest key wins: the smallest z, and of equal z the lowest face id, as in
// the exact scan (render/rasterizer.py in both packages).  At the winner the
// kernel writes the depth, optionally the face id and (w0, w1), the n_lin
// interpolated attribute planes (d0 w0 + d1 w1 + c), the n_const constant
// planes and, with z_grads, the winner's (za, zb); empty pixels get depth
// BIG_DEPTH, face -1 and zeros.  There is no capacity: `overflow` counts per
// mesh only the faces with an out-of-range index.
//
// Bound on an H100 at the training shape (72 meshes of 13,774 faces, 256^2,
// four constant planes, culled): 1.26e8 pixel tests of the faces' widened
// boxes (13 operations each) cost ~0.02 ms at the 67 TFLOP/s float32 peak;
// the outputs (five planes, 94 MB) and the inputs (screen vertices and
// attributes, 23 MB) ~0.035 ms at 3.35 TB/s.  So the function is bound by
// bytes, and what costs time is everything around the tests.  The first
// design (one thread per face, a 64-bit global atomicMin per hit into a 38
// MB key buffer, then a resolve pass) took 1.38 ms on an `NVIDIA H100 80GB
// HBM3, 700.00 W`: a warp waited for its
// largest box, every hit went to device memory, and the resolve read the
// key buffer back.  This design, after K3 (csrc/coverage.cu):
//
// * Pass 1 (face_bands_kernel), one thread per (mesh, face), applies the
//   keep test once and marks each kept face in a bit mask per band of
//   kBandRows rows that its widened box meets, and counts the faces with an
//   index out of range in `overflow`: once per mesh.
// * Pass 2 (raster_kernel): one block owns one (mesh, tile).  The tile
//   (render/cuda_raster.py::tile_plan: whole rows of up to 256 columns, as
//   many rows as the keys budget holds; 16 rows of 256 at 256^2) keeps its
//   64-bit keys in dynamic shared memory, set with shared atomicMin only
//   where a plain read shows the key would fall.  The global key buffer
//   and its memset are gone.  A warp reads the band masks of 32 chunks of
//   32 faces at once and walks only the chunks with a face marked in its
//   tile's bands.  Blocks take the row tiles from the image's middle
//   outwards: the rows through a body hold ten times the faces of the
//   others, so the long blocks start first.
// * In a chunk, each lane sets up one marked face (box clipped to the tile,
//   coefficients, the span constants below) into its warp's face table in
//   shared memory.  The faces' boxes are cut into units of kPiece columns
//   of one row, concatenated face after face; the warp steps through them
//   32 at a time, each lane finding its face by a binary search of a warp
//   scan, so that a warp's work is the sum of its boxes, not 32 times the
//   largest.  Each lane cuts its unit to the face's row span (row_span: a
//   bound proved against the rounded per-pixel formula, so that no pixel
//   the twin finds inside is dropped; about a third of a box's pixels on
//   posed bodies), and the step's span pixels are tested 32 at a time, each
//   lane finding its unit by a second search; an inside pixel's key
//   competes at once.
// * A face whose clipped box exceeds kBigPx pixels is queued and walked
//   afterwards by the whole block, so that one stretched face does not hold
//   up its warp.
// * After a barrier the block resolves its own tile: it decodes each key,
//   recomputes the winner's coefficients with the same operations (the
//   winner's vertices are in L1 or L2: a mesh's screen vertices are 94 KB),
//   and writes every output element of the tile once, consecutive threads on
//   consecutive pixels (four planes as one 16-byte store).
//
// On `NVIDIA H100 80GB HBM3, 700.00 W` it takes ~0.52 ms at the training
// shape (PERF.md, Findings).  What holds it back: the rows through the
// body hold most faces, so the tiles there take ten times as long as the
// others; and each warp step is a chain of shuffles, searches and shared
// atomics whose latency 32 warps an SM do not hide.

// Numerics: every operation is written with the round-to-nearest intrinsics
// in the order of `_edge_plane_coeffs` and of the plain PyTorch twin
// (render/cuda_raster.py::raster_plain), so that nvcc cannot contract a
// multiply and an add into an FMA, and the per-pixel minimum does not depend
// on the order of the atomics: depth, winners and planes equal the twin's bit
// for bit, and the output is the same on every launch.  64-bit offsets.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxTileKeys = 20480;  // 160 KB of keys, the most a tile may take
constexpr int kPiece = 32;           // columns of one row in a unit
constexpr int kBigPx = 4096;         // larger clipped boxes are walked by the whole block
constexpr int kQueue = 64;
constexpr int kBandRows = 8;         // pass 1 marks each kept face in the bands of 8 rows its box meets
constexpr float kBigDepth = 1e9f;
constexpr unsigned long long kEmpty = ~0ull;
constexpr unsigned kFull = 0xffffffffu;

struct Tile {  // pixel rows [r0, r1] and columns [c0, c1] of the image; keys row-major, tc a row
  int r0, r1, c0, c1, tc;
};

struct Face {  // coefficients, span constants, face id and box clipped to image and tile
  float c[9];   // a0 b0 c0 a1 b1 c1 za zb zc
  float m2;     // twice the span margin M, or -1: no span cull for this face
  float rc[3];  // reciprocals of the span slopes a0, a1, -(a0 + a1)
  int f, col_lo, col_hi, row_lo, row_hi;
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

__device__ __forceinline__ float signed_area(const float p[9]) {
  const float x0 = p[0], y0 = p[1], x1 = p[3], y1 = p[4], x2 = p[6], y2 = p[7];
  return __fsub_rn(__fmul_rn(__fsub_rn(x1, x0), __fsub_rn(y2, y0)),
                   __fmul_rn(__fsub_rn(x2, x0), __fsub_rn(y1, y0)));
}

// Edge-plane coefficients in the order of `_edge_plane_coeffs`.
__device__ __forceinline__ void coefficients(const float p[9], float area, float c[9]) {
  const float x0 = p[0], y0 = p[1], z0 = p[2], x1 = p[3], y1 = p[4], z1 = p[5];
  const float x2 = p[6], y2 = p[7], z2 = p[8];
  const float inv = __fdiv_rn(1.0f, area);
  c[0] = __fmul_rn(-__fsub_rn(y2, y1), inv);
  c[1] = __fmul_rn(__fsub_rn(x2, x1), inv);
  c[2] = __fmul_rn(__fsub_rn(__fmul_rn(__fsub_rn(y2, y1), x1), __fmul_rn(__fsub_rn(x2, x1), y1)), inv);
  c[3] = __fmul_rn(-__fsub_rn(y0, y2), inv);
  c[4] = __fmul_rn(__fsub_rn(x0, x2), inv);
  c[5] = __fmul_rn(__fsub_rn(__fmul_rn(__fsub_rn(y0, y2), x2), __fmul_rn(__fsub_rn(x0, x2), y2)), inv);
  const float dz0 = __fsub_rn(z0, z2), dz1 = __fsub_rn(z1, z2);
  c[6] = __fadd_rn(__fmul_rn(c[0], dz0), __fmul_rn(c[3], dz1));
  c[7] = __fadd_rn(__fmul_rn(c[1], dz0), __fmul_rn(c[4], dz1));
  c[8] = __fadd_rn(__fadd_rn(__fmul_rn(c[2], dz0), __fmul_rn(c[5], dz1)), z2);
}

// The vertex indices and screen coordinates of face f of the mesh at vm;
// false when an index is out of range.
__device__ __forceinline__ bool load_face(const float* __restrict__ vm, const int* __restrict__ faces, int f,
                                          int V, float p[9]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int i = __ldg(faces + 3 * (long long)f + k);
    if (i < 0 || i >= V) return false;
    p[3 * k] = __ldg(vm + 3 * (long long)i);
    p[3 * k + 1] = __ldg(vm + 3 * (long long)i + 1);
    p[3 * k + 2] = __ldg(vm + 3 * (long long)i + 2);
  }
  return true;
}

// The face's bounding box widened by one pixel and clipped to the image, as
// whole numbers (so the int conversions are exact); empty (lo > hi) when it
// misses the image.  NaN coordinates only widen it; such faces are not kept.
__device__ __forceinline__ void widened_box(const float p[9], int H, int W, int& col_lo, int& col_hi, int& row_lo,
                                            int& row_hi) {
  const float cx_lo = fmaxf(floorf(fminf(fminf(p[0], p[3]), p[6])) - 1.f, 0.f);
  const float cx_hi = fminf(ceilf(fmaxf(fmaxf(p[0], p[3]), p[6])) + 1.f, (float)(W - 1));
  const float cy_lo = fmaxf(floorf(fminf(fminf(p[1], p[4]), p[7])) - 1.f, 0.f);
  const float cy_hi = fminf(ceilf(fmaxf(fmaxf(p[1], p[4]), p[7])) + 1.f, (float)(H - 1));
  const bool empty = !(cx_lo <= cx_hi && cy_lo <= cy_hi);
  col_lo = empty ? 1 : (int)cx_lo, col_hi = empty ? 0 : (int)cx_hi;
  row_lo = empty ? 1 : (int)cy_lo, row_hi = empty ? 0 : (int)cy_hi;
}

// Pass 1, one thread per (mesh, face): whether the face is kept (indices in
// range, nine finite coordinates, |area| > 1e-9, area * cull_sign > 0 unless
// cull_sign is 0) and its widened box meets the image; if so its bit is set
// in the mask of each band of kBandRows rows the box meets (bits: (M, bands,
// ceil(F / 32)) words, zeroed by the launch).  A face with an index out of
// range is counted in its mesh's overflow.
__global__ void face_bands_kernel(const float* __restrict__ verts, const int* __restrict__ faces,
                                  unsigned* __restrict__ bits, int* __restrict__ overflow, int M, int V, int F,
                                  int H, int W, int cull_sign) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)M * F) return;
  const int m = (int)(idx / F), f = (int)(idx % F);
  float p[9];
  if (!load_face(verts + (long long)m * V * 3, faces, f, V, p)) {
    atomicAdd(overflow + m, 1);
    return;
  }
  bool kept = true;
#pragma unroll
  for (int k = 0; k < 9; ++k) kept &= isfinite(p[k]);
  const float area = signed_area(p);
  kept &= fabsf(area) > 1e-9f;
  if (cull_sign != 0) kept &= __fmul_rn(area, (float)cull_sign) > 0.f;
  int col_lo, col_hi, row_lo, row_hi;
  widened_box(p, H, W, col_lo, col_hi, row_lo, row_hi);
  if (!kept || col_lo > col_hi || row_lo > row_hi) return;
  const int bands = (H + kBandRows - 1) / kBandRows, wpb = (F + 31) >> 5;
  unsigned* mb = bits + (long long)m * bands * wpb + (f >> 5);
  for (int b = row_lo / kBandRows; b <= row_hi / kBandRows; ++b) atomicOr(mb + (long long)b * wpb, 1u << (f & 31));
}

constexpr float kSpanLimit = 0x1p100f;  // faces whose margin sum S exceeds it are not culled
constexpr float kQLimit = 0x1p20f;

// The span constants of a face with coefficients c (render/cuda_raster.py::
// span_constants is the same): S = 1 + (|a0| + |a1|) W + (|b0| + |b1|) H +
// |c0| + |c1| (float32, in that order), 2M = S 2^-19, and the reciprocals
// of the slopes a0, a1 and -(a0 + a1).  No cull unless S <= 2^100.
__device__ __forceinline__ void span_setup(Face& fc, int H, int W) {
  const float* c = fc.c;
  const float s = __fadd_rn(
      __fadd_rn(__fadd_rn(__fadd_rn(1.0f, __fmul_rn(__fadd_rn(fabsf(c[0]), fabsf(c[3])), (float)W)),
                          __fmul_rn(__fadd_rn(fabsf(c[1]), fabsf(c[4])), (float)H)),
                fabsf(c[2])),
      fabsf(c[5]));
  fc.m2 = s <= kSpanLimit ? __fmul_rn(s, 0x1p-19f) : -1.f;
  fc.rc[0] = __frcp_rn(c[0]);
  fc.rc[1] = __frcp_rn(c[3]);
  fc.rc[2] = __frcp_rn(-__fadd_rn(c[0], c[3]));
}

// The columns [lo, hi] of pixel row `row` outside which the face is inside
// at no pixel centre by the rounded formula (render/cuda_raster.py::
// row_spans is the same; lo > hi: at none).  With the exact sign of each
// final rounded sum, w0 >= 0 implies L0 = a0 gx + b0 gy + c0 >= -2.01u A0,
// A0 = |a0 gx| + |b0 gy| (u = 2^-24; and 2^-148 against underflow); the
// same for w1; w2 >= 0 implies 1 - L0 - L1 >= -4.1u (1 + A0 + A1 + |c0| +
// |c1|).  So a centre inside has alpha_i gx + beta_i >= -2M for the three
// slopes alpha = (a0, a1, -(a0 + a1)) and the float32 intercepts
// beta0 = b0 gy + c0, beta1 = b1 gy + c1, beta2 = (1 - beta0) - beta1: those
// bounds and the rounding of alpha and beta come to at most 8.2u S, and
// 2M = S 2^-19 = 32u S.  Then gx >= R_i / alpha_i for alpha_i > 0 (<= for
// < 0), R_i = -2M - beta_i, and q = fl(R_i rc_i) is that bound within
// 3.01u |q|, 0.19 px while |q| <= 2^20: the columns floor(q) - 1 and
// floor(q) + 1 keep a pixel of slack.  |q| > 2^20 or q = +-inf decides the
// row or nothing, a NaN q nothing; alpha_i = 0 empties the row when R_i > 0.
// (S is the float32 sum, at least 1 - 6u times the exact one.)
__device__ __forceinline__ void row_span(const float (&c)[6], float m2, const float (&rc)[3], int row,
                                         int& lo, int& hi) {
  lo = -0x7fffffff, hi = 0x7fffffff;
  if (m2 < 0.f) return;
  const float gy = __fadd_rn((float)row, 0.5f);
  const float beta0 = __fadd_rn(__fmul_rn(c[1], gy), c[2]), beta1 = __fadd_rn(__fmul_rn(c[4], gy), c[5]);
  const float alpha[3] = {c[0], c[3], -__fadd_rn(c[0], c[3])};
  const float beta[3] = {beta0, beta1, __fsub_rn(__fsub_rn(1.0f, beta0), beta1)};
  bool empty = false;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float r = __fsub_rn(-m2, beta[i]);
    const float q = __fmul_rn(r, rc[i]);
    if (alpha[i] > 0.f) {
      empty |= q > kQLimit;
      if (q >= -kQLimit && q <= kQLimit) lo = max(lo, (int)floorf(q) - 1);
    } else if (alpha[i] < 0.f) {
      empty |= q < -kQLimit;
      if (q >= -kQLimit && q <= kQLimit) hi = min(hi, (int)floorf(q) + 1);
    } else {
      empty |= r > 0.f;
    }
  }
  if (empty) lo = 1, hi = 0;
}

// Whether the pixel centre (col, row) is inside the face with coefficients c.
__device__ __forceinline__ bool inside(const float (&c)[6], int row, int col) {
  const float gx = __fadd_rn((float)col, 0.5f), gy = __fadd_rn((float)row, 0.5f);
  const float w0 = __fadd_rn(__fadd_rn(__fmul_rn(c[0], gx), __fmul_rn(c[1], gy)), c[2]);
  const float w1 = __fadd_rn(__fadd_rn(__fmul_rn(c[3], gx), __fmul_rn(c[4], gy)), c[5]);
  const float w2 = __fsub_rn(__fsub_rn(1.0f, w0), w1);
  return w0 >= 0.f && w1 >= 0.f && w2 >= 0.f;
}

// Face f of the mesh at vm, kept (pass 1 marked it): true (and fc filled)
// when its widened box meets the tile.
__device__ __forceinline__ bool face_setup(const float* __restrict__ vm, const int* __restrict__ faces,
                                           int f, int V, int H, int W, const Tile& t, Face& fc) {
  float p[9];
  load_face(vm, faces, f, V, p);  // its indices are in range
  widened_box(p, H, W, fc.col_lo, fc.col_hi, fc.row_lo, fc.row_hi);
  fc.col_lo = max(fc.col_lo, t.c0);
  fc.col_hi = min(fc.col_hi, t.c1);
  fc.row_lo = max(fc.row_lo, t.r0);
  fc.row_hi = min(fc.row_hi, t.r1);
  if (fc.col_lo > fc.col_hi || fc.row_lo > fc.row_hi) return false;
  coefficients(p, signed_area(p), fc.c);
  span_setup(fc, H, W);
  fc.f = f;
  return true;
}

// A unit is kPiece columns (fewer at the box's right edge) of one row of a
// face's box; unit `local` of a box lies in row local / pieces.
struct Unit {
  int row, col0, ncols;
};

__device__ __forceinline__ int pieces_of(int col_lo, int col_hi) { return (col_hi - col_lo + kPiece) / kPiece; }

__device__ __forceinline__ Unit unit_of(int col_lo, int col_hi, int row_lo, int local) {
  const int pieces = pieces_of(col_lo, col_hi);
  // local / pieces through a float reciprocal (local < 2^24), corrected by one
  int dr = (int)__fmul_rn((float)local, __frcp_rn((float)pieces));
  dr -= dr * pieces > local;
  dr += (dr + 1) * pieces <= local;
  Unit u;
  u.row = row_lo + dr;
  u.col0 = col_lo + (local - dr * pieces) * kPiece;
  u.ncols = min(kPiece, col_hi - u.col0 + 1);
  return u;
}

// Let face f's key at pixel (row, col) of the tile compete, if its depth
// (za, zb, zc) there is finite and below BIG_DEPTH.
__device__ __forceinline__ void compete(float za, float zb, float zc, int f, int row, int col,
                                        unsigned long long* keys, const Tile& t) {
  const float gx = __fadd_rn((float)col, 0.5f), gy = __fadd_rn((float)row, 0.5f);
  const float z = __fadd_rn(__fadd_rn(__fmul_rn(za, gx), __fmul_rn(zb, gy)), zc);
  if (isfinite(z) && z < kBigDepth) {
    const unsigned long long key = ((unsigned long long)order_bits(z) << 32) | (unsigned int)f;
    unsigned long long* k = keys + (row - t.r0) * t.tc + (col - t.c0);
    if (key < *k) atomicMin(k, key);
  }
}

// Lane of the warp whose inclusive count `incl` first exceeds x (x below the
// warp's total): a binary search of the warp scan.
__device__ __forceinline__ int owner_lane(int incl, int x) {
  int j = 0;
#pragma unroll
  for (int step = 16; step; step >>= 1)
    if (__shfl_sync(kFull, incl, j + step - 1) <= x) j += step;
  return j;
}

__device__ __forceinline__ int warp_inclusive_sum(int x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

// Grid: M * row_tiles * col_tiles blocks, one per (mesh, tile).
__global__ void __launch_bounds__(kThreads, 2)
    raster_kernel(const float* __restrict__ verts, const int* __restrict__ faces,
                  const float* __restrict__ attrs, long long attr_mesh_stride, float* __restrict__ depth,
                  int* __restrict__ face_out, float* __restrict__ b0_out, float* __restrict__ b1_out,
                  float* __restrict__ planes, const unsigned* __restrict__ bits, int V, int F, int H, int W,
                  int tile_rows, int tile_cols, int row_tiles, int col_tiles, int n_lin, int n_const,
                  int z_grads) {
  extern __shared__ unsigned long long keys[];
  __shared__ Face queue[kQueue];
  __shared__ Face warp_faces[kWarps][32];  // each warp's current 32 faces
  __shared__ int queued;
  // Blocks take the image's row tiles from the middle outwards (k = 0, 1,
  // 2, ... -> centre, centre + 1, centre - 1, ...; render/cuda_raster.py::
  // block_tile is the same), every mesh's at a time:
  // the rows through a body hold the most faces, so the longest blocks start
  // first and the short ones fill the end.
  const int M = gridDim.x / (row_tiles * col_tiles);
  const int k = (int)(blockIdx.x / (M * col_tiles)), rest = (int)(blockIdx.x % (M * col_tiles));
  const int m = rest / col_tiles;
  const int row_tile = (row_tiles - 1) / 2 + ((k & 1) ? 1 : -1) * ((k + 1) / 2);
  Tile t;
  t.r0 = row_tile * tile_rows;
  t.r1 = min(H, t.r0 + tile_rows) - 1;
  t.c0 = (rest % col_tiles) * tile_cols;
  t.c1 = min(W, t.c0 + tile_cols) - 1;
  t.tc = t.c1 - t.c0 + 1;
  const int npix = (t.r1 - t.r0 + 1) * t.tc;
  for (int i = threadIdx.x; i < npix; i += kThreads) keys[i] = kEmpty;
  if (threadIdx.x == 0) queued = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* vm = verts + (long long)m * V * 3;
  // The chunks of 32 faces with a face marked in a band of the tile: lane l
  // of warp w ORs the bands' words of chunk w + kWarps (l + 32 k) at once,
  // and the warp then walks the chunks whose word is not 0.
  const int chunks = (F + 31) >> 5, bands = (H + kBandRows - 1) / kBandRows;
  const unsigned* mb = bits + (long long)m * bands * chunks;
  for (int base = warp; base < chunks; base += kWarps * 32) {
    const int mine = base + kWarps * lane;
    unsigned word = 0u;
    if (mine < chunks)
      for (int b = t.r0 / kBandRows; b <= t.r1 / kBandRows; ++b) word |= __ldg(mb + (long long)b * chunks + mine);
    for (unsigned live = __ballot_sync(kFull, word != 0u); live; live &= live - 1u) {
      const int src = __ffs(live) - 1;
      const unsigned marked = __shfl_sync(kFull, word, src);
      const int f = ((base + kWarps * src) << 5) + lane;
      Face fc = {};
      const bool kept = ((marked >> lane) & 1u) && face_setup(vm, faces, f, V, H, W, t, fc);
      int n = kept ? (fc.row_hi - fc.row_lo + 1) * pieces_of(fc.col_lo, fc.col_hi) : 0;
      if (n * kPiece > kBigPx) {
        const int q = atomicAdd(&queued, 1);
        if (q < kQueue) {
          queue[q] = fc;
          n = 0;
        }
      }
      Face* wf = warp_faces[warp];
      __syncwarp();  // the previous chunk's steps are done with wf
      wf[lane] = fc;
      __syncwarp();
      // The chunk's units, concatenated face after face: an inclusive scan of
      // the counts, then 32 units per step, each lane finding its face by a
      // binary search of the scan (the faces wait in shared memory), and
      // cutting its unit to the face's row span (about a third of a box's
      // pixels on posed bodies).  The step's span pixels are then tested 32
      // at a time, each lane finding its unit by a second search, so that
      // every lane tests a pixel; an inside pixel's key competes at once.
      const int incl = warp_inclusive_sum(n, lane);
      const int total = __shfl_sync(kFull, incl, 31);
      const int excl = incl - n;
      for (int u = lane; u - lane < total; u += 32) {
        const int j = owner_lane(incl, min(u, total - 1));
        const int start = __shfl_sync(kFull, excl, j);
        int first = 0, cnt = 0, row = 0;
        if (u < total) {
          const Face& g = wf[j];
          const float c[6] = {g.c[0], g.c[1], g.c[2], g.c[3], g.c[4], g.c[5]};
          const float rc[3] = {g.rc[0], g.rc[1], g.rc[2]};
          const Unit un = unit_of(g.col_lo, g.col_hi, g.row_lo, u - start);
          int lo, hi;
          row_span(c, g.m2, rc, un.row, lo, hi);
          first = max(lo, un.col0);
          cnt = max(0, min(hi, un.col0 + un.ncols - 1) - first + 1);
          row = un.row;
        }
        const int pincl = warp_inclusive_sum(cnt, lane);
        const int ptotal = __shfl_sync(kFull, pincl, 31);
        for (int px = lane; px - lane < ptotal; px += 32) {
          const int o = owner_lane(pincl, min(px, ptotal - 1));
          const int col =
              __shfl_sync(kFull, first, o) + px - (__shfl_sync(kFull, pincl, o) - __shfl_sync(kFull, cnt, o));
          const int prow = __shfl_sync(kFull, row, o), jo = __shfl_sync(kFull, j, o);
          if (px < ptotal) {
            const Face& g = wf[jo];
            const float c[6] = {g.c[0], g.c[1], g.c[2], g.c[3], g.c[4], g.c[5]};
            if (inside(c, prow, col)) compete(g.c[6], g.c[7], g.c[8], g.f, prow, col, keys, t);
          }
        }
      }
    }
  }
  __syncthreads();
  // The queued large boxes, each walked by the whole block.
  const int nq = min(queued, kQueue);
  for (int q = 0; q < nq; ++q) {
    const Face& g = queue[q];
    const float c[6] = {g.c[0], g.c[1], g.c[2], g.c[3], g.c[4], g.c[5]};
    const float rc[3] = {g.rc[0], g.rc[1], g.rc[2]};
    const int units = (g.row_hi - g.row_lo + 1) * pieces_of(g.col_lo, g.col_hi);
    for (int u = threadIdx.x; u < units; u += kThreads) {
      const Unit un = unit_of(g.col_lo, g.col_hi, g.row_lo, u);
      int lo, hi;
      row_span(c, g.m2, rc, un.row, lo, hi);
      for (int col = max(lo, un.col0); col <= min(hi, un.col0 + un.ncols - 1); ++col)
        if (inside(c, un.row, col)) compete(g.c[6], g.c[7], g.c[8], g.f, un.row, col, keys, t);
    }
  }
  __syncthreads();

  // Resolve the tile: every output element written once, consecutive threads
  // on consecutive pixels of a row.
  const int n_attr = n_lin + n_const + (z_grads ? 2 : 0);
  const int row_w = 3 * n_lin + n_const;
  for (int i = threadIdx.x; i < npix; i += kThreads) {
    const int lr = i / t.tc, row = t.r0 + lr, col = t.c0 + (i - lr * t.tc);
    const long long idx = ((long long)m * H + row) * W + col;
    const unsigned long long key = keys[i];
    float* out = n_attr > 0 ? planes + idx * n_attr : nullptr;
    if (key == kEmpty) {
      depth[idx] = kBigDepth;
      if (face_out != nullptr) {
        face_out[idx] = -1;
        b0_out[idx] = 0.f;
        b1_out[idx] = 0.f;
      }
      if (n_attr == 4)
        *reinterpret_cast<float4*>(out) = make_float4(0.f, 0.f, 0.f, 0.f);
      else
        for (int k = 0; k < n_attr; ++k) out[k] = 0.f;
      continue;
    }
    const int f = (int)(key & 0xffffffffull);
    float p[9];
    load_face(vm, faces, f, V, p);  // the winner is kept: its indices are in range
    float c[9];
    coefficients(p, signed_area(p), c);
    const float gx = __fadd_rn((float)col, 0.5f), gy = __fadd_rn((float)row, 0.5f);
    const float w0 = __fadd_rn(__fadd_rn(__fmul_rn(c[0], gx), __fmul_rn(c[1], gy)), c[2]);
    const float w1 = __fadd_rn(__fadd_rn(__fmul_rn(c[3], gx), __fmul_rn(c[4], gy)), c[5]);
    depth[idx] = unorder_bits((unsigned int)(key >> 32));
    if (face_out != nullptr) {
      face_out[idx] = f;
      b0_out[idx] = w0;
      b1_out[idx] = w1;
    }
    if (n_attr == 0) continue;
    const float* ar = attrs + (long long)m * attr_mesh_stride + (long long)f * row_w;
    if (n_attr == 4 && n_lin == 0 && !z_grads) {  // the training render: four constants
      *reinterpret_cast<float4*>(out) = make_float4(__ldg(ar), __ldg(ar + 1), __ldg(ar + 2), __ldg(ar + 3));
      continue;
    }
    int k = 0;
    for (int j = 0; j < n_lin; ++j)
      out[k++] = __fadd_rn(__fadd_rn(__fmul_rn(__ldg(ar + 3 * j), w0), __fmul_rn(__ldg(ar + 3 * j + 1), w1)),
                           __ldg(ar + 3 * j + 2));
    for (int j = 0; j < n_const; ++j) out[k++] = __ldg(ar + 3 * n_lin + j);
    if (z_grads) {
      out[k++] = c[6];
      out[k++] = c[7];
    }
  }
}

}  // namespace

// verts: (M, V, 3) float32 screen coordinates (x = column, y = row, depth);
// faces: (F, 3) int32; attrs: (M or 1, F, 3 n_lin + n_const) float32 rows
// [d0 d1 c] per linear attribute then the constants, or null when there are
// none; attr_mesh_stride: F (3 n_lin + n_const) or 0 for one shared table;
// depth: (M, H, W) float32; face_out, b0_out, b1_out: (M, H, W) int32 /
// float32 / float32, or all null; planes: (M, H, W, n_lin + n_const +
// 2 z_grads) float32 (16-byte aligned), or null when that is 0; overflow:
// (M,) int32; bits: (M, ceil(H / 8), ceil(F / 32)) uint32 scratch.  Every element of every
// output is written.  tile_rows x tile_cols: the tile of one block, at most
// kMaxTileKeys pixels.  All device pointers, contiguous.  Launch on
// `stream`; return the first CUDA error.
extern "C" int raster_launch(const void* verts, const void* faces, const void* attrs, long long attr_mesh_stride,
                             void* depth, void* face_out, void* b0_out, void* b1_out, void* planes,
                             void* overflow, void* bits, int M, int V, int F, int H, int W, int tile_rows,
                             int tile_cols,
                             int n_lin, int n_const, int z_grads, int cull_sign, void* stream) {
  if (M <= 0 || H <= 0 || W <= 0) return 0;
  if (V <= 0 || F < 0 || n_lin < 0 || n_const < 0 || cull_sign < -1 || cull_sign > 1)
    return (int)cudaErrorInvalidValue;
  if ((n_lin + n_const > 0) != (attrs != nullptr)) return (int)cudaErrorInvalidValue;
  if ((n_lin + n_const + (z_grads ? 2 : 0) > 0) != (planes != nullptr)) return (int)cudaErrorInvalidValue;
  if (tile_rows <= 0 || tile_cols <= 0 || (long long)tile_rows * tile_cols > kMaxTileKeys)
    return (int)cudaErrorInvalidValue;
  const int rows = tile_rows < H ? tile_rows : H, cols = tile_cols < W ? tile_cols : W;
  const long long row_tiles = (H + tile_rows - 1) / tile_rows, col_tiles = (W + tile_cols - 1) / tile_cols;
  const long long blocks = (long long)M * row_tiles * col_tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int smem = rows * cols * (int)sizeof(unsigned long long);
  static bool sized = false;  // the kernel's dynamic shared memory limit, raised once
  if (!sized) {
    const cudaError_t err =
        cudaFuncSetAttribute(raster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxTileKeys * 8);
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  const size_t words = (size_t)M * ((H + kBandRows - 1) / kBandRows) * ((F + 31) / 32);
  cudaError_t err = cudaMemsetAsync(overflow, 0, (size_t)M * sizeof(int), s);
  if (err == cudaSuccess && words > 0) err = cudaMemsetAsync(bits, 0, words * sizeof(unsigned), s);
  if (err != cudaSuccess) return (int)err;
  const long long faces_total = (long long)M * F;
  if (faces_total > 0) {
    if ((faces_total + 255) / 256 > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    face_bands_kernel<<<(unsigned)((faces_total + 255) / 256), 256, 0, s>>>(
        (const float*)verts, (const int*)faces, (unsigned*)bits, (int*)overflow, M, V, F, H, W, cull_sign);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  raster_kernel<<<(unsigned)blocks, kThreads, smem, s>>>(
      (const float*)verts, (const int*)faces, (const float*)attrs, attr_mesh_stride, (float*)depth,
      (int*)face_out, (float*)b0_out, (float*)b1_out, (float*)planes, (const unsigned*)bits, V, F, H, W,
      tile_rows, tile_cols, (int)row_tiles, (int)col_tiles, n_lin, n_const, z_grads);
  return (int)cudaGetLastError();
}
