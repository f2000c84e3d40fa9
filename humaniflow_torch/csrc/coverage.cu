// Kernel K3: silhouette coverage of a (back-face culled) triangle set.
//
// Replaces the TPU kernels `_make_coverage_table_kernel` and
// `_make_coverage_kernel` of humaniflow_tpu/render/binned_rasterizer.py
// (called through `rasterize_binned_coverage`).  The TPU sorted faces into
// per-strip bins because it has no scatter; a strip holding more candidates
// than its capacity dropped some, and the mask was exact only at overflow 0.
// K3 has no capacity: every kept face is tested over its bounding box
// widened by one pixel and clipped to the image, at the pixel centres
// (col + 0.5, row + 0.5), with the edge-plane coefficients
// [a0 b0 c0 a1 b1 c1] (w0 = a0 x + b0 y + c0, w1 = a1 x + b1 y + c1,
// w2 = 1 - w0 - w1); a pixel is covered where min(w0, w1, w2) >= 0 for some
// kept face.  The only dropped faces are those with a vertex index outside
// [0, V), counted per mesh in `overflow`.
//
// Bound: at the SSP-3D shape (3,232 meshes of 13,774 faces at 256²) the
// edge tests of the widened boxes (~5e9, 8 operations each) cost ~0.6 ms at
// the float32 peak; the mask write (0.21 GB) and the screen vertices
// (0.30 GB) ~0.15 ms at 3.35 TB/s.  So the function is bound by operations.
// A body's boxes overlap heavily (each covered pixel lies in many boxes),
// so the design tests each pixel as few times as it can and keeps every
// store out of the loop:
//
// * One block owns one (mesh, band of rows) and walks all its faces.  The
//   band's mask lives in shared memory as bits (at most kBandWords 32-bit
//   words; at 256² the band is the whole image, 8 KB), set with atomicOr
//   only where a plain read shows a bit missing, and goes to device memory
//   once, as bytes, 16 per store where W allows.  Because one block sees
//   every face of its band, a face whose whole box is already set is
//   skipped after its setup, and so is any unit (below) whose pixels are.
//   Splitting a band's faces over the blocks of a thread-block cluster (to
//   OR their bits through distributed shared memory) measured slower: each
//   block then saw a fraction of the overlap, and skipped far fewer units.
// * A warp takes 32 faces at a time: each lane sets up one face (kept flag,
//   coefficients, box clipped to image and band).  The kept faces' boxes
//   are cut into units of kPiece columns of one row, concatenated face
//   after face; the warp steps through them 32 at a time, each lane finding
//   its face by a binary search of a warp scan, so a warp's work is the sum
//   of its boxes, not 32 times the largest, and culled faces cost one
//   setup.  Units whose pixels are all set already are dropped; the others
//   wait in the warp's ring in shared memory and are tested 32 at a time,
//   each lane a unit: kPiece pixel centres, the hits ORed into the bits.
// * A face whose clipped box exceeds kBigPx pixels is queued and walked
//   afterwards by all the block's threads together, so one stretched face
//   does not hold up its warp.
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

constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kBandWords = 8192;  // 32 KB of mask bits per block
constexpr int kPiece = 16;        // columns of one row in a unit
constexpr int kBigPx = 4096;      // larger clipped boxes are walked by the whole block
constexpr int kQueue = 128;
constexpr int kPending = 64;      // a warp's ring of units waiting for a test
constexpr unsigned kFull = 0xffffffffu;

struct Face {  // edge-plane coefficients and the box clipped to image and band
  float a0, b0, c0, a1, b1, c1;
  int col_lo, col_hi, row_lo, row_hi;
};

// Face f of the mesh at vm: true (and fc filled) when it is kept and its box
// meets rows [r0, r1]; `oob` is set when a vertex index is out of range.
__device__ __forceinline__ bool face_setup(const float* __restrict__ vm,
                                           const int* __restrict__ faces, int f, int V, int H,
                                           int W, int r0, int r1, int cull_sign, Face& fc,
                                           bool& oob) {
  const int i0 = __ldg(faces + 3 * f), i1 = __ldg(faces + 3 * f + 1),
            i2 = __ldg(faces + 3 * f + 2);
  if (i0 < 0 || i0 >= V || i1 < 0 || i1 >= V || i2 < 0 || i2 >= V) {
    oob = true;
    return false;
  }
  const float x0 = __ldg(vm + 3 * i0), y0 = __ldg(vm + 3 * i0 + 1);
  const float x1 = __ldg(vm + 3 * i1), y1 = __ldg(vm + 3 * i1 + 1);
  const float x2 = __ldg(vm + 3 * i2), y2 = __ldg(vm + 3 * i2 + 1);
  if (!(isfinite(x0) && isfinite(y0) && isfinite(x1) && isfinite(y1) && isfinite(x2) &&
        isfinite(y2)))
    return false;

  const float area = __fsub_rn(__fmul_rn(__fsub_rn(x1, x0), __fsub_rn(y2, y0)),
                               __fmul_rn(__fsub_rn(x2, x0), __fsub_rn(y1, y0)));
  if (!(fabsf(area) > 1e-9f)) return false;  // degenerate: never inside (c0 = -1)
  if (cull_sign != 0 && !(__fmul_rn(area, (float)cull_sign) > 0.f)) return false;

  // Bounding box widened by one pixel, clipped to the image; the clipped
  // bounds are whole numbers, so the int conversions are exact.
  const float cx_lo = fmaxf(floorf(fminf(fminf(x0, x1), x2)) - 1.f, 0.f);
  const float cx_hi = fminf(ceilf(fmaxf(fmaxf(x0, x1), x2)) + 1.f, (float)(W - 1));
  const float cy_lo = fmaxf(floorf(fminf(fminf(y0, y1), y2)) - 1.f, 0.f);
  const float cy_hi = fminf(ceilf(fmaxf(fmaxf(y0, y1), y2)) + 1.f, (float)(H - 1));
  if (cx_lo > cx_hi || cy_lo > cy_hi) return false;
  fc.col_lo = (int)cx_lo;
  fc.col_hi = (int)cx_hi;
  fc.row_lo = max((int)cy_lo, r0);  // then clipped to the band
  fc.row_hi = min((int)cy_hi, r1);
  if (fc.row_lo > fc.row_hi) return false;

  const float inv = __fdiv_rn(1.0f, area);
  fc.a0 = __fmul_rn(-__fsub_rn(y2, y1), inv);
  fc.b0 = __fmul_rn(__fsub_rn(x2, x1), inv);
  fc.c0 = __fmul_rn(
      __fsub_rn(__fmul_rn(__fsub_rn(y2, y1), x1), __fmul_rn(__fsub_rn(x2, x1), y1)), inv);
  fc.a1 = __fmul_rn(-__fsub_rn(y0, y2), inv);
  fc.b1 = __fmul_rn(__fsub_rn(x0, x2), inv);
  fc.c1 = __fmul_rn(
      __fsub_rn(__fmul_rn(__fsub_rn(y0, y2), x2), __fmul_rn(__fsub_rn(x0, x2), y2)), inv);
  return true;
}

// OR the hits of up to 32 columns of one row, from column col0, into the
// band's bits (two words at most).
__device__ __forceinline__ void set_bits(uint32_t* bits, int row_word, int col0, uint32_t hits) {
  const int wi = row_word + (col0 >> 5), sh = col0 & 31;
  const uint32_t lo = hits << sh, hi = sh ? hits >> (32 - sh) : 0u;
  if (lo && (bits[wi] & lo) != lo) atomicOr(bits + wi, lo);
  if (hi && (bits[wi + 1] & hi) != hi) atomicOr(bits + wi + 1, hi);
}

// True when the ncols pixels of one row from col0 are all set already.
__device__ __forceinline__ bool known(const uint32_t* bits, int row_word, int col0, int ncols) {
  const int wi = row_word + (col0 >> 5), sh = col0 & 31;
  uint32_t k = bits[wi] >> sh;
  if (sh + ncols > 32) k |= bits[wi + 1] << (32 - sh);
  const uint32_t valid = (1u << ncols) - 1u;
  return (k & valid) == valid;
}

// True when every pixel of the face's box is set already.
__device__ __forceinline__ bool face_known(const Face& fc, const uint32_t* bits, int wpr, int r0) {
  const int w_lo = fc.col_lo >> 5, w_hi = fc.col_hi >> 5;
  const uint32_t m_lo = kFull << (fc.col_lo & 31), m_hi = kFull >> (31 - (fc.col_hi & 31));
  for (int row = fc.row_lo; row <= fc.row_hi; ++row) {
    const uint32_t* rw = bits + (row - r0) * wpr;
    for (int w = w_lo; w <= w_hi; ++w) {
      const uint32_t m = (w == w_lo ? m_lo : kFull) & (w == w_hi ? m_hi : kFull);
      if ((rw[w] & m) != m) return false;
    }
  }
  return true;
}

// A unit is kPiece columns (fewer at the box's right edge) of one row of a
// face's box; unit `local` of a box lies in row local / pieces.
struct Unit {
  int row, col0, ncols;
};

__device__ __forceinline__ int pieces_of(int col_lo, int col_hi) {
  return (col_hi - col_lo + kPiece) / kPiece;
}

__device__ __forceinline__ Unit unit_of(int col_lo, int col_hi, int row_lo, int local) {
  const int pieces = pieces_of(col_lo, col_hi);
  const int dr = local / pieces;
  Unit u;
  u.row = row_lo + dr;
  u.col0 = col_lo + (local - dr * pieces) * kPiece;
  u.ncols = min(kPiece, col_hi - u.col0 + 1);
  return u;
}

// Test the unit's pixel centres against the face with coefficients c and OR
// the hits into the band's bits.
__device__ __forceinline__ void test_unit(const float (&c)[6], const Unit& u, uint32_t* bits,
                                          int wpr, int r0) {
  const float gy = __fadd_rn((float)u.row, 0.5f);
  const float by0 = __fmul_rn(c[1], gy), by1 = __fmul_rn(c[4], gy);
  float gx = __fadd_rn((float)u.col0, 0.5f);
  uint32_t hits = 0u;
#pragma unroll
  for (int k = 0; k < kPiece; ++k) {
    const float w0 = __fadd_rn(__fadd_rn(__fmul_rn(c[0], gx), by0), c[2]);
    const float w1 = __fadd_rn(__fadd_rn(__fmul_rn(c[3], gx), by1), c[5]);
    const float w2 = __fsub_rn(__fsub_rn(1.0f, w0), w1);
    hits |= (uint32_t)(w0 >= 0.f && w1 >= 0.f && w2 >= 0.f) << k;
    gx = __fadd_rn(gx, 1.0f);  // exact: whole numbers plus 0.5 below 2^23
  }
  hits &= (1u << u.ncols) - 1u;  // columns past the box are not the face's
  if (hits) set_bits(bits, (u.row - r0) * wpr, u.col0, hits);
}

// Test the pending unit e (row, col0 | ncols << 16 | face lane << 21) when
// `active`; every lane of the warp calls it (the coefficients come from the
// face's lane by shuffles).
__device__ __forceinline__ void test_pending(const Face& fc, int2 e, bool active, uint32_t* bits,
                                             int wpr, int r0) {
  const int j = (e.y >> 21) & 31;
  const float c[6] = {__shfl_sync(kFull, fc.a0, j), __shfl_sync(kFull, fc.b0, j),
                      __shfl_sync(kFull, fc.c0, j), __shfl_sync(kFull, fc.a1, j),
                      __shfl_sync(kFull, fc.b1, j), __shfl_sync(kFull, fc.c1, j)};
  if (active) test_unit(c, Unit{e.x, e.y & 0xffff, (e.y >> 16) & 31}, bits, wpr, r0);
}

__device__ __forceinline__ uint32_t nibble_bytes(uint32_t v) {  // 4 bits -> 4 bytes of 0/1
  return (v & 1u) | ((v & 2u) << 7) | ((v & 4u) << 14) | ((v & 8u) << 21);
}

// Write the ncols low bits of v as bytes at out (16-byte aligned when vec).
__device__ __forceinline__ void store_bits(uint8_t* out, uint32_t v, int ncols, bool vec) {
  if (vec) {
    for (int k = 0; k < ncols; k += 16) {
      const uint32_t s = v >> k;
      *reinterpret_cast<uint4*>(out + k) = make_uint4(
          nibble_bytes(s), nibble_bytes(s >> 4), nibble_bytes(s >> 8), nibble_bytes(s >> 12));
    }
  } else {
    for (int k = 0; k < ncols; ++k) out[k] = (uint8_t)((v >> k) & 1u);
  }
}

// Grid: (M · bands); block b serves mesh b / bands, band b % bands.
__global__ void __launch_bounds__(kThreads)
    coverage_kernel(const float* __restrict__ verts, const int* __restrict__ faces,
                    uint8_t* __restrict__ mask, int* __restrict__ overflow, int V, int F, int H,
                    int W, int band_rows, int bands, int cull_sign) {
  extern __shared__ uint32_t bits[];
  __shared__ Face queue[kQueue];
  __shared__ int2 pending[kWarps][kPending];
  __shared__ int queued, bad_total;
  const int m = (int)(blockIdx.x / bands), band = (int)(blockIdx.x % bands);
  const int r0 = band * band_rows, r1 = min(H, r0 + band_rows) - 1;
  const int wpr = (W + 31) >> 5;
  const int nwords = (r1 - r0 + 1) * wpr;
  for (int i = threadIdx.x; i < nwords; i += kThreads) bits[i] = 0u;
  if (threadIdx.x == 0) queued = bad_total = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t lanes_below = (1u << lane) - 1u;
  int2* pend = pending[warp];
  const float* vm = verts + (long long)m * V * 3;
  int bad = 0;
  const int chunks = (F + 31) >> 5;
  for (int c = warp; c < chunks; c += kWarps) {
    // Each lane sets up one face of the chunk; a face whose box is already
    // set, or that is not kept, has no units.
    const int f = (c << 5) + lane;
    Face fc = {};
    bool oob = false;
    bool kept = f < F && face_setup(vm, faces, f, V, H, W, r0, r1, cull_sign, fc, oob);
    bad += oob;
    if (kept && face_known(fc, bits, wpr, r0)) kept = false;
    int n = kept ? (fc.row_hi - fc.row_lo + 1) * pieces_of(fc.col_lo, fc.col_hi) : 0;
    if (n * kPiece > kBigPx) {
      const int q = atomicAdd(&queued, 1);
      if (q < kQueue) {
        queue[q] = fc;
        n = 0;
      }
    }
    // The chunk's units, concatenated face after face: an inclusive scan of
    // the counts, then 32 units per step, each lane finding its face by a
    // binary search of the scan.  Units whose pixels are all set already
    // are dropped; the rest queue in the warp's ring and are tested 32 at a
    // time, so that the warp's lanes test pixels together.
    int incl = n;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += y;
    }
    const int total = __shfl_sync(kFull, incl, 31);
    const int excl = incl - n;
    int head = 0, tail = 0;  // the ring's read and write counts, the same in every lane
    for (int u = lane; u - lane < total; u += 32) {
      int j = 0;
#pragma unroll
      for (int step = 16; step; step >>= 1)
        if (__shfl_sync(kFull, incl, j + step - 1) <= u) j += step;
      const int col_lo = __shfl_sync(kFull, fc.col_lo, j), col_hi = __shfl_sync(kFull, fc.col_hi, j);
      const int row_lo = __shfl_sync(kFull, fc.row_lo, j), start = __shfl_sync(kFull, excl, j);
      bool need = false;
      Unit un = {};
      if (u < total) {
        un = unit_of(col_lo, col_hi, row_lo, u - start);
        need = !known(bits, (un.row - r0) * wpr, un.col0, un.ncols);
      }
      const uint32_t needy = __ballot_sync(kFull, need);
      if (need)
        pend[(tail + __popc(needy & lanes_below)) % kPending] =
            make_int2(un.row, un.col0 | (un.ncols << 16) | (j << 21));
      tail += __popc(needy);
      if (tail - head >= 32) {
        __syncwarp();
        const int2 e = pend[(head + lane) % kPending];
        __syncwarp();
        head += 32;
        test_pending(fc, e, true, bits, wpr, r0);
      }
    }
    __syncwarp();
    const int2 e = pend[(head + lane) % kPending];
    __syncwarp();
    if (head < tail) test_pending(fc, e, lane < tail - head, bits, wpr, r0);
  }
  if (bad) atomicAdd(&bad_total, bad);
  __syncthreads();
  // The queued large boxes, each walked by the whole block.
  const int nq = min(queued, kQueue);
  for (int q = 0; q < nq; ++q) {
    const Face& g = queue[q];
    const float cf[6] = {g.a0, g.b0, g.c0, g.a1, g.b1, g.c1};
    const int units = (g.row_hi - g.row_lo + 1) * pieces_of(g.col_lo, g.col_hi);
    for (int u = threadIdx.x; u < units; u += kThreads) {
      const Unit un = unit_of(g.col_lo, g.col_hi, g.row_lo, u);
      if (!known(bits, (un.row - r0) * wpr, un.col0, un.ncols)) test_unit(cf, un, bits, wpr, r0);
    }
  }
  // Each face is counted by band 0 only: once per mesh.
  if (band == 0 && threadIdx.x == 0 && bad_total) atomicAdd(overflow + m, bad_total);
  __syncthreads();

  const bool vec = (W & 15) == 0;
  for (int i = threadIdx.x; i < nwords; i += kThreads) {
    const int rr = i / wpr, wc = i - rr * wpr;
    store_bits(mask + ((long long)m * H + r0 + rr) * W + (wc << 5), bits[i],
               min(32, W - (wc << 5)), vec);
  }
}

}  // namespace

// verts: (M, V, 3) float32 screen coordinates (x = column, y = row; the
// third is unused); faces: (F, 3) int32; mask: (M, H, W) uint8, every byte
// written; overflow: (M,) int32, zeroed by the caller.  band_rows: rows per
// band, with band_rows · ceil(W / 32) <= kBandWords.  All device pointers,
// contiguous.  Launch on `stream`; return cudaGetLastError().
extern "C" int coverage_launch(const void* verts, const void* faces, void* mask, void* overflow,
                               int M, int V, int F, int H, int W, int band_rows, int cull_sign,
                               void* stream) {
  if (M <= 0 || H <= 0 || W <= 0) return 0;
  if (V <= 0 || F < 0 || cull_sign < -1 || cull_sign > 1) return (int)cudaErrorInvalidValue;
  const long long wpr = (W + 31) / 32;
  if (band_rows <= 0 || band_rows * wpr > kBandWords) return (int)cudaErrorInvalidValue;
  const long long bands = (H + band_rows - 1) / band_rows;
  const long long blocks = (long long)M * bands;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(band_rows < H ? band_rows : H) * wpr * sizeof(uint32_t);
  coverage_kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)verts, (const int*)faces, (uint8_t*)mask, (int*)overflow, V, F, H, W,
      band_rows, (int)bands, cull_sign);
  return (int)cudaGetLastError();
}
