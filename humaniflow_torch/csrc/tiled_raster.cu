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
//   inv valid 0 0 0]; it reduces the chunk's bounds [ymin ymax xmin xmax]
//   over its real faces (padding and faces with an out-of-range vertex
//   index excluded; NaN propagates, as jnp.min does, so a chunk holding a
//   NaN coordinate is culled everywhere, as on the TPU).
// * `raster_kernel`, one block of 128x8 threads per (mesh, 8x128 pixel
//   band), one thread per pixel, walks the chunks in order.  A chunk is
//   walked only if its bounds overlap the band's 32x128 culling tile, with
//   the TPU kernel's test; a walked chunk is staged in shared memory and
//   each thread loops over its 64 faces in order, keeping its pixel's
//   running (depth, face, w0, w1, w2) in registers.  take = z < depth
//   (strict), so the lowest face index wins a tie.
//
// Bound: at the visualisation shape (32 meshes of 13,774 faces at 256²)
// the outputs (five planes, 42 MB) and the screen vertices cost ~0.013 ms
// at 3.35 TB/s, and the z-buffer's own work, each face against the pixels
// of its box (~220 tests a face, 13 operations each), ~0.02 ms at the
// float32 peak.  This kernel tests every face of a live chunk against its
// whole 32x128 tile, ~90 times that work.  The culling tile is the TPU's,
// kept so that the chunks walked are exactly the TPU kernel's: a finer tile
// would skip more, but could drop a pixel that the rounding of a nearly
// degenerate face claims outside its box, and then the kernel would no
// longer equal its twin.
//
// Numerics: every operation is written with the round-to-nearest
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
constexpr int kPack = 16;       // floats per packed face
constexpr int kChunkGroup = 1024;  // chunk flags decided per pass over the chunk list
constexpr float kBigDepth = 1e9f;

__device__ __forceinline__ float nan_min(float a, float b) { return (a != a || a < b) ? a : b; }
__device__ __forceinline__ float nan_max(float a, float b) { return (a != a || a > b) ? a : b; }

__global__ void __launch_bounds__(kChunk) setup_kernel(const float* __restrict__ verts,
                                                       const int* __restrict__ faces,
                                                       float* __restrict__ tri,
                                                       float* __restrict__ bounds, int V, int F,
                                                       int C) {
  __shared__ float s_red[4][kChunk];
  const int c = blockIdx.x, m = blockIdx.y, k = threadIdx.x;
  const int f = c * kChunk + k;
  float pack[kPack] = {0.f};
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
      ymin = nan_min(nan_min(y0, y1), y2);
      ymax = nan_max(nan_max(y0, y1), y2);
      xmin = nan_min(nan_min(x0, x1), x2);
      xmax = nan_max(nan_max(x0, x1), x2);
    }
  }
  float4* dst = reinterpret_cast<float4*>(tri + ((long long)m * C * kChunk + f) * kPack);
#pragma unroll
  for (int q = 0; q < kPack / 4; ++q)
    dst[q] = make_float4(pack[4 * q], pack[4 * q + 1], pack[4 * q + 2], pack[4 * q + 3]);

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

__global__ void __launch_bounds__(kTileCols* kBandRows)
    raster_kernel(const float* __restrict__ tri, const float* __restrict__ bounds,
                  float* __restrict__ depth_out, int* __restrict__ face_out,
                  float* __restrict__ bary_out, int C, int H, int W) {
  __shared__ float4 s_tri[kChunk * kPack / 4];
  __shared__ unsigned char s_live[kChunkGroup];
  const int m = blockIdx.z;
  const int tid = threadIdx.y * kTileCols + threadIdx.x;
  const int col = blockIdx.x * kTileCols + threadIdx.x;
  const int row = blockIdx.y * kBandRows + threadIdx.y;
  const float col0 = (float)(blockIdx.x * kTileCols);
  const float row0 = (float)((blockIdx.y * kBandRows) / kTileRows * kTileRows);
  const float gx = __fadd_rn((float)col, 0.5f);
  const float gy = __fadd_rn((float)row, 0.5f);
  const float* bm = bounds + (long long)m * C * 4;
  const float4* tm = reinterpret_cast<const float4*>(tri + (long long)m * C * kChunk * kPack);

  float best = kBigDepth, b0 = 0.f, b1 = 0.f, b2 = 0.f;
  int best_f = -1;
  for (int base = 0; base < C; base += kChunkGroup) {
    const int n = min(kChunkGroup, C - base);
    __syncthreads();  // the previous group's flags are no longer read
    for (int i = tid; i < n; i += kTileCols * kBandRows) {
      const float* bc = bm + (long long)(base + i) * 4;
      s_live[i] = (bc[1] >= row0) & (bc[0] <= row0 + (float)kTileRows) & (bc[3] >= col0) &
                  (bc[2] <= col0 + (float)kTileCols);
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      if (!s_live[j]) continue;  // the same for every thread of the block
      const int c = base + j;
      __syncthreads();  // the previous chunk is no longer read
      if (tid < kChunk * kPack / 4) s_tri[tid] = tm[(long long)c * kChunk * kPack / 4 + tid];
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < kChunk; ++k) {
        const float4 p0 = s_tri[4 * k], p1 = s_tri[4 * k + 1], p2 = s_tri[4 * k + 2],
                     p3 = s_tri[4 * k + 3];
        // p0 = (x1, y1, x2, y2), p1 = (x2-x1, y2-y1, x0-x2, y0-y2), p2 = (z0, z1, z2, inv),
        // p3.x = valid
        const float w0 = __fmul_rn(__fsub_rn(__fmul_rn(p1.x, __fsub_rn(gy, p0.y)),
                                             __fmul_rn(p1.y, __fsub_rn(gx, p0.x))),
                                   p2.w);
        const float w1 = __fmul_rn(__fsub_rn(__fmul_rn(p1.z, __fsub_rn(gy, p0.w)),
                                             __fmul_rn(p1.w, __fsub_rn(gx, p0.z))),
                                   p2.w);
        const float w2 = __fsub_rn(__fsub_rn(1.0f, w0), w1);
        if (p3.x != 0.f && w0 >= 0.f && w1 >= 0.f && w2 >= 0.f) {
          const float z = __fadd_rn(__fadd_rn(__fmul_rn(w0, p2.x), __fmul_rn(w1, p2.y)),
                                    __fmul_rn(w2, p2.z));
          if (z < best) {
            best = z;
            best_f = c * kChunk + k;
            b0 = w0;
            b1 = w1;
            b2 = w2;
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
// faces: (F, 3) int32; tri: (M, C·64, 16) float32 scratch, 16-byte aligned;
// bounds: (M, C, 4) float32 scratch; depth: (M, H, W) float32; face:
// (M, H, W) int32; bary: (M, H, W, 3) float32; C = ceil(F / 64); H a
// multiple of 32 and W of 128.  All device pointers, contiguous.  Launch on
// `stream`; return cudaGetLastError().
extern "C" int tiled_raster_launch(const void* verts, const void* faces, void* tri, void* bounds,
                                   void* depth, void* face, void* bary, int M, int V, int F,
                                   int H, int W, void* stream) {
  if (M <= 0 || H <= 0 || W <= 0) return 0;
  if (V <= 0 || F <= 0 || H % kTileRows != 0 || W % kTileCols != 0 || M > 65535)
    return (int)cudaErrorInvalidValue;
  const int C = (F + kChunk - 1) / kChunk;
  cudaStream_t s = (cudaStream_t)stream;
  setup_kernel<<<dim3(C, M), kChunk, 0, s>>>((const float*)verts, (const int*)faces, (float*)tri,
                                             (float*)bounds, V, F, C);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  raster_kernel<<<dim3(W / kTileCols, H / kBandRows, M), dim3(kTileCols, kBandRows), 0, s>>>(
      (const float*)tri, (const float*)bounds, (float*)depth, (int*)face, (float*)bary, C, H, W);
  return (int)cudaGetLastError();
}
