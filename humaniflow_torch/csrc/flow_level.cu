// Fused forward flow stack of one autoregressive depth level, for Hopper
// (sm_90a), plain C interface for ctypes.
//
// K5 flow_level replaces humaniflow_tpu/flows/pallas_level.py
//                _make_level_kernel (wrapper flow_forward_level).
//
// For every row r and level part p (absolute part index pa = parts[p]) it
// pushes z[r, p, :] (3 floats) through the flow's transforms in order:
//   per coupling c:  Permute(perm[c]), then ConditionalSplineCoupling with
//                    split 1: h = [ctx[r, p, :], x0] (context first) through
//                    the part's ReLU MLP; the last layer's 62 outputs split
//                    into w (16), h (16), d (14), l (16), each dimension-major
//                    ((2, 8) or (2, 7)); x1 and x2 go through the linear-
//                    rational spline (8 bins) of their dimension;
//   then ScaledRadialTanh when radius > 0.
// No log-det.
//
// Bound on an H100: per (row, part) 2 couplings x 9,216 multiply-adds of
// the 65-64-32-32-62 MLP plus ~400 float64 spline operations per coupling;
// one AR pass (8 launches, 23 parts, 3,232 rows) is ~2.8 GFLOP, 0.04 ms at
// the 67 TFLOP/s float32 peak outside the tensor cores, and moves ~22 MB
// (contexts dominate), 0.007 ms at 3.35 TB/s: bound by operations.
//
// Design.
// * The wrapper (flows/cuda_level.py level_pack) packs each part's MLP once
//   into one contiguous buffer per coupling, in the order this kernel reads
//   its mma fragments: per layer the B fragments [k-step][n-tile pair]
//   [lane][4], the bias in the accumulator's column order and, for the first
//   layer, the weight column of x0.  A block owns one part and 64 rows
//   (kBlockRows); one thread brings every layer of every coupling into
//   shared memory with TMA bulk copies, each completing its own mbarrier, so
//   that a warp starts a layer as soon as that layer has landed and the
//   second coupling's weights arrive while the first computes.
// * A warp carries 16 rows (one mma tile) through both couplings and the
//   radial tanh on its own: no block barrier after the start, __syncwarp
//   around a per-warp scratch.
// * The MLP runs on the tensor cores, mma.sync m16n8k8 TF32 with the 3xTF32
//   split (hi = rna(a), lo = a - hi, read truncated; acc += a_lo b_hi +
//   a_hi b_lo + a_hi b_hi, CUTLASS's OpMultiplyAddFastF32 scheme), which
//   keeps float32 accuracy; single-pass TF32 would keep ~3 decimal digits.  The first
//   layer reads the contexts straight from device memory as float4 (its k
//   order permuted to match); x0 enters as a float32 FMA with its weight
//   column.  A layer's accumulator is the next layer's A operand as it lies
//   in the registers: the next layer's k order is the accumulator's column
//   order (k = t <-> column 2t, k = t + 4 <-> column 2t + 1), so activations
//   never leave the registers.
// * The last layer's 64 outputs (packed [w0 w1 h0 h1 d0 . d1 . l0 l1], 8
//   apiece) go through the warp's scratch, [param][row] with a row stride of
//   18, and all 32 lanes evaluate the splines: lane = (row, dimension).
// * The splines run in float64 on the float32 parameters and input, rounded
//   once to float32.  In float32 the spline's own rounding (softmax knots
//   scaled to +-bound, the bin offset over its width) moves a level's output
//   by ~4e-6, and a float32 spline on MLP outputs a rounding apart from the
//   twin's lands as far from the twin; the eight chained levels carried that
//   to 8.7e-6 in the rotations of a B = 32, N = 100 pass on an H100.  In float64 K5's
//   own error is its MLP's, ~2e-7 a level, and its gap to the twin is the
//   twin's float32 rounding (rotations 5.8e-6); it costs ~0.05 ms a pass.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxCouplings = 8;
constexpr int kMaxLayers = 8;
constexpr int kBins = 8;
constexpr int kTileRows = 16;      // rows of one mma tile, carried by one warp
constexpr int kWarps = 4;          // warps per block
constexpr int kBlockRows = kWarps * kTileRows;  // rows per block
constexpr int kParams = 64;        // the last layer's outputs, packed 8 per (kind, dimension)
constexpr int kScratchStride = 18; // [param][row]: (row, dim) lanes read 32 banks, dims 8 params apart
constexpr int kScratchFloats = kParams * kScratchStride;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kMinBinWidth = 1e-3f;
constexpr float kMinBinHeight = 1e-3f;
constexpr float kMinDerivative = 1e-3f;
constexpr float kBoundaryDerivative = 0.999f;  // 1 - kMinDerivative, as the twin rounds it
constexpr float kMinLambda = 0.025f;
constexpr float kLambdaScale = 0.95f;          // 1 - 2 * kMinLambda
constexpr float kEps = 1e-6f;

}  // namespace

// Mirrored field for field by humaniflow_torch/flows/cuda_level.py _Params.
struct FlowLevelParams {
  const float* packed;                        // (num_parts, n_couplings, coupling_floats)
  int layer_off[kMaxCouplings][kMaxLayers];   // floats from a coupling's start to the layer's block
  int layer_floats[kMaxCouplings][kMaxLayers];
  int k_steps[kMaxCouplings][kMaxLayers];     // 8 inputs each
  int n_tiles[kMaxCouplings][kMaxLayers];     // 8 outputs each, even
  int perm[kMaxCouplings][3];
  float bound[kMaxCouplings];
  int n_layers[kMaxCouplings];
  int n_couplings;
  int num_parts;
  int coupling_floats;
  int c_dim;
  int max_tiles;  // n-tiles of the widest layer: the register tile (8 or 16)
  float radius;   // <= 0: no radial tanh
};

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// One TMA bulk copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) into shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// a = hi + lo: hi = a rounded to TF32, nearest with ties away from zero
// (cvt.rna.tf32.f32, here on the integer pipe: conversions issue at a
// quarter of the float32 rate), lo = a - hi exactly in float32, which the
// tensor core reads truncated to TF32.
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi, uint32_t& lo) {
  const uint32_t h = (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
  hi = h;
  lo = __float_as_uint(a - __uint_as_float(h));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment's four values (rows g, g + 8 at k = t; rows g, g + 8 at
// k = t + 4), split.
__device__ __forceinline__ void split_a(float r0k0, float r8k0, float r0k4, float r8k4, uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) {
  split_tf32(r0k0, hi[0], lo[0]);
  split_tf32(r8k0, hi[1], lo[1]);
  split_tf32(r0k4, hi[2], lo[2]);
  split_tf32(r8k4, hi[3], lo[3]);
}

// Accumulators start at the bias: column 2t and 2t + 1 of each n-tile.
template <int MAXT, int NT>
__device__ __forceinline__ void init_bias(const float* bias, int t, float (&acc)[MAXT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const float2 b = *reinterpret_cast<const float2*>(bias + 8 * nt + 2 * t);
    acc[nt][0] = b.x;
    acc[nt][1] = b.y;
    acc[nt][2] = b.x;
    acc[nt][3] = b.y;
  }
}

// One k-step of a layer of NT n-tiles: the A fragment against every
// n-tile's B fragment in 3xTF32, the small products first.  Each term
// sweeps all n-tiles before the next term, so that consecutive mma.sync
// write different accumulators and their latencies overlap.
template <int MAXT, int NT>
__device__ __forceinline__ void k_step(const float* wk, int lane, const uint32_t (&a_hi)[4],
                                       const uint32_t (&a_lo)[4], float (&acc)[MAXT][4]) {
  const float4* b4 = reinterpret_cast<const float4*>(wk) + lane;
  uint32_t b_hi[NT][2], b_lo[NT][2];
#pragma unroll
  for (int np = 0; np < NT / 2; ++np) {
    const float4 b = b4[np * 32];
    split_tf32(b.x, b_hi[2 * np][0], b_lo[2 * np][0]);
    split_tf32(b.y, b_hi[2 * np][1], b_lo[2 * np][1]);
    split_tf32(b.z, b_hi[2 * np + 1][0], b_lo[2 * np + 1][0]);
    split_tf32(b.w, b_hi[2 * np + 1][1], b_lo[2 * np + 1][1]);
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) mma_tf32(acc[nt], a_lo, b_hi[nt][0], b_hi[nt][1]);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) mma_tf32(acc[nt], a_hi, b_lo[nt][0], b_lo[nt][1]);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) mma_tf32(acc[nt], a_hi, b_hi[nt][0], b_hi[nt][1]);
}

// Four context features f..f+3 of one row (zero past c_dim or for no row).
__device__ __forceinline__ float4 load_ctx4(const float* row, int f, int c_dim, bool vec) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (row == nullptr) return v;
  if (vec && f + 3 < c_dim) return __ldg(reinterpret_cast<const float4*>(row + f));
  if (f < c_dim) v.x = __ldg(row + f);
  if (f + 1 < c_dim) v.y = __ldg(row + f + 1);
  if (f + 2 < c_dim) v.z = __ldg(row + f + 2);
  if (f + 3 < c_dim) v.w = __ldg(row + f + 3);
  return v;
}

// The first layer: contexts (k-step 2q + h takes features 16q + 4t + 2h and
// 16q + 4t + 2h + 1 as k = t and t + 4), then x0's column by float32 FMAs.
// The first 64 features come in held (ctx0: rows g, g + 8), later ones are
// read from device memory.  wl: B fragments, bias, x0 column.
template <int MAXT, int NT>
__device__ __forceinline__ void first_layer(const float* wl, int nks, int lane, const float4 (&ctx0)[2][4],
                                            const float* ctx_g, const float* ctx_g8, int c_dim, bool vec,
                                            float x0_g, float x0_g8, float (&acc)[MAXT][4]) {
  const int t = lane & 3;
  const float* bias = wl + nks * NT * 64;
  const float* x0col = bias + NT * 8;
  init_bias<MAXT, NT>(bias, t, acc);
  for (int q0 = 0; 2 * q0 < nks; q0 += 4) {  // four 16-feature groups at a time: their loads in flight together
    float4 fg[4], fg8[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      fg[i] = q0 == 0 ? ctx0[0][i] : load_ctx4(ctx_g, 16 * (q0 + i) + 4 * t, c_dim, vec);
      fg8[i] = q0 == 0 ? ctx0[1][i] : load_ctx4(ctx_g8, 16 * (q0 + i) + 4 * t, c_dim, vec);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int ks = 2 * q0 + i;
      if (ks < nks) {
        const float4 a = fg[i >> 1], a8 = fg8[i >> 1];
        uint32_t a_hi[4], a_lo[4];
        if (i & 1) {
          split_a(a.z, a8.z, a.w, a8.w, a_hi, a_lo);
        } else {
          split_a(a.x, a8.x, a.y, a8.y, a_hi, a_lo);
        }
        k_step<MAXT, NT>(wl + ks * NT * 64, lane, a_hi, a_lo, acc);
      }
    }
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const float2 w = *reinterpret_cast<const float2*>(x0col + 8 * nt + 2 * t);
    acc[nt][0] = fmaf(w.x, x0_g, acc[nt][0]);
    acc[nt][1] = fmaf(w.y, x0_g, acc[nt][1]);
    acc[nt][2] = fmaf(w.x, x0_g8, acc[nt][2]);
    acc[nt][3] = fmaf(w.y, x0_g8, acc[nt][3]);
  }
}

// A later layer, its A operand the previous layer's accumulator (after ReLU).
template <int MAXT, int NT>
__device__ __forceinline__ void dense_layer(const float* wl, int nks, int lane, const float (&act)[MAXT][4],
                                            float (&acc)[MAXT][4]) {
  init_bias<MAXT, NT>(wl + nks * NT * 64, lane & 3, acc);
#pragma unroll
  for (int ks = 0; ks < MAXT; ++ks) {
    if (ks < nks) {
      uint32_t a_hi[4], a_lo[4];
      split_a(act[ks][0], act[ks][2], act[ks][1], act[ks][3], a_hi, a_lo);
      k_step<MAXT, NT>(wl + ks * NT * 64, lane, a_hi, a_lo, acc);
    }
  }
}

// first_layer and dense_layer with their n-tile count as a constant (even,
// at most MAXT), so that a k-step's mma.sync carry no guards.
template <int MAXT, int NT = 2>
__device__ __forceinline__ void first_layer_n(int nnt, const float* wl, int nks, int lane,
                                              const float4 (&ctx0)[2][4], const float* ctx_g, const float* ctx_g8,
                                              int c_dim, bool vec, float x0_g, float x0_g8, float (&acc)[MAXT][4]) {
  if constexpr (NT <= MAXT) {
    if (nnt == NT) {
      first_layer<MAXT, NT>(wl, nks, lane, ctx0, ctx_g, ctx_g8, c_dim, vec, x0_g, x0_g8, acc);
    } else {
      first_layer_n<MAXT, NT + 2>(nnt, wl, nks, lane, ctx0, ctx_g, ctx_g8, c_dim, vec, x0_g, x0_g8, acc);
    }
  }
}

template <int MAXT, int NT = 2>
__device__ __forceinline__ void dense_layer_n(int nnt, const float* wl, int nks, int lane,
                                              const float (&act)[MAXT][4], float (&acc)[MAXT][4]) {
  if constexpr (NT <= MAXT) {
    if (nnt == NT) {
      dense_layer<MAXT, NT>(wl, nks, lane, act, acc);
    } else {
      dense_layer_n<MAXT, NT + 2>(nnt, wl, nks, lane, act, acc);
    }
  }
}

__device__ __forceinline__ double softplus(double x) { return x > 20.0 ? x : log1p(exp(x)); }

__device__ __forceinline__ double sigmoid(double x) { return 1.0 / (1.0 + exp(-x)); }

// Knots of softmax-normalised bin sizes spanning [-bound, bound], the end
// knots pinned exactly; the cumulative sum runs in the twin's order.
// p[k * kScratchStride] is parameter column k of this lane's row.
__device__ __forceinline__ void make_knots(const float* p, int col0, double bound, double min_frac,
                                           double knot[kBins + 1]) {
  double e[kBins];
  double m = -INFINITY;
#pragma unroll
  for (int b = 0; b < kBins; ++b) {
    e[b] = p[(col0 + b) * kScratchStride];
    m = fmax(m, e[b]);
  }
  double s = 0.0;
#pragma unroll
  for (int b = 0; b < kBins; ++b) {
    e[b] = exp(e[b] - m);
    s += e[b];
  }
  double cum = 0.0;
  knot[0] = -bound;
#pragma unroll
  for (int b = 0; b < kBins - 1; ++b) {
    cum += min_frac + (1.0 - min_frac * kBins) * (e[b] / s);
    knot[b + 1] = 2.0 * bound * cum - bound;
  }
  knot[kBins] = bound;
}

// Monotonic linear-rational spline of dimension j, forward, as
// humaniflow_torch/flows/spline.py monotonic_rational_spline_forward, in
// float64 on the float32 input and parameters, rounded once at the end.  The
// packed parameter columns: widths 8j + b, heights 16 + 8j + b, interior
// derivatives 32 + 8j + k - 1 (knot k = 1..7), lambdas 48 + 8j + b.
__device__ float spline_forward(float x_in, const float* p, int j, float bound_in) {
  const double x = x_in, bound = bound_in;
  const bool inside = x >= -bound && x <= bound;
  const double xc = fmin(fmax(x, -bound), bound);
  double kw[kBins + 1], kh[kBins + 1];
  make_knots(p, 8 * j, bound, kMinBinWidth, kw);
  make_knots(p, 16 + 8 * j, bound, kMinBinHeight, kh);

  // count of knots at or below x (a tie goes to the bin the knot opens)
  int idx = -1;
#pragma unroll
  for (int b = 0; b <= kBins; ++b) idx += xc >= kw[b] + kEps ? 1 : 0;
  idx = min(max(idx, 0), kBins - 1);

  double in_cw = kw[0], in_w = kw[1] - kw[0], in_ch = kh[0], in_h = kh[1] - kh[0];
#pragma unroll
  for (int b = 1; b < kBins; ++b) {
    if (b == idx) {
      in_cw = kw[b];
      in_w = kw[b + 1] - kw[b];
      in_ch = kh[b];
      in_h = kh[b + 1] - kh[b];
    }
  }
  const double in_delta = in_h / in_w;
  // derivatives at the bin's knots: the boundary constant at knots 0 and 8,
  // MIN_DERIVATIVE + softplus(d) inside
  const int dcol = 32 + 8 * j - 1;
  const double d_lo =
      idx == 0 ? kBoundaryDerivative : kMinDerivative + softplus(p[(dcol + idx) * kScratchStride]);
  const double d_hi =
      idx == kBins - 1 ? kBoundaryDerivative : kMinDerivative + softplus(p[(dcol + idx + 1) * kScratchStride]);
  const double lam = kLambdaScale * sigmoid(p[(48 + 8 * j + idx) * kScratchStride]) + kMinLambda;

  const double wb = sqrt(d_lo / d_hi);
  const double wc = (lam * d_lo + (1.0 - lam) * wb * d_hi) / in_delta;
  const double ya = in_ch;
  const double yb = in_h + in_ch;
  const double yc = ((1.0 - lam) * ya + lam * wb * yb) / ((1.0 - lam) + lam * wb);
  const double theta = (xc - in_cw) / in_w;
  double num, den;
  if (theta <= lam) {
    num = ya * (lam - theta) + wc * yc * theta;
    den = (lam - theta) + wc * theta;
  } else {
    num = wc * yc * (1.0 - theta) + wb * yb * (theta - lam);
    den = wc * (1.0 - theta) + wb * (theta - lam);
  }
  return inside ? static_cast<float>(num / den) : x_in;
}

__device__ __forceinline__ float pick3(float x0, float x1, float x2, int k) {
  return k == 0 ? x0 : (k == 1 ? x1 : x2);
}

// grid (row ranges of kBlockRows, level parts), 32 * kWarps threads.
template <int MAXT>
__global__ void __launch_bounds__(32 * kWarps) flow_level_kernel(const float* __restrict__ z,
                                                                const float* __restrict__ ctx,
                                                                const int64_t* __restrict__ parts,
                                                                float* __restrict__ out, long long rows, int num_p,
                                                                bool ctx_vec, FlowLevelParams prm) {
  extern __shared__ float4 smem4[];
  __shared__ uint64_t bars[kMaxCouplings * kMaxLayers];
  float* wsm = reinterpret_cast<float*>(smem4);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* scratch = wsm + prm.n_couplings * prm.coupling_floats + warp * kScratchFloats;
  const int p = blockIdx.y;
  const long long r0 = static_cast<long long>(blockIdx.x) * kBlockRows;
  const long long r_end = min(rows, r0 + kBlockRows);
  const long long pa = parts[p];
  if (pa < 0 || pa >= prm.num_parts) {  // uniform over the block: poison, before any copy starts
    for (long long r = r0 + threadIdx.x; r < r_end; r += blockDim.x) {
      for (int k = 0; k < 3; ++k) out[(r * num_p + p) * 3 + k] = NAN;
    }
    return;
  }
  const int n_c = prm.n_couplings;
  if (threadIdx.x == 0) {
    for (int c = 0; c < n_c; ++c) {
      for (int l = 0; l < prm.n_layers[c]; ++l) mbar_init(&bars[c * kMaxLayers + l]);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {  // every layer of every coupling, in the order they are used
    const float* src = prm.packed + pa * n_c * prm.coupling_floats;
    for (int c = 0; c < n_c; ++c) {
      for (int l = 0; l < prm.n_layers[c]; ++l) {
        const int off = c * prm.coupling_floats + prm.layer_off[c][l];
        bulk_load(wsm + off, src + off, 4u * prm.layer_floats[c][l], &bars[c * kMaxLayers + l]);
      }
    }
  }

  const int g = lane >> 2, row = lane & 15, j = lane >> 4;
  // Each warp owns one 16-row tile of the block's rows.  Warp 0 owns the
  // first, so it waits on every copy before it can leave: no copy is in
  // flight when the block ends.
  const long long m0 = r0 + warp * kTileRows;
  if (m0 >= r_end) return;
  const long long r = m0 + row;
  const bool valid = r < r_end;
  float x0 = 0.f, x1 = 0.f, x2 = 0.f;
  if (valid) {
    const float* zr = z + (r * num_p + p) * 3;
    x0 = zr[0];
    x1 = zr[1];
    x2 = zr[2];
  }
  const float* ctx_g = m0 + g < r_end ? ctx + ((m0 + g) * num_p + p) * prm.c_dim : nullptr;
  const float* ctx_g8 = m0 + g + 8 < r_end ? ctx + ((m0 + g + 8) * num_p + p) * prm.c_dim : nullptr;
  float4 ctx0[2][4];  // features 0-63 of rows g and g + 8: both couplings read them
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    ctx0[0][i] = load_ctx4(ctx_g, 16 * i + 4 * (lane & 3), prm.c_dim, ctx_vec);
    ctx0[1][i] = load_ctx4(ctx_g8, 16 * i + 4 * (lane & 3), prm.c_dim, ctx_vec);
  }

  for (int c = 0; c < n_c; ++c) {
    const float y0 = pick3(x0, x1, x2, prm.perm[c][0]);
    const float y1 = pick3(x0, x1, x2, prm.perm[c][1]);
    const float y2 = pick3(x0, x1, x2, prm.perm[c][2]);
    const float y0_g = __shfl_sync(kFull, y0, g), y0_g8 = __shfl_sync(kFull, y0, g + 8);
    const float* wc = wsm + c * prm.coupling_floats;
    float act[MAXT][4], acc[MAXT][4];
    mbar_wait(&bars[c * kMaxLayers], 0);
    first_layer_n<MAXT>(prm.n_tiles[c][0], wc + prm.layer_off[c][0], prm.k_steps[c][0], lane, ctx0, ctx_g,
                        ctx_g8, prm.c_dim, ctx_vec, y0_g, y0_g8, acc);
    for (int l = 1; l < prm.n_layers[c]; ++l) {
#pragma unroll
      for (int nt = 0; nt < MAXT; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) act[nt][i] = acc[nt][i] < 0.f ? 0.f : acc[nt][i];  // keeps NaN, as torch.relu
      }
      mbar_wait(&bars[c * kMaxLayers + l], 0);
      dense_layer_n<MAXT>(prm.n_tiles[c][l], wc + prm.layer_off[c][l], prm.k_steps[c][l], lane, act, acc);
    }
    __syncwarp();  // the previous coupling's spline reads of the scratch are done
    const int t = lane & 3;
#pragma unroll
    for (int nt = 0; nt < kParams / 8; ++nt) {
      float* s = scratch + (8 * nt + 2 * t) * kScratchStride + g;
      s[0] = acc[nt][0];
      s[kScratchStride] = acc[nt][1];
      s[8] = acc[nt][2];
      s[kScratchStride + 8] = acc[nt][3];
    }
    __syncwarp();
    const float o = spline_forward(j == 0 ? y1 : y2, scratch + row, j, prm.bound[c]);
    x0 = y0;
    x1 = __shfl_sync(kFull, o, row);
    x2 = __shfl_sync(kFull, o, row + 16);
  }

  if (prm.radius > 0.f) {
    const float radius = prm.radius;
    const float nsq = x0 * x0 + x1 * x1 + x2 * x2;
    const bool small = nsq < 1e-14f;
    const float norm = sqrtf(small ? 1.f : nsq);
    const float scale = small ? 1.f : tanhf(norm / radius) * radius / norm;
    x0 *= scale;
    x1 *= scale;
    x2 *= scale;
  }
  if (valid && j == 0) {
    float* o = out + (r * num_p + p) * 3;
    o[0] = x0;
    o[1] = x1;
    o[2] = x2;
  }
}

template <int MAXT>
int launch(const float* z, const float* ctx, const int64_t* parts, float* out, long long rows, int num_p,
           bool ctx_vec, const FlowLevelParams* prm, long long smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(flow_level_kernel<MAXT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((rows + kBlockRows - 1) / kBlockRows), static_cast<unsigned>(num_p));
  flow_level_kernel<MAXT><<<grid, 32 * kWarps, static_cast<size_t>(smem), stream>>>(
      z, ctx, parts, out, rows, num_p, ctx_vec, *prm);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of a block, bytes (mirrored by flows/cuda_level.py
// smem_bytes).
long long smem_bytes(const FlowLevelParams* prm) {
  return static_cast<long long>(sizeof(float)) *
         (static_cast<long long>(prm->n_couplings) * prm->coupling_floats +
          static_cast<long long>(kWarps) * kScratchFloats);
}

}  // namespace

extern "C" {

int flow_level_params_size() { return static_cast<int>(sizeof(FlowLevelParams)); }

// z (rows, P, 3), ctx (rows, P, C), parts (P,) int64, out (rows, P, 3); all
// contiguous on one device.  ctx_vec: ctx rows may be read as float4.
// Returns a cudaError_t.
int flow_level_launch(const float* z, const float* ctx, const int64_t* parts, float* out, long long rows,
                      int num_p, int ctx_vec, const FlowLevelParams* prm, void* stream) {
  if (rows <= 0 || num_p <= 0) return 0;
  if (prm->max_tiles != 8 && prm->max_tiles != 16) return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = smem_bytes(prm);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (prm->max_tiles == 8) {
    return launch<8>(z, ctx, parts, out, rows, num_p, ctx_vec != 0, prm, smem, s);
  }
  return launch<16>(z, ctx, parts, out, rows, num_p, ctx_vec != 0, prm, smem, s);
}

}  // extern "C"
