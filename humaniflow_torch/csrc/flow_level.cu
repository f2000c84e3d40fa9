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
// No log-det.  The MLP weights are the part-stacked DenseNN tensors,
// weight (num_parts, out, in) and bias (num_parts, out), read at row pa.
//
// Bound on an H100: per (row, part) 2 couplings x 9,216 multiply-adds (2
// operations each) of the 65-64-32-32-62 MLP plus ~400 spline operations
// per coupling; one AR pass (8 launches, 23 parts, 3,232 rows) is
// ~2.8 GFLOP, 0.04 ms at the 67 TFLOP/s float32 peak outside the tensor
// cores, and moves ~22 MB (contexts dominate), 0.007 ms at 3.35 TB/s: bound
// by operations.  Float32 FMAs only: the TPU kernel ran its matmuls at
// HIGHEST precision, and TF32 keeps only ~3 decimal digits.
//
// Design: kRows rows of one part per block, grid (row tiles, level parts),
// kSplit warps per block.  Lane l of every warp owns row l, and warp q
// computes the q-th quarter of each dense layer's outputs, so a row's MLP
// runs on four threads and a block holds four warps.  The block stages its
// part's MLP weights for one coupling in shared memory with cp.async (rows
// padded to a multiple of 4 inputs and 32 outputs, pads zero); all lanes of
// a warp read the same weights, as float4 broadcasts.  The contexts of the
// block's rows are staged once, transposed to [feature][row] with an odd row
// stride (coalesced global reads, conflict-free shared stores); activations
// live in two shared [feature][row] buffers and never reach device memory.
// A thread keeps 8 outputs in registers and walks the inputs 4 at a time: 4
// activation loads and 8 float4 weight loads per 32 FMAs.  Warps 0 and 1
// evaluate the two splines of a coupling.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxCouplings = 8;
constexpr int kMaxLayers = 8;
constexpr int kBins = 8;
constexpr int kRows = 32;            // rows per block: one per lane
constexpr int kSplit = 4;            // warps per block: each computes a quarter of a layer's outputs
constexpr int kThreads = kRows * kSplit;
constexpr int kOutPad = 8 * kSplit;  // output rows of a layer are padded to this
constexpr int kStride = kRows + 1;   // shared [feature][row] stride, odd
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
  const float* weight[kMaxCouplings][kMaxLayers];  // (num_parts, out, in)
  const float* bias[kMaxCouplings][kMaxLayers];    // (num_parts, out)
  int dims[kMaxCouplings][kMaxLayers + 1];         // in, hidden..., out
  int perm[kMaxCouplings][3];
  float bound[kMaxCouplings];
  int n_layers[kMaxCouplings];
  int n_couplings;
  int num_parts;
  float radius;       // <= 0: no radial tanh
  int weight_floats;  // shared floats of the largest coupling's padded weights
  int act_rows;       // rows of each activation buffer (max padded width)
};

namespace {

__host__ __device__ __forceinline__ int round_up(int x, int m) { return (x + m - 1) / m * m; }

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// Copy coupling c's MLP weights of part pa into shared memory: per layer
// W (outp, inp) row-major, then b (outp), with inp = round_up(in, 4),
// outp = round_up(out, kOutPad) and zero pads.
__device__ void stage_weights(const FlowLevelParams& prm, int c, long long pa, float* wsm) {
  int off = 0;
  for (int l = 0; l < prm.n_layers[c]; ++l) {
    const int in = prm.dims[c][l], out = prm.dims[c][l + 1];
    const int inp = round_up(in, 4), outp = round_up(out, kOutPad);
    const float* w = prm.weight[c][l] + pa * out * in;
    const float* b = prm.bias[c][l] + pa * out;
    for (int k = threadIdx.x; k < outp * inp; k += blockDim.x) {
      const int o = k / inp, i = k - o * inp;
      if (o < out && i < in) {
        cp_async4(wsm + off + k, w + static_cast<long long>(o) * in + i);
      } else {
        wsm[off + k] = 0.f;
      }
    }
    float* bsm = wsm + off + outp * inp;
    for (int o = threadIdx.x; o < outp; o += blockDim.x) {
      if (o < out) {
        cp_async4(bsm + o, b + o);
      } else {
        bsm[o] = 0.f;
      }
    }
    off += outp * inp + outp;
  }
  cp_async_wait_all();
}

// act_out[o][t] = (relu)(sum_i W[o][i] * act_in[i][t] + b[o]) for the q-th
// quarter of the outputs o < outp.
__device__ __forceinline__ void dense_layer(const float* __restrict__ wl, int inp, int outp,
                                            const float* __restrict__ act_in, float* __restrict__ act_out,
                                            bool relu, int t, int q) {
  const float* bl = wl + outp * inp;
  const int per = outp / kSplit;
  for (int o0 = q * per; o0 < (q + 1) * per; o0 += 8) {
    float acc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = 0.f;
    for (int i0 = 0; i0 < inp; i0 += 4) {
      const float a0 = act_in[(i0 + 0) * kStride + t];
      const float a1 = act_in[(i0 + 1) * kStride + t];
      const float a2 = act_in[(i0 + 2) * kStride + t];
      const float a3 = act_in[(i0 + 3) * kStride + t];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 w = *reinterpret_cast<const float4*>(wl + (o0 + j) * inp + i0);
        acc[j] = fmaf(w.x, a0, acc[j]);
        acc[j] = fmaf(w.y, a1, acc[j]);
        acc[j] = fmaf(w.z, a2, acc[j]);
        acc[j] = fmaf(w.w, a3, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float v = acc[j] + bl[o0 + j];
      if (relu && v < 0.f) v = 0.f;  // keeps NaN, as torch.relu
      act_out[(o0 + j) * kStride + t] = v;
    }
  }
}

__device__ __forceinline__ float softplus(float x) { return x > 20.f ? x : log1pf(expf(x)); }

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// Knots of softmax-normalised bin sizes spanning [-bound, bound], the end
// knots pinned exactly; the cumulative sum runs in the twin's order.
__device__ __forceinline__ void make_knots(const float* p, int row0, int t, float bound, float min_frac,
                                           float knot[kBins + 1]) {
  float e[kBins];
  float m = -INFINITY;
#pragma unroll
  for (int b = 0; b < kBins; ++b) {
    e[b] = p[(row0 + b) * kStride + t];
    m = fmaxf(m, e[b]);
  }
  float s = 0.f;
#pragma unroll
  for (int b = 0; b < kBins; ++b) {
    e[b] = expf(e[b] - m);
    s += e[b];
  }
  float cum = 0.f;
  knot[0] = -bound;
#pragma unroll
  for (int b = 0; b < kBins - 1; ++b) {
    cum += min_frac + (1.f - min_frac * kBins) * (e[b] / s);
    knot[b + 1] = 2.f * bound * cum - bound;
  }
  knot[kBins] = bound;
}

// Monotonic linear-rational spline of dimension j, forward, as
// humaniflow_torch/flows/spline.py monotonic_rational_spline_forward.  The
// parameters are the rows of p (the MLP's last layer): widths 8j + b,
// heights 16 + 8j + b, interior derivatives 32 + 7j + b, lambdas 46 + 8j + b.
__device__ float spline_forward(float x, const float* p, int j, float bound, int t) {
  const bool inside = x >= -bound && x <= bound;
  const float xc = fminf(fmaxf(x, -bound), bound);
  float kw[kBins + 1], kh[kBins + 1];
  make_knots(p, 8 * j, t, bound, kMinBinWidth, kw);
  make_knots(p, 16 + 8 * j, t, bound, kMinBinHeight, kh);

  // count of knots at or below x (a tie goes to the bin the knot opens)
  int idx = -1;
#pragma unroll
  for (int b = 0; b <= kBins; ++b) idx += xc >= kw[b] + kEps ? 1 : 0;
  idx = min(max(idx, 0), kBins - 1);

  float in_cw = kw[0], in_w = kw[1] - kw[0], in_ch = kh[0], in_h = kh[1] - kh[0];
#pragma unroll
  for (int b = 1; b < kBins; ++b) {
    if (b == idx) {
      in_cw = kw[b];
      in_w = kw[b + 1] - kw[b];
      in_ch = kh[b];
      in_h = kh[b + 1] - kh[b];
    }
  }
  const float in_delta = in_h / in_w;
  // derivatives at the bin's knots: the boundary constant at knots 0 and 8,
  // MIN_DERIVATIVE + softplus(d) inside; d of knot k is row 32 + 7j + k - 1
  const int drow = 32 + 7 * j - 1;
  const float d_lo = idx == 0 ? kBoundaryDerivative : kMinDerivative + softplus(p[(drow + idx) * kStride + t]);
  const float d_hi =
      idx == kBins - 1 ? kBoundaryDerivative : kMinDerivative + softplus(p[(drow + idx + 1) * kStride + t]);
  const float lam = kLambdaScale * sigmoid(p[(46 + 8 * j + idx) * kStride + t]) + kMinLambda;

  const float wb = sqrtf(d_lo / d_hi);
  const float wc = (lam * d_lo + (1.f - lam) * wb * d_hi) / in_delta;
  const float ya = in_ch;
  const float yb = in_h + in_ch;
  const float yc = ((1.f - lam) * ya + lam * wb * yb) / ((1.f - lam) + lam * wb);
  const float theta = (xc - in_cw) / in_w;
  float num, den;
  if (theta <= lam) {
    num = ya * (lam - theta) + wc * yc * theta;
    den = (lam - theta) + wc * theta;
  } else {
    num = wc * yc * (1.f - theta) + wb * yb * (theta - lam);
    den = wc * (1.f - theta) + wb * (theta - lam);
  }
  return inside ? num / den : x;
}

__device__ __forceinline__ float pick3(float x0, float x1, float x2, int k) {
  return k == 0 ? x0 : (k == 1 ? x1 : x2);
}

__global__ void __launch_bounds__(kThreads) flow_level_kernel(const float* __restrict__ z,
                                                           const float* __restrict__ ctx,
                                                           const int64_t* __restrict__ parts,
                                                           float* __restrict__ out, long long rows, int num_p,
                                                           int c_dim, FlowLevelParams prm) {
  extern __shared__ float4 smem4[];
  float* wsm = reinterpret_cast<float*>(smem4);
  float* ctxbuf = wsm + prm.weight_floats;  // [round_up(C + 1, 4)][kStride]; row C is x0
  const int cin = round_up(c_dim + 1, 4);
  float* act_a = ctxbuf + cin * kStride;
  float* act_b = act_a + prm.act_rows * kStride;
  float* spline_out = act_b + prm.act_rows * kStride;  // [2][kRows]

  const int t = threadIdx.x % kRows;  // the row within the tile
  const int q = threadIdx.x / kRows;  // the warp: quarter of the outputs, spline dimension
  const int p = blockIdx.y;
  const long long r0 = static_cast<long long>(blockIdx.x) * kRows;
  const long long r = r0 + t;
  const bool valid = r < rows;
  const long long pa = parts[p];
  if (pa < 0 || pa >= prm.num_parts) {  // uniform over the block: poison, no sync reached
    if (valid && q == 0) {
      for (int k = 0; k < 3; ++k) out[(r * num_p + p) * 3 + k] = NAN;
    }
    return;
  }

  for (int i = threadIdx.x; i < kRows * c_dim; i += blockDim.x) {
    const int row = i / c_dim, k = i - row * c_dim;
    const long long rr = r0 + row;
    ctxbuf[k * kStride + row] = rr < rows ? ctx[(rr * num_p + p) * c_dim + k] : 0.f;
  }
  for (int k = c_dim + q; k < cin; k += kSplit) ctxbuf[k * kStride + t] = 0.f;

  float x0 = 0.f, x1 = 0.f, x2 = 0.f;
  if (valid) {
    const float* zr = z + (r * num_p + p) * 3;
    x0 = zr[0];
    x1 = zr[1];
    x2 = zr[2];
  }

  for (int c = 0; c < prm.n_couplings; ++c) {
    __syncthreads();  // the contexts are staged; the previous weights are no longer read
    stage_weights(prm, c, pa, wsm);
    __syncthreads();
    const float y0 = pick3(x0, x1, x2, prm.perm[c][0]);
    const float y1 = pick3(x0, x1, x2, prm.perm[c][1]);
    const float y2 = pick3(x0, x1, x2, prm.perm[c][2]);
    if (q == 0) ctxbuf[c_dim * kStride + t] = y0;  // the hypernet's last input
    __syncthreads();

    const float* in_buf = ctxbuf;
    float* out_buf = act_a;
    const int n_layers = prm.n_layers[c];
    int off = 0;
    for (int l = 0; l < n_layers; ++l) {
      const int inp = round_up(prm.dims[c][l], 4), outp = round_up(prm.dims[c][l + 1], kOutPad);
      dense_layer(wsm + off, inp, outp, in_buf, out_buf, l < n_layers - 1, t, q);
      __syncthreads();  // the layer's outputs are complete; its inputs are no longer read
      off += outp * inp + outp;
      in_buf = out_buf;
      out_buf = out_buf == act_a ? act_b : act_a;
    }
    if (q < 2) spline_out[q * kRows + t] = spline_forward(q == 0 ? y1 : y2, in_buf, q, prm.bound[c], t);
    __syncthreads();
    x0 = y0;
    x1 = spline_out[t];
    x2 = spline_out[kRows + t];
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
  if (valid && q == 0) {
    float* o = out + (r * num_p + p) * 3;
    o[0] = x0;
    o[1] = x1;
    o[2] = x2;
  }
}

}  // namespace

extern "C" {

int flow_level_params_size() { return static_cast<int>(sizeof(FlowLevelParams)); }

int flow_level_rows_per_block() { return kRows; }

// Dynamic shared memory of one block, bytes.
long long flow_level_smem_bytes(int c_dim, const FlowLevelParams* prm) {
  return static_cast<long long>(sizeof(float)) *
         (prm->weight_floats + static_cast<long long>(round_up(c_dim + 1, 4) + 2 * prm->act_rows) * kStride +
          2 * kRows);
}

// z (rows, P, 3), ctx (rows, P, C), parts (P,) int64, out (rows, P, 3); all
// contiguous on one device.  Returns a cudaError_t.
int flow_level_launch(const float* z, const float* ctx, const int64_t* parts, float* out, long long rows,
                      int num_p, int c_dim, const FlowLevelParams* prm, void* stream) {
  if (rows <= 0 || num_p <= 0) return 0;
  const long long smem = flow_level_smem_bytes(c_dim, prm);
  cudaError_t err =
      cudaFuncSetAttribute(flow_level_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((rows + kRows - 1) / kRows), static_cast<unsigned>(num_p));
  flow_level_kernel<<<grid, kThreads, static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(
      z, ctx, parts, out, rows, num_p, c_dim, *prm);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
