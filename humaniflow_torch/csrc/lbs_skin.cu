// Kernel K7: linear blend skinning of channel-major posed vertices.
//
// Replaces the TPU kernel `_lbs_kernel` of humaniflow_tpu/models/pallas_lbs.py
// (called through `lbs_skin_pallas_cm`):
//
//   out[b, c, v] = sum_j W[v, j] * (sum_i R_j[c, i] * p[b, i, v] + t_j[c])
//
// with a12[b, j] = [R_j (row-major 9) | t_j (3)].
//
// Bound: 12*24 + 12 FMAs per (row, vertex), against the read of the posed
// vertices and the write of the output: at B*N = 3200 rows and V = 6890,
// 13.2 GFLOP (0.197 ms at the float32 peak) against 0.53 GB (0.158 ms at
// 3.35 TB/s).  No path of the JAX package or of the port calls it: the SMPL
// forward fuses skinning into K1 and K2.
//
// Design: a block owns kVT = 512 vertices and kRows = 16 rows; each thread owns four vertices (two pairs 256 apart
// when V is even, so that a warp's float2 loads and stores of the posed
// vertices and the output are coalesced) and holds their 4 x 24 skinning
// weights in registers, read once for all the block's rows.  The rows' a12
// stream through shared memory in chunks of 4 rows, double-buffered, each
// chunk one TMA bulk copy completing an mbarrier (a row of V = 6890 floats
// is not 16-byte aligned, so the posed vertices cannot go by TMA): each
// thread stages its own posed vertices of the next chunk with cp.async
// while it computes this one, so no registers wait on device memory.  Per
// row a thread forms the 12 transform entries T[r] = sum_j W[v, j] *
// a12[b, j, r] of its four vertices with float32 FMAs: every broadcast
// float4 of a12 feeds 16.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kVT = 4 * kThreads;  // vertices per block: 4 a thread
constexpr int kJ = 24;             // joints
constexpr int kA = kJ * 12;        // a12 floats per row
constexpr int kRows = 16;          // rows per block
constexpr int kChunk = 4;          // rows per TMA chunk of a12 and per cp.async stage of posed vertices
static_assert(kRows % kChunk == 0, "a block's rows are whole chunks");
constexpr int kStages = 2;         // posed-vertex chunks in flight
constexpr int kPosedBytes = kStages * kChunk * 3 * kThreads * 16;  // dynamic shared memory

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// Chunk `k` of the block's rows (rows b0 + kChunk k ..) into buffer k % 2.
__device__ __forceinline__ void load_chunk(float* dst, const float* a12, int b0, int nb, int k, uint64_t* bar) {
  const int rows = min(kChunk, nb - k * kChunk);
  const uint32_t bytes = static_cast<uint32_t>(rows * kA * sizeof(float));
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_addr(dst)),
      "l"(a12 + static_cast<long long>(b0 + k * kChunk) * kA), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void cp_async(void* dst, const float* src, int bytes, bool valid) {
  // bytes 4 or 8; a vertex past V reads nothing and lands as zeros
  if (bytes == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
                 "r"(valid ? 8 : 0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
                 "r"(valid ? 4 : 0)
                 : "memory");
  }
}

// kPairs: V is even, so a thread's vertices are two float2 of each channel
// (pairs start at even vertices, and a row's channels at multiples of V);
// else they lie 128 apart.  Dynamic shared memory: the posed vertices of
// kStages chunks, [stage][row][channel][thread] float4, each thread's own
// copies.
template <bool kPairs>
__global__ void __launch_bounds__(kThreads) lbs_skin_kernel(const float* __restrict__ w,
                                                            const float* __restrict__ a12,
                                                            const float* __restrict__ posed,
                                                            float* __restrict__ out, int B, int V) {
  extern __shared__ float4 dyn[];
  float4* s_p = dyn;
  __shared__ alignas(128) float s_a[2][kChunk * kA];
  __shared__ uint64_t bars[2];
  const int b0 = blockIdx.y * kRows;
  const int nb = min(kRows, B - b0);
  const int chunks = (nb + kChunk - 1) / kChunk;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(&bars[i])) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    for (int k = 0; k < 2 && k < chunks; ++k) load_chunk(s_a[k], a12, b0, nb, k, &bars[k]);
  }

  int vv[4];
  if (kPairs) {
    vv[0] = blockIdx.x * kVT + 2 * tid;
    vv[1] = vv[0] + 1;
    vv[2] = vv[0] + kVT / 2;
    vv[3] = vv[2] + 1;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) vv[q] = blockIdx.x * kVT + tid + q * kThreads;
  }
  // chunk k's posed vertices of this thread into stage k % kStages
  auto stage_posed = [&](int k) {
    const int rows = min(kChunk, nb - k * kChunk);
    float4* dst = s_p + (k % kStages) * kChunk * 3 * kThreads + tid;
    for (int rr = 0; rr < rows; ++rr) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float* pc = posed + (static_cast<long long>(b0 + k * kChunk + rr) * 3 + c) * V;
        float* d = reinterpret_cast<float*>(dst + (rr * 3 + c) * kThreads);
        if (kPairs) {
          cp_async(d, pc + (vv[0] < V ? vv[0] : 0), 8, vv[0] < V);
          cp_async(d + 2, pc + (vv[2] < V ? vv[2] : 0), 8, vv[2] < V);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) cp_async(d + q, pc + (vv[q] < V ? vv[q] : 0), 4, vv[q] < V);
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  stage_posed(0);

  float wv[4][kJ];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int v = vv[q];
    if (v < V) {
      const float4* w4 = reinterpret_cast<const float4*>(w + static_cast<long long>(v) * kJ);
#pragma unroll
      for (int i = 0; i < kJ / 4; ++i) {
        const float4 t = __ldg(w4 + i);
        wv[q][4 * i] = t.x;
        wv[q][4 * i + 1] = t.y;
        wv[q][4 * i + 2] = t.z;
        wv[q][4 * i + 3] = t.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < kJ; ++j) wv[q][j] = 0.f;
    }
  }

  for (int k = 0; k < chunks; ++k) {
    if (k + 1 < chunks) {
      stage_posed(k + 1);
    } else {
      asm volatile("cp.async.commit_group;\n" ::: "memory");  // an empty group keeps the count
    }
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // chunk k's own copies have landed
    mbar_wait(&bars[k & 1], (k >> 1) & 1);
    const int rows = min(kChunk, nb - k * kChunk);
    const float4* sp = s_p + (k % kStages) * kChunk * 3 * kThreads + tid;
    for (int rr = 0; rr < rows; ++rr) {
      const float4* a = reinterpret_cast<const float4*>(s_a[k & 1] + rr * kA);
      float t[4][12];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int i = 0; i < 12; ++i) t[q][i] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const float4 q0 = a[3 * j], q1 = a[3 * j + 1], q2 = a[3 * j + 2];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float x = wv[q][j];
          t[q][0] = fmaf(x, q0.x, t[q][0]);
          t[q][1] = fmaf(x, q0.y, t[q][1]);
          t[q][2] = fmaf(x, q0.z, t[q][2]);
          t[q][3] = fmaf(x, q0.w, t[q][3]);
          t[q][4] = fmaf(x, q1.x, t[q][4]);
          t[q][5] = fmaf(x, q1.y, t[q][5]);
          t[q][6] = fmaf(x, q1.z, t[q][6]);
          t[q][7] = fmaf(x, q1.w, t[q][7]);
          t[q][8] = fmaf(x, q2.x, t[q][8]);
          t[q][9] = fmaf(x, q2.y, t[q][9]);
          t[q][10] = fmaf(x, q2.z, t[q][10]);
          t[q][11] = fmaf(x, q2.w, t[q][11]);
        }
      }
      float p[3][4];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float4 pc = sp[(rr * 3 + c) * kThreads];
        p[c][0] = pc.x;
        p[c][1] = pc.y;
        p[c][2] = pc.z;
        p[c][3] = pc.w;
      }
      const long long base = static_cast<long long>(b0 + k * kChunk + rr) * 3 * V;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float o[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          o[q] = fmaf(t[q][3 * c], p[0][q], fmaf(t[q][3 * c + 1], p[1][q], fmaf(t[q][3 * c + 2], p[2][q], t[q][9 + c])));
        }
        float* oc = out + base + static_cast<long long>(c) * V;
        if (kPairs) {
          if (vv[0] < V) *reinterpret_cast<float2*>(oc + vv[0]) = make_float2(o[0], o[1]);
          if (vv[2] < V) *reinterpret_cast<float2*>(oc + vv[2]) = make_float2(o[2], o[3]);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (vv[q] < V) oc[vv[q]] = o[q];
          }
        }
      }
    }
    if (k + 2 < chunks) {
      __syncthreads();  // every thread is done with this chunk's a12 buffer
      if (tid == 0) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        load_chunk(s_a[k & 1], a12, b0, nb, k + 2, &bars[k & 1]);
      }
    }
  }
}

}  // namespace

extern "C" {

// w: (V, 24) float32; a12: (B, 24, 12) float32; posed: (B, 3, V) float32;
// out: (B, 3, V) float32.  All device pointers, contiguous, 16-byte
// aligned.  Launch on `stream`;
// return cudaGetLastError().
int lbs_skin_launch(const void* w, const void* a12, const void* posed, void* out, int B, int V, void* stream) {
  if (B <= 0 || V <= 0) return 0;
  const int row_blocks = (B + kRows - 1) / kRows;
  if (row_blocks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((V + kVT - 1) / kVT, row_blocks);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (V % 2 == 0) {
    cudaError_t err = cudaFuncSetAttribute(lbs_skin_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           kPosedBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    lbs_skin_kernel<true><<<grid, kThreads, kPosedBytes, s>>>(static_cast<const float*>(w),
                                                              static_cast<const float*>(a12),
                                                              static_cast<const float*>(posed),
                                                              static_cast<float*>(out), B, V);
  } else {
    cudaError_t err = cudaFuncSetAttribute(lbs_skin_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           kPosedBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    lbs_skin_kernel<false><<<grid, kThreads, kPosedBytes, s>>>(static_cast<const float*>(w),
                                                               static_cast<const float*>(a12),
                                                               static_cast<const float*>(posed),
                                                               static_cast<float*>(out), B, V);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
