// Blocked top-2 descriptor matcher for Hopper (sm_90a).
//
// Replaces sfmfromscratch_tpu/ops/pallas/match_kernel.py::_match_kernel.
// For every query row a of d1 and every database row b of d2 it ranks
// rel(a, b) = ||b||^2 - 2 a.b (the wrapper supplies ||b||^2, with 1e12 for
// masked rows, and adds ||a||^2 afterwards) and returns the smallest and
// second-smallest rel and the index of the smallest. The (n1, n2) distance
// matrix never reaches device memory.
//
// Block (16 x 16 threads) -> TM = 32 query rows of one pair. The block walks
// the database in tiles of TN = 64 rows; each tile's 32 x 64 cross products
// are a register-tiled FP32 FMA product (2 rows x 4 columns per thread)
// over chunks of KC = 32 descriptor dimensions staged in shared memory.
// Tensor cores (TF32/bf16, wgmma) would change the arithmetic and are left
// for a later change: this kernel reproduces the JAX float32 path.
//
// Running top-2: each thread keeps (b1, i1, b2) for its 2 rows over the
// columns it owns, visited in increasing index order, updated with a strict
// `<` so ties keep the lowest index (jnp.argmin / lax.top_k semantics). At
// the end the 16 threads that share a row merge their partials with the rule
// of match_kernel.py:96-98, ties broken toward the lower index:
//   b1' = min(b1, m1), i1' = (b1 < m1 || (b1 == m1 && i1 < g1)) ? i1 : g1,
//   b2' = min(max(b1, m1), min(b2, m2)).
//
// Bound: 2 * n1 * n2 * D flops per pair (1.60 GFLOP at 2499 x 2499 x 128),
// 24 us at the H100 SXM's 67 TFLOP/s FP32 rate: compute-bound. This first
// version uses CUDA-core FMAs from shared memory and is not tuned.

#include <cuda_runtime.h>

namespace {

constexpr int TM = 32;       // query rows per block
constexpr int TN = 64;       // database rows per tile
constexpr int KC = 32;       // descriptor dimensions per shared-memory chunk
constexpr int TX = 16;       // threads along database columns
constexpr int TY = 16;       // threads along query rows
constexpr int RPT = TM / TY; // rows per thread (2)
constexpr int CPT = TN / TX; // columns per thread (4)
constexpr float BIG = 1e30f; // sentinel, as in the Pallas kernel

__device__ __forceinline__ void merge_top2(float& b1, int& i1, float& b2,
                                           float m1, int g1, float m2) {
  const bool keep = (b1 < m1) || (b1 == m1 && i1 < g1);
  const float nb2 = fminf(fmaxf(b1, m1), fminf(b2, m2));
  b1 = fminf(b1, m1);
  i1 = keep ? i1 : g1;
  b2 = nb2;
}

__global__ void __launch_bounds__(TX * TY)
match_top2_kernel(const float* __restrict__ d1, const float* __restrict__ d2,
                  const float* __restrict__ n2sq, float* __restrict__ dist1,
                  float* __restrict__ dist2, int* __restrict__ idx,
                  int n1, int n2, int D) {
  __shared__ float As[KC][TM + 1];
  __shared__ float Bs[KC][TN + 1];

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * TM;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * TX + tx;
  const float* A = d1 + (size_t)b * n1 * D;
  const float* Bm = d2 + (size_t)b * n2 * D;
  const float* nb = n2sq + (size_t)b * n2;

  float best1[RPT], best2[RPT];
  int arg1[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    best1[r] = BIG;
    best2[r] = BIG;
    arg1[r] = 0;
  }

  for (int c0 = 0; c0 < n2; c0 += TN) {
    float acc[RPT][CPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[r][c] = 0.0f;

    for (int k0 = 0; k0 < D; k0 += KC) {
      // Stage A (TM x KC) and B (TN x KC) chunks, transposed, zero-filled
      // past the ragged edges. Consecutive threads read consecutive k.
      for (int i = tid; i < TM * KC; i += TX * TY) {
        const int row = i / KC, k = i % KC;
        const int q = q0 + row, kk = k0 + k;
        As[k][row] = (q < n1 && kk < D) ? A[(size_t)q * D + kk] : 0.0f;
      }
      for (int i = tid; i < TN * KC; i += TX * TY) {
        const int col = i / KC, k = i % KC;
        const int j = c0 + col, kk = k0 + k;
        Bs[k][col] = (j < n2 && kk < D) ? Bm[(size_t)j * D + kk] : 0.0f;
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < KC; ++k) {
        float a[RPT], bv[CPT];
#pragma unroll
        for (int r = 0; r < RPT; ++r) a[r] = As[k][ty + r * TY];
#pragma unroll
        for (int c = 0; c < CPT; ++c) bv[c] = Bs[k][tx + c * TX];
#pragma unroll
        for (int r = 0; r < RPT; ++r)
#pragma unroll
          for (int c = 0; c < CPT; ++c) acc[r][c] = fmaf(a[r], bv[c], acc[r][c]);
      }
      __syncthreads();
    }

    // Running top-2 over this thread's columns, in increasing index order.
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int j = c0 + tx + c * TX;
      if (j >= n2) continue;
      const float nbj = nb[j];
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const float v = nbj - 2.0f * acc[r][c];
        if (v < best1[r]) {
          best2[r] = best1[r];
          best1[r] = v;
          arg1[r] = j;
        } else if (v < best2[r]) {
          best2[r] = v;
        }
      }
    }
  }

  // Merge across the 16 threads (a half-warp) that share each row.
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
#pragma unroll
    for (int off = TX / 2; off > 0; off >>= 1) {
      const float m1 = __shfl_xor_sync(0xffffffffu, best1[r], off);
      const int g1 = __shfl_xor_sync(0xffffffffu, arg1[r], off);
      const float m2 = __shfl_xor_sync(0xffffffffu, best2[r], off);
      merge_top2(best1[r], arg1[r], best2[r], m1, g1, m2);
    }
    const int q = q0 + ty + r * TY;
    if (tx == 0 && q < n1) {
      dist1[(size_t)b * n1 + q] = best1[r];
      dist2[(size_t)b * n1 + q] = best2[r];
      idx[(size_t)b * n1 + q] = arg1[r];
    }
  }
}

}  // namespace

// d1: (B, n1, D), d2: (B, n2, D), n2sq: (B, n2) float32, contiguous, on the
// device. Outputs dist1, dist2: (B, n1) float32 (||a||^2 not yet added) and
// idx: (B, n1) int32. Returns the CUDA error code of the launch.
extern "C" int sfm_match_top2(const void* d1, const void* d2, const void* n2sq,
                              void* dist1, void* dist2, void* idx,
                              int B, int n1, int n2, int D, void* stream) {
  if (B < 1 || n1 < 1 || n2 < 1 || D < 1) return (int)cudaErrorInvalidValue;
  dim3 block(TX, TY);
  dim3 grid((n1 + TM - 1) / TM, B);
  match_top2_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(d1), static_cast<const float*>(d2),
      static_cast<const float*>(n2sq), static_cast<float*>(dist1),
      static_cast<float*>(dist2), static_cast<int*>(idx), n1, n2, D);
  return (int)cudaGetLastError();
}
