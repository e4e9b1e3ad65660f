// Fused Harris response for Hopper (sm_90a).
//
// Replaces sfmfromscratch_tpu/ops/pallas/harris_kernel.py::_harris_kernel
// (whole image per grid step) and ::_harris_tiled_kernel (row slabs with a
// halo, for images past the TPU's 12 MB VMEM gate). Hopper has no such gate:
// one 2-D tiled kernel covers both regimes.
//
// R = det(M) - alpha * trace(M)^2, M = Gaussian-smoothed Sobel second moments.
// Sobel taps (-1,0,1) x (1,2,1) and the separable normalised Gaussian are
// cross-correlations with zero padding (cv2 BORDER_CONSTANT).
//
// Block (32 x 8 threads) -> one TILE_H x TILE_W output tile of one image.
//   1. Stage the tile plus a halo of G/2 + 1 pixels in shared memory, zeros
//      outside the image.
//   2. Sobel gradients on the tile plus G/2; a gradient whose pixel lies
//      outside the true image is zeroed (as the tiled Pallas kernel does,
//      harris_kernel.py:188-196), so tile and image borders keep parity with
//      the plain path. Store Ix^2, IxIy, Iy^2.
//   3. Gaussian along rows, then along columns, through shared memory.
//   4. Write R.
//
// Bound: one f32 read and one f32 write per pixel (8 bytes/pixel; 3.46 MB for
// the three pyramid levels of one 360x480 image, ~1 us at 3.35 TB/s). The
// arithmetic is ~100 flops/pixel, far below the FP32 rate, so the kernel is
// memory- and at these sizes launch-bound. The design reads each input pixel
// from device memory once per tile (halo re-reads are ~30% at G=7) and keeps
// every intermediate in shared memory; it is not tuned further.

#include <cuda_runtime.h>

namespace {

constexpr int TILE_W = 32;
constexpr int TILE_H = 32;
constexpr int BLOCK_X = 32;
constexpr int BLOCK_Y = 8;
constexpr int MAX_TAPS = 31;

// The Gaussian taps travel by value in the kernel's parameters.
struct Taps {
  float v[MAX_TAPS];
};

__global__ void harris_kernel(const float* __restrict__ img,
                              float* __restrict__ out, Taps taps,
                              int G, float alpha, int H, int W) {
  extern __shared__ float smem[];
  const int g = G / 2;
  const int halo = g + 1;
  const int in_w = TILE_W + 2 * halo;
  const int in_h = TILE_H + 2 * halo;
  const int gw = TILE_W + 2 * g;  // gradient region width
  const int gh = TILE_H + 2 * g;  // gradient region height

  float* s_in = smem;                      // in_h * in_w
  float* s_xx = s_in + in_h * in_w;        // gh * gw (then gh * TILE_W after row pass)
  float* s_xy = s_xx + gh * gw;
  float* s_yy = s_xy + gh * gw;
  float* r_xx = s_yy + gh * gw;            // gh * TILE_W
  float* r_xy = r_xx + gh * TILE_W;
  float* r_yy = r_xy + gh * TILE_W;

  const int b = blockIdx.z;
  const int row0 = blockIdx.y * TILE_H;
  const int col0 = blockIdx.x * TILE_W;
  const float* src = img + (size_t)b * H * W;
  const int tid = threadIdx.y * BLOCK_X + threadIdx.x;
  const int nthreads = BLOCK_X * BLOCK_Y;

  // Taps into shared memory, each read with a constant index: indexing the
  // parameter struct with a variable would copy it to the local stack.
  __shared__ float s_taps[MAX_TAPS];
#pragma unroll
  for (int k = 0; k < MAX_TAPS; ++k)
    if (tid == k) s_taps[k] = taps.v[k];

  // 1. Input tile plus halo, zero outside the image.
  for (int i = tid; i < in_h * in_w; i += nthreads) {
    const int r = row0 - halo + i / in_w;
    const int c = col0 - halo + i % in_w;
    s_in[i] = (r >= 0 && r < H && c >= 0 && c < W) ? src[(size_t)r * W + c] : 0.0f;
  }
  __syncthreads();

  // 2. Sobel at gradient-region pixel (gr, gc) = input pixel (gr+1, gc+1).
  for (int i = tid; i < gh * gw; i += nthreads) {
    const int gr = i / gw;
    const int gc = i % gw;
    const int r = row0 - g + gr;
    const int c = col0 - g + gc;
    float ix = 0.0f, iy = 0.0f;
    if (r >= 0 && r < H && c >= 0 && c < W) {
      const float* p = s_in + gr * in_w + gc;  // top-left of the 3x3 window
      // Separable as in the Pallas kernel: horizontal pass then vertical.
      const float dx0 = p[2] - p[0];
      const float dx1 = p[in_w + 2] - p[in_w];
      const float dx2 = p[2 * in_w + 2] - p[2 * in_w];
      ix = dx0 + 2.0f * dx1 + dx2;
      const float sm0 = p[0] + 2.0f * p[1] + p[2];
      const float sm2 = p[2 * in_w] + 2.0f * p[2 * in_w + 1] + p[2 * in_w + 2];
      iy = sm2 - sm0;
    }
    s_xx[i] = ix * ix;
    s_xy[i] = ix * iy;
    s_yy[i] = iy * iy;
  }
  __syncthreads();

  // 3a. Gaussian along rows: (gh, gw) -> (gh, TILE_W).
  for (int i = tid; i < gh * TILE_W; i += nthreads) {
    const int rr = i / TILE_W;
    const int cc = i % TILE_W;
    const int base = rr * gw + cc;
    float axx = 0.0f, axy = 0.0f, ayy = 0.0f;
    for (int k = 0; k < G; ++k) {
      const float w = s_taps[k];
      axx += w * s_xx[base + k];
      axy += w * s_xy[base + k];
      ayy += w * s_yy[base + k];
    }
    r_xx[i] = axx;
    r_xy[i] = axy;
    r_yy[i] = ayy;
  }
  __syncthreads();

  // 3b. Gaussian along columns and 4. the response.
  float* dst = out + (size_t)b * H * W;
  for (int i = tid; i < TILE_H * TILE_W; i += nthreads) {
    const int rr = i / TILE_W;
    const int cc = i % TILE_W;
    const int r = row0 + rr;
    const int c = col0 + cc;
    if (r >= H || c >= W) continue;
    float sxx = 0.0f, sxy = 0.0f, syy = 0.0f;
    for (int k = 0; k < G; ++k) {
      const float w = s_taps[k];
      const int j = (rr + k) * TILE_W + cc;
      sxx += w * r_xx[j];
      sxy += w * r_xy[j];
      syy += w * r_yy[j];
    }
    const float det = sxx * syy - sxy * sxy;
    const float tr = sxx + syy;
    dst[(size_t)r * W + c] = det - alpha * tr * tr;
  }
}

size_t smem_bytes(int G) {
  const int g = G / 2;
  const int halo = g + 1;
  const size_t in_sz = (size_t)(TILE_H + 2 * halo) * (TILE_W + 2 * halo);
  const size_t grad_sz = (size_t)(TILE_H + 2 * g) * (TILE_W + 2 * g);
  const size_t row_sz = (size_t)(TILE_H + 2 * g) * TILE_W;
  return (in_sz + 3 * grad_sz + 3 * row_sz) * sizeof(float);
}

}  // namespace

// img, out: (B, H, W) float32, contiguous, on the device. taps: G host floats.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int sfm_harris_response(const void* img, void* out, const float* taps,
                                   int G, float alpha, int B, int H, int W,
                                   void* stream) {
  if (G < 1 || G > MAX_TAPS || (G % 2) == 0) return (int)cudaErrorInvalidValue;
  Taps t = {};
  for (int k = 0; k < G; ++k) t.v[k] = taps[k];
  const size_t smem = smem_bytes(G);
  cudaError_t err = cudaFuncSetAttribute(harris_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 block(BLOCK_X, BLOCK_Y);
  dim3 grid((W + TILE_W - 1) / TILE_W, (H + TILE_H - 1) / TILE_H, B);
  harris_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<float*>(out), t, G, alpha, H, W);
  return (int)cudaGetLastError();
}
