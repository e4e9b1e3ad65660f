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
// Bound: one f32 read and one f32 write per pixel (8 bytes/pixel: 13.8 MB
// for the 10-image batch of the engine at 360x480, 4.1 us at 3.35 TB/s).
// The arithmetic is ~100 flops/pixel, far below the FP32 rate, so the kernel
// is bound by bytes, and at these sizes by the latency of each block's
// phases. The design:
//   - G (the Gaussian size) is a template parameter, instantiated for the odd
//     sizes 1..31: every tap loop unrolls and the taps stay in registers;
//   - a block of 32 x 8 threads computes a TILE_W x TILE_H = 32 x 64 output
//     tile (the taller tile cuts the halo's extra loads from ~56% at 32 x 32
//     to ~41% at G = 7); threads map to pixels through 2-D indices, or walk a
//     region flat by adding the block's stride to a (row, column) pair, with
//     no division or remainder at run time;
//   - 1. the input tile plus its halo is staged in shared memory, zero
//        outside the image, with 16-byte loads where the image's rows are
//        16-byte aligned (the left halo is rounded up to 4 pixels for that),
//        all of a thread's loads started before its first store;
//     2. Sobel gradients on the tile plus G/2, four pixels of a row per
//        thread from a 3 x 6 window in registers; a gradient whose pixel
//        lies outside the true image is zeroed (as the tiled Pallas kernel
//        does, harris_kernel.py:188-196), so tile and image borders keep
//        parity with the plain path; Ix^2, IxIy, Iy^2 go to shared memory;
//     3. the Gaussian along rows, four outputs of a row per thread from a
//        window of G + 3 values per map in registers;
//     4. the Gaussian along columns: each thread walks down a strip of 8 rows
//        of one column with a sliding window of 8 + G - 1 values per map in
//        registers (3 (8 + G - 1) shared-memory reads for 24 outputs instead
//        of 24 G), then the response;
//     5. the response tile is written to global memory with 16-byte stores
//        where the rows allow, else 128-byte coalesced rows of scalars.

#include <cuda_runtime.h>

namespace {

constexpr int TILE_W = 32;
constexpr int TILE_H = 64;
constexpr int BLOCK_X = 32;
constexpr int BLOCK_Y = 8;
constexpr int STRIP = TILE_H / BLOCK_Y;   // output rows per thread in pass 4 (8)
constexpr int MAX_DEVICES = 64;

template <int G>
struct Taps {
  float v[G];
};

template <int G>
struct Geometry {
  static constexpr int g = G / 2;
  static constexpr int halo = g + 1;                       // Sobel (1) + Gaussian reach
  static constexpr int left = (halo + 3) / 4 * 4;          // left halo, 16-byte aligned
  static constexpr int gw = TILE_W + 2 * g;                // gradient region
  static constexpr int gh = TILE_H + 2 * g;
  static constexpr int gq = (gw + 3) / 4;                  // its column quads
  static constexpr int gs = 4 * gq;                        // its row pitch
  // Input pitch: the tile and halo, and the windows of the last quad.
  static constexpr int need_w = left + TILE_W + halo > gs + left - halo + 2
                                    ? left + TILE_W + halo : gs + left - halo + 2;
  static constexpr int in_w = (need_w + 3) / 4 * 4;
  static constexpr int in_h = TILE_H + 2 * halo;
  static constexpr int floats = in_h * in_w + 3 * gh * gs + 3 * gh * TILE_W;
};

template <int G>
__global__ void __launch_bounds__(BLOCK_X * BLOCK_Y)
harris_kernel(const float* __restrict__ img, float* __restrict__ out, Taps<G> taps,
              float alpha, int H, int W, int vec) {
  using Geo = Geometry<G>;
  constexpr int g = Geo::g, halo = Geo::halo, left = Geo::left;
  constexpr int in_w = Geo::in_w, in_h = Geo::in_h, gh = Geo::gh, gq = Geo::gq, gs = Geo::gs;
  extern __shared__ float4 smem_f4[];
  float* s_in = reinterpret_cast<float*>(smem_f4);   // in_h x in_w
  float* s_xx = s_in + in_h * in_w;                  // gh x gs each
  float* s_xy = s_xx + gh * gs;
  float* s_yy = s_xy + gh * gs;
  float* r_xx = s_yy + gh * gs;                      // gh x TILE_W each
  float* r_xy = r_xx + gh * TILE_W;
  float* r_yy = r_xy + gh * TILE_W;

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int b = blockIdx.z;
  const int row0 = blockIdx.y * TILE_H;
  const int col0 = blockIdx.x * TILE_W;
  const float* src = img + (size_t)b * H * W;
  float* dst = out + (size_t)b * H * W;

  // Flat walks over a region of width w: thread t starts at (t / w, t % w),
  // found by subtraction, and steps by the block's 256 threads, which is
  // (256 / w) rows plus (256 % w) columns, both compile-time constants.
  constexpr int NT = BLOCK_X * BLOCK_Y;
  const int tid = ty * BLOCK_X + tx;

  // 1. Input tile plus halo; s_in(i, j) is pixel (row0 - halo + i, col0 - left + j).
  if (vec) {
    // One float4 per step; W % 4 == 0 and col0 - left is a multiple of 4,
    // so a float4 lies wholly inside or outside a row. All loads of a
    // thread are started before any store.
    constexpr int w4 = in_w / 4;
    constexpr int steps = (in_h * w4 + NT - 1) / NT;
    int i = 0, j4 = tid;
    while (j4 >= w4) { j4 -= w4; ++i; }
    float4 v[steps];
    int at[steps];
#pragma unroll
    for (int u = 0; u < steps; ++u) {
      const int r = row0 - halo + i, c = col0 - left + j4 * 4;
      v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      at[u] = i < in_h ? i * in_w + j4 * 4 : -1;
      if (i < in_h && r >= 0 && r < H && c >= 0 && c < W)
        v[u] = __ldg(reinterpret_cast<const float4*>(src + (size_t)r * W + c));
      i += NT / w4;
      j4 += NT % w4;
      if (j4 >= w4) { j4 -= w4; ++i; }
    }
#pragma unroll
    for (int u = 0; u < steps; ++u)
      if (at[u] >= 0) *reinterpret_cast<float4*>(s_in + at[u]) = v[u];
  } else {
    for (int i = ty; i < in_h; i += BLOCK_Y) {
      const int r = row0 - halo + i;
      for (int j = tx; j < in_w; j += BLOCK_X) {
        const int c = col0 - left + j;
        s_in[i * in_w + j] = (r >= 0 && r < H && c >= 0 && c < W) ? __ldg(src + (size_t)r * W + c) : 0.0f;
      }
    }
  }
  __syncthreads();

  // 2. Sobel at gradient-region pixel (i, j) = image pixel (row0 - g + i,
  //    col0 - g + j), the centre of s_in's 3x3 window at (i + 1, j + left - g).
  //    A thread takes 4 pixels of a row from a 3 x 6 window in registers.
  {
    int i = 0, q = tid;
    while (q >= gq) { q -= gq; ++i; }
    for (; i < gh;) {
      const int r = row0 - g + i;
      const int j0 = 4 * q;
      const float* p = s_in + i * in_w + (j0 + left - halo);   // top-left of the first window
      float a0[6], a1[6], a2[6];
#pragma unroll
      for (int e = 0; e < 6; ++e) {
        a0[e] = p[e];
        a1[e] = p[in_w + e];
        a2[e] = p[2 * in_w + e];
      }
      const bool row_in = r >= 0 && r < H;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = col0 - g + j0 + e;
        float ix = 0.0f, iy = 0.0f;
        if (row_in && c >= 0 && c < W) {
          // Separable as in the Pallas kernel: horizontal pass then vertical.
          const float dx0 = a0[e + 2] - a0[e];
          const float dx1 = a1[e + 2] - a1[e];
          const float dx2 = a2[e + 2] - a2[e];
          ix = dx0 + 2.0f * dx1 + dx2;
          const float sm0 = a0[e] + 2.0f * a0[e + 1] + a0[e + 2];
          const float sm2 = a2[e] + 2.0f * a2[e + 1] + a2[e + 2];
          iy = sm2 - sm0;
        }
        const int k = i * gs + j0 + e;
        s_xx[k] = ix * ix;
        s_xy[k] = ix * iy;
        s_yy[k] = iy * iy;
      }
      i += NT / gq;
      q += NT % gq;
      if (q >= gq) { q -= gq; ++i; }
    }
  }
  __syncthreads();

  // 3. Gaussian along rows: (gh, gs) -> (gh, TILE_W), 4 outputs of a row per
  //    thread from a window of G + 3 values per map in registers.
  {
    constexpr int Q = TILE_W / 4;
    static_assert(Q == 8, "quads of a tile row");
    for (int i = tid >> 3, q = tid & 7; i < gh; i += NT / Q) {
      const int base = i * gs + 4 * q;
      float wxx[G + 3], wxy[G + 3], wyy[G + 3];
#pragma unroll
      for (int k = 0; k < G + 3; ++k) {
        wxx[k] = s_xx[base + k];
        wxy[k] = s_xy[base + k];
        wyy[k] = s_yy[base + k];
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float axx = 0.0f, axy = 0.0f, ayy = 0.0f;
#pragma unroll
        for (int k = 0; k < G; ++k) {
          const float w = taps.v[k];
          axx += w * wxx[e + k];
          axy += w * wxy[e + k];
          ayy += w * wyy[e + k];
        }
        const int o = i * TILE_W + 4 * q + e;
        r_xx[o] = axx;
        r_xy[o] = axy;
        r_yy[o] = ayy;
      }
    }
  }
  __syncthreads();

  // 4. Gaussian along columns over a window in registers, then the response,
  //    kept in s_in (free since pass 2) for the vectorised store.
  const int i0 = ty * STRIP;
  float wxx[STRIP + G - 1], wxy[STRIP + G - 1], wyy[STRIP + G - 1];
#pragma unroll
  for (int k = 0; k < STRIP + G - 1; ++k) {
    const int o = (i0 + k) * TILE_W + tx;
    wxx[k] = r_xx[o];
    wxy[k] = r_xy[o];
    wyy[k] = r_yy[o];
  }
  float resp[STRIP];
#pragma unroll
  for (int s = 0; s < STRIP; ++s) {
    float sxx = 0.0f, sxy = 0.0f, syy = 0.0f;
#pragma unroll
    for (int k = 0; k < G; ++k) {
      const float w = taps.v[k];
      sxx += w * wxx[s + k];
      sxy += w * wxy[s + k];
      syy += w * wyy[s + k];
    }
    const float det = sxx * syy - sxy * sxy;
    const float tr = sxx + syy;
    resp[s] = det - alpha * tr * tr;
  }

  // 5. Store.
  if (vec) {
#pragma unroll
    for (int s = 0; s < STRIP; ++s) s_in[(i0 + s) * TILE_W + tx] = resp[s];
    __syncthreads();
    const int c4 = tid & (TILE_W / 4 - 1);
    for (int i = tid >> 3; i < TILE_H; i += BLOCK_X * BLOCK_Y / (TILE_W / 4)) {
      const int r = row0 + i, c = col0 + c4 * 4;
      if (r < H && c < W)
        *reinterpret_cast<float4*>(dst + (size_t)r * W + c) =
            *reinterpret_cast<const float4*>(s_in + i * TILE_W + c4 * 4);
    }
  } else {
    const int c = col0 + tx;
#pragma unroll
    for (int s = 0; s < STRIP; ++s) {
      const int r = row0 + i0 + s;
      if (r < H && c < W) dst[(size_t)r * W + c] = resp[s];
    }
  }
}

template <int G>
int launch(const float* img, float* out, const float* taps_in, float alpha, int B, int H, int W,
           cudaStream_t stream) {
  // The dynamic shared-memory attribute, raised once per device.
  static bool raised[MAX_DEVICES] = {};
  constexpr size_t smem = Geometry<G>::floats * sizeof(float);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!raised[dev]) {
    err = cudaFuncSetAttribute(harris_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    raised[dev] = true;
  }
  Taps<G> t;
  for (int k = 0; k < G; ++k) t.v[k] = taps_in[k];
  const int vec = (W % 4 == 0) && (reinterpret_cast<size_t>(img) % 16 == 0) &&
                  (reinterpret_cast<size_t>(out) % 16 == 0);
  const dim3 block(BLOCK_X, BLOCK_Y);
  const dim3 grid((W + TILE_W - 1) / TILE_W, (H + TILE_H - 1) / TILE_H, B);
  harris_kernel<G><<<grid, block, smem, stream>>>(img, out, t, alpha, H, W, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// img, out: (B, H, W) float32, contiguous, on the device. taps: G host floats,
// G odd, 1..31. Returns the CUDA error code of the launch (0 on success).
extern "C" int sfm_harris_response(const void* img, void* out, const float* taps, int G,
                                   float alpha, int B, int H, int W, void* stream) {
  if (B < 1 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const float* in = static_cast<const float*>(img);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (G) {
#define SFM_HARRIS_CASE(n) \
  case n:                  \
    return launch<n>(in, o, taps, alpha, B, H, W, st);
    SFM_HARRIS_CASE(1) SFM_HARRIS_CASE(3) SFM_HARRIS_CASE(5) SFM_HARRIS_CASE(7) SFM_HARRIS_CASE(9)
    SFM_HARRIS_CASE(11) SFM_HARRIS_CASE(13) SFM_HARRIS_CASE(15) SFM_HARRIS_CASE(17)
    SFM_HARRIS_CASE(19) SFM_HARRIS_CASE(21) SFM_HARRIS_CASE(23) SFM_HARRIS_CASE(25)
    SFM_HARRIS_CASE(27) SFM_HARRIS_CASE(29) SFM_HARRIS_CASE(31)
#undef SFM_HARRIS_CASE
    default:
      return (int)cudaErrorInvalidValue;   // even G, or G outside 1..31
  }
}
