// Blocked top-2 descriptor matcher for Hopper (sm_90a), f32 and bf16 modes.
//
// Replaces sfmfromscratch_tpu/ops/pallas/match_kernel.py::_match_kernel,
// with its bf16=True mode (match_kernel.py:47-48, 56-57, 76-77). For every
// query row a of d1 and every database row b of d2 it ranks
// rel(a, b) = ||b||^2 - 2 a.b (the wrapper supplies ||b||^2, with 1e12 for
// masked rows, and adds ||a||^2 afterwards) and returns the smallest and
// second-smallest rel and the index of the smallest. The (n1, n2) distance
// matrix never reaches device memory.
//
// Bound: 2 * n1 * n2 * D flops per pair, 14.4 GFLOP for the engine's 9 pairs
// of 2499 x 2499 x 128: 0.215 ms at the H100 SXM's 67 TFLOP/s FP32 rate,
// 0.0146 ms at its 989 TFLOP/s dense bf16 rate. The f32 mode is bound by
// the rate at which its FP32 FMAs go out (with operands in registers only,
// the same loop reaches about half of the peak; tools/kernel_ablation.py);
// in the bf16 mode the database loads and their conversion, the top-2
// epilogue over n1 * n2 values on the CUDA cores and the mma each take a
// share, far above the tensor-core bound.
//
// Both modes: a block of 256 threads keeps TM = 128 queries resident in
// shared memory and walks the database in tiles of TN = 128 rows. When
// B * ceil(n1 / TM) blocks would leave SMs idle, the walk is split into S
// segments of whole tiles across blocks (grid.y); each block writes its
// partial (best, index, second) triples and a second kernel merges them in
// segment order. Each thread keeps a running top-2 per row over the columns
// it owns, visited in increasing index order with a strict `<`, so ties keep
// the lowest index (jnp.argmin / lax.top_k). Partial top-2s merge with the
// rule of match_kernel.py:96-98, ties broken toward the lower index:
//   b1' = min(b1, m1), i1' = (b1 < m1 || (b1 == m1 && i1 < g1)) ? i1 : g1,
//   b2' = min(max(b1, m1), min(b2, m2)).
// The merge gives the exact top-2 of the union in any order, so the result
// does not depend on the split; no atomics are used.
//
// f32 mode (FP32 FMA on CUDA cores, the JAX float32 arithmetic; no TF32):
//   - database chunks of TN x KC (KC = 32) go through a 3-stage ring filled
//     by 16-byte cp.async copies, so loads overlap the FMAs;
//   - each thread owns an 8 x 8 micro-tile (rows ty + 16 i, columns
//     tx + 16 j) and reads A and B as float4 along k from row-major tiles
//     padded by 4 floats (conflict-free): 16 LDS.128 per 256 FMA.
// bf16 mode (mma.sync.m16n8k16 bf16 x bf16 -> f32 on tensor cores):
//   - A and the database chunks are rounded to bf16 (round to nearest even,
//     as astype/`.bfloat16()` do) while they are staged; a chunk is loaded
//     into registers while the previous one is multiplied;
//   - 8 warps as 4 (rows) x 2 (columns), each a 32 x 64 tile of 2 x 8 mma
//     tiles fed by ldmatrix from tiles padded by 8 bf16 (conflict-free);
//   - the 4 lanes of a quad that share an accumulator row merge by shuffles,
//     the two column halves through shared memory;
//   - two blocks per SM, so that one block's top-2 epilogue overlaps the
//     other's loads and mma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TM = 128;        // query rows per block
constexpr int TN = 128;        // database rows per tile
constexpr int KC = 32;         // descriptor dimensions per staged chunk
constexpr int THREADS = 256;
constexpr int STAGES = 3;      // f32 cp.async ring depth
constexpr int PAD_F = 4;       // f32 row padding (floats)
constexpr int PAD_H = 8;       // bf16 row padding (bf16 values)
constexpr int MAX_DEVICES = 64;
constexpr float BIG = 1e30f;   // sentinel, as in the Pallas kernel

__device__ __forceinline__ void merge_top2(float& b1, int& i1, float& b2,
                                           float m1, int g1, float m2) {
  const bool keep = (b1 < m1) || (b1 == m1 && i1 < g1);
  const float nb2 = fminf(fmaxf(b1, m1), fminf(b2, m2));
  b1 = fminf(b1, m1);
  i1 = keep ? i1 : g1;
  b2 = nb2;
}

// One candidate into a running top-2, branch-free (a branchy update cost
// about half of the bf16 mode's time on the card): the second best is
// min(b2, max(b1, v)); a strict `<` keeps the earlier (lower) index on a tie.
__device__ __forceinline__ void push_top2(float& b1, int& i1, float& b2, float v, int j) {
  b2 = fminf(b2, fmaxf(b1, v));
  i1 = v < b1 ? j : i1;
  b1 = fminf(b1, v);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;   // 0 source bytes: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Where a block's result goes: the final outputs when S == 1, else its
// segment's slice of the partials (B, S, n1).
struct Out {
  float* dist1;
  float* dist2;
  int* idx;
};

__device__ __forceinline__ void store_result(const Out& o, int b, int seg, int S, int n1,
                                             int q, float b1, int i1, float b2) {
  const size_t at = ((size_t)b * S + seg) * n1 + q;
  o.dist1[at] = b1;
  o.dist2[at] = b2;
  o.idx[at] = i1;
}

// ---------------------------------------------------------------- f32 mode

__global__ void __launch_bounds__(THREADS, 1)
match_f32_kernel(const float* __restrict__ d1, const float* __restrict__ d2,
                 const float* __restrict__ n2sq, Out out, int n1, int n2, int D,
                 int tiles_per_seg) {
  extern __shared__ float4 smem_f4[];
  float* smem = reinterpret_cast<float*>(smem_f4);
  const int SA = D + PAD_F;
  constexpr int SB = KC + PAD_F;
  float* As = smem;                // TM x SA, resident
  float* Bs = smem + TM * SA;      // STAGES x TN x SB ring

  const int b = blockIdx.z;
  const int seg = blockIdx.y;
  const int S = gridDim.y;
  const int q0 = blockIdx.x * TM;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const float* A = d1 + (size_t)b * n1 * D;
  const float* Bm = d2 + (size_t)b * n2 * D;
  const float* nb = n2sq + (size_t)b * n2;

  const int n_tiles = (n2 + TN - 1) / TN;
  const int t_begin = seg * tiles_per_seg;
  const int t_end = min(t_begin + tiles_per_seg, n_tiles);
  const int nck = D / KC;                        // chunks per tile
  const int total = (t_end - t_begin) * nck;     // chunks of this block

  // Resident query tile, zero past n1.
  for (int r = ty; r < TM; r += 16) {
    const int q = q0 + r;
    for (int c4 = tx; c4 < D / 4; c4 += 16) {
      const bool ok = q < n1;
      cp_async16(As + r * SA + c4 * 4, ok ? A + (size_t)q * D + c4 * 4 : A, ok);
    }
  }
  // Chunk c of this block -> ring slot c % STAGES; rows past n2 zero-filled.
  auto load_chunk = [&](int c) {
    if (c < total) {
      const int tile = t_begin + c / nck;
      const int k0 = (c - (c / nck) * nck) * KC;
      float* dst = Bs + (c % STAGES) * TN * SB;
      const int c4 = tid & 7;
#pragma unroll
      for (int r = tid >> 3; r < TN; r += THREADS / 8) {
        const int j = tile * TN + r;
        const bool ok = j < n2;
        cp_async16(dst + r * SB + c4 * 4, ok ? Bm + (size_t)j * D + k0 + c4 * 4 : Bm, ok);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) load_chunk(s);

  float best1[8], best2[8];
  int arg1[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    best1[i] = BIG;
    best2[i] = BIG;
    arg1[i] = 0;
  }
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  int kc = 0, tile = t_begin;
  for (int c = 0; c < total; ++c) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();               // chunk c landed; slot of chunk c-1 is free
    load_chunk(c + STAGES - 1);

    const float* Ak = As + ty * SA + kc * KC;
    const float* Bk = Bs + (c % STAGES) * TN * SB + tx * SB;
#pragma unroll
    for (int k = 0; k < KC; k += 4) {
      float4 bv[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) bv[j] = *reinterpret_cast<const float4*>(Bk + j * 16 * SB + k);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(Ak + i * 16 * SA + k);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[i][j] = fmaf(a.x, bv[j].x, acc[i][j]);
          acc[i][j] = fmaf(a.y, bv[j].y, acc[i][j]);
          acc[i][j] = fmaf(a.z, bv[j].z, acc[i][j]);
          acc[i][j] = fmaf(a.w, bv[j].w, acc[i][j]);
        }
      }
    }

    if (++kc == nck) {
      // Tile done: running top-2 over this thread's columns, in increasing order.
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = tile * TN + tx + 16 * j;
        if (col < n2) {
          const float nbj = __ldg(nb + col);
#pragma unroll
          for (int i = 0; i < 8; ++i) push_top2(best1[i], arg1[i], best2[i], nbj - 2.0f * acc[i][j], col);
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i][j] = 0.0f;
      }
      kc = 0;
      ++tile;
    }
  }
  cp_async_wait<0>();

  // Merge across the 16 threads (a half-warp) that share each row.
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float m1 = __shfl_xor_sync(0xffffffffu, best1[i], off);
      const int g1 = __shfl_xor_sync(0xffffffffu, arg1[i], off);
      const float m2 = __shfl_xor_sync(0xffffffffu, best2[i], off);
      merge_top2(best1[i], arg1[i], best2[i], m1, g1, m2);
    }
    const int q = q0 + ty + 16 * i;
    if (tx == 0 && q < n1) store_result(out, b, seg, S, n1, q, best1[i], arg1[i], best2[i]);
  }
}

// --------------------------------------------------------------- bf16 mode

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x = lo at the lower address
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                            uint32_t& r3, const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(s));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two blocks per SM (at most 128 registers a thread, no spills): one block's
// top-2 epilogue overlaps the other's loads and mma.
__global__ void __launch_bounds__(THREADS, 2)
match_bf16_kernel(const float* __restrict__ d1, const float* __restrict__ d2,
                  const float* __restrict__ n2sq, Out out, int n1, int n2, int D,
                  int tiles_per_seg) {
  extern __shared__ float4 smem_f4[];
  const int SA = D + PAD_H;                      // bf16 values per A row
  constexpr int SB = KC + PAD_H;                 // bf16 values per B row
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem_f4);   // TM x SA
  __nv_bfloat16* Bs = As + TM * SA;                                // 2 x TN x SB
  float* mrg = reinterpret_cast<float*>(Bs + 2 * TN * SB);         // 3 x TM

  const int b = blockIdx.z;
  const int seg = blockIdx.y;
  const int S = gridDim.y;
  const int q0 = blockIdx.x * TM;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp & 3;     // rows wm*32 .. +32
  const int wn = warp >> 2;    // columns wn*64 .. +64 of each tile
  const float* A = d1 + (size_t)b * n1 * D;
  const float* Bm = d2 + (size_t)b * n2 * D;
  const float* nb = n2sq + (size_t)b * n2;

  const int n_tiles = (n2 + TN - 1) / TN;
  const int t_begin = seg * tiles_per_seg;
  const int t_end = min(t_begin + tiles_per_seg, n_tiles);
  const int nck = D / KC;
  const int total = (t_end - t_begin) * nck;

  // Resident query tile, rounded to bf16, zero past n1.
  for (int r = tid >> 5; r < TM; r += THREADS / 32) {
    const int q = q0 + r;
    for (int c4 = lane; c4 < D / 4; c4 += 32) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q < n1) v = __ldg(reinterpret_cast<const float4*>(A + (size_t)q * D) + c4);
      uint2 p;
      p.x = pack_bf16(v.x, v.y);
      p.y = pack_bf16(v.z, v.w);
      *reinterpret_cast<uint2*>(As + r * SA + c4 * 4) = p;
    }
  }

  // Database chunk c (TN rows x KC) through registers: 4 float4 per thread.
  const int c4 = tid & 7;
  float4 stage[TN * KC / 4 / THREADS];
  auto fetch = [&](int c) {
    const int tile = t_begin + c / nck;
    const int k0 = (c - (c / nck) * nck) * KC;
#pragma unroll
    for (int u = 0; u < TN * KC / 4 / THREADS; ++u) {
      const int j = tile * TN + (tid >> 3) + u * (THREADS / 8);
      stage[u] = j < n2 ? __ldg(reinterpret_cast<const float4*>(Bm + (size_t)j * D + k0) + c4)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  auto put = [&](int slot) {
    __nv_bfloat16* dst = Bs + slot * TN * SB;
#pragma unroll
    for (int u = 0; u < TN * KC / 4 / THREADS; ++u) {
      const int r = (tid >> 3) + u * (THREADS / 8);
      uint2 p;
      p.x = pack_bf16(stage[u].x, stage[u].y);
      p.y = pack_bf16(stage[u].z, stage[u].w);
      *reinterpret_cast<uint2*>(dst + r * SB + c4 * 4) = p;
    }
  };

  float best1[4], best2[4];
  int arg1[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    best1[i] = BIG;
    best2[i] = BIG;
    arg1[i] = 0;
  }
  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 8; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.0f;

  fetch(0);
  put(0);
  __syncthreads();

  // ldmatrix addresses: A (row-major m16 x k16) lane -> row lane & 15, column
  // (lane >> 4) * 8; B (n rows, k contiguous) lane -> matrix m = lane >> 3:
  // row (m >> 1) * 8 + (lane & 7) of an n16 pair, column (m & 1) * 8.
  const int a_row = wm * 32 + (lane & 15);
  const int a_col = (lane >> 4) * 8;
  const int b_row = wn * 64 + ((lane >> 4) << 3) + (lane & 7);
  const int b_col = ((lane >> 3) & 1) * 8;

  int kc = 0, tile = t_begin;
  for (int c = 0; c < total; ++c) {
    const bool more = c + 1 < total;
    if (more) fetch(c + 1);        // global loads in flight during the mma
    const __nv_bfloat16* Bk = Bs + (c & 1) * TN * SB;
#pragma unroll
    for (int ks = 0; ks < KC; ks += 16) {
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(af[mi][0], af[mi][1], af[mi][2], af[mi][3],
                    As + (a_row + mi * 16) * SA + kc * KC + ks + a_col);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b0, b1, b2, b3;
        ldmatrix_x4(b0, b1, b2, b3, Bk + (b_row + np * 16) * SB + ks + b_col);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_bf16(acc[mi][2 * np], af[mi], b0, b1);
          mma_bf16(acc[mi][2 * np + 1], af[mi], b2, b3);
        }
      }
    }

    if (++kc == nck) {
      // Tile done. Accumulator element e of mma tile (mi, nj): row
      // wm*32 + mi*16 + lane/4 + (e >> 1) * 8, column nj*8 + 2*(lane%4) + (e & 1).
#pragma unroll
      for (int nj = 0; nj < 8; ++nj) {
#pragma unroll
        for (int e1 = 0; e1 < 2; ++e1) {
          const int col = tile * TN + wn * 64 + nj * 8 + 2 * (lane & 3) + e1;
          if (col < n2) {
            const float nbj = __ldg(nb + col);
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
#pragma unroll
              for (int h = 0; h < 2; ++h)
                push_top2(best1[mi * 2 + h], arg1[mi * 2 + h], best2[mi * 2 + h],
                          nbj - 2.0f * acc[mi][nj][h * 2 + e1], col);
          }
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.0f;
      }
      kc = 0;
      ++tile;
    }
    if (more) {
      put((c + 1) & 1);            // the slot last read in chunk c - 1
      __syncthreads();
    }
  }

  // Quad merge (the 4 lanes that share a row), then the two column halves.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float m1 = __shfl_xor_sync(0xffffffffu, best1[i], off);
      const int g1 = __shfl_xor_sync(0xffffffffu, arg1[i], off);
      const float m2 = __shfl_xor_sync(0xffffffffu, best2[i], off);
      merge_top2(best1[i], arg1[i], best2[i], m1, g1, m2);
    }
  }
  int* mrg_i = reinterpret_cast<int*>(mrg + TM);
  float* mrg_2 = mrg + 2 * TM;
  if (wn == 1 && (lane & 3) == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = wm * 32 + (i >> 1) * 16 + (lane >> 2) + (i & 1) * 8;
      mrg[r] = best1[i];
      mrg_i[r] = arg1[i];
      mrg_2[r] = best2[i];
    }
  }
  __syncthreads();
  if (wn == 0 && (lane & 3) == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = wm * 32 + (i >> 1) * 16 + (lane >> 2) + (i & 1) * 8;
      merge_top2(best1[i], arg1[i], best2[i], mrg[r], mrg_i[r], mrg_2[r]);
      const int q = q0 + r;
      if (q < n1) store_result(out, b, seg, S, n1, q, best1[i], arg1[i], best2[i]);
    }
  }
}

// ------------------------------------------------------- segment merge

__global__ void merge_segments_kernel(const float* __restrict__ p1, const float* __restrict__ p2,
                                      const int* __restrict__ pi, float* __restrict__ dist1,
                                      float* __restrict__ dist2, int* __restrict__ idx, int B,
                                      int S, int n1) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (q >= n1) return;
  size_t at = (size_t)b * S * n1 + q;
  float b1 = p1[at], b2 = p2[at];
  int i1 = pi[at];
  for (int s = 1; s < S; ++s) {
    at += n1;
    merge_top2(b1, i1, b2, p1[at], pi[at], p2[at]);
  }
  dist1[(size_t)b * n1 + q] = b1;
  dist2[(size_t)b * n1 + q] = b2;
  idx[(size_t)b * n1 + q] = i1;
}

size_t smem_bytes(bool bf16, int D) {
  if (bf16)
    return (size_t)(TM * (D + PAD_H) + 2 * TN * (KC + PAD_H)) * 2 + 3 * TM * 4;
  return (size_t)(TM * (D + PAD_F) + STAGES * TN * (KC + PAD_F)) * 4;
}

// Per device and mode: the shared-memory size the attribute was raised to,
// the SM count and the blocks per SM at that size, so a call after the first
// asks the runtime nothing.
struct DeviceInfo {
  size_t smem[2];
  int sms;
  int per_sm[2];
};
DeviceInfo g_info[MAX_DEVICES];

cudaError_t prepare(bool bf16, size_t smem, int* slots) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  DeviceInfo& info = g_info[dev];
  const int m = bf16 ? 1 : 0;
  if (info.sms == 0) {
    err = cudaDeviceGetAttribute(&info.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  if (info.smem[m] < smem) {
    const void* fn = bf16 ? (const void*)match_bf16_kernel : (const void*)match_f32_kernel;
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    err = bf16 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info.per_sm[m], match_bf16_kernel,
                                                               THREADS, smem)
               : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info.per_sm[m], match_f32_kernel,
                                                               THREADS, smem);
    if (err != cudaSuccess) return err;
    info.smem[m] = smem;
  }
  *slots = info.sms * (info.per_sm[m] > 0 ? info.per_sm[m] : 1);
  return cudaSuccess;
}

// Segments of the database walk: the split whose waves x (tiles per segment
// + the fixed cost of a block, about half a tile) is least.
int choose_tiles_per_seg(int blocks, int n_tiles, int slots, int max_segments) {
  int best_tps = n_tiles;
  double best_cost = 1e300;
  for (int s = 1; s <= max_segments && s <= n_tiles; ++s) {
    const int tps = (n_tiles + s - 1) / s;
    const int segs = (n_tiles + tps - 1) / tps;
    const long long all = (long long)blocks * segs;
    const double waves = (double)((all + slots - 1) / slots);
    const double cost = waves * (tps + 0.5);
    if (cost < best_cost - 1e-9) {
      best_cost = cost;
      best_tps = tps;
    }
  }
  return best_tps;
}

}  // namespace

// d1: (B, n1, D), d2: (B, n2, D), n2sq: (B, n2) float32, contiguous, on the
// device; D a multiple of 32. Outputs dist1, dist2: (B, n1) float32
// (||a||^2 not yet added) and idx: (B, n1) int32. scratch: 3 * B *
// max_segments * n1 words for the partials of a split walk. segments: 0
// chooses the split, else the number of segments asked for (at most
// max_segments). bf16: 0 for the f32 mode, 1 for bf16 multiplicands.
// Returns the CUDA error code of the launches.
extern "C" int sfm_match_top2(const void* d1, const void* d2, const void* n2sq, void* dist1,
                              void* dist2, void* idx, void* scratch, int B, int n1, int n2,
                              int D, int bf16, int segments, int max_segments, void* stream) {
  if (B < 1 || n1 < 1 || n2 < 1 || D < KC || D % KC != 0 || max_segments < 1 ||
      segments < 0 || segments > max_segments)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(bf16 != 0, D);
  int slots = 0;
  cudaError_t err = prepare(bf16 != 0, smem, &slots);
  if (err != cudaSuccess) return (int)err;
  const int q_tiles = (n1 + TM - 1) / TM;
  const int n_tiles = (n2 + TN - 1) / TN;
  const int tps = segments > 0 ? (n_tiles + segments - 1) / segments
                               : choose_tiles_per_seg(B * q_tiles, n_tiles, slots, max_segments);
  const int S = (n_tiles + tps - 1) / tps;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Out out;
  if (S == 1) {
    out = Out{static_cast<float*>(dist1), static_cast<float*>(dist2), static_cast<int*>(idx)};
  } else {
    float* p = static_cast<float*>(scratch);
    const size_t part = (size_t)B * S * n1;
    out = Out{p, p + part, reinterpret_cast<int*>(p + 2 * part)};
  }
  const dim3 grid(q_tiles, S, B);
  const float* a = static_cast<const float*>(d1);
  const float* bm = static_cast<const float*>(d2);
  const float* nb = static_cast<const float*>(n2sq);
  if (bf16)
    match_bf16_kernel<<<grid, THREADS, smem, st>>>(a, bm, nb, out, n1, n2, D, tps);
  else
    match_f32_kernel<<<grid, THREADS, smem, st>>>(a, bm, nb, out, n1, n2, D, tps);
  err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return (int)err;
  const dim3 mgrid((n1 + 127) / 128, B);
  merge_segments_kernel<<<mgrid, 128, 0, st>>>(out.dist1, out.dist2, out.idx,
                                               static_cast<float*>(dist1),
                                               static_cast<float*>(dist2),
                                               static_cast<int*>(idx), B, S, n1);
  return (int)cudaGetLastError();
}
