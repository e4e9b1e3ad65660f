// Segment sums over a fixed plan for Hopper (sm_90a): out[s] = sum of the
// rows x[r] with idx[r] == s, for rows of F = 1, 3, 6, 9, 16, 18 or 36 values
// in float32 or float64 (the sharded BA's float64 check).
//
// Replaces no TPU kernel: the JAX package leaves jax.ops.segment_sum to XLA's
// scatter. Every segment sum of the port on the card is one launch of this
// kernel (ba/schur.py::segment_sum): bundle adjustment's blocks (3, 6, 9, 18,
// 36), motion averaging's 3-vectors and 3x3 blocks, triangulation's 4x4 and
// 3x3 normal matrices, and the scalar weights, costs and counts (1) of
// triangulation and the chain refresh. Their index vectors stay fixed through
// a solve while the sums repeat (about 45 an LM iteration, two a CG step), and
// padding puts long zero-weight runs on segment 0 (up to 4,095 rows in BA).
//
// The plan (ba/schur.py::segment_plan) is built once per index vector and
// solve: perm, the rows in segment order (a stable sort of idx); offsets, the
// S + 1 segment starts, empty segments included; long_segs, the segments of
// more than LONG_ROWS rows; and group, the lanes given to each other segment
// (a power of two up to 32, enough for at most ROWS_PER_LANE rows a lane).
// One launch writes all of out:
//   - blocks [0, num_long) take one long segment each: thread t adds rows
//     t, t + 256, t + 512, ... of the segment in that order, the warp combines
//     its lanes by a butterfly of shuffles (xor 16, 8, 4, 2, 1), and thread f
//     adds the 8 warps' partials for value f in warp order;
//   - the other blocks give each segment in turn `group` lanes: lane l adds
//     rows l, l + group, ... in that order, then the group's butterfly. The
//     long segments are skipped here, and an empty segment is written as 0.
// No atomics: the order of every addition is fixed by the plan, so the same
// inputs give the same bits on every call. The sums stay in the rows' type;
// only their order differs from index_put_'s strictly sequential one. With n
// rows in a segment both orders are within (n - 1) u of the sum of the rows'
// absolute values of the exact sum (Higham's bound for any order of
// additions, u = 2^-24 in float32), so chip_smoke.py holds the two to 2 n u
// of that sum.
//
// Bound: the rows are read once and the sums written once, O (4 F + 4) bytes
// for the rows and their places in perm and 4 F S bytes out; at the BA's
// shapes that is under 1 MB, well under a microsecond at 3.35 TB/s, so the
// launch and three dependent global reads (offsets, perm, the row) set the
// time. The rows a lane reads are loaded in batches of up to 8 independent
// loads before they are added, so that a lane waits on memory once a batch,
// and a row is read 16 or 8 bytes at a time where its width and address
// allow: the lanes of a warp read 32 different rows, so each load instruction
// touches up to 32 sectors, and wide rows in 4-byte loads spent most of the
// kernel's time in the load units.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;     // beat 512 and 1024 at kf150_video's BA shapes on an H100
constexpr int WARPS = THREADS / 32;
constexpr int LONG_ROWS = 256;   // longer segments get a block of their own

// Rows loaded together by a lane before they are added: fewer for wide rows,
// to keep the loaded values in registers (W: a row's 4-byte words).
template <int W>
struct Batch {
  static constexpr int value = W <= 9 ? 8 : (W <= 18 ? 4 : 2);
};

// A row is read V values at a time (16 or 8 bytes, where the rows' width and
// alignment allow): the same values, added one by one in the same order, in
// fewer load instructions.
template <typename T, int V> struct Vec;
template <typename T> struct Vec<T, 1> {
  using L = T;
  static __device__ __forceinline__ T at(const L& v, int) { return v; }
};
template <> struct Vec<float, 2> {
  using L = float2;
  static __device__ __forceinline__ float at(const L& v, int i) { return i == 0 ? v.x : v.y; }
};
template <> struct Vec<float, 4> {
  using L = float4;
  static __device__ __forceinline__ float at(const L& v, int i) {
    return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
  }
};
template <> struct Vec<double, 2> {
  using L = double2;
  static __device__ __forceinline__ double at(const L& v, int i) { return i == 0 ? v.x : v.y; }
};

// acc += x[perm[i]] for i = first, first + stride, ... below end, in that order.
template <typename T, int F, int V>
__device__ __forceinline__ void add_rows(const T* __restrict__ x,
                                         const int* __restrict__ perm, int begin, int end,
                                         int first, int stride, T (&acc)[F]) {
  constexpr int B = Batch<F * (int)sizeof(T) / 4>::value;
  using L = typename Vec<T, V>::L;
  for (int base = begin + first; base < end; base += B * stride) {
    int row[B];
#pragma unroll
    for (int u = 0; u < B; ++u) {
      const int i = base + u * stride;
      row[u] = i < end ? __ldg(perm + i) : -1;
    }
#pragma unroll
    for (int u = 0; u < B; ++u) {
      const bool here = row[u] >= 0;
      const L* xr = reinterpret_cast<const L*>(x + (long long)(here ? row[u] : 0) * F);
#pragma unroll
      for (int k = 0; k < F / V; ++k) {
        const L v = __ldg(xr + k);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          if (here) acc[k * V + j] += Vec<T, V>::at(v, j);
        }
      }
    }
  }
}

template <typename T, int F, int V>
__global__ void __launch_bounds__(THREADS)
segment_sum_kernel(const T* __restrict__ x, const int* __restrict__ perm,
                   const int* __restrict__ offsets, const int* __restrict__ long_segs,
                   int num_segments, int num_long, int group, T* __restrict__ out) {
  T acc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = T(0);
  const int lane = threadIdx.x & 31;

  if ((int)blockIdx.x < num_long) {
    __shared__ T part[WARPS][F];
    const int seg = long_segs[blockIdx.x];
    add_rows<T, F, V>(x, perm, offsets[seg], offsets[seg + 1], threadIdx.x, THREADS, acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int f = 0; f < F; ++f) acc[f] += __shfl_xor_sync(0xffffffffu, acc[f], off);
    }
    const int warp = threadIdx.x >> 5;
#pragma unroll
    for (int f = 0; f < F; ++f) {
      if ((f & 31) == lane) part[warp][f] = acc[f];
    }
    __syncthreads();
    if (threadIdx.x < F) {
      T s = part[0][threadIdx.x];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) s += part[w][threadIdx.x];
      out[(long long)seg * F + threadIdx.x] = s;
    }
    return;
  }

  // Every lane of the warp takes part in the shuffles: a group past the last
  // segment, or on a long one, adds no row and writes nothing.
  const long long g = ((long long)(blockIdx.x - num_long) * THREADS + threadIdx.x) / group;
  const int in_group = threadIdx.x & (group - 1);
  int begin = 0, end = 0;
  bool write = g < num_segments;
  if (write) {
    begin = offsets[g];
    end = offsets[g + 1];
    if (end - begin > LONG_ROWS) {
      write = false;
      end = begin;
    }
  }
  add_rows<T, F, V>(x, perm, begin, end, in_group, group, acc);
  for (int off = group >> 1; off > 0; off >>= 1) {
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] += __shfl_xor_sync(0xffffffffu, acc[f], off);
  }
  if (write) {
    // After the butterfly every lane of the group holds every sum, the same
    // bits in each (a + b == b + a); lane l writes values l, l + group, ...
#pragma unroll
    for (int f = 0; f < F; ++f) {
      if ((f & (group - 1)) == in_group) out[g * F + f] = acc[f];
    }
  }
}

// The widest load the rows allow: 16 bytes where a row's size and the
// rows' address are multiples of it, else 8, else one value.
template <typename T, int F>
int launch(const void* x, const void* perm, const void* offsets, const void* long_segs,
           int num_segments, int num_long, int group, void* out, cudaStream_t stream) {
  const long long short_blocks = ((long long)num_segments * group + THREADS - 1) / THREADS;
  const long long blocks = num_long + short_blocks;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  constexpr int V16 = 16 / sizeof(T), V8 = 8 / sizeof(T);
  const uintptr_t at = reinterpret_cast<uintptr_t>(x);
  auto kernel = F % V16 == 0 && at % 16 == 0 ? segment_sum_kernel<T, F, F % V16 == 0 ? V16 : 1>
              : F % V8 == 0 && at % 8 == 0 ? segment_sum_kernel<T, F, F % V8 == 0 ? V8 : 1>
              : segment_sum_kernel<T, F, 1>;
  kernel<<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int*>(perm),
      static_cast<const int*>(offsets), static_cast<const int*>(long_segs), num_segments,
      num_long, group, static_cast<T*>(out));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_width(const void* x, const void* perm, const void* offsets, const void* long_segs,
                 int num_segments, int num_long, int group, int width, void* out,
                 cudaStream_t s) {
  switch (width) {
    case 1: return launch<T, 1>(x, perm, offsets, long_segs, num_segments, num_long, group, out, s);
    case 3: return launch<T, 3>(x, perm, offsets, long_segs, num_segments, num_long, group, out, s);
    case 6: return launch<T, 6>(x, perm, offsets, long_segs, num_segments, num_long, group, out, s);
    case 9: return launch<T, 9>(x, perm, offsets, long_segs, num_segments, num_long, group, out, s);
    case 16: return launch<T, 16>(x, perm, offsets, long_segs, num_segments, num_long, group, out, s);
    case 18: return launch<T, 18>(x, perm, offsets, long_segs, num_segments, num_long, group, out, s);
    case 36: return launch<T, 36>(x, perm, offsets, long_segs, num_segments, num_long, group, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x: rows (O, width) of float32 (value_bytes 4) or float64 (8), contiguous and
// aligned to their type (read 8 or 16 bytes at a time where width and the
// address allow); perm: int32 (O,); offsets: int32 (num_segments + 1,);
// long_segs: int32 (num_long,), the segments of more than 256 rows, each
// once; group: the lanes of every other segment, a power of two from 1 to
// 32; out: (num_segments, width) of x's type, every value written. Returns
// the CUDA error of the launch (0 on success).
extern "C" int sfm_segment_sum(const void* x, const void* perm, const void* offsets,
                               const void* long_segs, int num_segments, int num_long, int group,
                               int width, int value_bytes, void* out, void* stream) {
  if (num_segments < 1 || num_long < 0 || num_long > num_segments || group < 1 || group > 32 ||
      (group & (group - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (value_bytes == 4)
    return launch_width<float>(x, perm, offsets, long_segs, num_segments, num_long, group, width,
                               out, s);
  if (value_bytes == 8)
    return launch_width<double>(x, perm, offsets, long_segs, num_segments, num_long, group, width,
                                out, s);
  return (int)cudaErrorInvalidValue;
}
