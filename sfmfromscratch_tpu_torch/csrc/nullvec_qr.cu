// Batched null vector of 8x9 minimal systems for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves this solve to XLA
// (ops/smallsvd.py::nullvec_lstsq, the complete QR of A^T). It was added
// because the port's torch.linalg.qr(A^T, mode="complete") runs cuSOLVER's
// Householder product (orgqr) once per matrix, about 12 launches a system,
// and the RANSAC filters solve one system a hypothesis: a global run made
// ~1.5 M launches for work worth microseconds of device time.
//
// For each (8, 9) system A it returns the unit vector q = Q[:, 8] / ||Q[:, 8]||
// of the complete QR A^T = Q R, which spans A's null space when rank(A) = 8
// and is orthogonal to A's rows whatever the rank. The arithmetic is LAPACK's
// unblocked Householder QR (sgeqr2 with slarfg's conventions) in float32 on the
// CUDA cores, no TF32:
//   - reflector j of column j of A^T (row j of A): alpha = M[j][j], x = M[j+1:][j];
//     tau = 0 where ||x|| = 0, else beta = -copysign(||(alpha, x)||, alpha),
//     tau = (beta - alpha) / beta, v = (1, x / (alpha - beta));
//   - each reflector H_j = I - tau v v^T is applied to the columns after j;
//   - q = H_0 H_1 ... H_7 e_8, the reflectors applied to e_8 in reverse order,
//     as sorg2r forms Q's last column; then q / ||q||.
// That is geqrf + orgqr's vector, sign included, to float32 rounding. A system
// with a non-finite entry gives NaN in all nine entries.
//
// Bound: 288 bytes read and 36 written a system, 1,079 FLOP: 0.097 ms for 1 M
// systems at 3.35 TB/s against 0.016 ms at 67 TFLOP/s FP32, so bytes. Design:
// one thread owns one system, so nothing is shared between systems and a
// result does not depend on the batch's shape. A block of 128 threads stages
// its 128 x 72 floats through shared memory with coalesced loads, rows padded
// to 73 floats so that thread t's reads of its own system hit distinct banks;
// each thread then holds A^T (9 x 8) in registers, every loop unrolled with
// constant indices. The nine results go back through shared memory, so the
// stores coalesce too. One launch solves the whole batch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;   // systems per block
constexpr int R = 8;           // rows of A
constexpr int C = 9;           // columns of A
constexpr int ELEMS = R * C;   // floats a system
constexpr int STRIDE = ELEMS + 1;

__global__ void __launch_bounds__(THREADS)
nullvec_qr_kernel(const float* __restrict__ A, float* __restrict__ out, long long count) {
  __shared__ float s[THREADS * STRIDE];
  const long long first = (long long)blockIdx.x * THREADS;
  const int here = (int)min((long long)THREADS, count - first);
  const float* src = A + first * ELEMS;
  for (int i = threadIdx.x; i < here * ELEMS; i += THREADS) {
    const int sys = i / ELEMS;
    s[sys * STRIDE + (i - sys * ELEMS)] = src[i];
  }
  __syncthreads();

  const bool active = threadIdx.x < here;
  float q[C];
  if (active) {
    // m[i][j] = A[j][i]: the 9 x 8 matrix A^T.
    float m[C][R];
    bool finite = true;
    const float* mine = s + threadIdx.x * STRIDE;
#pragma unroll
    for (int j = 0; j < R; ++j) {
#pragma unroll
      for (int i = 0; i < C; ++i) {
        m[i][j] = mine[j * C + i];
        finite = finite && isfinite(m[i][j]);
      }
    }
    float tau[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      float xn2 = 0.f;
#pragma unroll
      for (int i = j + 1; i < C; ++i) xn2 = fmaf(m[i][j], m[i][j], xn2);
      const float alpha = m[j][j];
      float t = 0.f;
      if (xn2 > 0.f) {
        const float beta = -copysignf(sqrtf(fmaf(alpha, alpha, xn2)), alpha);
        t = (beta - alpha) / beta;
        const float scal = 1.f / (alpha - beta);
#pragma unroll
        for (int i = j + 1; i < C; ++i) m[i][j] *= scal;
        m[j][j] = beta;
      }
      tau[j] = t;
#pragma unroll
      for (int c = j + 1; c < R; ++c) {
        float w = m[j][c];
#pragma unroll
        for (int i = j + 1; i < C; ++i) w = fmaf(m[i][j], m[i][c], w);
        w *= t;
        m[j][c] -= w;
#pragma unroll
        for (int i = j + 1; i < C; ++i) m[i][c] = fmaf(-w, m[i][j], m[i][c]);
      }
    }
#pragma unroll
    for (int i = 0; i < C; ++i) q[i] = i == C - 1 ? 1.f : 0.f;
#pragma unroll
    for (int j = R - 1; j >= 0; --j) {
      float w = q[j];
#pragma unroll
      for (int i = j + 1; i < C; ++i) w = fmaf(m[i][j], q[i], w);
      w *= tau[j];
      q[j] -= w;
#pragma unroll
      for (int i = j + 1; i < C; ++i) q[i] = fmaf(-w, m[i][j], q[i]);
    }
    float n2 = 0.f;
#pragma unroll
    for (int i = 0; i < C; ++i) n2 = fmaf(q[i], q[i], n2);
    const float norm = finite ? sqrtf(n2) : __int_as_float(0x7fc00000);
#pragma unroll
    for (int i = 0; i < C; ++i) q[i] = finite ? q[i] / norm : norm;
  }
  __syncthreads();   // every thread has read its system
  if (active) {
#pragma unroll
    for (int i = 0; i < C; ++i) s[threadIdx.x * C + i] = q[i];
  }
  __syncthreads();
  float* dst = out + first * C;
  for (int i = threadIdx.x; i < here * C; i += THREADS) dst[i] = s[i];
}

}  // namespace

// A: `count` contiguous row-major float32 (8, 9) systems; out: `count` x 9
// float32. Returns the CUDA error of the launch (0 on success).
extern "C" int sfm_nullvec_qr(const void* A, void* out, long long count, void* stream) {
  if (count < 1) return (int)cudaErrorInvalidValue;
  const long long blocks = (count + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  nullvec_qr_kernel<<<(unsigned)blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(A), static_cast<float*>(out), count);
  return (int)cudaGetLastError();
}
