// Translation averaging's whole solve in one launch for Hopper (sm_90a):
// every IRLS round of geometry/averaging.py::translation_averaging, its
// weights and right-hand side, all of its fixed-count CG steps and the
// re-anchoring to camera 0, in float32 or float64.
//
// Replaces no TPU kernel: the JAX package leaves this solve (a lax.scan of
// IRLS rounds around a lax.scan of CG steps) to XLA. It was added because
// the port ran the two scans as Python loops of tiny PyTorch ops: ~24,000
// launches a call at the engines' 12 rounds of 64 steps (each step two
// gathers, two segment sums and some twenty scalar-vector ops on at most a
// few hundred floats; 470-670 ms on an H100's host), so the host's launch
// path set the solve's time while the card idled.
//
// Both branches of the Python code run here, chosen by whether edge scales
// are given: with them (ANCHORED, the engines' path) each round solves the
// anchored Laplacian system L c = b, L v = sum_e w_e (v_i - v_j) on the
// edge's two cameras, plus 10 v_0 on camera 0 and 1e-8 v; without them,
// Govindu's projection system, (I - u u^T) in place of the identity on each
// edge and the rank-1 gauge term (g . v) g in place of the ridge. Same
// arithmetic as the Python code, in the same type: the annealed Huber
// threshold max(start decay^t, final) and lam = 2^-t computed here from
// scalars (no host-to-device copy a round), the guarded divisions (1e-12,
// 1e-9), the along > 0 test and torch's NaN propagation in clamp and
// maximum. nvcc may fuse a product and a sum into one FMA, and the dot
// products add in another order, so card and CPU agree to rounding.
//
// Design: one block does the whole solve and stays resident through it,
// __syncthreads() between phases; cameras and edges are strided over its
// threads (one thread a camera or edge up to 1,024 of them). The solver's
// state (per camera c, x, r, p, A p and b; per edge u, w0, the data scales,
// the IRLS weights, `along` and the three values each edge adds to its
// cameras' sums; the edge and plan indices) is a few KB at the engines'
// shapes and lives in shared memory while it fits (the card's opt-in limit
// per block, 227 KB on an H100: about 1,000 cameras with 2,500 edges in
// float32); past that it lives in a scratch buffer in device memory that
// the wrapper allocates, served by L1 and L2. A CG step is four barriers:
// the edge phase writes each edge's term, each camera's thread then adds
// its edges' terms, and two block reductions give p.Ap and r.r.
//
// Fixed order, no atomics: camera k's sum walks its edges in the order of
// the plans that ba/schur.py::segment_plan builds for edge_i and edge_j
// (perm and offsets; edge index order within a camera, the order in which
// index_add_ adds on the CPU), from 0, the sum over edge_i's segment minus
// the sum over edge_j's, as the Python code subtracts its two segment sums.
// Dot products are block reductions in a fixed tree: each thread adds its
// own cameras or edges in order, the warp combines its lanes by a butterfly
// of shuffles (xor 16, 8, 4, 2, 1: every lane ends with the same bits), and
// every thread adds the warps' sums in warp order. The same inputs give the
// same bits on every call.
//
// Bound: one pass over the state is state_bytes(C, E); a call makes about
// num_iters x (cg_iters + 2) such passes, from shared memory (or L2): 7.0 MB
// at glob20_ring's shape (C 20, E 128, float32), 0.027 ms at one SM's 128
// bytes a clock (1.98 GHz). The dependent chain of barriers and the longest
// segment's serial walk (the padding's zero-weight self-loops on camera 0)
// set the time, ~2.6 ms there; the launch replaces the host's ~24,000.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 1024;
constexpr int WARPS = MAX_THREADS / 32;
// Two alternating buffers of the warps' partial sums, at the head of the
// dynamic shared memory: a reduction's buffer is written again only after
// the next reduction's barrier, when every thread has read it.
constexpr int REDUCE_SLOTS = 2 * WARPS;

template <typename T> struct Ops;
template <> struct Ops<float> {
  static __device__ __forceinline__ float sqrt(float x) { return sqrtf(x); }
  static __device__ __forceinline__ float pow(float x, float y) { return powf(x, y); }
  static __device__ __forceinline__ float ldexp(float x, int e) { return ldexpf(x, e); }
  static __device__ __forceinline__ float abs(float x) { return fabsf(x); }
};
template <> struct Ops<double> {
  static __device__ __forceinline__ double sqrt(double x) { return ::sqrt(x); }
  static __device__ __forceinline__ double pow(double x, double y) { return ::pow(x, y); }
  static __device__ __forceinline__ double ldexp(double x, int e) { return ::ldexp(x, e); }
  static __device__ __forceinline__ double abs(double x) { return fabs(x); }
};

// torch.clamp_min, torch.clamp_max and torch.maximum, NaN propagated.
template <typename T> __device__ __forceinline__ T clamp_min(T x, T m) { return x < m ? m : x; }
template <typename T> __device__ __forceinline__ T clamp_max(T x, T m) { return x > m ? m : x; }
template <typename T> __device__ __forceinline__ T maximum(T a, T b) {
  return (a > b || a != a) ? a : b;
}
// _cg_fixed's guard: where(|d| < 1e-12, 1e-12, d).
template <typename T> __device__ __forceinline__ T guard(T d) {
  return Ops<T>::abs(d) < T(1e-12) ? T(1e-12) : d;
}

template <typename T>
struct Args {
  const T* u;               // (E, 3) unit directions of c_i - c_j
  const long long* ei;      // (E,)
  const long long* ej;      // (E,)
  const T* c_init;          // (C, 3)
  const T* w0;              // (E,) edge weights, or null: all 1
  const T* edge_s;          // (E,) edge scales, or null: the projection branch
  const int* perm_i;        // segment_plan(edge_i, C): perm (E,), offsets (C + 1,)
  const int* off_i;
  const int* perm_j;        // segment_plan(edge_j, C)
  const int* off_j;
  int C, E, num_iters, cg_iters;
  T start, final_, decay;   // the Huber threshold's schedule
  unsigned char* scratch;   // the state where it does not fit in shared memory
  T* out;                   // (C, 3) centres, camera 0 at the origin
};

template <typename T>
struct State {
  T *c, *x, *r, *p, *ap, *b;   // (C, 3); b holds g on the projection branch
  T *u, *q;                    // (E, 3); q: each edge's term of the current sums
  T *w0, *sd, *w, *al;         // (E,): weights, data scales, IRLS weights, along
  int *ei, *ej, *pi, *pj;      // (E,)
  int *oi, *oj;                // (C + 1,)
};

// Bytes of the state: the T arrays first, then the int arrays.
template <typename T>
size_t state_bytes(int C, int E) {
  return sizeof(T) * (18 * (size_t)C + 10 * (size_t)E) +
         sizeof(int) * (4 * (size_t)E + 2 * (size_t)C + 2);
}

template <typename T>
__device__ __forceinline__ State<T> layout(unsigned char* base, int C, int E) {
  State<T> s;
  T* f = reinterpret_cast<T*>(base);
  T** per_camera[] = {&s.c, &s.x, &s.r, &s.p, &s.ap, &s.b};
  for (T** a : per_camera) { *a = f; f += 3 * (size_t)C; }
  s.u = f; f += 3 * (size_t)E;
  s.q = f; f += 3 * (size_t)E;
  T** per_edge[] = {&s.w0, &s.sd, &s.w, &s.al};
  for (T** a : per_edge) { *a = f; f += E; }
  int* n = reinterpret_cast<int*>(f);
  int** edge_ints[] = {&s.ei, &s.ej, &s.pi, &s.pj};
  for (int** a : edge_ints) { *a = n; n += E; }
  s.oi = n; n += C + 1;
  s.oj = n;
  return s;
}

// The block's sum of every thread's v, the same bits in every thread.
template <typename T>
__device__ __forceinline__ T block_sum(T v, T* red, int& parity) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  T* buf = red + WARPS * parity;
  parity ^= 1;
  if ((threadIdx.x & 31) == 0) buf[threadIdx.x >> 5] = v;
  __syncthreads();
  T sum = buf[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) sum += buf[w];
  return sum;
}

// acc += q[perm[n]] for n in [begin, end), in that order.
template <typename T>
__device__ __forceinline__ void segment_add(const T* q, const int* perm, int begin, int end,
                                            T (&acc)[3]) {
#pragma unroll 4
  for (int n = begin; n < end; ++n) {
    const T* row = q + 3 * perm[n];
    acc[0] += row[0];
    acc[1] += row[1];
    acc[2] += row[2];
  }
}

// out = A v (apply_L or apply_A); returns this thread's part of v . out.
template <typename T, bool ANCHORED>
__device__ __forceinline__ T apply(const State<T>& s, const T* v, T* out, int C, int E, T* red,
                                   int& parity) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int e = tid; e < E; e += nt) {
    const int i = s.ei[e], j = s.ej[e];
    T d0 = v[3 * i] - v[3 * j], d1 = v[3 * i + 1] - v[3 * j + 1], d2 = v[3 * i + 2] - v[3 * j + 2];
    if (!ANCHORED) {
      const T* u = s.u + 3 * e;
      const T a = u[0] * d0 + u[1] * d1 + u[2] * d2;
      d0 = d0 - u[0] * a;
      d1 = d1 - u[1] * a;
      d2 = d2 - u[2] * a;
    }
    const T w = s.w[e];
    s.q[3 * e] = w * d0;
    s.q[3 * e + 1] = w * d1;
    s.q[3 * e + 2] = w * d2;
  }
  T gv = T(0);
  if (ANCHORED) {
    __syncthreads();
  } else {
    T part = T(0);
    for (int k = tid; k < C; k += nt)
      part += s.b[3 * k] * v[3 * k] + s.b[3 * k + 1] * v[3 * k + 1] + s.b[3 * k + 2] * v[3 * k + 2];
    gv = block_sum(part, red, parity);   // the barrier before the cameras read q
  }
  T dot = T(0);
  for (int k = tid; k < C; k += nt) {
    T o[3] = {T(0), T(0), T(0)}, m[3] = {T(0), T(0), T(0)};
    segment_add(s.q, s.pi, s.oi[k], s.oi[k + 1], o);
    segment_add(s.q, s.pj, s.oj[k], s.oj[k + 1], m);
#pragma unroll
    for (int f = 0; f < 3; ++f) {
      T val = o[f] - m[f];
      if (k == 0) val = val + T(10) * v[f];                    // the pin on camera 0
      val = ANCHORED ? val + T(1e-8) * v[3 * k + f]            // the ridge
                     : val + gv * s.b[3 * k + f];              // rho (g . v) g, rho = 1
      out[3 * k + f] = val;
      dot += v[3 * k + f] * val;
    }
  }
  return dot;
}

template <typename T, bool SHARED, bool ANCHORED>
__global__ void __launch_bounds__(MAX_THREADS) transavg_kernel(const Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* red = reinterpret_cast<T*>(smem);
  const int tid = threadIdx.x, nt = blockDim.x, C = a.C, E = a.E;
  const State<T> s = layout<T>(SHARED ? smem + REDUCE_SLOTS * sizeof(T) : a.scratch, C, E);
  int parity = 0;

  T part = T(0);
  for (int e = tid; e < E; e += nt) {
#pragma unroll
    for (int f = 0; f < 3; ++f) s.u[3 * e + f] = a.u[3 * e + f];
    const T w0 = a.w0 ? a.w0[e] : T(1);
    s.w0[e] = w0;
    part += w0;
    if (ANCHORED) s.sd[e] = a.edge_s[e];
    s.ei[e] = (int)a.ei[e];
    s.ej[e] = (int)a.ej[e];
    s.pi[e] = a.perm_i[e];
    s.pj[e] = a.perm_j[e];
  }
  for (int k = tid; k <= C; k += nt) {
    s.oi[k] = a.off_i[k];
    s.oj[k] = a.off_j[k];
  }
  for (int k = tid; k < C; k += nt) {
#pragma unroll
    for (int f = 0; f < 3; ++f) s.c[3 * k + f] = a.c_init[3 * k + f] - a.c_init[f];
  }
  const T sum_w0 = clamp_min(block_sum(part, red, parity), T(1e-9));

  for (int t = 0; t < a.num_iters; ++t) {
    const T delta = clamp_min(a.start * Ops<T>::pow(a.decay, T(t)), a.final_);
    // The round's IRLS weights, and each edge's term of b (anchored) or g.
    if (ANCHORED) {
      const T lam = Ops<T>::ldexp(T(1), -t);
      for (int e = tid; e < E; e += nt) {
        const int i = s.ei[e], j = s.ej[e];
        const T* u = s.u + 3 * e;
        const T d0 = s.c[3 * i] - s.c[3 * j], d1 = s.c[3 * i + 1] - s.c[3 * j + 1],
                d2 = s.c[3 * i + 2] - s.c[3 * j + 2];
        const T along = u[0] * d0 + u[1] * d1 + u[2] * d2;
        const T sd = s.sd[e];
        const T se = lam * sd + (T(1) - lam) * maximum(along, T(0.05) * sd);
        const T r0 = d0 - se * u[0], r1 = d1 - se * u[1], r2 = d2 - se * u[2];
        const T rn = Ops<T>::sqrt(r0 * r0 + r1 * r1 + r2 * r2) / clamp_min(se, T(1e-9));
        const T w = s.w0[e] * clamp_max(delta / clamp_min(rn, T(1e-9)), T(1));
        s.w[e] = w;
        const T ws = w * se;
#pragma unroll
        for (int f = 0; f < 3; ++f) s.q[3 * e + f] = ws * u[f];
      }
    } else {
      T mpart = T(0);
      for (int e = tid; e < E; e += nt) {
        const int i = s.ei[e], j = s.ej[e];
        const T* u = s.u + 3 * e;
        const T along = u[0] * (s.c[3 * i] - s.c[3 * j]) + u[1] * (s.c[3 * i + 1] - s.c[3 * j + 1]) +
                        u[2] * (s.c[3 * i + 2] - s.c[3 * j + 2]);
        s.al[e] = along;
        mpart += s.w0[e] * Ops<T>::abs(along);
      }
      const T scale = clamp_min(block_sum(mpart, red, parity) / sum_w0, T(1e-9));
      for (int e = tid; e < E; e += nt) {
        const int i = s.ei[e], j = s.ej[e];
        const T* u = s.u + 3 * e;
        const T along = s.al[e];
        const T r0 = (s.c[3 * i] - s.c[3 * j]) - along * u[0],
                r1 = (s.c[3 * i + 1] - s.c[3 * j + 1]) - along * u[1],
                r2 = (s.c[3 * i + 2] - s.c[3 * j + 2]) - along * u[2];
        const T r = Ops<T>::sqrt(r0 * r0 + r1 * r1 + r2 * r2) / scale;
        T w = s.w0[e] * clamp_max(delta / clamp_min(r, T(1e-9)), T(1));
        w = w * (along > T(0) ? T(1) : T(0.05));
        s.w[e] = w;
#pragma unroll
        for (int f = 0; f < 3; ++f) s.q[3 * e + f] = w * u[f];
      }
    }
    __syncthreads();
    for (int k = tid; k < C; k += nt) {
      T o[3] = {T(0), T(0), T(0)}, m[3] = {T(0), T(0), T(0)};
      segment_add(s.q, s.pi, s.oi[k], s.oi[k + 1], o);
      segment_add(s.q, s.pj, s.oj[k], s.oj[k + 1], m);
#pragma unroll
      for (int f = 0; f < 3; ++f) {
        s.b[3 * k + f] = o[f] - m[f];
        s.x[3 * k + f] = s.c[3 * k + f];
      }
    }
    __syncthreads();

    // _cg_fixed from x = c: r = b - A x, p = r, then cg_iters steps.
    apply<T, ANCHORED>(s, s.x, s.ap, C, E, red, parity);
    T rpart = T(0);
    for (int k = tid; k < C; k += nt) {
#pragma unroll
      for (int f = 0; f < 3; ++f) {
        const T bb = ANCHORED ? s.b[3 * k + f] : sum_w0 * s.b[3 * k + f];   // rho target g
        const T r = bb - s.ap[3 * k + f];
        s.r[3 * k + f] = r;
        s.p[3 * k + f] = r;
        rpart += r * r;
      }
    }
    T rs = block_sum(rpart, red, parity);
    for (int it = 0; it < a.cg_iters; ++it) {
      const T denom = block_sum(apply<T, ANCHORED>(s, s.p, s.ap, C, E, red, parity), red, parity);
      const T alpha = rs / guard(denom);
      rpart = T(0);
      for (int k = tid; k < C; k += nt) {
#pragma unroll
        for (int f = 0; f < 3; ++f) {
          s.x[3 * k + f] = s.x[3 * k + f] + alpha * s.p[3 * k + f];
          const T r = s.r[3 * k + f] - alpha * s.ap[3 * k + f];
          s.r[3 * k + f] = r;
          rpart += r * r;
        }
      }
      const T rs_new = block_sum(rpart, red, parity);
      const T beta = rs_new / (rs < T(1e-12) ? T(1e-12) : rs);
      for (int k = tid; k < C; k += nt) {
#pragma unroll
        for (int f = 0; f < 3; ++f) s.p[3 * k + f] = s.r[3 * k + f] + beta * s.p[3 * k + f];
      }
      rs = rs_new;
      __syncthreads();
    }
    for (int k = tid; k < C; k += nt) {
#pragma unroll
      for (int f = 0; f < 3; ++f) s.c[3 * k + f] = s.x[3 * k + f] - s.x[f];
    }
    __syncthreads();
  }
  for (int k = tid; k < C; k += nt) {
#pragma unroll
    for (int f = 0; f < 3; ++f) a.out[3 * k + f] = s.c[3 * k + f];
  }
}

template <typename T, bool SHARED, bool ANCHORED>
int run(const Args<T>& a, int threads, size_t smem, cudaStream_t stream) {
  auto kernel = transavg_kernel<T, SHARED, ANCHORED>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<1, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const Args<T>& a, long long scratch_bytes, cudaStream_t stream) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  const size_t state = state_bytes<T>(a.C, a.E), reduce = REDUCE_SLOTS * sizeof(T);
  const bool shared = reduce + state <= (size_t)optin;
  if (!shared && (a.scratch == nullptr || scratch_bytes < (long long)state))
    return (int)cudaErrorInvalidValue;
  const int most = a.C > a.E ? a.C : a.E;
  const int threads = most >= MAX_THREADS ? MAX_THREADS : (most < 32 ? 32 : (most + 31) / 32 * 32);
  const size_t smem = shared ? reduce + state : reduce;
  if (shared)
    return a.edge_s ? run<T, true, true>(a, threads, smem, stream)
                    : run<T, true, false>(a, threads, smem, stream);
  return a.edge_s ? run<T, false, true>(a, threads, smem, stream)
                  : run<T, false, false>(a, threads, smem, stream);
}

template <typename T>
int launch_typed(const void* u, const void* ei, const void* ej, const void* c_init,
                 const void* w0, const void* edge_s, const void* perm_i, const void* off_i,
                 const void* perm_j, const void* off_j, int C, int E, int num_iters,
                 int cg_iters, double start, double final_, double decay, void* scratch,
                 long long scratch_bytes, void* out, cudaStream_t stream) {
  Args<T> a;
  a.u = static_cast<const T*>(u);
  a.ei = static_cast<const long long*>(ei);
  a.ej = static_cast<const long long*>(ej);
  a.c_init = static_cast<const T*>(c_init);
  a.w0 = static_cast<const T*>(w0);
  a.edge_s = static_cast<const T*>(edge_s);
  a.perm_i = static_cast<const int*>(perm_i);
  a.off_i = static_cast<const int*>(off_i);
  a.perm_j = static_cast<const int*>(perm_j);
  a.off_j = static_cast<const int*>(off_j);
  a.C = C;
  a.E = E;
  a.num_iters = num_iters;
  a.cg_iters = cg_iters;
  a.start = (T)start;
  a.final_ = (T)final_;
  a.decay = (T)decay;
  a.scratch = static_cast<unsigned char*>(scratch);
  a.out = static_cast<T*>(out);
  return launch<T>(a, scratch_bytes, stream);
}

}  // namespace

// u: (E, 3) and c_init: (C, 3) of float32 (value_bytes 4) or float64 (8);
// ei, ej: int64 (E,), in [0, C); w0: (E,) or null (all 1); edge_s: (E,) or
// null (the projection branch); perm_i, off_i and perm_j, off_j: int32 plans
// of ei and ej over C segments (ba/schur.py::segment_plan: perm (E,),
// offsets (C + 1,)); start, final: the Huber threshold's first and last
// values, decay its factor a round; scratch: scratch_bytes of device memory,
// used for the state where it does not fit in shared memory (may be null
// where it does); out: (C, 3) of u's type. Every array contiguous. Returns
// the CUDA error of the launch (0 on success).
extern "C" int sfm_translation_averaging(const void* u, const void* ei, const void* ej,
                                         const void* c_init, const void* w0, const void* edge_s,
                                         const void* perm_i, const void* off_i,
                                         const void* perm_j, const void* off_j, int num_cameras,
                                         int num_edges, int num_iters, int cg_iters,
                                         double start, double final_, double decay,
                                         int value_bytes, void* scratch, long long scratch_bytes,
                                         void* out, void* stream) {
  if (num_cameras < 1 || num_edges < 0 || num_iters < 0 || cg_iters < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (value_bytes == 4)
    return launch_typed<float>(u, ei, ej, c_init, w0, edge_s, perm_i, off_i, perm_j, off_j,
                               num_cameras, num_edges, num_iters, cg_iters, start, final_, decay,
                               scratch, scratch_bytes, out, s);
  if (value_bytes == 8)
    return launch_typed<double>(u, ei, ej, c_init, w0, edge_s, perm_i, off_i, perm_j, off_j,
                                num_cameras, num_edges, num_iters, cg_iters, start, final_, decay,
                                scratch, scratch_bytes, out, s);
  return (int)cudaErrorInvalidValue;
}
