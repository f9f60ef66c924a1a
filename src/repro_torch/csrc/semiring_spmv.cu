// Semiring SpMV partials for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the Pallas TPU kernel `_spmv_kernel` in
// src/repro/kernels/semiring_spmv.py (lines 71-97), launched by
// `spmv_partials` through `pl.pallas_call` (line 120).  Same contract:
// for each block b of EDGE_BLOCK = 512 edges and each lane t of its
// TILE = 128 destinations,
//
//   out[b, t] = tie(REDUCE_{e in b, dst_e == t} combine(v_e, w_e), identity)
//
// where padding (dst = -1) and lanes no edge hits contribute the
// aggregator's identity and the result is clamped at it (`tie`).
// `plus_times` is a plain sum (no clamp; empty lanes are 0).
//
// Design.  One thread block per edge block, 128 threads, one output lane
// each.  The block stages its 512 (dst, combine(v, w)) pairs in shared
// memory with coalesced loads (thread t loads edges t, t+128, t+256,
// t+384), then every thread scans all 512 pairs in edge order — each read
// is a shared-memory broadcast, no bank conflicts — and reduces the ones
// that hit its lane.  No atomics and no data-dependent order: the result
// is deterministic, and `plus_times` sums in edge order, which keeps it
// within 1e-5 of the plain version.  The TPU kernel's dense [512, 128]
// compare/select grid becomes this per-lane scan; its sequential grid
// becomes independent blocks (nothing is carried between them).
//
// Bound.  The data the call must move is 8 bytes per edge (value and
// dst; 12 with weights) plus 512 bytes of output per block: 143 MB, about
// 43 us at 3.35 TB/s, for the 31,018 blocks of an RMAT 2^18 pull.  The
// scan instead issues 512 x 128 compare-selects per block, about 2.0e9 at
// that size, so this first kernel is bound by the scan's instruction
// issue, well above the bytes bound.  Shared-memory atomics, or a
// segmented reduction over the already destination-sorted stream, would
// bring it down to the bytes bound; that is a later change.
//
// C interface: spmv_partials_launch sets the given device current, launches
// on the given stream and returns cudaGetLastError(); it allocates nothing
// and does not synchronise.

#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int TILE = 128;
constexpr int EDGE_BLOCK = 512;

// semiring codes: the order of SEMIRINGS in kernels/semiring_spmv.py
enum Semiring { MIN = 0, MIN_PLUS = 1, MAX = 2, MAX_MIN = 3, OR = 4, PLUS_TIMES = 5 };

template <typename T> struct Ops;

template <> struct Ops<int> {
  static constexpr int kPosInf = 2147483647;
  __device__ static int one() { return 1; }
  __device__ static int lo(int a, int b) { return b < a ? b : a; }
  __device__ static int hi(int a, int b) { return b > a ? b : a; }
  // wrapping add/mul (jax and torch wrap int32; signed overflow is UB in C++)
  __device__ static int add(int a, int b) { return (int)((unsigned)a + (unsigned)b); }
  __device__ static int mul(int a, int b) { return (int)((unsigned)a * (unsigned)b); }
};

template <> struct Ops<float> {
  __device__ static float one() { return 1.0f; }
  // NaN-propagating, as jnp.minimum / torch.minimum are
  __device__ static float lo(float a, float b) {
    return a != a ? a : (b != b ? b : (b < a ? b : a));
  }
  __device__ static float hi(float a, float b) {
    return a != a ? a : (b != b ? b : (b > a ? b : a));
  }
  __device__ static float add(float a, float b) { return __fadd_rn(a, b); }
  __device__ static float mul(float a, float b) { return __fmul_rn(a, b); }
};

// the aggregator identities of core/semiring.py
template <int S, typename T> __device__ __forceinline__ T identity() {
  constexpr bool kInt = std::is_integral<T>::value;
  if constexpr (S == MIN || S == MIN_PLUS) {
    if constexpr (kInt) return Ops<int>::kPosInf;
    else return __int_as_float(0x7f800000);  // +inf
  } else if constexpr (S == MAX || S == MAX_MIN) {
    return kInt ? T(-1) : T(0);
  } else {
    return T(0);  // OR, PLUS_TIMES
  }
}

template <int S, typename T> __device__ __forceinline__ T combine(T v, T w) {
  if constexpr (S == MIN_PLUS) return Ops<T>::add(v, w);
  else if constexpr (S == MAX_MIN) return Ops<T>::lo(v, w);  // path bottleneck
  else if constexpr (S == PLUS_TIMES) return Ops<T>::mul(v, w);
  else return v;
}

template <int S, typename T> __device__ __forceinline__ T reduce(T acc, T c) {
  if constexpr (S == MIN || S == MIN_PLUS) return Ops<T>::lo(acc, c);
  else if constexpr (S == PLUS_TIMES) return Ops<T>::add(acc, c);
  else return Ops<T>::hi(acc, c);  // MAX, MAX_MIN, OR
}

template <typename T> struct __align__(8) Edge {
  int dst;
  T cand;
};

template <int S, typename T>
__global__ void __launch_bounds__(TILE)
spmv_partials_kernel(const T* __restrict__ vals, const int* __restrict__ dst,
                     const T* __restrict__ w, T* __restrict__ out) {
  __shared__ Edge<T> edges[EDGE_BLOCK];
  const long long base = (long long)blockIdx.x * EDGE_BLOCK;
  const int lane = threadIdx.x;
#pragma unroll
  for (int k = 0; k < EDGE_BLOCK / TILE; ++k) {
    const int e = k * TILE + lane;
    const T wt = w != nullptr ? w[base + e] : Ops<T>::one();
    Edge<T> ed;
    ed.dst = dst[base + e];
    ed.cand = combine<S, T>(vals[base + e], wt);
    edges[e] = ed;
  }
  __syncthreads();

  const T ident = identity<S, T>();
  T acc = ident;
#pragma unroll 16
  for (int e = 0; e < EDGE_BLOCK; ++e) {
    const Edge<T> ed = edges[e];  // broadcast read
    acc = ed.dst == lane ? reduce<S, T>(acc, ed.cand) : acc;
  }
  if constexpr (S != PLUS_TIMES) acc = reduce<S, T>(acc, ident);  // tie
  out[(long long)blockIdx.x * TILE + lane] = acc;
}

template <typename T>
cudaError_t launch(int semiring, const void* vals, const void* dst,
                   const void* w, void* out, int n_blocks, cudaStream_t s) {
  const T* v = static_cast<const T*>(vals);
  const int* d = static_cast<const int*>(dst);
  const T* wt = static_cast<const T*>(w);
  T* o = static_cast<T*>(out);
  const dim3 grid(n_blocks), block(TILE);
  switch (semiring) {
    case MIN: spmv_partials_kernel<MIN, T><<<grid, block, 0, s>>>(v, d, wt, o); break;
    case MIN_PLUS: spmv_partials_kernel<MIN_PLUS, T><<<grid, block, 0, s>>>(v, d, wt, o); break;
    case MAX: spmv_partials_kernel<MAX, T><<<grid, block, 0, s>>>(v, d, wt, o); break;
    case MAX_MIN: spmv_partials_kernel<MAX_MIN, T><<<grid, block, 0, s>>>(v, d, wt, o); break;
    case OR: spmv_partials_kernel<OR, T><<<grid, block, 0, s>>>(v, d, wt, o); break;
    case PLUS_TIMES: spmv_partials_kernel<PLUS_TIMES, T><<<grid, block, 0, s>>>(v, d, wt, o); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int spmv_partials_launch(int device, int semiring, int dtype,
                                    const void* vals, const void* dst,
                                    const void* w, void* out, int n_blocks,
                                    void* stream) {
  if (n_blocks <= 0) return (int)cudaErrorInvalidValue;
  // this library's runtime keeps its own current device: set it to the
  // stream's, so the launch lands in that device's (primary) context
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // dtype codes: 0 = int32, 1 = float32 (kernels/semiring_spmv.py)
  if (dtype == 0) return (int)launch<int>(semiring, vals, dst, w, out, n_blocks, s);
  if (dtype == 1) return (int)launch<float>(semiring, vals, dst, w, out, n_blocks, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
