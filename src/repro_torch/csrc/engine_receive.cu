// The engine tick's receive for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces no Pallas kernel: the JAX package's receive
// (src/repro/core/engine.py::_phase2_receive) is an XLA scatter.  It was
// added because the PyTorch form of the same delivery, one
// `scatter_reduce_` over every padded slot of the receive buffers, took
// 7.45 ms of an 11.0 ms tick at the benchmark's shape (PERF.md): each of
// the [P, R, C] slots is read, every empty slot (id = -1) is aimed at one
// spare index a row, so about 2 M atomics a row land on one address in
// turn, and the transposed receive views are first copied and widened to
// int64 indices at the full padded size.
//
// Contract (kernels/receive.py::deliver, whose plain PyTorch version is
// the same function): for the receive ids and values [P, R, C], given as
// strided views, the pre-receive plane old [P, vs] and the output planes
// new, active and cursor (copies of the state that the wrapper made),
// every slot with 0 <= id < vs and improves(val, old[p, id]) applies
// new[p, id] = new[p, id] (+) val with an atomic, stores active[p, id] = 1
// and cursor[p, id] = 0, and counts one accepted message in accepted[p].
// (+) is min or max (or is max over {0, 1}); improves is the strict < or >.
// Both are independent of order, so `new`, the set of vertices that
// changed, the cursor resets and the counts equal the scatter's result on
// every launch.  The engine sends ids in [-1, vs); one compare treats any
// id outside [0, vs) as empty, so no id writes outside its row.
//
// Bound: the id scan.  Every slot's id has to be read once, 4 bytes each:
// 16.3 M slots (65 MB) at the benchmark's shape, 20 us at 3.35 TB/s.  The
// live slots (about 9 k a tick) add a value load, a gather from `old` and
// at most an atomic and two stores each, noise beside the scan.  What the
// design does about it:
//   * One pass, ids only.  A thread loads four 16-byte id vectors of one
//     row before it looks at any of them (16 ids in flight a thread, 4 k a
//     block of 256), and touches a value, `old` or the output planes only
//     for a live id.  An empty slot costs its 4 bytes and a compare: no
//     value load, no atomic.
//   * The views as they are.  Row strides come in as arguments, so the
//     transposed [Pn, P, cap] views that exchange_local returns, whose rows
//     sit cap + 1 ids apart, are read in place.  Every receive view the
//     engine makes has contiguous rows of ids (innermost stride 1, which
//     the wrapper requires): a row is read as 16-byte vectors from its
//     first 16-byte boundary, and the at most three ids before it and three
//     after the last whole vector go to block 0's first threads.
//   * Float atomics exact for every non-NaN value: a non-negative float
//     orders as a signed int and a negative one in reverse as an unsigned
//     int, so min is atomicMin on the int bits for val >= +0 and atomicMax
//     on the unsigned bits for a set sign bit (max the other way round).
//   * One count a warp: each thread counts its accepted slots, the warp
//     sums them with one __reduce_add_sync, and lane 0 adds a non-zero sum
//     to accepted[p] (a block lies in one row, so in one shard).
//
// C interface: engine_receive_launch sets the given device current,
// launches on the given stream and returns cudaGetLastError() as an int
// (0 = launched); cuda_error_string names an error.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;                    // id vectors a thread
constexpr int VEC_PER_BLOCK = THREADS * UNROLL;
constexpr int IDS_PER_BLOCK = VEC_PER_BLOCK * 4;

enum Agg { MIN = 0, MAX = 1 };

template <typename T, int AGG> struct Op;

template <> struct Op<int, MIN> {
  __device__ static bool improves(int v, int o) { return v < o; }
  __device__ static void apply(int* a, int v) { atomicMin(a, v); }
};
template <> struct Op<int, MAX> {
  __device__ static bool improves(int v, int o) { return v > o; }
  __device__ static void apply(int* a, int v) { atomicMax(a, v); }
};
template <> struct Op<float, MIN> {
  __device__ static bool improves(float v, float o) { return v < o; }
  __device__ static void apply(float* a, float v) {
    if (__float_as_int(v) >= 0)
      atomicMin(reinterpret_cast<int*>(a), __float_as_int(v));
    else
      atomicMax(reinterpret_cast<unsigned*>(a), __float_as_uint(v));
  }
};
template <> struct Op<float, MAX> {
  __device__ static bool improves(float v, float o) { return v > o; }
  __device__ static void apply(float* a, float v) {
    if (__float_as_int(v) >= 0)
      atomicMax(reinterpret_cast<int*>(a), __float_as_int(v));
    else
      atomicMin(reinterpret_cast<unsigned*>(a), __float_as_uint(v));
  }
};

struct Row {
  const int* ids;  // the row's first id; the row's ids are contiguous
  long long vals_off;  // the row's first value, in elements
  long long vals_step;
  long long plane;  // p * vs
};

// a live slot: 0 <= id < vs in one unsigned compare
__device__ __forceinline__ bool live(int id, int vs) {
  return static_cast<unsigned>(id) < static_cast<unsigned>(vs);
}

template <typename T, int AGG>
__device__ __forceinline__ int deliver_one(const Row& row, const T* vals,
                                           const T* old, T* out,
                                           uint8_t* active, int* cursor,
                                           long long c, int id) {
  const T v = vals[row.vals_off + c * row.vals_step];
  const long long at = row.plane + id;
  if (!Op<T, AGG>::improves(v, old[at])) return 0;
  Op<T, AGG>::apply(out + at, v);
  active[at] = 1;
  cursor[at] = 0;
  return 1;
}

// One block: IDS_PER_BLOCK ids of one row.  blockIdx.y = p * R + r.
template <typename T, int AGG>
__global__ void __launch_bounds__(THREADS)
receive_kernel(const int* __restrict__ ids, const T* __restrict__ vals,
               long long is0, long long is1, long long vs0, long long vs1,
               long long vs2, int R, long long C, const T* __restrict__ old,
               T* out, uint8_t* active, int* cursor, int vs,
               unsigned long long* accepted) {
  const int p = blockIdx.y / R, r = blockIdx.y % R;
  Row row{ids + p * is0 + r * is1, p * vs0 + r * vs1, vs2,
          static_cast<long long>(p) * vs};
  const int t = threadIdx.x;
  int acc = 0;
  // ids before the row's first 16-byte boundary (head) and after its last
  // whole vector (tail): at most three each, for block 0
  const long long head = ((16 - (reinterpret_cast<uintptr_t>(row.ids) & 15))
                          & 15) / 4;
  const long long h = head < C ? head : C;
  const long long nvec = (C - h) / 4;
  const long long tail0 = h + 4 * nvec;
  if (blockIdx.x == 0 && t < 6) {
    const long long c = t < 3 ? t : tail0 + (t - 3);
    if ((t < 3 && c < h) || (t >= 3 && c < C)) {
      const int id = row.ids[c];
      if (live(id, vs))
        acc += deliver_one<T, AGG>(row, vals, old, out, active, cursor, c,
                                   id);
    }
  }
  const int4* vec = reinterpret_cast<const int4*>(row.ids + h);
  const long long v0 = static_cast<long long>(blockIdx.x) * VEC_PER_BLOCK + t;
  int4 got[UNROLL];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const long long v = v0 + u * THREADS;
    got[u] = v < nvec ? __ldg(vec + v) : make_int4(-1, -1, -1, -1);
  }
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const int4 g = got[u];
    if ((g.x & g.y & g.z & g.w) < 0) continue;  // all four empty
    const long long c = h + 4 * (v0 + u * THREADS);
    const int four[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (live(four[k], vs))
        acc += deliver_one<T, AGG>(row, vals, old, out, active, cursor,
                                   c + k, four[k]);
  }
  const unsigned sum = __reduce_add_sync(0xffffffffu, static_cast<unsigned>(acc));
  if ((t & 31) == 0 && sum)
    atomicAdd(accepted + p, static_cast<unsigned long long>(sum));
}

template <typename T, int AGG>
cudaError_t launch(const void* ids, const void* vals, const long long* is,
                   const long long* vst, int P, int R, long long C,
                   const void* old, void* out, void* active, void* cursor,
                   int vs, void* accepted, cudaStream_t s) {
  // a block covers at most IDS_PER_BLOCK ids of its row
  const dim3 grid(static_cast<unsigned>((C + IDS_PER_BLOCK - 1)
                                        / IDS_PER_BLOCK),
                  static_cast<unsigned>(P * R));
  receive_kernel<T, AGG><<<grid, THREADS, 0, s>>>(
      static_cast<const int*>(ids), static_cast<const T*>(vals), is[0], is[1],
      vst[0], vst[1], vst[2], R, C, static_cast<const T*>(old),
      static_cast<T*>(out), static_cast<uint8_t*>(active),
      static_cast<int*>(cursor), vs,
      static_cast<unsigned long long*>(accepted));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_agg(int agg, const void* ids, const void* vals,
                       const long long* is, const long long* vst, int P,
                       int R, long long C, const void* old, void* out,
                       void* active, void* cursor, int vs, void* accepted,
                       cudaStream_t s) {
  if (agg == MIN)
    return launch<T, MIN>(ids, vals, is, vst, P, R, C, old, out, active,
                          cursor, vs, accepted, s);
  if (agg == MAX)
    return launch<T, MAX>(ids, vals, is, vst, P, R, C, old, out, active,
                          cursor, vs, accepted, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// agg: 0 = min, 1 = max (or); dtype: 0 = int32, 1 = float32
// (kernels/receive.py).  ids_strides and vals_strides: three element
// strides each, of the [P, R, C] views; the ids' innermost stride is 1
// (C = 1 excepted, where it means nothing).
extern "C" int engine_receive_launch(int device, int agg, int dtype,
                                     const void* ids, const void* vals,
                                     const long long* ids_strides,
                                     const long long* vals_strides, int P,
                                     int R, long long C, const void* old,
                                     void* out, void* active, void* cursor,
                                     int vs, void* accepted, void* stream) {
  if (P <= 0 || R <= 0 || C <= 0 || vs <= 0 || P * R > 65535
      || (ids_strides[2] != 1 && C > 1))
    return (int)cudaErrorInvalidValue;
  // this library's runtime keeps its own current device: set it to the
  // stream's, so the launch lands in that device's (primary) context
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_agg<int>(agg, ids, vals, ids_strides, vals_strides, P,
                                R, C, old, out, active, cursor, vs, accepted,
                                s);
  if (dtype == 1)
    return (int)launch_agg<float>(agg, ids, vals, ids_strides, vals_strides,
                                  P, R, C, old, out, active, cursor, vs,
                                  accepted, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
