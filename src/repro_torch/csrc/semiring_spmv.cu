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
// The scalar form (use_mxu = 0): a segmented reduction over the
// destination-sorted stream.  Bound: the call must move 8 bytes per edge
// (value and dst; 12 with the weights that min_plus, max_min and
// plus_times read, while min, max and or ignore them) plus 512 bytes of
// output per block, each read or written once: 143 MB for the 31,018
// blocks of an RMAT 2^18 pull, 0.0427 ms at 3.35 TB/s (206 MB and
// 0.0616 ms with weights).  The kernel is
// built to stay on that bytes bound: it reads each byte once, with 16-byte
// loads, and issues a few instructions per edge.
//   * One 128-thread block per edge block.  Thread i loads edges 4i..4i+3
//     as one 16-byte vector per array (coalesced, no shared staging),
//     combines them and reduces the equal-dst runs among its four edges in
//     edge order.
//   * The stream's builder (kernels/ops.py::build_pulled_graph) sorts
//     edges by destination and pads each tile's run to whole blocks, so
//     within a block dst never decreases and padding (-1) sits at the
//     tail.  Read as unsigned, -1 is a key past 127, so the whole block is
//     non-decreasing.  A warp (128 edges) checks that with one __all_sync.
//   * Sorted warp (the stream's case): a segmented inclusive scan over the
//     warp's threads, keyed on each thread's last dst, merges only equal
//     keys (5 __shfl_up_sync steps), so the thread where a run ends holds
//     the run's reduction.  Each lane then has at most one run in the
//     warp: the thread that ends it stores it to part[warp][lane], which
//     starts at the identity; keys >= 128 (padding) are dropped.
//   * Unsorted warp (any other input, e.g. random dst): the warp stages
//     its 128 (dst, value) pairs in shared memory and each thread scans
//     them in edge order for the 4 lanes it owns (t, t+32, t+64, t+96):
//     deterministic, at most the old per-lane scan's work.
//   * After one __syncthreads, thread t reduces part[0..3][t] in warp order,
//     clamps at the identity (`tie`, not for plus_times) and writes out.
// No atomics: every lane's reduction runs in a fixed order, so the result
// is the same on every launch, and float min/max keep the NaN propagation
// of Ops<float>.  (Shared-memory atomics would need CAS loops for float
// min/max and would sum plus_times in an order that changes between runs.)
// plus_times sums run-then-tree, not in edge order: each thread's run in
// edge order, the scan's tree over threads, then the warps in order.  The
// plain version sums in another order, so plus_times is held to rtol/atol
// 1e-5 against it; the idempotent forms are exact.
//
// The tensor-core form of plus_times (use_mxu = 1).  The TPU kernel's
// `use_mxu=True` branch (semiring_spmv.py lines 80-87) writes the same
// sum as cand[1, 512] @ onehot[512, 128] on the TPU's matrix unit, with
// fp32 accumulation.  Here it is D = A B with `mma.sync.m16n8k16` (bf16
// in, fp32 accumulate):
//   * A [128 lanes x 512 edges] is the one-hot matrix, A[t, e] = (dst_e ==
//     t).  0 and 1 are exact in bf16.  Each thread builds its A fragment
//     in registers from the edges' dst, so A never touches memory.
//   * B [512 edges x 8] holds cand_e = v_e * w_e (rounded to float32 as
//     __fmul_rn, as the scalar form rounds it) split into three bf16
//     terms, hi + mid + lo, in columns 0, 1, 2 (columns 3-7 are zero).
//     Each term is the round-to-nearest bf16 of what the terms before it
//     left, so hi + mid + lo == cand_e exactly: 3 x 8 significant bits
//     cover float32's 24 (the residual after hi has at most 16 bits, the
//     residual after mid at most 8).  This holds for |cand_e| >= 2^-110;
//     below that bf16's subnormals drop bits of lo, an absolute error
//     under 2^-133.  Inputs must be finite, as for the TPU's matmul form.
//   * Every product is exact (one-hot times bf16), so only the fp32
//     accumulation rounds: each column is a sum of at most 512 terms, and
//     out = hi_sum + (mid_sum + lo_sum).  The error is that of a float32
//     sum of the lane's terms, |err| <= ~513 u sum_e |cand_e| (u = 2^-24)
//     at worst and ~sqrt(513) u in practice, like the scalar form's
//     sequential sum; both are held to rtol/atol 1e-5 against the plain
//     version.  Plain TF32 (10-bit mantissa) would not meet 1e-5.
// One 128-thread block per edge block, as the scalar form.  Warp w owns
// lanes [32w, 32w + 32): two 16-row M tiles.  It walks the 512 edges in
// 32 k-steps of 16; per step each thread reads the dst and the split
// terms of its four edges (2t, 2t+1, 2t+8, 2t+9) from shared memory,
// builds both M tiles' A fragments and reuses its B fragment for both.
// Bound: the same bytes as the weighted scalar form (0.0616 ms on the
// RMAT 2^18 stream); the issued tensor work, 31,018 x 2 x 128 x 512 x 8 =
// 3.3e10 FLOP, takes ~0.03 ms at 989 TFLOP/s (bf16 dense), under it.
//
// C interface: spmv_partials_launch sets the given device current, launches
// on the given stream and returns cudaGetLastError(); it allocates nothing
// and does not synchronise.  The scalar form reads 16-byte vectors, so its
// input pointers must be 16-byte aligned (the wrapper checks).

#include <cuda_bf16.h>
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

constexpr int WARPS = TILE / 32;                 // 4 warps of 128 edges each
constexpr int PER_THREAD = EDGE_BLOCK / TILE;    // 4 consecutive edges
constexpr unsigned kFull = 0xffffffffu;

template <typename T> struct Vec4;
template <> struct Vec4<int> { using type = int4; };
template <> struct Vec4<float> { using type = float4; };

// one 16-byte load of p[0..3] (p is 16-byte aligned: the wrapper checks
// the base pointers, and every thread's offset is a multiple of 4)
template <typename T>
__device__ __forceinline__ void load4(const T* __restrict__ p, T (&x)[4]) {
  const typename Vec4<T>::type v =
      *reinterpret_cast<const typename Vec4<T>::type*>(p);
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}

template <int S, typename T>
__global__ void __launch_bounds__(TILE)
spmv_partials_kernel(const T* __restrict__ vals, const int* __restrict__ dst,
                     const T* __restrict__ w, T* __restrict__ out) {
  __shared__ T part[WARPS][TILE];                     // per-warp lane results
  __shared__ Edge<T> staged[WARPS][32 * PER_THREAD];  // unsorted warps only
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long e0 = (long long)blockIdx.x * EDGE_BLOCK + PER_THREAD * tid;

  int d[PER_THREAD];
  T c[PER_THREAD];
  load4(dst + e0, d);
  load4(vals + e0, c);
  if (w != nullptr) {
    T wt[PER_THREAD];
    load4(w + e0, wt);
#pragma unroll
    for (int e = 0; e < PER_THREAD; ++e) c[e] = combine<S, T>(c[e], wt[e]);
  } else {
#pragma unroll
    for (int e = 0; e < PER_THREAD; ++e)
      c[e] = combine<S, T>(c[e], Ops<T>::one());
  }
  // keys as unsigned: padding (-1) sorts after every lane, and any key
  // >= TILE is dropped
  unsigned k[PER_THREAD];
#pragma unroll
  for (int e = 0; e < PER_THREAD; ++e) k[e] = (unsigned)d[e];

  const T ident = identity<S, T>();
  T* row = part[warp];
  const unsigned prev_last = __shfl_up_sync(kFull, k[PER_THREAD - 1], 1);
  const bool in_order = k[0] <= k[1] && k[1] <= k[2] && k[2] <= k[3] &&
                        (lane == 0 || prev_last <= k[0]);
  if (__all_sync(kFull, in_order)) {
    // sorted warp: every key's edges are one run; the thread where it ends
    // stores its reduction, so each row entry is written at most once
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j) row[j * 32 + lane] = ident;
    __syncwarp();
    // runs among my four edges, in edge order: the head run (it may go on
    // from the threads before), runs inside, and the tail run (it may go
    // on into the threads after)
    T acc = c[0], head = c[0];
    bool uniform = true;  // my four edges are one run
#pragma unroll
    for (int e = 1; e < PER_THREAD; ++e) {
      if (k[e] != k[e - 1]) {
        if (uniform) head = acc;
        else if (k[e - 1] < TILE) row[k[e - 1]] = acc;  // a run inside
        uniform = false;
        acc = c[e];
      } else {
        acc = reduce<S, T>(acc, c[e]);
      }
    }
    // segmented inclusive scan of the tail runs over the warp: a thread
    // whose tail key equals mine up to o lanes back is, in a sorted warp,
    // in my run with every thread between
    const unsigned key = k[PER_THREAD - 1];
    T run = acc;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const T r = __shfl_up_sync(kFull, run, o);
      const unsigned rk = __shfl_up_sync(kFull, key, o);
      if (lane >= o && rk == key) run = reduce<S, T>(r, run);
    }
    const T prev_run = __shfl_up_sync(kFull, run, 1);
    const unsigned next_first = __shfl_down_sync(kFull, k[0], 1);
    if (!uniform) {  // my head run ends here
      if (lane > 0 && prev_last == k[0]) head = reduce<S, T>(prev_run, head);
      if (k[0] < TILE) row[k[0]] = head;
    }
    if ((lane == 31 || next_first != key) && key < TILE) row[key] = run;
  } else {
    // unsorted warp: a per-lane scan of the warp's 128 edges in edge order
    Edge<T>* st = staged[warp];
#pragma unroll
    for (int e = 0; e < PER_THREAD; ++e) {
      Edge<T> ed;
      ed.dst = d[e];
      ed.cand = c[e];
      st[PER_THREAD * lane + e] = ed;
    }
    __syncwarp();
    T acc[PER_THREAD];
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j) acc[j] = ident;
#pragma unroll 8
    for (int e = 0; e < 32 * PER_THREAD; ++e) {
      const Edge<T> ed = st[e];  // broadcast read
#pragma unroll
      for (int j = 0; j < PER_THREAD; ++j)
        acc[j] = ed.dst == j * 32 + lane ? reduce<S, T>(acc[j], ed.cand) : acc[j];
    }
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j) row[j * 32 + lane] = acc[j];
  }
  __syncthreads();

  T acc = part[0][tid];
#pragma unroll
  for (int wi = 1; wi < WARPS; ++wi) acc = reduce<S, T>(acc, part[wi][tid]);
  if constexpr (S != PLUS_TIMES) acc = reduce<S, T>(acc, ident);  // tie
  out[(long long)blockIdx.x * TILE + tid] = acc;
}

// halfword stride of one split row in shared memory: 264 words, so the
// three rows start 8 banks apart and a warp's B reads do not conflict
constexpr int kSplitStride = EDGE_BLOCK + 16;
constexpr unsigned kOneBf16 = 0x3F80u;  // 1.0 in bf16

// two one-hot bf16 entries of row `row`, packed as an A register (the
// lower edge in the low half)
__device__ __forceinline__ unsigned onehot2(int2 d, int row) {
  return (d.x == row ? kOneBf16 : 0u) | (d.y == row ? kOneBf16 << 16 : 0u);
}

__device__ __forceinline__ void mma_bf16_16816(float (&acc)[4], unsigned a0,
                                               unsigned a1, unsigned a2,
                                               unsigned a3, unsigned b0,
                                               unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %11, %12, %13};\n"
      : "=f"(acc[0]), "=f"(acc[1]), "=f"(acc[2]), "=f"(acc[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1),
        "f"(acc[0]), "f"(acc[1]), "f"(acc[2]), "f"(acc[3]));
}

__global__ void __launch_bounds__(TILE)
spmv_plus_times_mma_kernel(const float* __restrict__ vals,
                           const int* __restrict__ dst,
                           const float* __restrict__ w,
                           float* __restrict__ out) {
  __shared__ __align__(16) int sdst[EDGE_BLOCK];
  __shared__ __align__(16) unsigned short split[3][kSplitStride];
  const long long base = (long long)blockIdx.x * EDGE_BLOCK;
  const int tid = threadIdx.x;
#pragma unroll
  for (int k = 0; k < EDGE_BLOCK / TILE; ++k) {
    const int e = k * TILE + tid;
    const float v = vals[base + e];
    const float cand = w != nullptr ? __fmul_rn(v, w[base + e]) : v;
    const __nv_bfloat16 hi = __float2bfloat16_rn(cand);
    const float r1 = __fsub_rn(cand, __bfloat162float(hi));
    const __nv_bfloat16 mid = __float2bfloat16_rn(r1);
    const __nv_bfloat16 lo =
        __float2bfloat16_rn(__fsub_rn(r1, __bfloat162float(mid)));
    split[0][e] = __bfloat16_as_ushort(hi);
    split[1][e] = __bfloat16_as_ushort(mid);
    split[2][e] = __bfloat16_as_ushort(lo);
    sdst[e] = dst[base + e];
  }
  __syncthreads();

  const int lane = tid & 31;
  const int g = lane >> 2;  // fragment row group / B column
  const int t = lane & 3;   // thread in group
  const int row0 = (tid >> 5) * 32 + g;  // M tile m covers row0 + 16m (+8)
  float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll 4
  for (int kb = 0; kb < EDGE_BLOCK; kb += 16) {
    const int e0 = kb + 2 * t;  // k = 2t, 2t+1; e0 + 8: k = 2t+8, 2t+9
    const int2 d01 = *reinterpret_cast<const int2*>(&sdst[e0]);
    const int2 d89 = *reinterpret_cast<const int2*>(&sdst[e0 + 8]);
    unsigned b0 = 0u, b1 = 0u;
    if (g < 3) {
      b0 = *reinterpret_cast<const unsigned*>(&split[g][e0]);
      b1 = *reinterpret_cast<const unsigned*>(&split[g][e0 + 8]);
    }
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int r = row0 + 16 * m;
      mma_bf16_16816(acc[m], onehot2(d01, r), onehot2(d01, r + 8),
                     onehot2(d89, r), onehot2(d89, r + 8), b0, b1);
    }
  }
  // thread t = 0 holds columns 0, 1 (hi, mid) of rows r and r + 8; its
  // neighbour t = 1 holds column 2 (lo)
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const float lo_r = __shfl_down_sync(0xffffffffu, acc[m][0], 1);
    const float lo_r8 = __shfl_down_sync(0xffffffffu, acc[m][2], 1);
    if (t == 0) {
      const long long o = (long long)blockIdx.x * TILE + row0 + 16 * m;
      out[o] = __fadd_rn(acc[m][0], __fadd_rn(acc[m][1], lo_r));
      out[o + 8] = __fadd_rn(acc[m][2], __fadd_rn(acc[m][3], lo_r8));
    }
  }
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
                                    int use_mxu, const void* vals,
                                    const void* dst, const void* w, void* out,
                                    int n_blocks, void* stream) {
  if (n_blocks <= 0) return (int)cudaErrorInvalidValue;
  // this library's runtime keeps its own current device: set it to the
  // stream's, so the launch lands in that device's (primary) context
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (use_mxu) {  // the tensor-core form: plus_times on float32 only
    if (semiring != PLUS_TIMES || dtype != 1) return (int)cudaErrorInvalidValue;
    spmv_plus_times_mma_kernel<<<dim3(n_blocks), dim3(TILE), 0, s>>>(
        static_cast<const float*>(vals), static_cast<const int*>(dst),
        static_cast<const float*>(w), static_cast<float*>(out));
    return (int)cudaGetLastError();
  }
  // dtype codes: 0 = int32, 1 = float32 (kernels/semiring_spmv.py)
  if (dtype == 0) return (int)launch<int>(semiring, vals, dst, w, out, n_blocks, s);
  if (dtype == 1) return (int)launch<float>(semiring, vals, dst, w, out, n_blocks, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
