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
// and does not synchronise.

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
