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
//     t), in 8 M tiles of 16 lanes.  Each thread builds its A fragments
//     in registers, one fp16x2 compare (HSET2) per register: dst and row
//     ride as fp16 1024 + k, and an equal pair gives fp16 1.0, 0x3C00,
//     which read as bf16 is exactly 2^-7.  So A holds 2^-7 for a hit and
//     the output is scaled back by 128, exactly.
//   * B [512 edges x 8] holds cand_e = v_e * w_e (rounded to float32 as
//     __fmul_rn, as the scalar form rounds it) split into three bf16
//     terms, hi + mid + lo, in columns 0, 1, 2 (columns 3-7 are never
//     read).  Each term is the round-to-nearest bf16 of what the terms
//     before it left, so hi + mid + lo == cand_e exactly: 3 x 8
//     significant bits cover float32's 24 (the residual after hi has at
//     most 16 bits, the residual after mid at most 8).  With the 2^-7 of
//     A this holds for |cand_e| >= 2^-103; below that subnormals drop
//     bits of lo, an absolute error under 2^-126.  Inputs must be finite,
//     as for the TPU's matmul form.
//   * Every product is exact (a power of two times bf16), so only the
//     fp32 accumulation rounds: each warp sums its columns over at most
//     128 edges, the four warps' sums are added in warp order, and out =
//     128 (hi + (mid + lo)).  The error is that of a float32 sum of the
//     lane's terms, like the scalar form's; both are held to rtol/atol
//     1e-5 against the plain version.  Plain TF32 (10-bit mantissa) would
//     not meet 1e-5.
// Bound: the bytes of the scalar form, 12 per edge with weights (206 MB,
// 0.0616 ms at 3.35 TB/s on the 31,018 blocks of an RMAT 2^18 pull), 8
// without (143 MB, 0.0427 ms).  The tensor work is 4,096 FLOP per
// (k-step, M tile) pair the kernel issues (kernels/semiring_spmv.py::
// mma_tile_steps counts them): about 31 pairs a block on the
// destination-sorted stream, ~4e9 FLOP at RMAT 2^18, ~0.004 ms at 989
// TFLOP/s, far under the bytes.  What the design does against what holds
// a row-split form (each warp owning 32 lanes and walking all 512 edges)
// at several times its bound:
//   * k-steps split across warps, not rows.  Warp w takes edges
//     [128w, 128w + 128), 8 k-steps of 16, for all 8 M tiles, where a row
//     split walks all 512 edges for each warp's two M tiles (256 mma a
//     block, in chains of 32 dependent mma).  The warps write their
//     hi/mid/lo column sums to shared memory and thread r adds them in
//     warp order: no atomics, so two launches give the same bits.
//   * Only the M tiles a k-step hits.  The stream is sorted by dst, so 16
//     consecutive edges hit about one 16-lane tile.  The warp gathers
//     every k-step's set of hit tiles at once (a tile mask per lane, two
//     xor-shuffles, two __reduce_or_sync) and issues A builds and mma
//     only for the tiles in the span [lowest, highest] of each k-step.
//     An all-padding k-step issues nothing.  The skip is exact (a tile no
//     edge hits adds 0), so any input stays right; on random dst every
//     k-step issues all 8 tiles, 256 mma a block, but in 8 chains of 8 a
//     warp, not 2 of 32.
//   * Two accumulators where two do.  A warp of the sorted stream covers
//     a few consecutive lanes, so nearly every warp hits at most two
//     adjacent tiles over all its k-steps.  Such a warp keeps two
//     accumulators at those tiles and tests two bits a k-step; any other
//     warp keeps all eight (8 x 4 fp32 registers) behind a warp-uniform
//     predicate on an unrolled m = 0..7 loop, so the accumulators stay in
//     registers.  The combine adds a windowed warp's sums only on the 32
//     rows of its window.
//   * Each input byte is loaded once, 16 bytes at a time.  Lane i of a
//     warp loads its four consecutive edges (one coalesced 16-byte load
//     per array, as the scalar form does) and turns them in registers
//     into their operands: the three split terms as B registers and the
//     dst as fp16 keys (padding and keys >= 128 as 1279, which no row
//     matches).  Within a k-step the pairing of k positions with edges is
//     free as long as A and B share it, so thread (g, t) of the fragment
//     layout takes the four edges of lane 4s + t as k = 2t, 2t + 1,
//     2t + 8, 2t + 9.  The operands (32 bytes a lane) move through a
//     per-warp slab of shared memory, written once, read by the warp's
//     own threads after a __syncwarp: a thread reads its B term (which
//     depends on g) and the dst keys with two 8-byte loads a k-step.
//     Shuffles cannot do that as cheaply: a sender cannot choose the term
//     for each of its eight readers, so all three terms' words move and g
//     selects, 7 shuffles and 4 selects a k-step, and that version was
//     bound by its instruction issue (PERF.md).
//   * Occupancy: one 128-thread block per edge block with at most 64
//     registers (__launch_bounds__(128, 8)), so at least 8 blocks, 48 KB
//     of loads, are in flight per SM where ~20 KB covers the latency at
//     3.35 TB/s.  A single streaming pass with no reuse gains nothing from
//     TMA or a cp.async ring at that occupancy; ptxas' registers, shared
//     memory and spills are in chip_smoke.py's phase `ptxas`.  wgmma is
//     not the instruction here: its 64-row M would make the skip 4x
//     coarser and each A build 4x larger, for tensor work that is already
//     1/15 of the bytes bound.
//
// C interface: spmv_partials_launch sets the given device current, launches
// on the given stream and returns cudaGetLastError(); it allocates nothing
// and does not synchronise.  Both forms read 16-byte vectors, so the input
// pointers must be 16-byte aligned (the wrapper checks).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
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

constexpr int KSTEP = 16;                          // edges per mma k-step
constexpr int KSTEPS = 32 * PER_THREAD / KSTEP;    // 8 k-steps a warp
constexpr int M_TILES = TILE / 16;                 // 8 M tiles of 16 lanes
// a row of part: D columns 0 and 2 of a row land 8 banks apart
constexpr int kPartStride = TILE + 4;

__device__ __forceinline__ unsigned bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const unsigned*>(&v);
}

// the exact three-term bf16 split of (c0, c1): hi + mid + lo == c, each
// term packed as a B register (c0 in the low half)
__device__ __forceinline__ void split3(float c0, float c1, unsigned& hi,
                                      unsigned& mid, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(c0, c1);
  const float2 hf = __bfloat1622float2(h);
  const float r0 = __fsub_rn(c0, hf.x), r1 = __fsub_rn(c1, hf.y);
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(m);
  hi = bf16x2_bits(h);
  mid = bf16x2_bits(m);
  lo = bf16x2_bits(__floats2bfloat162_rn(__fsub_rn(r0, mf.x),
                                         __fsub_rn(r1, mf.y)));
}

// two one-hot entries packed as an A register, in one fp16x2 compare: p
// holds two dst and r the row twice as fp16 1024 + k (bits 0x6400 + k,
// exact for k < 1024); equal halves become fp16 1.0, 0x3C00, which read as
// bf16 is 2^-7 (kOneHot), and the others 0
constexpr float kOneHot = 0.0078125f;  // 2^-7
constexpr unsigned kFp16Base = 0x64006400u;  // fp16 1024 in both halves

__device__ __forceinline__ unsigned onehot2(unsigned p, unsigned r) {
  const __half2 eq = __heq2(*reinterpret_cast<const __half2*>(&p),
                            *reinterpret_cast<const __half2*>(&r));
  return *reinterpret_cast<const unsigned*>(&eq);
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

// what one lane's four edges give the tensor-core form's k-step: the
// split terms hi, mid, lo as B registers (edges 0, 1 in .x, 2, 3 in .y)
// and the dst as fp16x2 A-build keys
struct __align__(16) Operands {
  uint2 terms[3];
  uint2 dst;
};

__global__ void __launch_bounds__(TILE, 8)
spmv_plus_times_mma_kernel(const float* __restrict__ vals,
                           const int* __restrict__ dst,
                           const float* __restrict__ w,
                           float* __restrict__ out) {
  // per warp, D columns 0-3 of every row: hi, mid, lo sums (3 unused)
  __shared__ float part[WARPS][4][kPartStride];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2;  // fragment row group / B column
  const int t = lane & 3;   // thread in group
  const long long e0 = (long long)blockIdx.x * EDGE_BLOCK + PER_THREAD * tid;

  // my four consecutive edges, one 16-byte load per array
  int d[PER_THREAD];
  float c[PER_THREAD];
  load4(dst + e0, d);
  load4(vals + e0, c);
  if (w != nullptr) {
    float wt[PER_THREAD];
    load4(w + e0, wt);
#pragma unroll
    for (int e = 0; e < PER_THREAD; ++e) c[e] = __fmul_rn(c[e], wt[e]);
  }
  // the operands my four edges give a k-step: their split terms and their
  // dst as fp16 1024 + dst (padding and keys >= TILE as 1279, which no row
  // matches), and the set of M tiles they hit
  Operands mine;
  split3(c[0], c[1], mine.terms[0].x, mine.terms[1].x, mine.terms[2].x);
  split3(c[2], c[3], mine.terms[0].y, mine.terms[1].y, mine.terms[2].y);
  unsigned tiles = 0u, key[PER_THREAD];
#pragma unroll
  for (int e = 0; e < PER_THREAD; ++e) {
    const bool valid = (unsigned)d[e] < (unsigned)TILE;
    key[e] = valid ? (unsigned)d[e] : 0xffu;
    tiles |= valid ? 1u << (key[e] >> 4) : 0u;
  }
  mine.dst = make_uint2(__byte_perm(key[0], key[1], 0x5410) | kFp16Base,
                        __byte_perm(key[2], key[3], 0x5410) | kFp16Base);
  // they go through a per-warp slab of shared memory: the B term a reader
  // takes depends on its g, which a shuffle's sender cannot choose
  __shared__ Operands slab[WARPS][32];
  slab[warp][lane] = mine;
  __syncwarp();
  // k-step s is the warp's edges [16s, 16s + 16), held by lanes 4s..4s+3:
  // their tile sets, OR-ed, go to byte s & 3 of sets[s >> 2]
  // (warp-uniform)
  tiles |= __shfl_xor_sync(kFull, tiles, 1);
  tiles |= __shfl_xor_sync(kFull, tiles, 2);
  const unsigned placed = tiles << (8 * (g & 3));
  const unsigned sets[2] = {__reduce_or_sync(kFull, g < 4 ? placed : 0u),
                            __reduce_or_sync(kFull, g < 4 ? 0u : placed)};
  // lane 4s + t's edges are my k = 2t, 2t + 1, 2t + 8, 2t + 9 in k-step s;
  // B column g takes term g (columns 3-7 take lo and are never read)
  const Operands* from = &slab[warp][t];
  const int term = g < 2 ? g : 2;
  const unsigned row0 = kFp16Base + (unsigned)g * 0x10001u;  // row g, fp16
  // one mma of k-step s into the tile whose row g is r
  auto issue = [&](float (&acc)[4], int s, unsigned r) {
    const uint2 p = from[4 * s].dst, b = from[4 * s].terms[term];
    const unsigned r8 = r + 0x80008u;  // row + 8
    mma_bf16_16816(acc, onehot2(p.x, r), onehot2(p.x, r8), onehot2(p.y, r),
                   onehot2(p.y, r8), b.x, b.y);
  };
  // every tile the warp's k-steps hit
  unsigned hit = sets[0] | sets[1];
  hit = (hit | hit >> 8 | hit >> 16 | hit >> 24) & 0xffu;
  __shared__ int window_of[WARPS];
  int window = -1;  // all tiles
  if (hit == 0u || 31 - __clz(hit) - (__ffs(hit) - 1) <= 1) {
    // the stream's common case: the warp hits at most two adjacent tiles,
    // so two accumulators at tiles [window, window + 1] cover it; bits 0
    // and 1 of k-step s's byte in near[] say which of the two it hits
    window = min(max(__ffs(hit) - 1, 0), M_TILES - 2);
    const unsigned near[2] = {sets[0] >> window, sets[1] >> window};
    const unsigned r0 = row0 + (unsigned)window * 0x100010u;
    const unsigned r1 = r0 + 0x100010u;
    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int s = 0; s < KSTEPS; ++s) {
      const unsigned byte = 8 * (s & 3);
      if (near[s >> 2] & (1u << byte)) issue(acc[0], s, r0);
      if (near[s >> 2] & (2u << byte)) issue(acc[1], s, r1);
    }
    if (t < 2) {
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int r = g + 16 * (window + m);
        part[warp][2 * t][r] = acc[m][0];
        part[warp][2 * t + 1][r] = acc[m][1];
        part[warp][2 * t][r + 8] = acc[m][2];
        part[warp][2 * t + 1][r + 8] = acc[m][3];
      }
    }
  } else {
    float acc[M_TILES][4];
#pragma unroll
    for (int m = 0; m < M_TILES; ++m)
      acc[m][0] = acc[m][1] = acc[m][2] = acc[m][3] = 0.f;
#pragma unroll
    for (int s = 0; s < KSTEPS; ++s) {
      const unsigned set = (sets[s >> 2] >> (8 * (s & 3))) & 0xffu;
      if (set == 0u) continue;  // all padding: nothing to issue
      // the span [lowest, highest] of the tiles hit, as a mask
      const unsigned span =
          (0xffu >> __clz(set << 24)) & (0u - (set & (0u - set)));
#pragma unroll
      for (int m = 0; m < M_TILES; ++m)  // a warp-uniform skip
        if (span & (1u << m)) issue(acc[m], s, row0 + m * 0x100010u);
    }
    // thread (g, t) holds D columns 2t, 2t + 1 of rows g + 16m and
    // g + 8 + 16m: t = 0 the hi and mid sums, t = 1 the lo sum
    if (t < 2) {
#pragma unroll
      for (int m = 0; m < M_TILES; ++m) {
        const int r = g + 16 * m;
        part[warp][2 * t][r] = acc[m][0];
        part[warp][2 * t + 1][r] = acc[m][1];
        part[warp][2 * t][r + 8] = acc[m][2];
        part[warp][2 * t + 1][r + 8] = acc[m][3];
      }
    }
  }
  if (lane == 0) window_of[warp] = window;
  __syncthreads();
  // my row's sums over the warps, in warp order; a warp whose window does
  // not hold my row adds 0
  float hi = 0.f, mid = 0.f, lo = 0.f;
#pragma unroll
  for (int wi = 0; wi < WARPS; ++wi) {
    const int win = window_of[wi];
    if (win < 0 || (unsigned)(tid - 16 * win) < 32u) {
      hi = __fadd_rn(hi, part[wi][0][tid]);
      mid = __fadd_rn(mid, part[wi][1][tid]);
      lo = __fadd_rn(lo, part[wi][2][tid]);
    }
  }
  // undo the one-hot's 2^-7: exact
  out[(long long)blockIdx.x * TILE + tid] =
      __fmul_rn(__fadd_rn(hi, __fadd_rn(mid, lo)), 1.0f / kOneHot);
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
