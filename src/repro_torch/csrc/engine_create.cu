// The engine tick's create for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces no Pallas kernel: the JAX package's create
// (src/repro/core/engine.py::_phase1_create) is XLA code.  It was added
// because the PyTorch form of the same phase, some 160 torch ops over
// padded tensors, took 2.74 ms of a 2.81 ms tick in the benchmark's WCC
// cells and about 5 ms of a 5.3 ms tick in its SSSP cell (PERF.md): it
// sorts, gathers and scatters every one of the P x M x D fetch slots
// (8.4 M at Graph500 scale 19, 16.8 M at scale 20, many as int64) where a
// few thousand carry a message, and the host spends the tick launching it.
//
// Contract (kernels/create.py::create; core/engine.py::_phase1_create is
// the plain version and gives the same bits), for the idempotent programs:
//   select  — per shard p: target = clamp(ceil(n_active * rho), 1, M), and
//             at most max(M / max(throttle[p], 1), 1) when a throttle is
//             given; each active vertex's priority bucket (log, linear or
//             disabled, the float32 arithmetic of priority_buckets, the
//             demotion penalty clamped at bucket 31); the first `target`
//             active vertices in (bucket, vertex index) order take slots
//             0, 1, ... in that order;
//   fetch   — slot s streams edges lo + cur + d, d < min(D, deg - cur) and
//             d < window[p] when a window is given;
//   create  — the message is the program's combine of the source value
//             and the edge's weight;
//   route   — a message's rank is its position among the shard's messages
//             to the same destination shard, in flat order s * D + d; it
//             is kept when rank < cap and written to row (p, dst / vs) at
//             that rank; every other slot of the send buffers holds the
//             identity and id -1;
//   advance — the cursor moves to min(first dropped d, window, deg - cur)
//             past cur; a vertex whose stream is done leaves the frontier
//             with cursor 0.  active and cursor are written into copies.
// sent[p] counts the kept messages, fetched[p] the fetched edges.
//
// Bound: bytes.  The send buffers are filled once (8 bytes a slot: 131 MB
// in the WCC cells, 264 MB in SSSP), the [P, vs] planes are read and
// copied once, and only the selected vertices' edge windows are read:
// about 45 us a tick in WCC and 90 us in SSSP at 3.35 TB/s.  What the
// design does about it:
//   * Nothing is sorted.  The slot order (bucket, index) comes from a
//     per-block count of each bucket, a scan of those counts over the
//     blocks, and each vertex's rank among its bucket inside its block
//     (__match_any_sync a warp, a prefix over the warps).  The route rank
//     comes the same way from per-block counts of each destination shard.
//   * Six launches in one C call: count (copies the planes, counts the
//     buckets, fills the send buffers with 16-byte stores), scan the
//     buckets (target and threshold), place the selected vertices in their
//     slots, count the routes of each block of slots, scan them (sent,
//     fetched), write the kept messages and advance the cursors.  A route
//     block past the last selected slot exits at once.
//   * Scratch (a few MB: one byte a vertex for its bucket, the slots, the
//     per-block counts) comes from the caller's workspace; nothing of the
//     padded P x M x D size exists.
//
// C interface: engine_create_workspace_bytes sizes the workspace;
// engine_create_launch sets the given device current, launches the six
// kernels on the given stream and returns cudaGetLastError() as an int
// (0 = launched); cuda_error_string names an error.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NB = 32;           // priority buckets (engine.N_BUCKETS)
constexpr int INACTIVE = 255;    // the bucket byte of an inactive vertex
constexpr int VB = 1024;         // vertices a select block, one a thread
constexpr int SCAN = 1024;       // threads of a scan block
constexpr int RT = 256;          // threads of a route block
constexpr int RW = RT / 32;      // warps of a route block
constexpr int POS = 1024;        // message positions a route block covers
constexpr int MAX_PN = 512;      // destination shards the route takes
constexpr int META = 64;         // ints of per-shard results
constexpr unsigned FULL = 0xffffffffu;

enum Prio { DISABLED = 0, LINEAR = 1, LOG = 2 };
enum Combine { COPY = 0, FADD = 1, IADD1 = 2, FMIN = 3 };

// engine._LOG_BUCKET_EDGES: the smallest float32 x (as bits) in bucket >= k
__constant__ unsigned kLogEdges[NB - 1] = {
    0x2f7fffffu, 0x30400000u, 0x30dfffffu, 0x316fffffu, 0x31f7ffffu,
    0x327bfffdu, 0x32fdfffdu, 0x337efffdu, 0x33ff7ffdu, 0x347fbffdu,
    0x34ffdffdu, 0x357feff9u, 0x35fff802u, 0x367ffbf9u, 0x36fffe02u,
    0x377ffef9u, 0x37ffff71u, 0x387fffb9u, 0x38ffffd1u, 0x397fffe9u,
    0x39ffffe9u, 0x3a7ffff5u, 0x3affffefu, 0x3b7ffff0u, 0x3bfffff9u,
    0x3c800001u, 0x3d000005u, 0x3d7ffff1u, 0x3dfffff9u, 0x3e800001u,
    0x3f000005u};

struct Args {
  int P, vs, M, D, Pn, cap;
  long long es;      // edges a shard row (col_idx and weights)
  int is_float;      // values are float32 (else int32)
  int key_invert;    // priority key scale - pv (max, or) or pv (min)
  int prio, demote_by, combine;
  unsigned ident;    // the identity's 32 bits
  float scale, recip, rho;
  const unsigned* values;  // [P, vs], int32 or float32 bits
  const uint8_t* active;   // [P, vs] bool
  const int* cursor;       // [P, vs]
  const int* row_ptr;      // [P, vs + 1]
  const int* col_idx;      // [P, es]
  const float* weights;    // [P, es] or null
  const int* throttle;     // [P] or null
  const uint8_t* demote;   // [P, vs] bool or null
  const int* window;       // [P] or null
  uint8_t* active_out;
  int* cursor_out;
  unsigned* send_vals;     // [P, Pn, cap]
  int* send_ids;           // [P, Pn, cap]
  long long* counts;       // [2, P]: sent, fetched
  // workspace
  int* meta;    // [P, META]: target, threshold, selected; the buckets'
                // exclusive totals from META_CUM
  int* vhist;   // [P, nbv, NB] bucket counts a block, then their scan
  int* rhist;   // [P, nbm, Pn] route counts a block, then their scan
  int* sel;     // [P, M] the vertex in each slot
  uint8_t* bkt; // [P, vs] bucket of each active vertex, INACTIVE else
  int nbv, nbm, spb;
};

constexpr int META_TARGET = 0, META_THR = 1, META_NSEL = 2, META_CUM = 8;

__device__ __forceinline__ unsigned lanes_below() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// clamp as torch's: a NaN passes through
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return x != x ? x : fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ int bucket_of(const Args& a, long long at) {
  int b = 0;
  if (a.prio != DISABLED) {
    const unsigned bits = a.values[at];
    const float pv = a.is_float ? __uint_as_float(bits)
                                : __int2float_rn(static_cast<int>(bits));
    const float key = a.key_invert ? __fsub_rn(a.scale, pv) : pv;
    const float x = __fmul_rn(clampf(key, 0.0f, a.scale), a.recip);
    if (a.prio == LINEAR) {
      b = static_cast<int>(clampf(floorf(__fmul_rn(x, 32.0f)), 0.0f, 31.0f));
    } else {  // the edges at or below x
#pragma unroll
      for (int k = 0; k < NB - 1; ++k)
        b += __uint_as_float(kLogEdges[k]) <= x;
    }
  }
  if (a.demote && a.demote[at]) b = min(b + a.demote_by, NB - 1);
  return b;
}

// 1. copy the planes, bucket the active vertices and count each bucket;
// every block fills its share of the send buffers
__global__ void __launch_bounds__(VB) select_count(Args a) {
  __shared__ int hist[NB];
  const int p = blockIdx.y, t = threadIdx.x;
  if (t < NB) hist[t] = 0;
  __syncthreads();
  const int v = blockIdx.x * VB + t;
  int key = NB;
  if (v < a.vs) {
    const long long at = static_cast<long long>(p) * a.vs + v;
    const uint8_t act = a.active[at];
    a.active_out[at] = act;
    a.cursor_out[at] = a.cursor[at];
    if (act) key = bucket_of(a, at);
    a.bkt[at] = static_cast<uint8_t>(act ? key : INACTIVE);
  }
  const unsigned same = __match_any_sync(FULL, key);
  if (key < NB && (same & lanes_below()) == 0)
    atomicAdd(&hist[key], __popc(same));
  __syncthreads();
  if (t < NB)
    a.vhist[(static_cast<long long>(p) * a.nbv + blockIdx.x) * NB + t] =
        hist[t];

  const long long words = static_cast<long long>(a.P) * a.Pn * a.cap;
  const long long nvec = words / 4;
  const long long blocks = static_cast<long long>(gridDim.x) * gridDim.y;
  const long long blk = static_cast<long long>(blockIdx.y) * gridDim.x
                        + blockIdx.x;
  const long long chunk = (nvec + blocks - 1) / blocks;
  const long long end = min(nvec, (blk + 1) * chunk);
  const uint4 ident = make_uint4(a.ident, a.ident, a.ident, a.ident);
  const int4 none = make_int4(-1, -1, -1, -1);
  uint4* vals4 = reinterpret_cast<uint4*>(a.send_vals);
  int4* ids4 = reinterpret_cast<int4*>(a.send_ids);
  for (long long i = blk * chunk + t; i < end; i += VB) {
    vals4[i] = ident;
    ids4[i] = none;
  }
  if (blk == 0 && t < words - 4 * nvec) {
    a.send_vals[4 * nvec + t] = a.ident;
    a.send_ids[4 * nvec + t] = -1;
  }
}

// an exclusive scan of n ints at stride `step` by one warp, in place;
// returns their total
__device__ __forceinline__ int warp_scan(int* x, long long step, int n) {
  const int lane = threadIdx.x & 31;
  int run = 0;
  for (int c = 0; c < n; c += 32) {
    const int i = c + lane;
    const int mine = i < n ? x[i * step] : 0;
    int incl = mine;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += y;
    }
    if (i < n) x[i * step] = run + incl - mine;
    run += __shfl_sync(FULL, incl, 31);
  }
  return run;
}

// 2. per shard: scan each bucket's counts over the blocks; the target,
// the threshold bucket and the number of slots
__global__ void __launch_bounds__(SCAN) select_scan(Args a) {
  __shared__ int tot[NB];
  const int p = blockIdx.x, w = threadIdx.x / 32;
  const int sum = warp_scan(a.vhist + static_cast<long long>(p) * a.nbv * NB
                            + w, NB, a.nbv);
  if ((threadIdx.x & 31) == 0) tot[w] = sum;
  __syncthreads();
  if (threadIdx.x != 0) return;
  int n = 0;
  for (int b = 0; b < NB; ++b) n += tot[b];
  float tf = clampf(ceilf(__fmul_rn(__int2float_rn(n), a.rho)), 1.0f,
                    static_cast<float>(a.M));
  if (a.throttle)
    tf = fminf(tf, static_cast<float>(max(a.M / max(a.throttle[p], 1), 1)));
  const int target = static_cast<int>(tf);
  int* m = a.meta + p * META;
  int cum = 0, thr = NB;
  for (int b = 0; b < NB; ++b) {
    m[META_CUM + b] = cum;
    cum += tot[b];
    if (thr == NB && cum >= target) thr = b;
  }
  m[META_TARGET] = target;
  m[META_THR] = thr;
  m[META_NSEL] = min(target, n);
}

// 3. each selected vertex into its slot: the active vertices of lower
// buckets, then of its own bucket in earlier blocks, warps and lanes
__global__ void __launch_bounds__(VB) select_place(Args a) {
  __shared__ int wcnt[VB / 32][NB];
  __shared__ int base[NB];
  const int p = blockIdx.y, t = threadIdx.x, w = t >> 5;
  const int* m = a.meta + p * META;
  if (t < NB)
    base[t] = m[META_CUM + t]
              + a.vhist[(static_cast<long long>(p) * a.nbv + blockIdx.x) * NB
                        + t];
  (&wcnt[0][0])[t] = 0;
  const int target = m[META_TARGET], thr = m[META_THR];
  const int v = blockIdx.x * VB + t;
  const int b = v < a.vs ? a.bkt[static_cast<long long>(p) * a.vs + v]
                         : INACTIVE;
  const int key = b <= thr ? b : NB;  // thr <= NB < INACTIVE
  const unsigned same = __match_any_sync(FULL, key);
  const int rank = __popc(same & lanes_below());
  __syncthreads();
  if (key < NB && rank == 0) wcnt[w][key] = __popc(same);
  __syncthreads();
  if (t < NB) {
    int run = 0;
    for (int i = 0; i < VB / 32; ++i) {
      const int c = wcnt[i][t];
      wcnt[i][t] = run;
      run += c;
    }
  }
  __syncthreads();
  if (key < NB) {
    const int slot = base[key] + wcnt[w][key] + rank;
    if (slot < target) a.sel[static_cast<long long>(p) * a.M + slot] = v;
  }
}

// the slots [s0, s0 + ns) of shard p: vertex, first edge, edges to fetch
__device__ __forceinline__ void load_slots(const Args& a, int p, int s0,
                                           int ns, int* sv, int* se,
                                           int* snd) {
  const int win = a.window ? a.window[p] : a.D;
  const int* rp = a.row_ptr + static_cast<long long>(p) * (a.vs + 1);
  for (int i = threadIdx.x; i < ns; i += RT) {
    const int v = a.sel[static_cast<long long>(p) * a.M + s0 + i];
    const int lo = rp[v], deg = rp[v + 1] - lo;
    const int cur = a.cursor[static_cast<long long>(p) * a.vs + v];
    sv[i] = v;
    se[i] = lo + cur;
    snd[i] = max(min(min(a.D, deg - cur), win), 0);
  }
}

// the destination shard of position f of the block's slots, or -1
__device__ __forceinline__ int route_of(const Args& a, int p, int f,
                                        const int* se, const int* snd,
                                        int* dst) {
  const int i = f / a.D, d = f - i * a.D;
  if (d >= snd[i]) return -1;
  *dst = a.col_idx[static_cast<long long>(p) * a.es + se[i] + d];
  const int q = *dst >= 0 ? *dst / a.vs : -1;
  return q < a.Pn ? q : -1;
}

// 4. each block of slots: its messages to each destination shard
__global__ void __launch_bounds__(RT) route_count(Args a) {
  __shared__ int sv[POS], se[POS], snd[POS];
  __shared__ int cnt[MAX_PN];
  const int p = blockIdx.y, t = threadIdx.x;
  const int s0 = blockIdx.x * a.spb;
  const int nsel = a.meta[p * META + META_NSEL];
  if (s0 >= nsel) return;
  const int ns = min(a.spb, nsel - s0);
  load_slots(a, p, s0, ns, sv, se, snd);
  for (int q = t; q < a.Pn; q += RT) cnt[q] = 0;
  __syncthreads();
  const int total = ns * a.D;
  for (int f = t; f < total; f += RT) {
    int dst;
    const int q = route_of(a, p, f, se, snd, &dst);
    if (q >= 0) atomicAdd(&cnt[q], 1);
  }
  __syncthreads();
  for (int q = t; q < a.Pn; q += RT)
    a.rhist[(static_cast<long long>(p) * a.nbm + blockIdx.x) * a.Pn + q] =
        cnt[q];
}

// 5. per shard: scan each destination's counts over the live blocks;
// sent and fetched
__global__ void __launch_bounds__(SCAN) route_scan(Args a) {
  __shared__ unsigned long long sums[2];
  const int p = blockIdx.x, w = threadIdx.x / 32, lane = threadIdx.x & 31;
  if (threadIdx.x < 2) sums[threadIdx.x] = 0;
  __syncthreads();
  const int nsel = a.meta[p * META + META_NSEL];
  const int live = (nsel + a.spb - 1) / a.spb;
  for (int q = w; q < a.Pn; q += SCAN / 32) {
    const int n = warp_scan(a.rhist + static_cast<long long>(p) * a.nbm * a.Pn
                            + q, a.Pn, live);
    if (lane == 0) {
      atomicAdd(&sums[0], static_cast<unsigned long long>(min(n, a.cap)));
      atomicAdd(&sums[1], static_cast<unsigned long long>(n));
    }
  }
  __syncthreads();
  if (threadIdx.x < 2)
    a.counts[threadIdx.x * a.P + p] = static_cast<long long>(sums[threadIdx.x]);
}

__device__ __forceinline__ unsigned combine(const Args& a, unsigned v,
                                            long long e) {
  if (a.combine == COPY) return v;
  if (a.combine == IADD1) return v + 1u;  // int32 wraps, as torch's add
  const float x = __uint_as_float(v);
  const float w = a.weights ? a.weights[e] : 1.0f;
  if (a.combine == FADD) return __float_as_uint(__fadd_rn(x, w));
  // FMIN: torch.minimum and clamp(max=1.0) both pass a NaN on
  return __float_as_uint(x != x ? x : w != w ? w : fminf(x, w));
}

// 6. each block of slots: its messages' ranks (the block's scanned base,
// earlier chunks, earlier warps, earlier lanes), the kept ones written,
// then each slot's cursor and activity from its first dropped edge
__global__ void __launch_bounds__(RT) route_write(Args a) {
  __shared__ int sv[POS], se[POS], snd[POS], sfd[POS];
  __shared__ unsigned sval[POS];
  __shared__ int base[MAX_PN], ctot[MAX_PN], wcnt[RW][MAX_PN];
  const int p = blockIdx.y, t = threadIdx.x, w = t >> 5;
  const int s0 = blockIdx.x * a.spb;
  const int nsel = a.meta[p * META + META_NSEL];
  if (s0 >= nsel) return;
  const int ns = min(a.spb, nsel - s0);
  load_slots(a, p, s0, ns, sv, se, snd);
  for (int i = t; i < ns; i += RT) {
    sval[i] = a.values[static_cast<long long>(p) * a.vs + sv[i]];
    sfd[i] = a.D;
  }
  for (int q = t; q < a.Pn; q += RT) {
    base[q] = a.rhist[(static_cast<long long>(p) * a.nbm + blockIdx.x) * a.Pn
                      + q];
    for (int k = 0; k < RW; ++k) wcnt[k][q] = 0;
  }
  __syncthreads();
  const long long row = static_cast<long long>(p) * a.Pn;
  const int total = ns * a.D;
  for (int c0 = 0; c0 < total; c0 += RT) {
    const int f = c0 + t;
    int dst = 0;
    const int q = f < total ? route_of(a, p, f, se, snd, &dst) : -1;
    const int key = q >= 0 ? q : a.Pn;
    const unsigned same = __match_any_sync(FULL, key);
    const int rank = __popc(same & lanes_below());
    if (q >= 0 && rank == 0) wcnt[w][q] = __popc(same);
    __syncthreads();
    for (int k = t; k < a.Pn; k += RT) {
      int run = 0;
      for (int j = 0; j < RW; ++j) {
        const int c = wcnt[j][k];
        wcnt[j][k] = run;
        run += c;
      }
      ctot[k] = run;
    }
    __syncthreads();
    if (q >= 0) {
      const int i = f / a.D, d = f - i * a.D;
      const int r = base[q] + wcnt[w][q] + rank;
      if (r < a.cap) {
        const long long at = (row + q) * a.cap + r;
        a.send_vals[at] = combine(a, sval[i], static_cast<long long>(p) * a.es
                                                  + se[i] + d);
        a.send_ids[at] = dst - q * a.vs;
      } else {
        atomicMin(&sfd[i], d);
      }
    }
    __syncthreads();
    for (int k = t; k < a.Pn; k += RT) {
      base[k] += ctot[k];
      for (int j = 0; j < RW; ++j) wcnt[j][k] = 0;
    }
    __syncthreads();
  }
  const int win = a.window ? a.window[p] : a.D;
  const int* rp = a.row_ptr + static_cast<long long>(p) * (a.vs + 1);
  for (int i = t; i < ns; i += RT) {
    const int v = sv[i];
    const long long at = static_cast<long long>(p) * a.vs + v;
    const int cur = a.cursor[at], deg = rp[v + 1] - rp[v];
    const int nxt = cur + min(min(sfd[i], win), deg - cur);
    const bool done = nxt >= deg;
    a.cursor_out[at] = done ? 0 : nxt;
    a.active_out[at] = done ? 0 : 1;
  }
}

long long align_up(long long x) { return (x + 255) & ~255LL; }

struct Layout {
  int nbv, nbm, spb;
  long long meta, vhist, rhist, sel, bkt, total;  // byte offsets
};

Layout layout(int P, int vs, int M, int D, int Pn) {
  Layout l;
  l.nbv = (vs + VB - 1) / VB;
  l.spb = D >= POS ? 1 : POS / D;
  l.nbm = (M + l.spb - 1) / l.spb;
  const long long p = P;
  l.meta = 0;
  l.vhist = align_up(l.meta + p * META * 4);
  l.rhist = align_up(l.vhist + p * l.nbv * NB * 4);
  l.sel = align_up(l.rhist + p * l.nbm * Pn * 4);
  l.bkt = align_up(l.sel + p * M * 4);
  l.total = align_up(l.bkt + p * vs);
  return l;
}

bool aligned16(const void* x) {
  return (reinterpret_cast<uintptr_t>(x) & 15) == 0;
}

}  // namespace

// the workspace engine_create_launch needs, in bytes (-1: bad sizes)
extern "C" long long engine_create_workspace_bytes(int P, int vs, int M,
                                                   int D, int Pn) {
  if (P <= 0 || vs <= 0 || M <= 0 || D <= 0 || Pn <= 0) return -1;
  return layout(P, vs, M, D, Pn).total;
}

// ints: P, vs, M, D, Pn, cap, es, is_float, key_invert, prio (0 disabled,
// 1 linear, 2 log), demote_by, combine (0 copy, 1 float add, 2 int add 1,
// 3 float min), identity bits.  floats: scale, recip, rho.  ptrs: values,
// active, cursor, row_ptr, col_idx, weights, throttle, demote, window,
// active_out, cursor_out, send_vals, send_ids, counts, workspace
// (kernels/create.py; weights, throttle, demote and window may be null).
extern "C" int engine_create_launch(int device, const long long* ints,
                                    const float* floats, void* const* ptrs,
                                    long long workspace_bytes, void* stream) {
  Args a;
  a.P = static_cast<int>(ints[0]);
  a.vs = static_cast<int>(ints[1]);
  a.M = static_cast<int>(ints[2]);
  a.D = static_cast<int>(ints[3]);
  a.Pn = static_cast<int>(ints[4]);
  a.cap = static_cast<int>(ints[5]);
  a.es = ints[6];
  a.is_float = static_cast<int>(ints[7]);
  a.key_invert = static_cast<int>(ints[8]);
  a.prio = static_cast<int>(ints[9]);
  a.demote_by = static_cast<int>(ints[10]);
  a.combine = static_cast<int>(ints[11]);
  a.ident = static_cast<unsigned>(ints[12]);
  a.scale = floats[0];
  a.recip = floats[1];
  a.rho = floats[2];
  a.values = static_cast<const unsigned*>(ptrs[0]);
  a.active = static_cast<const uint8_t*>(ptrs[1]);
  a.cursor = static_cast<const int*>(ptrs[2]);
  a.row_ptr = static_cast<const int*>(ptrs[3]);
  a.col_idx = static_cast<const int*>(ptrs[4]);
  a.weights = static_cast<const float*>(ptrs[5]);
  a.throttle = static_cast<const int*>(ptrs[6]);
  a.demote = static_cast<const uint8_t*>(ptrs[7]);
  a.window = static_cast<const int*>(ptrs[8]);
  a.active_out = static_cast<uint8_t*>(ptrs[9]);
  a.cursor_out = static_cast<int*>(ptrs[10]);
  a.send_vals = static_cast<unsigned*>(ptrs[11]);
  a.send_ids = static_cast<int*>(ptrs[12]);
  a.counts = static_cast<long long*>(ptrs[13]);
  char* ws = static_cast<char*>(ptrs[14]);
  if (a.P <= 0 || a.P > 65535 || a.vs <= 0 || a.M <= 0 || a.D <= 0
      || a.Pn <= 0 || a.Pn > MAX_PN || a.cap <= 0 || a.es < 0
      || a.prio < DISABLED || a.prio > LOG || a.combine < COPY
      || a.combine > FMIN || !aligned16(a.send_vals)
      || !aligned16(a.send_ids) || !aligned16(ws))
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout l = layout(a.P, a.vs, a.M, a.D, a.Pn);
  if (workspace_bytes < l.total)
    return static_cast<int>(cudaErrorInvalidValue);
  a.meta = reinterpret_cast<int*>(ws + l.meta);
  a.vhist = reinterpret_cast<int*>(ws + l.vhist);
  a.rhist = reinterpret_cast<int*>(ws + l.rhist);
  a.sel = reinterpret_cast<int*>(ws + l.sel);
  a.bkt = reinterpret_cast<uint8_t*>(ws + l.bkt);
  a.nbv = l.nbv;
  a.nbm = l.nbm;
  a.spb = l.spb;
  // this library's runtime keeps its own current device: set it to the
  // stream's, so the launches land in that device's (primary) context
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 vgrid(static_cast<unsigned>(l.nbv), static_cast<unsigned>(a.P));
  const dim3 rgrid(static_cast<unsigned>(l.nbm), static_cast<unsigned>(a.P));
  select_count<<<vgrid, VB, 0, s>>>(a);
  select_scan<<<a.P, SCAN, 0, s>>>(a);
  select_place<<<vgrid, VB, 0, s>>>(a);
  route_count<<<rgrid, RT, 0, s>>>(a);
  route_scan<<<a.P, SCAN, 0, s>>>(a);
  route_write<<<rgrid, RT, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
