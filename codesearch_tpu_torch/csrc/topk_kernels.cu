// Exact top-k selection kernels for Hopper (sm_90a), bound to Python via ctypes.
//
// Replaces the three Pallas kernels of codesearch_tpu/ops/pallas_topk.py:
//   cs_cosine_topk_bf16  <- fused_cosine_topk       (_fused_kernel)         kernel a
//   cs_cosine_topk_int8  <- fused_cosine_topk_int8  (_fused_kernel_int8)    kernel b
//   cs_scores_topk       <- fused_scores_topk       (_fused_kernel_scores)  kernel c
//
// What bounds them on an H100: the two cosine kernels read the whole corpus
// matrix once per query group (N*d bytes: 201 MB for bf16 and 101 MB for
// int8 at N=262,144, d=384), so they are bound by device-memory bandwidth
// (3.35 TB/s), not by arithmetic: a [9,384]x[384,N] product is ~1.8 GFLOP.
// The scores kernel reads B*N*4 bytes of precomputed scores (1 MB a row,
// 0.3 us at the memory rate), so what it costs is its launches and the
// latency of its passes, not bytes.
//
// Exactness and tie order: a selection key packs the score into the high 32
// bits (order-preserving bit transform) and the complemented column index
// into the low 32 bits, so one unsigned 64-bit descending order is "score
// desc, then index asc" -- the lowest index wins a tie, as XLA top_k and the
// Pallas kernels do. Every key is unique. Key 0 is below every real key and
// pads ragged blocks. Invalid rows and dead slots score -3e38, as in the
// Pallas kernels.
//
// The TPU kernels kept ONE running top-k in VMEM because their grid runs
// tiles in order on one core. Hopper blocks run in parallel and in no order,
// so selection is spread over CTAs in passes:
//
// a, b: pass 1. Every CTA owns a contiguous range of `rows` corpus rows. For
//   a group of up to kQueryGroup queries it computes each score in the kernel
//   body (the corpus rows are read ONCE for the whole group, each warp
//   streaming whole rows with 16-byte loads), applies the validity mask, sorts
//   the block's keys in shared memory (bitonic) and writes its top-kp partial
//   list, kp = min(k, rows): for k >= rows every key of the block.
//   Pass 2 for k <= kMergeMaxK: merge_topk, one CTA per query (or per group of
//   lists, then once more) streams the partial lists and keeps the exact top-k
//   in a shared-memory buffer of 4,096 or 8,192 keys. Pass 2 above
//   kMergeMaxK: the radix select below, over the partial lists as key arrays.
//
// c, and a/b above kMergeMaxK: an exact radix select (select_*), which no
//   shared-memory buffer bounds: any 1 <= k <= n. Its passes over a row of m
//   keys (c: computed on the fly from scores, slot_meta and boost_kid; a/b:
//   the partial lists) run as a fixed sequence of five launches, spread over
//   ceil(m / 1024) CTAs a row, with every decision taken on the device:
//   - select_hist<0..2>: each CTA builds a shared-memory histogram of one
//     digit of its keys' score bits (bits 31-20, 19-8, 7-0 of the 32-bit
//     order-preserving score), levels 1 and 2 only over keys whose higher
//     digits match the prefix chosen so far, and adds it to the row's global
//     histogram with atomics. Lanes of a warp with the same digit add once
//     (__match_any_sync): a row where a third of the scores are exactly 0.0
//     sends them all to one bin. The last CTA of the row to finish (a ticket
//     counter after a fence) scans the global histogram, picks the bin that
//     holds the k-th key and writes the new prefix and the count still needed
//     in it. After level 2 the prefix is the k-th key's score T exactly, and
//     `need` keys of score T are still to take; level 2's CTAs also keep their
//     own 256-bin counts, from which that last CTA writes each CTA's count of
//     score-T keys before it (ties are then taken in index order).
//   - select_collect: every key above T is a winner, written at a slot of the
//     row's output reserved with one atomic per CTA; a key equal to T is a
//     winner if its rank among the score-T keys in index order (its CTA's
//     offset plus a block scan) is below `need`, written after the others in
//     that order. Heavy ties (10^5 equal zeros) cost one bin, no sorting.
//   - select_sort (k <= kSortMax): one CTA bitonic-sorts the winners above T
//     in shared memory (128 KB at 16,384 keys) and writes values and indices;
//     the score-T winners are in order already. select_rank (larger k): each
//     winner's rank is the number of winners above it (O(k^2) compares,
//     spread over k / 128 CTAs of 1,024 threads), for the rare --limit in
//     the thousands.
//
// Every kernel launches on the caller's stream and allocates nothing (the
// caller passes the scratch, the select's histograms zeroed); every entry
// point returns the CUDA error of its launches (0 on success, negative for a
// bad argument). cs_init sets the kernels' shared-memory limits once, when
// the library is loaded.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef unsigned long long u64;

namespace {

constexpr float kNegInf = -3.0e38f;
constexpr int kMergeMaxK = 4096;  // largest k merge_topk takes (a and b only)
constexpr int kQueryGroup = 16;
constexpr int kPass1Threads = 256;
constexpr int kMergeThreads = 1024;
constexpr int kMergeSlots = 4096;  // smallest merge buffer (keys)
// radix select
constexpr int kSelThreads = 256;
constexpr int kSelItems = 4;                        // contiguous keys a thread
constexpr int kSelChunk = kSelThreads * kSelItems;  // keys a CTA
constexpr int kBinsHi = 4096;                       // levels 0 and 1: 12-bit digits
constexpr int kBinsLo = 256;                        // level 2: 8-bit digit
// zero-initialised ints a row: hist0, hist1, hist2, then 4 counters (the
// per-level tickets of the last-CTA decision and the winners' fill count)
constexpr int kZeroInts = 2 * kBinsHi + kBinsLo + 8;
constexpr int kStateInts = 16;  // a row: {prefix, need, above, -} after each level
constexpr int kSortMax = 16384;
constexpr int kSortThreads = 1024;
constexpr int kRankWinners = 128;  // winners a CTA of select_rank
constexpr int kRankParts = 8;      // threads counting for each winner
constexpr int kRankThreads = kRankWinners * kRankParts;
constexpr int kRankTile = 2048;

constexpr int kErrBadArg = -1;

__device__ __forceinline__ uint32_t ord_of(float f) {
  f = f + 0.0f;  // -0 becomes +0, so the two zeros tie as they compare equal
  uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float float_of(uint32_t o) {
  uint32_t u = (o & 0x80000000u) ? (o & 0x7FFFFFFFu) : ~o;
  return __uint_as_float(u);
}

__device__ __forceinline__ u64 make_key(float s, int row) {
  return ((u64)ord_of(s) << 32) | (u64)(~(uint32_t)row);
}

// Bitonic sort, descending, of nseg consecutive segments of len keys each
// (len a power of two) in shared memory. All segments advance through the
// same stages, so a stage costs one barrier however many segments there are.
// The caller synchronises before the call; the sort ends synchronised.
__device__ void block_sort_desc(u64* k, int len, int nseg = 1) {
  const int half = len >> 1;
  for (int size = 2; size <= len; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < nseg * half; t += blockDim.x) {
        const int seg = t / half, i = t - seg * half;
        const int lo = 2 * i - (i & (stride - 1));
        u64* base = k + seg * len;
        const u64 a = base[lo];
        const u64 b = base[lo + stride];
        const bool desc = (lo & size) == 0;
        if ((a < b) == desc) {
          base[lo] = b;
          base[lo + stride] = a;
        }
      }
      __syncthreads();
    }
  }
}

// Writes the first kp keys of each of the block's nlists sorted lists.
__device__ void write_partials(const u64* keys, int rows, int nlists, int list0,
                               int kp, u64* part) {
  for (int j = 0; j < nlists; ++j) {
    u64* dst = part + ((size_t)(list0 + j) * gridDim.x + blockIdx.x) * kp;
    for (int i = threadIdx.x; i < kp; i += blockDim.x) dst[i] = keys[j * rows + i];
  }
}

// Sums QG per-lane partial values across the warp with QG - 1 + (5 - log2 QG)
// shuffles (a halving butterfly, instead of 5 per value): afterwards every
// lane whose id has its low (5 - log2 QG) bits clear holds in v[0] the total
// of query slot lane >> (5 - log2 QG). The order of the sums is fixed.
template <int QG, typename T>
__device__ __forceinline__ void warp_reduce_slots(T (&v)[QG], int lane) {
#pragma unroll
  for (int step = 0; step < 5; ++step) {
    const int o = 16 >> step;
    const int c = QG >> step;  // values a lane still holds before this step
    if (c > 1) {
      const bool hi = (lane & o) != 0;
#pragma unroll
      for (int i = 0; i < c / 2; ++i) {
        const T send = hi ? v[i] : v[i + c / 2];
        const T keep = hi ? v[i + c / 2] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
      }
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], o);
    }
  }
}

template <int QG>
__device__ __forceinline__ int slot_shift() {
  return QG == 1 ? 5 : QG == 2 ? 4 : QG == 4 ? 3 : QG == 8 ? 2 : 1;
}

constexpr int kRowsPerStep = 2;  // corpus rows a warp scores at once

// ---- pass 1: bf16 cosine scores (q . c, bf16 inputs, f32 accumulation) ----
// Shared memory: keys [QG][rows], then the group's queries as f32, laid out
// [query][half][vector] in float4 so that lane v reads its 16 bytes next to
// lane v+1's (no bank conflicts); unused query slots hold zeros.
template <int QG>
__global__ void __launch_bounds__(kPass1Threads, 2)
cosine_partial_bf16(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ c,
                    const uint8_t* __restrict__ valid, int nq, int n, int d,
                    int rows, int kp, u64* __restrict__ part) {
  extern __shared__ __align__(16) unsigned char smem[];
  u64* keys = reinterpret_cast<u64*>(smem);
  float4* qf = reinterpret_cast<float4*>(keys + QG * rows);
  const int nvec = d >> 3;  // 8 bf16 values per 16-byte load
  const int q0 = blockIdx.y * QG;
  const int qn = min(QG, nq - q0);
  const int r0 = blockIdx.x * rows;
  for (int i = threadIdx.x; i < QG * 2 * nvec; i += blockDim.x) {
    const int j = i / (2 * nvec), h = (i / nvec) & 1, v = i % nvec;
    float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
    if (j < qn) {
      const __nv_bfloat16* src = q + (size_t)(q0 + j) * d + v * 8 + h * 4;
      f = make_float4(__bfloat162float(src[0]), __bfloat162float(src[1]),
                      __bfloat162float(src[2]), __bfloat162float(src[3]));
    }
    qf[i] = f;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int step = (blockDim.x >> 5) * kRowsPerStep;
  for (int r = warp * kRowsPerStep; r < rows; r += step) {
    float acc[kRowsPerStep][QG];
#pragma unroll
    for (int rr = 0; rr < kRowsPerStep; ++rr)
#pragma unroll
      for (int j = 0; j < QG; ++j) acc[rr][j] = 0.0f;
    for (int v = lane; v < nvec; v += 32) {
      float cv[kRowsPerStep][8];
#pragma unroll
      for (int rr = 0; rr < kRowsPerStep; ++rr) {
        const int row = r0 + r + rr;
        uint4 raw = make_uint4(0u, 0u, 0u, 0u);
        if (row < n) raw = __ldg(reinterpret_cast<const uint4*>(c + (size_t)row * d) + v);
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const float2 f = __bfloat1622float2(h[t]);
          cv[rr][2 * t] = f.x;
          cv[rr][2 * t + 1] = f.y;
        }
      }
#pragma unroll
      for (int j = 0; j < QG; ++j) {
        const float4 a = qf[(2 * j) * nvec + v];
        const float4 b = qf[(2 * j + 1) * nvec + v];
#pragma unroll
        for (int rr = 0; rr < kRowsPerStep; ++rr) {
          float s = acc[rr][j];
          s = fmaf(cv[rr][0], a.x, s);
          s = fmaf(cv[rr][1], a.y, s);
          s = fmaf(cv[rr][2], a.z, s);
          s = fmaf(cv[rr][3], a.w, s);
          s = fmaf(cv[rr][4], b.x, s);
          s = fmaf(cv[rr][5], b.y, s);
          s = fmaf(cv[rr][6], b.z, s);
          s = fmaf(cv[rr][7], b.w, s);
          acc[rr][j] = s;
        }
      }
    }
#pragma unroll
    for (int rr = 0; rr < kRowsPerStep; ++rr) {
      warp_reduce_slots<QG>(acc[rr], lane);
      const int j = lane >> slot_shift<QG>();
      const int row = r0 + r + rr;
      if ((lane & ((1 << slot_shift<QG>()) - 1)) == 0 && j < qn && r + rr < rows) {
        const bool ok = row < n;
        keys[j * rows + r + rr] = ok ? make_key(valid[row] ? acc[rr][0] : kNegInf, row) : 0ull;
      }
    }
  }
  __syncthreads();
  block_sort_desc(keys, rows, qn);
  write_partials(keys, rows, qn, q0, kp, part);
}

// ---- pass 1: int8 cosine scores (int8 x int8 -> int32, f32 rescale) -------
// Shared memory: keys [QG][rows], then the group's int8 queries [QG][d]
// (lane v reads 16 contiguous bytes next to lane v+1's).
template <int QG>
__global__ void __launch_bounds__(kPass1Threads, 2)
cosine_partial_int8(const int8_t* __restrict__ q, const float* __restrict__ q_scale,
                    const int8_t* __restrict__ c, const float* __restrict__ row_scale,
                    const uint8_t* __restrict__ valid, int nq, int n, int d,
                    int rows, int kp, u64* __restrict__ part) {
  extern __shared__ __align__(16) unsigned char smem[];
  u64* keys = reinterpret_cast<u64*>(smem);
  int8_t* qs = reinterpret_cast<int8_t*>(keys + QG * rows);
  const int nvec = d >> 4;  // 16 int8 values per 16-byte load
  const int q0 = blockIdx.y * QG;
  const int qn = min(QG, nq - q0);
  const int r0 = blockIdx.x * rows;
  for (int i = threadIdx.x; i < QG * d; i += blockDim.x)
    qs[i] = i < qn * d ? q[(size_t)q0 * d + i] : (int8_t)0;
  __syncthreads();
  const int4* qv = reinterpret_cast<const int4*>(qs);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int step = (blockDim.x >> 5) * kRowsPerStep;
  for (int r = warp * kRowsPerStep; r < rows; r += step) {
    int acc[kRowsPerStep][QG];
#pragma unroll
    for (int rr = 0; rr < kRowsPerStep; ++rr)
#pragma unroll
      for (int j = 0; j < QG; ++j) acc[rr][j] = 0;
    for (int v = lane; v < nvec; v += 32) {
      int4 cw[kRowsPerStep];
#pragma unroll
      for (int rr = 0; rr < kRowsPerStep; ++rr) {
        const int row = r0 + r + rr;
        cw[rr] = make_int4(0, 0, 0, 0);
        if (row < n) cw[rr] = __ldg(reinterpret_cast<const int4*>(c + (size_t)row * d) + v);
      }
#pragma unroll
      for (int j = 0; j < QG; ++j) {
        const int4 a = qv[j * nvec + v];
#pragma unroll
        for (int rr = 0; rr < kRowsPerStep; ++rr) {
          int s = acc[rr][j];
          s = __dp4a(cw[rr].x, a.x, s);
          s = __dp4a(cw[rr].y, a.y, s);
          s = __dp4a(cw[rr].z, a.z, s);
          s = __dp4a(cw[rr].w, a.w, s);
          acc[rr][j] = s;
        }
      }
    }
#pragma unroll
    for (int rr = 0; rr < kRowsPerStep; ++rr) {
      warp_reduce_slots<QG>(acc[rr], lane);
      const int j = lane >> slot_shift<QG>();
      const int row = r0 + r + rr;
      if ((lane & ((1 << slot_shift<QG>()) - 1)) == 0 && j < qn && r + rr < rows) {
        u64 key = 0ull;
        if (row < n) {
          // (s * q_scale) * row_scale, the order of _fused_kernel_int8
          const float s = __fmul_rn(__fmul_rn((float)acc[rr][0], q_scale[q0 + j]), row_scale[row]);
          key = make_key(valid[row] ? s : kNegInf, row);
        }
        keys[j * rows + r + rr] = key;
      }
    }
  }
  __syncthreads();
  block_sort_desc(keys, rows, qn);
  write_partials(keys, rows, qn, q0, kp, part);
}

// ---- pass 2: exact top-k of a group of sorted partial lists ---------------
// CTA b merges lists [g * per_group, (g + 1) * per_group) of query q, where
// q = b / groups and g = b % groups; each list holds kp keys. The result is
// written as keys (out_keys, for a further merge) or as (vals, idx).
// Shared memory: SLOTS keys (SLOTS >= kpad + kMergeThreads): the running
// top-kpad, then room for the survivors of a few candidate rounds. SLOTS is
// a template argument so that the sort's index arithmetic folds to shifts.
template <int SLOTS>
__global__ void __launch_bounds__(kMergeThreads)
merge_topk(const u64* __restrict__ part, int n_lists, int kp, int per_group, int groups,
           int k, int kpad, u64* __restrict__ out_keys, float* __restrict__ vals,
           int* __restrict__ idx) {
  extern __shared__ __align__(16) unsigned char smem[];
  u64* keys = reinterpret_cast<u64*>(smem);
  __shared__ int fill;
  __shared__ u64 thr;
  const int q = blockIdx.x / groups, g = blockIdx.x % groups;
  const int l0 = g * per_group;
  const int l1 = min(n_lists, l0 + per_group);
  const u64* cand = part + ((size_t)q * n_lists + l0) * kp;
  const int total = (l1 - l0) * kp;
  const int chunk = SLOTS - kpad;
  for (int i = threadIdx.x; i < SLOTS; i += blockDim.x) keys[i] = 0ull;
  if (threadIdx.x == 0) {
    fill = 0;
    thr = 0ull;
  }
  __syncthreads();
  for (int base = 0; base < total; base += blockDim.x) {
    const int i = base + threadIdx.x;
    if (i < total) {
      const u64 key = cand[i];
      if (key > thr) keys[kpad + atomicAdd(&fill, 1)] = key;
    }
    __syncthreads();
    const int f = fill;
    const bool last = base + (int)blockDim.x >= total;
    __syncthreads();  // every thread has read fill before it changes
    if (f > chunk - (int)blockDim.x || (last && f > 0)) {
      for (int j = kpad + f + threadIdx.x; j < SLOTS; j += blockDim.x) keys[j] = 0ull;
      __syncthreads();
      block_sort_desc(keys, SLOTS);
      if (threadIdx.x == 0) {
        fill = 0;
        thr = keys[k - 1];
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    const u64 key = keys[i];
    const size_t o = (size_t)blockIdx.x * k + i;
    if (out_keys != nullptr) {
      out_keys[o] = key;
    } else {
      vals[o] = float_of((uint32_t)(key >> 32));
      idx[o] = (int)(~(uint32_t)key);
    }
  }
}

// ---- the radix select -------------------------------------------------------
// Where its scratch lies. Row b's zeroed ints start at zero + b * kZeroInts:
// hist0 [kBinsHi], hist1 [kBinsHi], hist2 [kBinsLo], then tickets[3] and
// fill; state [nq][kStateInts] (slot L = 4 ints written after level L);
// tie_off [nq][nblk]; cnt [nq][nblk][kBinsLo]; win [nq][k] keys.
struct Select {
  int* zero;
  int* state;
  int* tie_off;
  int* cnt;
  u64* win;
  int nblk;
  __device__ int* hist(int b, int level) const {
    return zero + (size_t)b * kZeroInts + level * kBinsHi;
  }
  __device__ int* counters(int b) const { return zero + (size_t)b * kZeroInts + 2 * kBinsHi + kBinsLo; }
  __device__ int* slot(int b, int level) const { return state + b * kStateInts + 4 * level; }
};

size_t select_ints(int nq, int m) {
  const size_t nblk = (m + kSelChunk - 1) / kSelChunk;
  return (size_t)nq * kStateInts + (size_t)nq * nblk * (1 + kBinsLo);
}

// u64 entries of the select's scratch that need no initialisation.
size_t select_entries(int nq, int m, int k) {
  return (size_t)nq * k + (select_ints(nq, m) + 1) / 2;
}

Select select_at(u64* scratch, int* zero, int nq, int m, int k) {
  Select sel;
  sel.zero = zero;
  sel.win = scratch;
  sel.state = reinterpret_cast<int*>(scratch + (size_t)nq * k);
  sel.nblk = (m + kSelChunk - 1) / kSelChunk;
  sel.tie_off = sel.state + (size_t)nq * kStateInts;
  sel.cnt = sel.tie_off + (size_t)nq * sel.nblk;
  return sel;
}

// Keys of c, computed on the fly: score x3 where the slot's kind is the
// row's boost kind, -3e38 for a dead slot.
struct ScoreKeys {
  const float* scores;
  const int* meta;
  const int* kid;
  int n;
  int dead;
  struct Row {
    const float* s;
    const int* meta;
    int kid;
    int dead;
    __device__ __forceinline__ u64 operator()(int i) const {
      const int m = meta[i];
      const float v = __fmul_rn(s[i], m == kid ? 3.0f : 1.0f);
      return make_key(m == dead ? kNegInf : v, i);
    }
  };
  __device__ Row row(int b) const { return Row{scores + (size_t)b * n, meta, kid[b], dead}; }
};

// Keys of a and b above kMergeMaxK: the partial lists, m keys a query. A
// list is sorted and lists follow their rows, so keys of one score come in
// index order, as the select takes ties.
struct ListKeys {
  const u64* keys;
  int m;
  struct Row {
    const u64* k;
    __device__ __forceinline__ u64 operator()(int i) const { return k[i]; }
  };
  __device__ Row row(int b) const { return Row{keys + (size_t)b * m}; }
};

// Exclusive prefix sum of v over the block's threads in order, and the
// total; every thread calls it (blockDim a multiple of 32, at most 1024).
__device__ int block_excl_scan(int v, int* total) {
  __shared__ int ws[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) ws[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nw ? ws[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    ws[lane] = w;
  }
  __syncthreads();
  const int out = x - v + (warp > 0 ? ws[warp - 1] : 0);
  *total = ws[nw - 1];
  __syncthreads();  // ws is free for the next call
  return out;
}

// The bin of a global histogram that holds the kk-th key from the top:
// bin t with (keys in bins above t) < kk <= (keys in bins t and above).
// Returns t and sets *above to the keys in the bins above it.
template <int NB>
__device__ int find_bin(const int* h, int kk, int* above) {
  constexpr int kPer = NB / kSelThreads;
  __shared__ int found_bin, found_above;
  const int hi = NB - threadIdx.x * kPer;  // the thread's bins [hi - kPer, hi), top first
  int c[kPer], sum = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    c[j] = __ldcg(h + hi - 1 - j);
    sum += c[j];
  }
  int total;
  int s = block_excl_scan(sum, &total);
  if (s < kk && kk <= s + sum) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (s + c[j] >= kk) {
        found_bin = hi - 1 - j;
        found_above = s;
        break;
      }
      s += c[j];
    }
  }
  __syncthreads();
  *above = found_above;
  return found_bin;
}

// Level LEVEL of the select: the histogram of one digit of the score bits
// over the keys that match the prefix of the levels before, then the last
// CTA of the row picks the digit of the k-th key.
template <class Src, int LEVEL>
__global__ void __launch_bounds__(kSelThreads)
select_hist(Src src, int m, int k, Select sel) {
  constexpr int NB = LEVEL == 2 ? kBinsLo : kBinsHi;
  constexpr int kShift = LEVEL == 0 ? 20 : LEVEL == 1 ? 8 : 0;
  constexpr int kBits = LEVEL == 2 ? 8 : 12;
  __shared__ int h[NB];
  __shared__ bool last;
  const int b = blockIdx.y;
  for (int i = threadIdx.x; i < NB; i += kSelThreads) h[i] = 0;
  uint32_t prefix = 0u;  // the digits the levels before chose
  if constexpr (LEVEL > 0) prefix = (uint32_t)sel.slot(b, LEVEL - 1)[0];
  __syncthreads();
  const auto row = src.row(b);
  const int i0 = blockIdx.x * kSelChunk + threadIdx.x;
#pragma unroll
  for (int j = 0; j < kSelItems; ++j) {
    const int i = i0 + j * kSelThreads;
    int digit = -1;
    if (i < m) {
      const uint32_t o = (uint32_t)(row(i) >> 32);
      if (LEVEL == 0 || (o >> (kShift + kBits)) == prefix) digit = (int)((o >> kShift) & (NB - 1));
    }
    const unsigned peers = __match_any_sync(0xffffffffu, digit);
    if (digit >= 0 && (int)(threadIdx.x & 31) == __ffs(peers) - 1)
      atomicAdd(&h[digit], __popc(peers));
  }
  __syncthreads();
  int* gh = sel.hist(b, LEVEL);
  for (int i = threadIdx.x; i < NB; i += kSelThreads) {
    const int c = h[i];
    if (c) atomicAdd(gh + i, c);
    if (LEVEL == 2) sel.cnt[((size_t)b * sel.nblk + blockIdx.x) * kBinsLo + i] = c;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(sel.counters(b) + LEVEL, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // this CTA is the row's last: every other CTA's histogram is in gh
  int kk = k;  // keys still to take within the prefix
  if constexpr (LEVEL > 0) kk = sel.slot(b, LEVEL - 1)[1];
  int above;
  const int t = find_bin<NB>(gh, kk, &above);
  const uint32_t next = (prefix << kBits) | (uint32_t)t;
  const int need = kk - above;
  if (threadIdx.x == 0) {
    int* st = sel.slot(b, LEVEL);
    st[0] = (int)next;
    st[1] = need;
    st[2] = k - need;  // after level 2: the keys above the k-th key's score
  }
  if (LEVEL == 2) {
    // each CTA's count of keys of score T in the CTAs before it
    int carry = 0;
    for (int c0 = 0; c0 < sel.nblk; c0 += kSelThreads) {
      const int c = c0 + threadIdx.x;
      const int v = c < sel.nblk ? __ldcg(sel.cnt + ((size_t)b * sel.nblk + c) * kBinsLo + t) : 0;
      int total;
      const int before = block_excl_scan(v, &total);
      if (c < sel.nblk) sel.tie_off[(size_t)b * sel.nblk + c] = carry + before;
      carry += total;
    }
  }
}

// The winners: every key above T, and the first `need` keys of score T in
// index order, after them.
template <class Src>
__global__ void __launch_bounds__(kSelThreads)
select_collect(Src src, int m, int k, Select sel) {
  __shared__ int base;
  const int b = blockIdx.y;
  const int* st = sel.slot(b, 2);
  const uint32_t thr = (uint32_t)st[0];
  const int need = st[1], above = st[2];
  const auto row = src.row(b);
  const int i0 = blockIdx.x * kSelChunk + threadIdx.x * kSelItems;
  u64 key[kSelItems];
  int n_win = 0, n_tie = 0;
#pragma unroll
  for (int j = 0; j < kSelItems; ++j) {
    key[j] = i0 + j < m ? row(i0 + j) : 0ull;  // key 0: below every real key
    const uint32_t o = (uint32_t)(key[j] >> 32);
    n_win += o > thr;
    n_tie += i0 + j < m && o == thr;
  }
  int win_total, tie_total;
  int w = block_excl_scan(n_win, &win_total);
  int r = block_excl_scan(n_tie, &tie_total) + sel.tie_off[(size_t)b * sel.nblk + blockIdx.x];
  if (threadIdx.x == 0 && win_total > 0) base = atomicAdd(sel.counters(b) + 3, win_total);
  __syncthreads();
  u64* out = sel.win + (size_t)b * k;
#pragma unroll
  for (int j = 0; j < kSelItems; ++j) {
    const uint32_t o = (uint32_t)(key[j] >> 32);
    if (o > thr) {
      out[base + w++] = key[j];
    } else if (i0 + j < m && o == thr) {
      if (r < need) out[above + r] = key[j];
      ++r;
    }
  }
}

__device__ __forceinline__ void write_result(float* vals, int* idx, size_t o, u64 key) {
  vals[o] = float_of((uint32_t)(key >> 32));
  idx[o] = (int)(~(uint32_t)key);
}

// k <= kSortMax: one CTA a row sorts the winners above T in shared memory.
__global__ void __launch_bounds__(kSortThreads)
select_sort(Select sel, int k, float* __restrict__ vals, int* __restrict__ idx) {
  extern __shared__ __align__(16) unsigned char smem[];
  u64* keys = reinterpret_cast<u64*>(smem);
  const int b = blockIdx.x;
  const int above = sel.slot(b, 2)[2];
  int len = 1;
  while (len < above) len <<= 1;
  const u64* w = sel.win + (size_t)b * k;
  for (int i = threadIdx.x; i < len; i += blockDim.x) keys[i] = i < above ? w[i] : 0ull;
  __syncthreads();
  if (above > 1) block_sort_desc(keys, len);
  for (int i = threadIdx.x; i < k; i += blockDim.x)
    write_result(vals, idx, (size_t)b * k + i, i < above ? keys[i] : w[i]);
}

// Larger k: each winner above T goes to its rank, the number of winners
// above it; the score-T winners stay where they are. A CTA ranks
// kRankWinners winners, each counted by kRankParts threads over a share of
// every tile (so ceil(k / 128) CTAs of 1,024 threads fill the card).
__global__ void __launch_bounds__(kRankThreads)
select_rank(Select sel, int k, float* __restrict__ vals, int* __restrict__ idx) {
  __shared__ u64 tile[kRankTile];
  __shared__ int part_rank[kRankParts][kRankWinners];
  const int b = blockIdx.y;
  const int above = sel.slot(b, 2)[2];
  const int w0 = blockIdx.x * kRankWinners;
  const int mine_at = w0 + threadIdx.x % kRankWinners, part = threadIdx.x / kRankWinners;
  const u64* w = sel.win + (size_t)b * k;
  const size_t o = (size_t)b * k;
  if (w0 >= above) {  // uniform over the CTA: score-T winners only
    if (part == 0 && mine_at < k) write_result(vals, idx, o + mine_at, w[mine_at]);
    return;
  }
  const u64 mine = mine_at < above ? w[mine_at] : ~0ull;
  int rank = 0;
  for (int t0 = 0; t0 < above; t0 += kRankTile) {
    const int nt = min(kRankTile, above - t0);
    __syncthreads();
    for (int i = threadIdx.x; i < nt; i += kRankThreads) tile[i] = w[t0 + i];
    __syncthreads();
    const int per = (nt + kRankParts - 1) / kRankParts;
    const int i1 = min(nt, (part + 1) * per);
#pragma unroll 8
    for (int i = part * per; i < i1; ++i) rank += tile[i] > mine;
  }
  part_rank[part][threadIdx.x % kRankWinners] = rank;
  __syncthreads();
  if (part != 0 || mine_at >= k) return;
  if (mine_at < above) {
#pragma unroll
    for (int j = 1; j < kRankParts; ++j) rank += part_rank[j][threadIdx.x];
    write_result(vals, idx, o + rank, mine);
  } else {
    write_result(vals, idx, o + mine_at, w[mine_at]);
  }
}

// The five launches of the select over nq rows of m keys.
template <class Src>
int select_topk(const Src& src, int nq, int m, int k, u64* scratch, int* zero, float* vals,
                int* idx, cudaStream_t s) {
  const Select sel = select_at(scratch, zero, nq, m, k);
  const dim3 grid(sel.nblk, nq);
  select_hist<Src, 0><<<grid, kSelThreads, 0, s>>>(src, m, k, sel);
  select_hist<Src, 1><<<grid, kSelThreads, 0, s>>>(src, m, k, sel);
  select_hist<Src, 2><<<grid, kSelThreads, 0, s>>>(src, m, k, sel);
  select_collect<Src><<<grid, kSelThreads, 0, s>>>(src, m, k, sel);
  if (k <= kSortMax) {
    int len = 1;
    while (len < k) len <<= 1;
    select_sort<<<nq, kSortThreads, (size_t)len * sizeof(u64), s>>>(sel, k, vals, idx);
  } else {
    select_rank<<<dim3((k + kRankWinners - 1) / kRankWinners, nq), kRankThreads, 0, s>>>(
        sel, k, vals, idx);
  }
  return (int)cudaGetLastError();
}

bool is_pow2(int x) { return x > 0 && (x & (x - 1)) == 0; }

int next_pow2(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// Candidates one pass-2 CTA merges before the groups' results are merged
// once more: splitting a query's partial lists over several CTAs keeps the
// merge parallel when kp * n_cta is large (k in the hundreds).
constexpr int kMergeGroupCandidates = 8192;

int lists_per_group(int n_lists, int kp) {
  const int per = (kMergeGroupCandidates + kp - 1) / kp;
  return per < n_lists ? per : n_lists;
}

// u64 entries of scratch that need no initialisation: for a and b (rows > 0)
// the partial lists [nq][n_cta][kp], then merge_topk's second-level keys or
// the select's scratch; for c (rows == 0) the select's scratch over n keys.
size_t scratch_entries(int nq, int n, int k, int rows, bool select) {
  if (rows == 0) return select_entries(nq, n, k);
  const int n_cta = (n + rows - 1) / rows;
  const int kp = k < rows ? k : rows;
  const size_t lists = (size_t)nq * n_cta * kp;
  if (select) return lists + select_entries(nq, n_cta * kp, k);
  const int per = lists_per_group(n_cta, kp);
  const int groups = (n_cta + per - 1) / per;
  return lists + (groups > 1 ? (size_t)nq * groups * k : 0);
}

template <int SLOTS>
int merge_slots(u64* part, int nq, int n_cta, int kp, int k, int kpad, float* vals, int* idx,
                cudaStream_t s) {
  const size_t smem = (size_t)SLOTS * sizeof(u64);
  const int per = lists_per_group(n_cta, kp);
  const int groups = (n_cta + per - 1) / per;
  if (groups == 1) {
    merge_topk<SLOTS><<<nq, kMergeThreads, smem, s>>>(part, n_cta, kp, n_cta, 1, k, kpad,
                                                      nullptr, vals, idx);
    return (int)cudaGetLastError();
  }
  u64* level = part + (size_t)nq * n_cta * kp;
  merge_topk<SLOTS><<<nq * groups, kMergeThreads, smem, s>>>(part, n_cta, kp, per, groups, k,
                                                             kpad, level, nullptr, nullptr);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  merge_topk<SLOTS><<<nq, kMergeThreads, smem, s>>>(level, groups, k, groups, 1, k, kpad,
                                                    nullptr, vals, idx);
  return (int)cudaGetLastError();
}

// Pass 2 of a and b over the partial lists in `part` ([nq, n_cta, kp]
// keys): merge_topk (k up to 2048 in a 4,096-key buffer of 32 KB, larger k
// in an 8,192-key one of 64 KB), or the radix select over the lists.
int pass2(u64* part, int* zero, bool select, int nq, int n_cta, int kp, int k, float* vals,
          int* idx, cudaStream_t s) {
  if (select) {
    const int m = n_cta * kp;
    return select_topk(ListKeys{part, m}, nq, m, k, part + (size_t)nq * m, zero, vals, idx, s);
  }
  const int kpad = next_pow2(k);
  if (kpad + 2 * kMergeThreads <= kMergeSlots)
    return merge_slots<kMergeSlots>(part, nq, n_cta, kp, k, kpad, vals, idx, s);
  return merge_slots<2 * kMergeSlots>(part, nq, n_cta, kp, k, kpad, vals, idx, s);
}

bool bad_cosine(int nq, int n, int k, int rows, int select, const void* zero) {
  return nq < 1 || nq > 65535 || n < 1 || k < 1 || k > n || !is_pow2(rows) || rows < 64 ||
         rows > 4096 || (!select && k > kMergeMaxK) || (select && zero == nullptr) ||
         (long long)((n + rows - 1) / rows) * (k < rows ? k : rows) > 0x7fffffffLL;
}

// Queries scored per corpus pass: the smallest power of two >= nq, at most
// kQueryGroup (more queries take several passes over the corpus).
int query_group(int nq) { return nq >= kQueryGroup ? kQueryGroup : next_pow2(nq); }

template <int QG>
int launch_cosine_bf16(const void* q, const void* corpus, const void* valid, int nq, int n,
                       int d, int k, int rows, int select, void* part, void* zero, void* vals,
                       void* idx, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int n_cta = (n + rows - 1) / rows;
  const int kp = k < rows ? k : rows;
  const size_t smem = (size_t)QG * rows * sizeof(u64) + (size_t)QG * d * sizeof(float);
  dim3 grid(n_cta, (nq + QG - 1) / QG);
  cosine_partial_bf16<QG><<<grid, kPass1Threads, smem, s>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)corpus, (const uint8_t*)valid, nq, n,
      d, rows, kp, (u64*)part);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return pass2((u64*)part, (int*)zero, select, nq, n_cta, kp, k, (float*)vals, (int*)idx, s);
}

template <int QG>
int launch_cosine_int8(const void* q, const void* q_scale, const void* corpus,
                       const void* row_scale, const void* valid, int nq, int n, int d, int k,
                       int rows, int select, void* part, void* zero, void* vals, void* idx,
                       void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int n_cta = (n + rows - 1) / rows;
  const int kp = k < rows ? k : rows;
  const size_t smem = (size_t)QG * rows * sizeof(u64) + (size_t)QG * d;
  dim3 grid(n_cta, (nq + QG - 1) / QG);
  cosine_partial_int8<QG><<<grid, kPass1Threads, smem, s>>>(
      (const int8_t*)q, (const float*)q_scale, (const int8_t*)corpus, (const float*)row_scale,
      (const uint8_t*)valid, nq, n, d, rows, kp, (u64*)part);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return pass2((u64*)part, (int*)zero, select, nq, n_cta, kp, k, (float*)vals, (int*)idx, s);
}

template <class K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int QG>
cudaError_t allow_pass1(int bytes) {
  cudaError_t e = allow_smem(cosine_partial_bf16<QG>, bytes);
  return e != cudaSuccess ? e : allow_smem(cosine_partial_int8<QG>, bytes);
}

}  // namespace

extern "C" {

// Sets the dynamic shared memory each top-k kernel may take on the current
// device (above the default 48 KB only after this call); called once, when
// the library is loaded.
int cs_topk_init() {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = allow_pass1<1>(optin);
  if (e == cudaSuccess) e = allow_pass1<2>(optin);
  if (e == cudaSuccess) e = allow_pass1<4>(optin);
  if (e == cudaSuccess) e = allow_pass1<8>(optin);
  if (e == cudaSuccess) e = allow_pass1<16>(optin);
  if (e == cudaSuccess) e = allow_smem(merge_topk<kMergeSlots>, kMergeSlots * (int)sizeof(u64));
  if (e == cudaSuccess)
    e = allow_smem(merge_topk<2 * kMergeSlots>, 2 * kMergeSlots * (int)sizeof(u64));
  if (e == cudaSuccess) e = allow_smem(select_sort, kSortMax * (int)sizeof(u64));
  return (int)e;
}

// u64 entries of scratch the top-k entry points need: zeroed == 0, the
// scratch that needs no initialisation (rows: the cosine kernels' pass-1
// rows, 0 for cs_scores_topk; select: whether pass 2 is the radix select);
// zeroed == 1, the select's histograms and counters, which must be zero.
long long cs_scratch_entries(int nq, int n, int k, int rows, int select, int zeroed) {
  if (zeroed) return select ? ((long long)nq * kZeroInts + 1) / 2 : 0;
  return (long long)scratch_entries(nq, n, k, rows, select != 0);
}

const char* cs_error_string(int err) {
  if (err == kErrBadArg) return "invalid argument to a kernel entry point";
  return cudaGetErrorString((cudaError_t)err);
}

// `part` and `zero`: the scratch of cs_scratch_entries(nq, n, k, rows,
// select, 0 / 1), `zero` zeroed (unused when select is 0). select == 0 takes
// merge_topk as pass 2 (k <= 4096), select == 1 the radix select.
int cs_cosine_topk_bf16(const void* q, const void* corpus, const void* valid, int nq,
                        int n, int d, int k, int rows, int select, void* part, void* zero,
                        void* vals, void* idx, void* stream) {
  if (bad_cosine(nq, n, k, rows, select, zero) || d < 8 || d % 8 != 0 || d > 1024)
    return kErrBadArg;
  switch (query_group(nq)) {
    case 1: return launch_cosine_bf16<1>(q, corpus, valid, nq, n, d, k, rows, select, part, zero, vals, idx, stream);
    case 2: return launch_cosine_bf16<2>(q, corpus, valid, nq, n, d, k, rows, select, part, zero, vals, idx, stream);
    case 4: return launch_cosine_bf16<4>(q, corpus, valid, nq, n, d, k, rows, select, part, zero, vals, idx, stream);
    case 8: return launch_cosine_bf16<8>(q, corpus, valid, nq, n, d, k, rows, select, part, zero, vals, idx, stream);
    default: return launch_cosine_bf16<16>(q, corpus, valid, nq, n, d, k, rows, select, part, zero, vals, idx, stream);
  }
}

int cs_cosine_topk_int8(const void* q, const void* q_scale, const void* corpus,
                        const void* row_scale, const void* valid, int nq, int n, int d,
                        int k, int rows, int select, void* part, void* zero, void* vals,
                        void* idx, void* stream) {
  if (bad_cosine(nq, n, k, rows, select, zero) || d < 16 || d % 16 != 0 || d > 1024)
    return kErrBadArg;
  switch (query_group(nq)) {
    case 1: return launch_cosine_int8<1>(q, q_scale, corpus, row_scale, valid, nq, n, d, k, rows, select, part, zero, vals, idx, stream);
    case 2: return launch_cosine_int8<2>(q, q_scale, corpus, row_scale, valid, nq, n, d, k, rows, select, part, zero, vals, idx, stream);
    case 4: return launch_cosine_int8<4>(q, q_scale, corpus, row_scale, valid, nq, n, d, k, rows, select, part, zero, vals, idx, stream);
    case 8: return launch_cosine_int8<8>(q, q_scale, corpus, row_scale, valid, nq, n, d, k, rows, select, part, zero, vals, idx, stream);
    default: return launch_cosine_int8<16>(q, q_scale, corpus, row_scale, valid, nq, n, d, k, rows, select, part, zero, vals, idx, stream);
  }
}

// Kernel c: the radix select over nb rows of n scores; `part` and `zero` as
// cs_scratch_entries(nb, n, k, 0, 1, 0 / 1) give them.
int cs_scores_topk(const void* scores, const void* slot_meta, const void* boost_kid, int nb,
                   int n, int k, int dead_slot, void* part, void* zero, void* vals, void* idx,
                   void* stream) {
  if (nb < 1 || nb > 65535 || n < 1 || k < 1 || k > n || zero == nullptr) return kErrBadArg;
  const ScoreKeys src{(const float*)scores, (const int*)slot_meta, (const int*)boost_kid, n,
                      dead_slot};
  return select_topk(src, nb, n, k, (u64*)part, (int*)zero, (float*)vals, (int*)idx,
                     (cudaStream_t)stream);
}

}  // extern "C"
