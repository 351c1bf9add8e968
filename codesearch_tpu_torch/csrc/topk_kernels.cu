// Exact top-k selection kernels for Hopper (sm_90a), bound to Python via ctypes.
//
// Replaces the three Pallas kernels of codesearch_tpu/ops/pallas_topk.py:
//   cs_cosine_topk_bf16  <- fused_cosine_topk       (_fused_kernel)
//   cs_cosine_topk_int8  <- fused_cosine_topk_int8  (_fused_kernel_int8)
//   cs_scores_topk       <- fused_scores_topk       (_fused_kernel_scores)
//
// What bounds them on an H100: the two cosine kernels read the whole corpus
// matrix once per query group (N*d bytes: 201 MB for bf16 and 101 MB for
// int8 at N=262,144, d=384), so they are bound by device-memory bandwidth
// (3.35 TB/s), not by arithmetic: a [9,384]x[384,N] product is ~1.8 GFLOP.
// The scores kernel reads B*N*4 bytes of precomputed scores. Selection adds
// shared-memory sorting work that the design keeps per block and small.
//
// Design. The TPU kernel kept ONE running top-k in VMEM because its grid runs
// tiles in order on one core. Hopper blocks run in parallel and in no order,
// so selection takes two passes:
//   pass 1  every CTA owns a contiguous range of `rows` corpus rows. For a
//           group of up to kQueryGroup queries it computes each score in the
//           kernel body (the corpus rows are read ONCE for the whole group,
//           each warp streaming whole rows with 16-byte loads), applies the
//           validity mask or the kind boost, sorts the block's (score, row)
//           keys in shared memory (bitonic) and writes its top-kp partial list.
//   pass 2  one CTA per query streams all partial lists and keeps the exact
//           top-k in shared memory: candidates at or below the running k-th
//           key are dropped on sight, survivors are appended and the buffer is
//           re-sorted only when it fills. Where a query has many partial
//           lists, groups of them are merged first and their top-k merged
//           once more (two levels).
// k is bounded by kMaxK = 4096: the merge buffer holds 4,096 keys, or 8,192
// (64 KB of shared memory) for k above 2048, and the search path's largest
// selection, the BM25 dense leg's oversampled kpre, stays within it.
// Exactness and tie order: a selection key packs the score into the high 32
// bits (order-preserving bit transform) and the complemented row index into
// the low 32 bits, so one unsigned 64-bit descending order is "score desc,
// then index asc" -- the lowest index wins a tie, as XLA top_k and the Pallas
// kernel do. Key 0 is below every real key and pads ragged blocks.
// Invalid rows and dead slots score -3e38, as in the Pallas kernels.
//
// Every kernel launches on the caller's stream, allocates nothing (the
// caller passes the partial-list scratch) and every entry point returns the
// CUDA error of its launches (0 on success, negative for a bad argument).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef unsigned long long u64;

namespace {

constexpr float kNegInf = -3.0e38f;
constexpr int kMaxK = 4096;
constexpr int kQueryGroup = 16;
constexpr int kPass1Threads = 256;
constexpr int kMergeThreads = 1024;
constexpr int kMergeSlots = 4096;  // smallest merge buffer (keys)

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

// ---- pass 1: precomputed scores, kind boost and dead-slot mask ------------
__global__ void __launch_bounds__(kPass1Threads)
scores_partial(const float* __restrict__ scores, const int* __restrict__ slot_meta,
               const int* __restrict__ boost_kid, int n, int rows, int kp,
               int dead_slot, u64* __restrict__ part) {
  extern __shared__ __align__(16) unsigned char smem[];
  u64* keys = reinterpret_cast<u64*>(smem);
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * rows;
  const int kid = boost_kid[b];
  const float* srow = scores + (size_t)b * n;
  for (int i = threadIdx.x; i < rows; i += blockDim.x) {
    const int row = r0 + i;
    u64 key = 0ull;
    if (row < n) {
      const int m = slot_meta[row];
      const float s = __fmul_rn(srow[row], m == kid ? 3.0f : 1.0f);
      key = make_key(m == dead_slot ? kNegInf : s, row);
    }
    keys[i] = key;
  }
  __syncthreads();
  block_sort_desc(keys, rows);
  write_partials(keys, rows, 1, b, kp, part);
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

// Partial-list scratch (u64 entries) for nq queries over n columns.
size_t scratch_entries(int nq, int n, int k, int rows) {
  const int n_cta = (n + rows - 1) / rows;
  const int kp = k < rows ? k : rows;
  const int per = lists_per_group(n_cta, kp);
  const int groups = (n_cta + per - 1) / per;
  return (size_t)nq * n_cta * kp + (groups > 1 ? (size_t)nq * groups * k : 0);
}

template <int SLOTS>
int merge_slots(u64* part, int nq, int n_cta, int kp, int k, int kpad, float* vals, int* idx,
                cudaStream_t s) {
  const size_t smem = (size_t)SLOTS * sizeof(u64);
  cudaError_t e = cudaFuncSetAttribute(merge_topk<SLOTS>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
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
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  merge_topk<SLOTS><<<nq, kMergeThreads, smem, s>>>(level, groups, k, groups, 1, k, kpad,
                                                    nullptr, vals, idx);
  return (int)cudaGetLastError();
}

// Pass 2 over the partial lists in `part` ([nq, n_cta, kp] keys); the
// second-level keys go after them. k up to 2048 merges in a 4,096-key
// buffer (32 KB), larger k in an 8,192-key one (64 KB).
int merge(u64* part, int nq, int n_cta, int kp, int k, float* vals, int* idx,
          cudaStream_t s) {
  const int kpad = next_pow2(k);
  if (kpad + 2 * kMergeThreads <= kMergeSlots)
    return merge_slots<kMergeSlots>(part, nq, n_cta, kp, k, kpad, vals, idx, s);
  return merge_slots<2 * kMergeSlots>(part, nq, n_cta, kp, k, kpad, vals, idx, s);
}

bool bad_common(int nq, int n, int k, int rows) {
  return nq < 1 || n < 1 || k < 1 || k > kMaxK || k > n || !is_pow2(rows) ||
         rows < 64 || rows > 4096;
}

// Queries scored per corpus pass: the smallest power of two >= nq, at most
// kQueryGroup (more queries take several passes over the corpus).
int query_group(int nq) { return nq >= kQueryGroup ? kQueryGroup : next_pow2(nq); }

template <int QG>
int launch_cosine_bf16(const void* q, const void* corpus, const void* valid, int nq, int n,
                       int d, int k, int rows, void* part, void* vals, void* idx,
                       void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int n_cta = (n + rows - 1) / rows;
  const int kp = k < rows ? k : rows;
  const size_t smem = (size_t)QG * rows * sizeof(u64) + (size_t)QG * d * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(cosine_partial_bf16<QG>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(n_cta, (nq + QG - 1) / QG);
  cosine_partial_bf16<QG><<<grid, kPass1Threads, smem, s>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)corpus, (const uint8_t*)valid, nq, n,
      d, rows, kp, (u64*)part);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return merge((u64*)part, nq, n_cta, kp, k, (float*)vals, (int*)idx, s);
}

template <int QG>
int launch_cosine_int8(const void* q, const void* q_scale, const void* corpus,
                       const void* row_scale, const void* valid, int nq, int n, int d,
                       int k, int rows, void* part, void* vals, void* idx, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int n_cta = (n + rows - 1) / rows;
  const int kp = k < rows ? k : rows;
  const size_t smem = (size_t)QG * rows * sizeof(u64) + (size_t)QG * d;
  cudaError_t e = cudaFuncSetAttribute(cosine_partial_int8<QG>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(n_cta, (nq + QG - 1) / QG);
  cosine_partial_int8<QG><<<grid, kPass1Threads, smem, s>>>(
      (const int8_t*)q, (const float*)q_scale, (const int8_t*)corpus, (const float*)row_scale,
      (const uint8_t*)valid, nq, n, d, rows, kp, (u64*)part);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return merge((u64*)part, nq, n_cta, kp, k, (float*)vals, (int*)idx, s);
}

}  // namespace

extern "C" {

// u64 entries of partial-list scratch the top-k entry points need.
long long cs_scratch_entries(int nq, int n, int k, int rows) {
  return (long long)scratch_entries(nq, n, k, rows);
}

const char* cs_error_string(int err) {
  if (err == kErrBadArg) return "invalid argument to a top-k kernel";
  return cudaGetErrorString((cudaError_t)err);
}

// `part` is scratch of cs_scratch_entries(nq, n, k, rows) u64 entries.
int cs_cosine_topk_bf16(const void* q, const void* corpus, const void* valid, int nq,
                        int n, int d, int k, int rows, void* part, void* vals,
                        void* idx, void* stream) {
  if (bad_common(nq, n, k, rows) || d < 8 || d % 8 != 0 || d > 1024) return kErrBadArg;
  switch (query_group(nq)) {
    case 1: return launch_cosine_bf16<1>(q, corpus, valid, nq, n, d, k, rows, part, vals, idx, stream);
    case 2: return launch_cosine_bf16<2>(q, corpus, valid, nq, n, d, k, rows, part, vals, idx, stream);
    case 4: return launch_cosine_bf16<4>(q, corpus, valid, nq, n, d, k, rows, part, vals, idx, stream);
    case 8: return launch_cosine_bf16<8>(q, corpus, valid, nq, n, d, k, rows, part, vals, idx, stream);
    default: return launch_cosine_bf16<16>(q, corpus, valid, nq, n, d, k, rows, part, vals, idx, stream);
  }
}

int cs_cosine_topk_int8(const void* q, const void* q_scale, const void* corpus,
                        const void* row_scale, const void* valid, int nq, int n, int d,
                        int k, int rows, void* part, void* vals, void* idx, void* stream) {
  if (bad_common(nq, n, k, rows) || d < 16 || d % 16 != 0 || d > 1024) return kErrBadArg;
  switch (query_group(nq)) {
    case 1: return launch_cosine_int8<1>(q, q_scale, corpus, row_scale, valid, nq, n, d, k, rows, part, vals, idx, stream);
    case 2: return launch_cosine_int8<2>(q, q_scale, corpus, row_scale, valid, nq, n, d, k, rows, part, vals, idx, stream);
    case 4: return launch_cosine_int8<4>(q, q_scale, corpus, row_scale, valid, nq, n, d, k, rows, part, vals, idx, stream);
    case 8: return launch_cosine_int8<8>(q, q_scale, corpus, row_scale, valid, nq, n, d, k, rows, part, vals, idx, stream);
    default: return launch_cosine_int8<16>(q, q_scale, corpus, row_scale, valid, nq, n, d, k, rows, part, vals, idx, stream);
  }
}

int cs_scores_topk(const void* scores, const void* slot_meta, const void* boost_kid, int nb,
                   int n, int k, int dead_slot, int rows, void* part, void* vals, void* idx,
                   void* stream) {
  if (bad_common(nb, n, k, rows)) return kErrBadArg;
  cudaStream_t s = (cudaStream_t)stream;
  const int n_cta = (n + rows - 1) / rows;
  const int kp = k < rows ? k : rows;
  const size_t smem = (size_t)rows * sizeof(u64);
  cudaError_t e = cudaFuncSetAttribute(scores_partial,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(n_cta, nb);
  scores_partial<<<grid, kPass1Threads, smem, s>>>(
      (const float*)scores, (const int*)slot_meta, (const int*)boost_kid, n, rows, kp,
      dead_slot, (u64*)part);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return merge((u64*)part, nb, n_cta, kp, k, (float*)vals, (int*)idx, s);
}

}  // extern "C"
