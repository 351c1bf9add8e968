// Exact top-k selection kernels for Hopper (sm_90a), bound to Python via ctypes.
//
// Replaces the three Pallas kernels of codesearch_tpu/ops/pallas_topk.py:
//   cs_cosine_topk_bf16  <- fused_cosine_topk       (_fused_kernel)         kernel a
//   cs_cosine_topk_int8  <- fused_cosine_topk_int8  (_fused_kernel_int8)    kernel b
//   cs_scores_topk       <- fused_scores_topk       (_fused_kernel_scores)  kernel c
//
// The TPU kernels kept ONE running top-k in VMEM because their grid runs
// tiles in order on one core. Hopper blocks run in parallel and in no order,
// so a and b run in two stages, and the second is c's whole kernel:
//
// 1. The score pass of a and b (cosine_scores<kInt8>), bound by bytes. It
//    reads the corpus once per group of up to 16 queries (N*d bytes: 201 MB
//    in bf16, 101 MB in int8 at N=262,144, d=384: 0.060 / 0.030 ms at 3.35
//    TB/s) and writes each query's masked score row, f32 [Q, N] (1 MB a
//    query). The products are 3.2 GFLOP for a full group of 16, ~3 us of
//    tensor-core time. Cosine scoring is attention's first product, with the
//    queries as a 16-row tile and the corpus rows as keys, so the pass is
//    built from kernel d's pieces (csrc/attention_kernels.cu):
//    - The queries (f32) are loaded once a CTA into a 16-row A tile in shared
//      memory, zero past d and past the group's last query. a rounds them to
//      bf16 (RNE, the plain version's .to(bfloat16)); b quantizes them as
//      quantize_rows_int8 does (absmax, max(., 1e-12) / 127 and x / scale
//      with __fdiv_rn, rintf: half to even, clip +-127) and keeps the scales
//      in shared memory, so its wrapper launches nothing before the kernel.
//    - A persistent grid (the CTAs that fit on the SMs, split over the query
//      groups as grid.y) walks 64-row tiles of the corpus. A tile streams in
//      256-byte chunks of its rows through a 3-stage cp.async ring (two
//      chunks of 17 KB in flight while a CTA computes a third, 3 CTAs an SM
//      at d=384), zero-filled past d and past N; rows sit 16 bytes apart in
//      their bank groups, so the eight rows of an ldmatrix hit eight
//      different ones. examples/topk_variants.py chose the ring's depth.
//    - Each of 4 warps holds 16 rows of a tile as two n8 tiles and runs
//      mma.sync over the chunk: m16n8k16 bf16 -> f32 (a), m16n8k32 s8 -> s32
//      (b: exact int sums). The A fragments come from ldmatrix on the query
//      tile, the B fragments from ldmatrix on the corpus rows ([N, d]
//      row-major is already the .col operand). The pass sorts nothing: the
//      select reads the score rows.
//    - After a tile's last chunk the epilogue writes valid[row] ? score :
//      -3e38, b's score as (s * q_scale) * row_scale with __fmul_rn (the
//      plain version's order). The pass also zeroes the select's histograms,
//      so a's and b's wrappers need no memset.
//
// 2. The radix select (select_*), for every k of a, b and c: any 1 <= k <= n,
//    bound by its launches and the latency of its passes, not by bytes (c
//    reads B*N*4 bytes of scores, 1 MB a row, 0.3 us at the memory rate). Its
//    keys come from a key source: c's boosted scores (ScoreKeys, computed on
//    the fly from scores, slot_meta and boost_kid), a's and b's score rows
//    (RowKeys). Its passes over a row of m keys run as a fixed sequence of
//    five launches, spread over ceil(m / 1024) CTAs a row, with every
//    decision taken on the device:
//   - select_hist<0..2>: each CTA builds a shared-memory histogram of one
//     digit of its keys' score bits (bits 31-20, 19-8, 7-0 of the 32-bit
//     order-preserving score), levels 1 and 2 only over keys whose higher
//     digits match the prefix chosen so far, and adds it to the row's global
//     histogram with atomics. Each key adds to its bin with a plain shared
//     atomic: on an H100, adding a warp's equal digits once
//     (__match_any_sync) cost more than it saved, even on rows a third
//     exactly 0.0, all in one bin. The last CTA of the row to finish (a
//     ticket counter after a fence) scans the global histogram, picks the
//     bin that holds the k-th key and writes the new prefix and the count
//     still needed in it. After level 2 the prefix is the k-th key's score T exactly, and
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
// Exactness and tie order: a selection key packs the score into the high 32
// bits (order-preserving bit transform) and the complemented column index
// into the low 32 bits, so one unsigned 64-bit descending order is "score
// desc, then index asc" -- the lowest index wins a tie, as XLA top_k and the
// Pallas kernels do. Every key is unique. Key 0 is below every real key.
// Invalid rows and dead slots score -3e38, as in the Pallas kernels.
//
// Every kernel launches on the caller's stream and allocates nothing (the
// caller passes the scratch; c's select histograms zeroed); every entry
// point returns the CUDA error of its launches (0 on success, negative for a
// bad argument). cs_topk_init sets the kernels' shared-memory limits once,
// when the library is loaded.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

typedef unsigned long long u64;

namespace {

constexpr float kNegInf = -3.0e38f;
// the score pass
constexpr int kQueryTile = 16;               // queries a CTA scores (the mma's M)
constexpr int kScoreWarps = 4;
constexpr int kScoreThreads = kScoreWarps * 32;
constexpr int kTileRows = kScoreWarps * 16;  // corpus rows a tile: 16 a warp (two n8 tiles)
constexpr int kChunk = 256;                  // bytes of each row a ring stage holds: 8 k-steps
constexpr int kRowPad = 16;                  // bytes of padding a shared-memory row
constexpr int kStageBytes = kTileRows * (kChunk + kRowPad);
constexpr int kStages = 3;
constexpr int kMaxRowBytes = 2048;           // d <= 1024 (bf16)
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

// Bitonic sort, descending, of len keys (a power of two) in shared memory.
// The caller synchronises before the call; the sort ends synchronised.
__device__ void block_sort_desc(u64* k, int len) {
  const int half = len >> 1;
  for (int size = 2; size <= len; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < half; i += blockDim.x) {
        const int lo = 2 * i - (i & (stride - 1));
        const u64 a = k[lo];
        const u64 b = k[lo + stride];
        const bool desc = (lo & size) == 0;
        if ((a < b) == desc) {
          k[lo] = b;
          k[lo + stride] = a;
        }
      }
      __syncthreads();
    }
  }
}

// ---- stage 1: the score pass of a and b ------------------------------------
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? 16 : 0;  // 0: the 16 bytes are zero-filled, src not read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 tiles of 16-bit elements from shared memory, lane l naming row
// (l & 7) of tile (l >> 3); r[i] holds tile i's row g = lane / 4, elements
// 2t, 2t + 1 (t = lane % 4): bytes 4t..4t+3 of the tile's 16-byte row.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// D += A (16 x 32 bytes, row) * B (32 bytes x 8, col): a's bf16 -> f32
// (m16n8k16) and b's s8 -> s32 (m16n8k32). In bytes both take the same
// fragments: a0 (row g, bytes 4t..4t+3), a1 (row g + 8), a2 (row g, bytes
// 16 + 4t..), a3 (row g + 8, bytes 16 + 4t..); b0 (bytes 4t..4t+3 of column
// g), b1 (bytes 16 + 4t.. of column g); d0 d1 (row g, columns 2t, 2t + 1),
// d2 d3 (row g + 8, the same columns).
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// quantize_rows_int8's rounding of one value: round(x / scale), half to
// even, clipped to +-127.
__device__ __forceinline__ uint32_t quantize(float x, float scale) {
  const float r = fminf(fmaxf(rintf(__fdiv_rn(x, scale)), -127.0f), 127.0f);
  return (uint32_t)(uint8_t)(int8_t)r;
}

constexpr int kQueryVecs = kMaxRowBytes / 2 / 4 / 32;  // float4s a lane holds of a query

// The CTA's queries [q0, q0 + qn) (f32 [nq, d]) as the A tile: bf16 (a) or
// int8 with their scales in qscale (b), zero past d and past qn. One warp a
// query; the tile is synchronised by the caller's next barrier.
template <bool kInt8>
__device__ void load_queries(const float* __restrict__ q, int q0, int qn, int d,
                             unsigned char* qt, int qstride, float* qscale) {
  for (int i = threadIdx.x; i < kQueryTile * qstride / 16; i += kScoreThreads)
    reinterpret_cast<uint4*>(qt)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nv = d >> 2;
  for (int j = warp; j < qn; j += kScoreWarps) {
    const float4* src = reinterpret_cast<const float4*>(q + (size_t)(q0 + j) * d);
    float4 v[kQueryVecs];
    float amax = 0.0f;
#pragma unroll
    for (int i = 0; i < kQueryVecs; ++i) {
      const int c = lane + 32 * i;
      v[i] = c < nv ? __ldg(src + c) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      amax = fmaxf(amax, fmaxf(fmaxf(fabsf(v[i].x), fabsf(v[i].y)),
                               fmaxf(fabsf(v[i].z), fabsf(v[i].w))));
    }
    unsigned char* row = qt + j * qstride;
    if (kInt8) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
      const float scale = __fdiv_rn(fmaxf(amax, 1e-12f), 127.0f);
      if (lane == 0) qscale[j] = scale;
#pragma unroll
      for (int i = 0; i < kQueryVecs; ++i) {
        const int c = lane + 32 * i;
        if (c < nv)
          *reinterpret_cast<uint32_t*>(row + 4 * c) =
              quantize(v[i].x, scale) | quantize(v[i].y, scale) << 8 |
              quantize(v[i].z, scale) << 16 | quantize(v[i].w, scale) << 24;
      }
    } else {
#pragma unroll
      for (int i = 0; i < kQueryVecs; ++i) {
        const int c = lane + 32 * i;
        if (c < nv)
          *reinterpret_cast<uint2*>(row + 8 * c) =
              make_uint2(pack_bf16(v[i].x, v[i].y), pack_bf16(v[i].z, v[i].w));
      }
    }
  }
}

__host__ __device__ __forceinline__ int query_stride(int row_bytes) {
  return (row_bytes + kChunk - 1) / kChunk * kChunk + kRowPad;
}

size_t score_smem(int row_bytes) {
  return (size_t)kQueryTile * query_stride(row_bytes) + (size_t)kStages * kStageBytes;
}

// scores [nq, n]: each query's masked score row. zero [n_zero]: the select's
// histograms and counters, zeroed here for the select that follows.
template <bool kInt8>
__global__ void __launch_bounds__(kScoreThreads)
cosine_scores(const float* __restrict__ q, const unsigned char* __restrict__ corpus,
              const float* __restrict__ row_scale, const uint8_t* __restrict__ valid, int nq,
              int n, int d, int row_bytes, float* __restrict__ scores, int* __restrict__ zero,
              int n_zero) {
  using Acc = typename std::conditional<kInt8, int, float>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float qscale[kQueryTile];
  const int n_chunks = (row_bytes + kChunk - 1) / kChunk;
  const int qstride = query_stride(row_bytes);
  unsigned char* qt = smem;                           // [kQueryTile][qstride]
  unsigned char* ring = smem + kQueryTile * qstride;  // [kStages][kTileRows][kChunk + kRowPad]
  const int q0 = blockIdx.y * kQueryTile, qn = min(kQueryTile, nq - q0);
  {
    const int stride = gridDim.x * gridDim.y * kScoreThreads;
    for (int i = (blockIdx.y * gridDim.x + blockIdx.x) * kScoreThreads + threadIdx.x; i < n_zero;
         i += stride)
      zero[i] = 0;
  }

  // the CTA's items: chunk c of its i-th tile, blockIdx.x + i * gridDim.x, is
  // item i * n_chunks + c and lives in ring stage item % kStages
  const int n_tiles = (n + kTileRows - 1) / kTileRows;
  const int my_tiles = (int)blockIdx.x < n_tiles ? (n_tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int n_items = my_tiles * n_chunks;
  // every call commits a copy group, empty or not, so waiting for all but
  // the newest kStages - 2 groups makes the current item arrive
  auto copy = [&](int item) {
    if (item < n_items) {
      const int tile = blockIdx.x + (item / n_chunks) * gridDim.x;
      const int c0 = (item % n_chunks) * kChunk;
      unsigned char* st = ring + (item % kStages) * kStageBytes;
#pragma unroll
      for (int j = 0; j < kTileRows * (kChunk / 16) / kScoreThreads; ++j) {
        const int i = threadIdx.x + j * kScoreThreads;
        const int r = i / (kChunk / 16), b = (i % (kChunk / 16)) * 16;
        const int row = tile * kTileRows + r;
        const bool ok = row < n && c0 + b < row_bytes;
        cp_async16(st + r * (kChunk + kRowPad) + b,
                   ok ? corpus + (size_t)row * row_bytes + c0 + b : corpus, ok);
      }
    }
    cp_async_commit();
  };
  for (int s = 0; s < kStages - 1; ++s) copy(s);  // in flight while the queries load
  load_queries<kInt8>(q, q0, qn, d, qt, qstride, qscale);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // ldmatrix rows: A, query (lane & 15) at byte (lane >> 4) * 16 of a k-step;
  // B, corpus row 16 warp + (lane & 7) at byte (lane >> 3) * 16 of two k-steps
  const unsigned char* a_at = qt + (lane & 15) * qstride + (lane >> 4) * 16;
  const int b_at = (warp * 16 + (lane & 7)) * (kChunk + kRowPad) + (lane >> 3) * 16;
  Acc acc[2][4] = {};
  for (int item = 0; item < n_items; ++item) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // the item has arrived, and every warp is done with item - 1's stage
    copy(item + kStages - 1);
    const int ch = item % n_chunks;
    const unsigned char* st = ring + (item % kStages) * kStageBytes + b_at;
    const unsigned char* at = a_at + ch * kChunk;
#pragma unroll
    for (int kk = 0; kk < kChunk; kk += 64) {
      uint32_t a0[4], a1[4], b0[4], b1[4];
      ldmatrix_x4(a0, at + kk);
      ldmatrix_x4(a1, at + kk + 32);
      ldmatrix_x4(b0, st + kk);
      ldmatrix_x4(b1, st + 8 * (kChunk + kRowPad) + kk);
      mma(acc[0], a0, b0[0], b0[1]);
      mma(acc[1], a0, b1[0], b1[1]);
      mma(acc[0], a1, b0[2], b0[3]);
      mma(acc[1], a1, b1[2], b1[3]);
    }
    if (ch == n_chunks - 1) {
      const int row0 = (blockIdx.x + (item / n_chunks) * gridDim.x) * kTileRows + warp * 16 + 2 * t;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = row0 + 8 * nt + e;
          if (row >= n) continue;
          const bool ok = valid[row] != 0;
          const float rs = kInt8 ? row_scale[row] : 1.0f;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int qi = g + 8 * h;
            if (qi >= qn) continue;
            const Acc s = acc[nt][2 * h + e];
            // b: (s * q_scale) * row_scale, the order of _fused_kernel_int8
            const float v = kInt8 ? __fmul_rn(__fmul_rn((float)s, qscale[qi]), rs) : (float)s;
            scores[(size_t)(q0 + qi) * n + row] = ok ? v : kNegInf;
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[nt][i] = 0;
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the CTA (the tail's groups are empty)
}

// ---- stage 2: the radix select ---------------------------------------------
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

// Keys of a and b: the score rows of the score pass, the mask already in them.
struct RowKeys {
  const float* scores;
  int n;
  struct Row {
    const float* s;
    __device__ __forceinline__ u64 operator()(int i) const { return make_key(s[i], i); }
  };
  __device__ Row row(int b) const { return Row{scores + (size_t)b * n}; }
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
    if (digit >= 0) atomicAdd(&h[digit], 1);
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

// k <= kSortMax: one CTA a row sorts the winners above T in shared memory
// (a thread for each compare-exchange, up to 1,024).
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
    // a thread for each compare-exchange of a stage: fewer warps at each barrier
    const int threads = len / 2 < 32 ? 32 : len / 2 < kSortThreads ? len / 2 : kSortThreads;
    select_sort<<<nq, threads, (size_t)len * sizeof(u64), s>>>(sel, k, vals, idx);
  } else {
    select_rank<<<dim3((k + kRankWinners - 1) / kRankWinners, nq), kRankThreads, 0, s>>>(
        sel, k, vals, idx);
  }
  return (int)cudaGetLastError();
}

// u64 entries of a's and b's score rows [nq][n] (f32), which precede the
// select's scratch.
size_t score_entries(int nq, int n) { return ((size_t)nq * n + 1) / 2; }

bool bad_cosine(const void* q, const void* corpus, int nq, int n, int k, int row_bytes) {
  return nq < 1 || nq > 65535 || n < 1 || k < 1 || k > n || row_bytes < 16 ||
         row_bytes % 16 != 0 || row_bytes > kMaxRowBytes ||
         (((uintptr_t)q | (uintptr_t)corpus) & 15) != 0;
}

// CTAs of the score pass an SM at this row width (0 on an error).
template <bool kInt8>
int score_ctas_per_sm(int row_bytes) {
  int occ = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, cosine_scores<kInt8>, kScoreThreads,
                                                    score_smem(row_bytes)) != cudaSuccess)
    return 0;
  return occ;
}

// The score pass over a persistent grid (the CTAs that fit on the card,
// split over the query groups), then the select over its score rows.
template <bool kInt8>
int launch_cosine(const void* q, const void* corpus, const void* row_scale, const void* valid,
                  int nq, int n, int d, int k, void* part, void* zero, void* vals, void* idx,
                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int row_bytes = kInt8 ? d : 2 * d;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int occ = score_ctas_per_sm<kInt8>(row_bytes);
  if (occ < 1) return (int)cudaErrorInvalidConfiguration;
  const int groups = (nq + kQueryTile - 1) / kQueryTile;
  const int n_tiles = (n + kTileRows - 1) / kTileRows;
  const int ctas = sms * occ / groups;
  const int gx = ctas < 1 ? 1 : ctas < n_tiles ? ctas : n_tiles;
  float* scores = (float*)part;
  cosine_scores<kInt8><<<dim3(gx, groups), kScoreThreads, score_smem(row_bytes), s>>>(
      (const float*)q, (const unsigned char*)corpus, (const float*)row_scale,
      (const uint8_t*)valid, nq, n, d, row_bytes, scores, (int*)zero, nq * kZeroInts);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return select_topk(RowKeys{scores, n}, nq, n, k, (u64*)part + score_entries(nq, n),
                     (int*)zero, (float*)vals, (int*)idx, s);
}

template <class K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

extern "C" {

// Sets the dynamic shared memory each top-k kernel may take on the current
// device (above the default 48 KB only after this call); called once, when
// the library is loaded.
int cs_topk_init() {
  cudaError_t e = allow_smem(cosine_scores<false>, (int)score_smem(kMaxRowBytes));
  if (e == cudaSuccess) e = allow_smem(cosine_scores<true>, (int)score_smem(kMaxRowBytes / 2));
  if (e == cudaSuccess) e = allow_smem(select_sort, kSortMax * (int)sizeof(u64));
  return (int)e;
}

// u64 entries of scratch the top-k entry points need: zeroed == 0, the
// scratch that needs no initialisation (score_rows: a's and b's score rows
// [nq][n] before the select's scratch; 0 for cs_scores_topk); zeroed == 1,
// the select's histograms and counters (c's caller zeroes them, a's and b's
// score pass does).
long long cs_scratch_entries(int nq, int n, int k, int score_rows, int zeroed) {
  if (zeroed) return ((long long)nq * kZeroInts + 1) / 2;
  return (long long)((score_rows ? score_entries(nq, n) : 0) + select_entries(nq, n, k));
}

// CTAs of a's (int8 == 0) or b's score pass an SM at width d, as launched.
int cs_cosine_ctas_per_sm(int int8, int d) {
  return int8 ? score_ctas_per_sm<true>(d) : score_ctas_per_sm<false>(2 * d);
}

const char* cs_error_string(int err) {
  if (err == kErrBadArg) return "invalid argument to a kernel entry point";
  return cudaGetErrorString((cudaError_t)err);
}

// Kernel a: q f32 [nq, d] (rounded to bf16 in the kernel), corpus bf16 [n,
// d], valid u8 [n]; `part` and `zero` as cs_scratch_entries(nq, n, k, 1,
// 0 / 1) give them (`zero` need not be zeroed).
int cs_cosine_topk_bf16(const void* q, const void* corpus, const void* valid, int nq, int n,
                        int d, int k, void* part, void* zero, void* vals, void* idx,
                        void* stream) {
  if (bad_cosine(q, corpus, nq, n, k, 2 * d) || d < 8) return kErrBadArg;
  return launch_cosine<false>(q, corpus, nullptr, valid, nq, n, d, k, part, zero, vals, idx,
                              stream);
}

// Kernel b: q f32 [nq, d] (quantized in the kernel), corpus int8 [n, d] with
// row_scale f32 [n]; the rest as for kernel a.
int cs_cosine_topk_int8(const void* q, const void* corpus, const void* row_scale,
                        const void* valid, int nq, int n, int d, int k, void* part, void* zero,
                        void* vals, void* idx, void* stream) {
  if (bad_cosine(q, corpus, nq, n, k, d) || d > kMaxRowBytes / 2) return kErrBadArg;
  return launch_cosine<true>(q, corpus, row_scale, valid, nq, n, d, k, part, zero, vals, idx,
                             stream);
}

// Kernel c: the radix select over nb rows of n scores; `part` and `zero` as
// cs_scratch_entries(nb, n, k, 0, 0 / 1) give them, `zero` zeroed.
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
