// Encoder attention kernels for Hopper (sm_90a), bound to Python via ctypes.
//
// Replaces the three Pallas attention kernels of the JAX package:
//   cs_attention_full   <- pallas_attention_full (codesearch_tpu/ops/attention.py,
//                          _full_kernel)                                kernel d
//   cs_attention_flash  <- pallas_attention (same file, _flash_kernel)    kernel e
//   cs_attention_packed <- packed_attention (examples/ablate_head_packing.py,
//                          _packed_kernel)                              kernel f
// and adds a fourth that replaces an XLA composition, not a Pallas kernel:
//   cs_attention_window <- reference_attention(window=w) (same file)     windowed d
// All compute non-causal attention over a [B, H, S, Dh] bf16 batch with a
// [B, S] padding mask added to the scores as (1 - m) * -1e30 (never -inf, so
// a fully masked row stays finite: it averages V). Dh is 32 or 64 for d and
// e, 32 for f. Q, K, V and O may be strided views (last dimension
// contiguous, other strides multiples of 8 elements), so the encoder hands
// over its fused QKV projection without copies and takes O in [B, S, H, Dh]
// order. Query rows past S are computed on zeros and not stored. The
// windowed kernel takes what d takes and a window.
//
// What bounds them on an H100: per (batch, head) the score matrix is S x S,
// 2*S*S*Dh flops each for QK^T and PV, against 3*S*Dh*2 bytes of Q, K, V.
// At bge-small's S=512, Dh=32 that is ~170 flops per byte of K and V read,
// below the card's ~295 bf16 flops per byte, so bytes bound them (about
// 0.09 ms at B=256, H=12 on chip_smoke's ragged masks). What keeps them near
// that is never writing the S x S scores to device memory, feeding both
// products to the tensor cores (mma.sync m16n8k16, bf16 in, f32 accumulate)
// and keeping the scalar work per score small: at Dh=32 a score costs the
// tensor cores 2 * 32 flops a product, 192 over the three products of d and
// f, about as long as 5-10 FP32 instructions on the SM's CUDA cores, so the
// exp and the bookkeeping around each score decide the time.
//
// d and f: one two-sweep body (attention_two_sweep<DH, P, W, kNormaliseFirst>).
//   Both compute softmax exactly in two sweeps over the keys, because both
//   round p to bf16 before p @ V against the exact row max: _full_kernel casts
//   p = exp(s - max) and divides by the f32 sum after the product (d:
//   P = 1, Dh 32 or 64); _packed_kernel divides first, p = e / max(sum,
//   1e-30), then casts (f: P = 2 or 4 heads of one head group, Dh = 32; the
//   TPU kernel's block-diagonal packing only filled the MXU and is not
//   carried over). A CTA owns one batch row, P heads and W * 16 query rows;
//   each head has its own W warps of 16 rows, holding them as mma
//   A-fragments. Sweep 1 takes the row max (f: and the running sum of
//   exp); sweep 2 forms p, rounds it to bf16 and accumulates p @ V in f32
//   (d: and the f32 sum of p). The epilogue divides by the sum (d) or by 1
//   (f, already normalised), rounds to bf16 and stores. Three costs decide
//   the time, and this is what the body does about each:
//   - Work on padding keys. The CTA reads its mask row once, into the bias
//     of every key in shared memory, and takes n_keys = 1 + its last nonzero
//     key, or S for a fully masked row (which must average all S values of
//     V). Both sweeps run only over the 64-key tiles below n_keys, with K and
//     V zero-filled, not read, at and past n_keys. That is exact for 0/1
//     masks, holes included: beside a valid key a key of bias -1e30 adds
//     exactly 0 to the max, the sum and p @ V.
//   - Staging. K (sweep 1), then K and V (sweep 2), stream through a
//     double-buffered ring of 64-key tiles with cp.async (zero-fill past
//     n_keys), overlapped with the previous tile's compute. Sweep 1 also
//     loads V of the last two tiles and sweep 2 walks the tiles backwards,
//     starting on the two still resident, so a row of up to 128 keys reads
//     K and V once. K and V sit as [key][Dh + 8] rows (the 8 bf16 of
//     padding put the eight rows of a fragment load in eight bank groups);
//     the B-fragments of QK^T come from ldmatrix, those of PV from
//     ldmatrix.trans, so nothing is transposed by scalar stores. Shared
//     memory is 4 * P * 64 * (Dh + 8) * 2 bytes plus 4 bytes a key for the
//     bias: at S=512 22 KB for d at Dh=32, 38 KB at Dh=64, 82 KB for f at
//     P=4. No global load waits inside the tile loops.
//   - Scalar work per score. Scores stay in the log2 domain: scale * log2(e)
//     is one constant, the mask bias is kept in shared memory already times
//     log2(e) (keys past S: -inf, which exp2 turns into 0 and which never
//     wins a max: key 0 is always present and finite), so an exponent is
//     one FMA, one subtraction of the row max and one ex2.approx.ftz, and no
//     per-element bounds compare remains. Each thread keeps the max (f: and
//     sum) of its own keys across tiles; the four threads of a row merge
//     once, after sweep 1. f pays a second exp per score (sweep 1's sum) and
//     a multiply by the reciprocal of the sum.
//   W (warps, so 16-row slices, per head) was chosen on an H100 with
//   examples/attention_variants.py (ptxas registers and spills, the CTAs an
//   SM they allow, and times at W = 2, 4, 8; PERF.md section 6). d takes
//   W = 4: 80 registers a thread, 6 CTAs (24 warps) an SM at Dh=32, 132
//   registers and 3 CTAs at Dh=64; W = 8 ties at S=512 and loses at S=64,
//   the encoder's common bucket, where half its warps idle. f at P = 4 takes
//   W = 8: 1,024 threads held to 64 registers (36 bytes spilled) give 32
//   warps an SM, where W = 4 needs 101 registers and fits one 512-thread CTA
//   (16 warps). f at P = 2 takes W = 4: 80 registers (8 bytes spilled), 3
//   CTAs (24 warps) an SM.
//
// e (flash): one sweep over the keys with _flash_kernel's online softmax
//   (attention_flash<DH, W>): a CTA owns one (batch row, head) and W * 16
//   query rows, each warp 16 of them as mma A-fragments. It takes the pieces
//   of d's body: K and V stream through the same double-buffered ring of
//   64-key cp.async tiles (copy_tile, zero-filled at and past n_keys), the
//   B-fragments of QK^T come from ldmatrix and those of PV from
//   ldmatrix.trans on [key][Dh + 8] rows, and scores live in the log2 domain
//   (one FMA with the bias, one subtraction of the running max, one
//   ex2.approx a score). What differs from d:
//   - One sweep: per 64-key tile the running max of each row (the four
//     threads of a row merge it every tile, since all four scale their part
//     of p @ V by it), alpha = 2^(old - new max), the running sum (kept per
//     thread, merged once at the end) and p @ V with p near f32: p = hi + lo,
//     both bf16, two products (_flash_kernel multiplies p and V in f32).
//   - The bias cannot sit whole in shared memory (e takes any S), so it
//     streams with its tile through the ring: one thread a key loads the
//     next tile's mask while the current tile is computed and writes its
//     bias, times log2(e) and -inf past S, after it. n_keys = 1 + the row's
//     last valid key comes from one scan of the mask row backwards from its
//     end, in steps of 4 keys a thread, stopping at the first step that
//     holds a valid key (all S for a fully masked row). Tiles past n_keys are
//     skipped: exact for an online softmax too, since beside a valid key a
//     key of bias -1e30 gives p = 0 and alpha = 1.
//   - The running max starts at _flash_kernel's m0 = -1e30 taken to the log2
//     domain exactly as a masked key's bias is (-1e30 * log2(e), one
//     rounding), so a fully masked row sees x - max = 0 for every key, p = 1
//     and alpha = 1, and averages all S values of V, as the reference does.
//   W was chosen on an H100 with examples/attention_variants.py (PERF.md
//   section 6): W = 4, 110 registers and 4 CTAs (16 warps) an SM at Dh=32,
//   142 and 3 CTAs at Dh=64. W = 8 is within 3% at Dh=32, where it spills,
//   and 6% slower at Dh=64, where one CTA fits an SM.
//
// cs_attention_window (attention_window_band<DH, W>): sliding-window
//   attention, each query row i over the keys j with |i - j| <= window / 2
//   (ModernBERT's local layers). It replaces no Pallas kernel: the JAX
//   package composes windowed attention in XLA (reference_attention with a
//   window), and so did the port, at [B, H, S, S] f32 scores a layer. What
//   bounds it is bytes: at a window of 128 a query row scores at most 129
//   keys, so per (batch, head) the work is about 2 * 129 * S * Dh flops a
//   product against the same 3 * S * Dh * 2 bytes as d. It keeps d's
//   numerics and pieces (two exact sweeps, p rounded to bf16 before p @ V,
//   the f32 sum divided after; load_q, copy_tile, score_tile_ldm, store_o),
//   and differs in what it visits:
//   - A CTA owns one (batch row, head) and W * 16 query rows [q_lo, q_hi)
//     and streams only the 64-key tiles that meet [q_lo - w/2, q_hi - 1 +
//     w/2], clipped at n_keys (1 + the row's last valid key, S for a fully
//     masked row), through d's double-buffered ring (at w = 128: three
//     tiles, K and V read once each but the first). The mask bias of those
//     tiles' keys sits in shared memory, as d's does for the whole row.
//   - Each warp takes its 16 rows against 16 keys at a time: a block wholly
//     outside the band of every row is skipped (both products), one wholly
//     inside runs as d's, and an edge block sets the scores outside the band
//     to -inf (sweep 1) and their p to 0 (sweep 2). The tests are
//     warp-uniform: ldmatrix and mma need the whole warp.
//   - A row whose band holds no valid key (a padding row far past the last
//     valid one) keeps a max of at most a masked key's bias; its output is
//     written as 0 (acc / inf), never 0 / 0: the next layer weights that
//     padding key by 0, and 0 * NaN would be NaN.
//   W = 4, as d.
//
// Every kernel launches on the caller's stream and allocates nothing; every
// entry point returns the CUDA error of its launch (0 on success, -1 for a
// bad argument).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kMaskNeg = -1.0e30f;  // _NEG_INF of attention.py
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kPad = 8;        // bf16 of padding per shared-memory row
constexpr int kKeys = 64;      // keys per streamed tile of d, e and f
// warps (16 query rows each) per head: d, f at P = 2, f at P = 4, e
constexpr int kFullWarps = 4;
constexpr int kPackedWarpsP2 = 4;
constexpr int kPackedWarpsP4 = 8;
constexpr int kFlashWarps = 4;
constexpr int kWindowWarps = 4;
constexpr int kPackedDh = 32;
// a row max below this (log2 domain) saw no valid key: valid scores are
// finite and small, a masked key's bias is -1e30 * log2(e)
constexpr float kNoValidKey = -1.0e29f;
constexpr int kErrBadArg = -1;

// Element strides of the [B, H, S, Dh] views (the Dh stride is 1).
struct Layout {
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
};

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// D += A (16x16, row) * B (16x8, col); bf16 inputs, f32 accumulators.
// Fragments (g = lane / 4, t = lane % 4): a0 (g, 2t..2t+1), a1 (g+8, 2t..),
// a2 (g, 2t+8..), a3 (g+8, 2t+8..); b0 (k 2t..2t+1, n g), b1 (k 2t+8.., n g);
// d0 d1 (g, 2t..2t+1), d2 d3 (g+8, 2t..2t+1).
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float row_max4(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float row_sum4(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// 2^x, approximate (2 ulp), subnormal results flushed to 0; 2^-inf = 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The warp's 16 query rows [row0, row0 + 16) as A-fragments, zeros past S.
template <int DH>
__device__ __forceinline__ void load_q(const bf16* qg, long long qs, int row0, int S, int g,
                                       int t, uint32_t (&qa)[DH / 16][4]) {
  const int ra = row0 + g, rb = row0 + g + 8;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    qa[kk][0] = ra < S ? ld32(qg + ra * qs + c) : 0u;
    qa[kk][1] = rb < S ? ld32(qg + rb * qs + c) : 0u;
    qa[kk][2] = ra < S ? ld32(qg + ra * qs + c + 8) : 0u;
    qa[kk][3] = rb < S ? ld32(qg + rb * qs + c + 8) : 0u;
  }
}

__device__ __forceinline__ float mask_bias(float m) {
  return __fmul_rn(__fsub_rn(1.0f, m), kMaskNeg);
}

// Writes the warp's rows of O: acc / denom per row, rounded to bf16.
template <int DH>
__device__ __forceinline__ void store_o(bf16* og, long long os, int row0, int S, int g, int t,
                                        const float (&acc)[DH / 8][4], float da, float db) {
  const int ra = row0 + g, rb = row0 + g + 8;
#pragma unroll
  for (int nt = 0; nt < DH / 8; ++nt) {
    const int c = nt * 8 + 2 * t;
    if (ra < S)
      *reinterpret_cast<uint32_t*>(og + ra * os + c) =
          pack_bf16(__fdiv_rn(acc[nt][0], da), __fdiv_rn(acc[nt][1], da));
    if (rb < S)
      *reinterpret_cast<uint32_t*>(og + rb * os + c) =
          pack_bf16(__fdiv_rn(acc[nt][2], db), __fdiv_rn(acc[nt][3], db));
  }
}

// ---- d and f: one streamed two-sweep body ---------------------------------
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

// Four 8x8 bf16 tiles from shared memory, lane l naming row (l & 7) of tile
// (l >> 3); r[i] holds tile i's row g, columns 2t, 2t + 1.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// Four transposed 8x8 bf16 tiles: from [key][Dh + kPad] rows of V, lane l
// naming row (l & 15) at column (l >> 4) * 8, r0 r1 are the B-fragments
// (keys 0-7, 8-15) of one 8-wide column tile and r2 r3 those of the next.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// Raw scores q . k of the warp's 16 rows against keys [n0, n0 + 8) of a
// [key][DH + kPad] K tile; one ldmatrix.x4 gives the B-fragments of 32
// head dimensions (tile i: dimensions 8i..8i+7).
template <int DH>
__device__ __forceinline__ void score_tile_ldm(const uint32_t (&qa)[DH / 16][4], const bf16* ks,
                                               int n0, int lane, float (&c)[4]) {
  c[0] = c[1] = c[2] = c[3] = 0.0f;
  const bf16* kr = ks + (n0 + (lane & 7)) * (DH + kPad) + (lane >> 3) * 8;
#pragma unroll
  for (int kq = 0; kq < DH / 32; ++kq) {
    uint32_t kb[4];
    ldmatrix_x4(kb, kr + kq * 32);
    mma_16816(c, qa[2 * kq], kb[0], kb[1]);
    mma_16816(c, qa[2 * kq + 1], kb[2], kb[3]);
  }
}

__host__ __device__ __forceinline__ int keys_padded(int S) {
  return (S + kKeys - 1) / kKeys * kKeys;
}

template <int DH, int P>
size_t two_sweep_smem(int S) {
  return (size_t)4 * P * kKeys * (DH + kPad) * sizeof(bf16) +
         (size_t)keys_padded(S) * sizeof(float);
}

// Queues the copy of keys [k0, k0 + kKeys) of the P heads' K (and V) into
// one buffer, zeros at and past n_copy.
template <int DH, int P, int NT>
__device__ __forceinline__ void copy_tile(const bf16* kg, const bf16* vg, const Layout& L,
                                          int k0, int n_copy, bf16* kd, bf16* vd, bool with_v) {
  constexpr int kChunks = DH / 8;  // 16-byte chunks per key row
  for (int i = threadIdx.x; i < P * kKeys * kChunks; i += NT) {
    const int c = (i % kChunks) * 8;
    const int r = (i / kChunks) % kKeys;
    const int p = i / (kChunks * kKeys);
    const bool ok = k0 + r < n_copy;
    const long long key = ok ? k0 + r : 0;
    const int at = (p * kKeys + r) * (DH + kPad) + c;
    cp_async16(kd + at, kg + p * L.kh + key * L.ks + c, ok);
    if (with_v) cp_async16(vd + at, vg + p * L.vh + key * L.vs + c, ok);
  }
}

template <int DH, int P, int W, bool kNormaliseFirst>
__global__ void __launch_bounds__(P * W * 32)
attention_two_sweep(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const float* __restrict__ mask,
                    bf16* __restrict__ o, Layout L, int G, int S, int n_qblocks,
                    float scale_log2) {
  constexpr int NT = P * W * 32;
  constexpr int kTile = P * kKeys * (DH + kPad);  // bf16 of one K (or V) buffer
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* kbuf = reinterpret_cast<bf16*>(smem);                // [2][P][kKeys][DH + kPad]
  bf16* vbuf = kbuf + 2 * kTile;                             // [2][P][kKeys][DH + kPad]
  float* bias = reinterpret_cast<float*>(vbuf + 2 * kTile);  // [keys_padded(S)]
  __shared__ int last_of_warp[NT / 32];
  const int qb = blockIdx.x % n_qblocks, bg = blockIdx.x / n_qblocks;
  const int b = bg / G, h0 = (bg % G) * P;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int p = warp / W;  // the warp's head within the group
  const int row0 = qb * (W * 16) + (warp % W) * 16;
  const bool active = row0 < S;  // warp-uniform; idle warps still copy and join barriers
  const int head_rows = p * kKeys * (DH + kPad);  // this head's K/V rows in a buffer
  const bf16* kg = k + b * L.kb + h0 * L.kh;
  const bf16* vg = v + b * L.vb + h0 * L.vh;
  const float* mrow = mask + (size_t)b * S;

  uint32_t qa[DH / 16][4];
  load_q<DH>(q + b * L.qb + (h0 + p) * L.qh, L.qs, row0, S, g, t, qa);

  // the mask bias of every key in the log2 domain (-inf past S), and the
  // keys that count: up to the row's last valid one, all S if it has none
  int last = -1;
#pragma unroll 4
  for (int j = threadIdx.x; j < keys_padded(S); j += NT) {
    float bj = -INFINITY;
    if (j < S) {
      const float m = mrow[j];
      if (m != 0.0f) last = j;
      bj = __fmul_rn(mask_bias(m), kLog2e);
    }
    bias[j] = bj;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) last = max(last, __shfl_xor_sync(0xffffffffu, last, off));
  if (lane == 0) last_of_warp[warp] = last;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < NT / 32; ++w) last = max(last, last_of_warp[w]);
  const int n_keys = last < 0 ? S : last + 1;
  const int n_tiles = (n_keys + kKeys - 1) / kKeys;

  // Tile i lives in buffer i & 1 in both sweeps. Sweep 1 also loads V of the
  // last two tiles, and sweep 2 walks the tiles backwards, so it starts on
  // the two that are still resident (a row of up to 128 keys reads K and V
  // once). Every iteration commits a copy group, empty or not, so waiting
  // for all but the newest group is what makes the current tile arrive.
  copy_tile<DH, P, NT>(kg, vg, L, 0, n_keys, kbuf, vbuf, n_tiles <= 2);
  cp_async_commit();

  // sweep 1: per thread, the max over its keys of the scores in the log2
  // domain (f: and the sum of 2^(x - max), rescaled as the max grows), in
  // steps of 32 keys
  float ma = -FLT_MAX, mb = -FLT_MAX, la = 0.0f, lb = 0.0f;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int buf = tile & 1;
    if (tile + 1 < n_tiles)
      copy_tile<DH, P, NT>(kg, vg, L, (tile + 1) * kKeys, n_keys, kbuf + (buf ^ 1) * kTile,
                           vbuf + (buf ^ 1) * kTile, tile + 1 >= n_tiles - 2);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (active) {
      const float* bs = bias + tile * kKeys;
      const bf16* ks = kbuf + buf * kTile + head_rows;
#pragma unroll
      for (int k32 = 0; k32 < kKeys; k32 += 32) {
        float x[4][4];
        float ca = -FLT_MAX, cb = -FLT_MAX;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          score_tile_ldm<DH>(qa, ks, k32 + 8 * j, lane, x[j]);
          const float2 bj = *reinterpret_cast<const float2*>(bs + k32 + 8 * j + 2 * t);
          x[j][0] = fmaf(x[j][0], scale_log2, bj.x);
          x[j][1] = fmaf(x[j][1], scale_log2, bj.y);
          x[j][2] = fmaf(x[j][2], scale_log2, bj.x);
          x[j][3] = fmaf(x[j][3], scale_log2, bj.y);
          ca = fmaxf(ca, fmaxf(x[j][0], x[j][1]));
          cb = fmaxf(cb, fmaxf(x[j][2], x[j][3]));
        }
        const float na = fmaxf(ma, ca), nb = fmaxf(mb, cb);
        if (kNormaliseFirst) {
          float ra = 0.0f, rb = 0.0f;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            ra += ex2(x[j][0] - na) + ex2(x[j][1] - na);
            rb += ex2(x[j][2] - nb) + ex2(x[j][3] - nb);
          }
          la = la * ex2(ma - na) + ra;
          lb = lb * ex2(mb - nb) + rb;
        }
        ma = na;
        mb = nb;
      }
    }
    __syncthreads();  // this buffer is consumed before the next copy into it
  }
  // the four threads of a row merge: the max, and f's sum rescaled to it
  {
    const float ra = row_max4(ma), rb = row_max4(mb);
    if (kNormaliseFirst) {
      la = row_sum4(la * ex2(ma - ra));
      lb = row_sum4(lb * ex2(mb - rb));
    }
    ma = ra;
    mb = rb;
  }

  // sweep 2, last tile first: p = 2^(x - max) (f: times the reciprocal of
  // the sum), rounded to bf16, and p @ V in f32 (d: and the f32 sum of p)
  const float ia = kNormaliseFirst ? __frcp_rn(fmaxf(la, 1e-30f)) : 1.0f;
  const float ib = kNormaliseFirst ? __frcp_rn(fmaxf(lb, 1e-30f)) : 1.0f;
  float sa = 0.0f, sb = 0.0f;
  float acc[DH / 8][4];
#pragma unroll
  for (int nt = 0; nt < DH / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;
  for (int tile = n_tiles - 1; tile >= 0; --tile) {
    const int buf = tile & 1;
    if (tile >= 1 && tile - 1 < n_tiles - 2)  // not resident from sweep 1
      copy_tile<DH, P, NT>(kg, vg, L, (tile - 1) * kKeys, n_keys, kbuf + (buf ^ 1) * kTile,
                           vbuf + (buf ^ 1) * kTile, true);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (active) {
      const float* bs = bias + tile * kKeys;
      const bf16* ks = kbuf + buf * kTile + head_rows;
      const bf16* vs = vbuf + buf * kTile + head_rows;
#pragma unroll
      for (int kc = 0; kc < kKeys; kc += 16) {
        float pr[2][4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          score_tile_ldm<DH>(qa, ks, kc + 8 * half, lane, pr[half]);
          const float2 bj = *reinterpret_cast<const float2*>(bs + kc + 8 * half + 2 * t);
          float e[4];
          e[0] = ex2(fmaf(pr[half][0], scale_log2, bj.x) - ma);
          e[1] = ex2(fmaf(pr[half][1], scale_log2, bj.y) - ma);
          e[2] = ex2(fmaf(pr[half][2], scale_log2, bj.x) - mb);
          e[3] = ex2(fmaf(pr[half][3], scale_log2, bj.y) - mb);
          if (kNormaliseFirst) {
            e[0] *= ia;
            e[1] *= ia;
            e[2] *= ib;
            e[3] *= ib;
          } else {
            sa += e[0] + e[1];
            sb += e[2] + e[3];
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) pr[half][i] = e[i];
        }
        const uint32_t pa[4] = {pack_bf16(pr[0][0], pr[0][1]), pack_bf16(pr[0][2], pr[0][3]),
                                pack_bf16(pr[1][0], pr[1][1]), pack_bf16(pr[1][2], pr[1][3])};
#pragma unroll
        for (int np = 0; np < DH / 16; ++np) {
          uint32_t vb[4];
          ldmatrix_x4_trans(vb, vs + (kc + (lane & 15)) * (DH + kPad) + np * 16 + (lane >> 4) * 8);
          mma_16816(acc[2 * np], pa, vb[0], vb[1]);
          mma_16816(acc[2 * np + 1], pa, vb[2], vb[3]);
        }
      }
    }
    __syncthreads();
  }
  if (!active) return;
  // d divides by the f32 sum of p; f's p is normalised already (x / 1 = x)
  const float da = kNormaliseFirst ? 1.0f : row_sum4(sa);
  const float db = kNormaliseFirst ? 1.0f : row_sum4(sb);
  store_o<DH>(o + b * L.ob + (h0 + p) * L.oh, L.os, row0, S, g, t, acc, da, db);
}

// ---- e: one streamed sweep, online softmax ----------------------------------
// The bias of key j in the log2 domain: the mask's (1 - m) * -1e30 times
// log2(e), -inf past S.
__device__ __forceinline__ float key_bias(const float* mrow, int j, int S) {
  return j < S ? __fmul_rn(mask_bias(mrow[j]), kLog2e) : -INFINITY;
}

template <int DH, int W>
__global__ void __launch_bounds__(W * 32)
attention_flash(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const float* __restrict__ mask,
                bf16* __restrict__ o, Layout L, int H, int S, int n_qblocks, float scale_log2) {
  constexpr int NT = W * 32;
  constexpr int kTile = kKeys * (DH + kPad);  // bf16 of one K (or V) buffer
  static_assert(NT >= kKeys, "one thread a key stages the bias");
  __shared__ __align__(16) bf16 kbuf[2 * kTile];  // [2][kKeys][DH + kPad]
  __shared__ __align__(16) bf16 vbuf[2 * kTile];
  __shared__ __align__(16) float bias[2 * kKeys];
  __shared__ int last_of_warp[2][W];
  const int qb = blockIdx.x % n_qblocks, bh = blockIdx.x / n_qblocks;
  const int b = bh / H, h = bh % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = qb * (W * 16) + warp * 16;
  const bool active = row0 < S;  // warp-uniform; idle warps still copy and join barriers
  const bf16* kg = k + b * L.kb + h * L.kh;
  const bf16* vg = v + b * L.vb + h * L.vh;
  const float* mrow = mask + (size_t)b * S;

  uint32_t qa[DH / 16][4];
  load_q<DH>(q + b * L.qb + h * L.qh, L.qs, row0, S, g, t, qa);

  // the keys that count: up to the row's last valid one, all S if it has
  // none; the scan walks back from the row's end and stops at the first
  // step of 4 * NT keys that holds a valid one
  int last = -1;
  for (int end = S, step = 0; end > 0; end -= 4 * NT, ++step) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = end - 4 * NT + j * NT + (int)threadIdx.x;
      if (i >= 0 && mrow[i] != 0.0f) last = max(last, i);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      last = max(last, __shfl_xor_sync(0xffffffffu, last, off));
    if (lane == 0) last_of_warp[step & 1][warp] = last;
    __syncthreads();
#pragma unroll
    for (int w = 0; w < W; ++w) last = max(last, last_of_warp[step & 1][w]);
    if (last >= 0) break;  // uniform: every thread holds the block's maximum
  }
  const int n_keys = last < 0 ? S : last + 1;
  const int n_tiles = (n_keys + kKeys - 1) / kKeys;

  // tile i lives in buffer i & 1; every iteration commits a copy group, empty
  // or not, so waiting for all but the newest makes the current tile arrive
  copy_tile<DH, 1, NT>(kg, vg, L, 0, n_keys, kbuf, vbuf, true);
  cp_async_commit();
  if (threadIdx.x < kKeys) bias[threadIdx.x] = key_bias(mrow, threadIdx.x, S);

  // _flash_kernel's m0 = -1e30 in the log2 domain, rounded as a masked
  // key's bias is, and l0 = 0; the sums are per thread until the end
  const float m0 = __fmul_rn(kMaskNeg, kLog2e);
  float ma = m0, mb = m0, la = 0.0f, lb = 0.0f;
  float acc[DH / 8][4];
#pragma unroll
  for (int nt = 0; nt < DH / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int buf = tile & 1;
    const bool more = tile + 1 < n_tiles;
    float next_bias = 0.0f;
    if (more) {
      copy_tile<DH, 1, NT>(kg, vg, L, (tile + 1) * kKeys, n_keys, kbuf + (buf ^ 1) * kTile,
                           vbuf + (buf ^ 1) * kTile, true);
      if (threadIdx.x < kKeys) next_bias = key_bias(mrow, (tile + 1) * kKeys + threadIdx.x, S);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (active) {
      const bf16* ks = kbuf + buf * kTile;
      const bf16* vs = vbuf + buf * kTile;
      const float* bs = bias + buf * kKeys;
      float x[kKeys / 8][4];
      float na = ma, nb = mb;
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j) {
        score_tile_ldm<DH>(qa, ks, 8 * j, lane, x[j]);
        const float2 bj = *reinterpret_cast<const float2*>(bs + 8 * j + 2 * t);
        x[j][0] = fmaf(x[j][0], scale_log2, bj.x);
        x[j][1] = fmaf(x[j][1], scale_log2, bj.y);
        x[j][2] = fmaf(x[j][2], scale_log2, bj.x);
        x[j][3] = fmaf(x[j][3], scale_log2, bj.y);
        na = fmaxf(na, fmaxf(x[j][0], x[j][1]));
        nb = fmaxf(nb, fmaxf(x[j][2], x[j][3]));
      }
      na = row_max4(na);
      nb = row_max4(nb);
      const float alpha_a = ex2(ma - na), alpha_b = ex2(mb - nb);
      ma = na;
      mb = nb;
      la *= alpha_a;
      lb *= alpha_b;
#pragma unroll
      for (int nt = 0; nt < DH / 8; ++nt) {
        acc[nt][0] *= alpha_a;
        acc[nt][1] *= alpha_a;
        acc[nt][2] *= alpha_b;
        acc[nt][3] *= alpha_b;
      }
#pragma unroll
      for (int kc = 0; kc < kKeys / 16; ++kc) {
        // p of keys [16 kc, 16 kc + 16) as an A-fragment, split p = hi + lo
        float pv[4][2];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float* xs = x[2 * kc + half];
          pv[2 * half][0] = ex2(xs[0] - na);
          pv[2 * half][1] = ex2(xs[1] - na);
          pv[2 * half + 1][0] = ex2(xs[2] - nb);
          pv[2 * half + 1][1] = ex2(xs[3] - nb);
          la += pv[2 * half][0] + pv[2 * half][1];
          lb += pv[2 * half + 1][0] + pv[2 * half + 1][1];
        }
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const __nv_bfloat162 h2 = __floats2bfloat162_rn(pv[r][0], pv[r][1]);
          hi[r] = *reinterpret_cast<const uint32_t*>(&h2);
          lo[r] = pack_bf16(pv[r][0] - __low2float(h2), pv[r][1] - __high2float(h2));
        }
#pragma unroll
        for (int np = 0; np < DH / 16; ++np) {
          uint32_t vb[4];
          ldmatrix_x4_trans(vb, vs + (16 * kc + (lane & 15)) * (DH + kPad) + np * 16 +
                                    (lane >> 4) * 8);
          mma_16816(acc[2 * np], hi, vb[0], vb[1]);
          mma_16816(acc[2 * np], lo, vb[0], vb[1]);
          mma_16816(acc[2 * np + 1], hi, vb[2], vb[3]);
          mma_16816(acc[2 * np + 1], lo, vb[2], vb[3]);
        }
      }
    }
    // the next tile's bias into the buffer the previous tile has left
    if (more && threadIdx.x < kKeys) bias[(buf ^ 1) * kKeys + threadIdx.x] = next_bias;
    __syncthreads();  // this buffer is consumed before the next copy into it
  }
  if (!active) return;
  store_o<DH>(o + b * L.ob + h * L.oh, L.os, row0, S, g, t, acc,
              fmaxf(row_sum4(la), 1e-30f), fmaxf(row_sum4(lb), 1e-30f));
}

// ---- the windowed kernel: d's two sweeps over the band of keys -------------
// 64-key tiles an interval of W * 16 query rows widened by `half` on either
// side may touch, at most all of S's: the band's bias in shared memory.
__host__ __device__ __forceinline__ int band_tiles(int S, int rows, int half) {
  const int span = rows + 2 * half;
  const int touched = (span + kKeys - 2) / kKeys + 1;
  const int all = keys_padded(S) / kKeys;
  return touched < all ? touched : all;
}

template <int DH>
size_t window_smem(int S, int rows, int half) {
  return (size_t)4 * kKeys * (DH + kPad) * sizeof(bf16) +
         (size_t)band_tiles(S, rows, half) * kKeys * sizeof(float);
}

// Where 16 keys from kb lie against the band |j - i| <= half of the warp's
// 16 rows from row0: 0 outside every row's band, 1 inside every row's, 2 on
// its edge (warp-uniform).
__device__ __forceinline__ int band_block(int kb, int row0, int half) {
  const int lo = kb - (row0 + 15), hi = kb + 15 - row0;  // the block's range of j - i
  if (hi < -half || lo > half) return 0;
  return (lo >= -half && hi <= half) ? 1 : 2;
}

// Whether key j lies in row i's band.
__device__ __forceinline__ bool in_band(int j, int i, int half) {
  return abs(j - i) <= half;
}

template <int DH, int W>
__global__ void __launch_bounds__(W * 32)
attention_window_band(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const float* __restrict__ mask,
                      bf16* __restrict__ o, Layout L, int H, int S, int n_qblocks, int half,
                      float scale_log2) {
  constexpr int NT = W * 32;
  constexpr int kTile = kKeys * (DH + kPad);  // bf16 of one K (or V) buffer
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* kbuf = reinterpret_cast<bf16*>(smem);                // [2][kKeys][DH + kPad]
  bf16* vbuf = kbuf + 2 * kTile;                             // [2][kKeys][DH + kPad]
  float* bias = reinterpret_cast<float*>(vbuf + 2 * kTile);  // [the band's tiles][kKeys]
  __shared__ int last_of_warp[W];
  const int qb = blockIdx.x % n_qblocks, bh = blockIdx.x / n_qblocks;
  const int b = bh / H, h = bh % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q_lo = qb * (W * 16);
  const int row0 = q_lo + warp * 16;
  const int ra = row0 + g, rb = row0 + g + 8;
  const bool active = row0 < S;  // warp-uniform; idle warps still copy and join barriers
  const bf16* kg = k + b * L.kb + h * L.kh;
  const bf16* vg = v + b * L.vb + h * L.vh;
  const float* mrow = mask + (size_t)b * S;

  uint32_t qa[DH / 16][4];
  load_q<DH>(q + b * L.qb + h * L.qh, L.qs, row0, S, g, t, qa);

  // the keys that count: up to the row's last valid one, all S if it has none
  int last = -1;
  for (int j = threadIdx.x; j < S; j += NT)
    if (mrow[j] != 0.0f) last = j;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) last = max(last, __shfl_xor_sync(0xffffffffu, last, off));
  if (lane == 0) last_of_warp[warp] = last;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < W; ++w) last = max(last, last_of_warp[w]);
  const int n_keys = last < 0 ? S : last + 1;
  // the CTA's band [k_lo, k_hi), clipped at n_keys, as tiles t0 .. t0 + n_tiles - 1
  const int q_hi = min(S, q_lo + W * 16);
  const int k_lo = max(0, q_lo - half);
  const int k_hi = min(n_keys, q_hi + half);
  const int t0 = k_lo / kKeys;
  const int n_tiles = k_hi > k_lo ? (k_hi + kKeys - 1) / kKeys - t0 : 0;
  // the bias of the band's keys in the log2 domain, -inf past S (read after
  // the first barrier of sweep 1)
  for (int j = threadIdx.x; j < n_tiles * kKeys; j += NT) {
    const int key = t0 * kKeys + j;
    bias[j] = key < S ? __fmul_rn(mask_bias(mrow[key]), kLog2e) : -INFINITY;
  }

  // d's ring: tile i of the band in buffer i & 1, sweep 1 also loads V of
  // the last two tiles, sweep 2 walks back from them
  if (n_tiles > 0)
    copy_tile<DH, 1, NT>(kg, vg, L, t0 * kKeys, n_keys, kbuf, vbuf, n_tiles <= 2);
  cp_async_commit();

  // sweep 1: per thread, the max of its in-band scores (log2 domain)
  float ma = -FLT_MAX, mb = -FLT_MAX;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int buf = tile & 1;
    if (tile + 1 < n_tiles)
      copy_tile<DH, 1, NT>(kg, vg, L, (t0 + tile + 1) * kKeys, n_keys, kbuf + (buf ^ 1) * kTile,
                           vbuf + (buf ^ 1) * kTile, tile + 1 >= n_tiles - 2);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (active) {
      const float* bs = bias + tile * kKeys;
      const bf16* ks = kbuf + buf * kTile;
      const int key0 = (t0 + tile) * kKeys;
#pragma unroll
      for (int kc = 0; kc < kKeys; kc += 16) {
        const int where = band_block(key0 + kc, row0, half);
        if (where == 0) continue;
#pragma unroll
        for (int half8 = 0; half8 < 2; ++half8) {
          float x[4];
          score_tile_ldm<DH>(qa, ks, kc + 8 * half8, lane, x);
          const float2 bj = *reinterpret_cast<const float2*>(bs + kc + 8 * half8 + 2 * t);
          x[0] = fmaf(x[0], scale_log2, bj.x);
          x[1] = fmaf(x[1], scale_log2, bj.y);
          x[2] = fmaf(x[2], scale_log2, bj.x);
          x[3] = fmaf(x[3], scale_log2, bj.y);
          if (where == 2) {
            const int j = key0 + kc + 8 * half8 + 2 * t;
            if (!in_band(j, ra, half)) x[0] = -INFINITY;
            if (!in_band(j + 1, ra, half)) x[1] = -INFINITY;
            if (!in_band(j, rb, half)) x[2] = -INFINITY;
            if (!in_band(j + 1, rb, half)) x[3] = -INFINITY;
          }
          ma = fmaxf(ma, fmaxf(x[0], x[1]));
          mb = fmaxf(mb, fmaxf(x[2], x[3]));
        }
      }
    }
    __syncthreads();  // this buffer is consumed before the next copy into it
  }
  ma = row_max4(ma);
  mb = row_max4(mb);

  // sweep 2, last tile first: p = 2^(x - max) in the band, rounded to bf16,
  // p @ V and the sum of p in f32
  float sa = 0.0f, sb = 0.0f;
  float acc[DH / 8][4];
#pragma unroll
  for (int nt = 0; nt < DH / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;
  for (int tile = n_tiles - 1; tile >= 0; --tile) {
    const int buf = tile & 1;
    if (tile >= 1 && tile - 1 < n_tiles - 2)  // not resident from sweep 1
      copy_tile<DH, 1, NT>(kg, vg, L, (t0 + tile - 1) * kKeys, n_keys, kbuf + (buf ^ 1) * kTile,
                           vbuf + (buf ^ 1) * kTile, true);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (active) {
      const float* bs = bias + tile * kKeys;
      const bf16* ks = kbuf + buf * kTile;
      const bf16* vs = vbuf + buf * kTile;
      const int key0 = (t0 + tile) * kKeys;
#pragma unroll
      for (int kc = 0; kc < kKeys; kc += 16) {
        const int where = band_block(key0 + kc, row0, half);
        if (where == 0) continue;
        float pr[2][4];
#pragma unroll
        for (int half8 = 0; half8 < 2; ++half8) {
          score_tile_ldm<DH>(qa, ks, kc + 8 * half8, lane, pr[half8]);
          const float2 bj = *reinterpret_cast<const float2*>(bs + kc + 8 * half8 + 2 * t);
          float e[4];
          e[0] = ex2(fmaf(pr[half8][0], scale_log2, bj.x) - ma);
          e[1] = ex2(fmaf(pr[half8][1], scale_log2, bj.y) - ma);
          e[2] = ex2(fmaf(pr[half8][2], scale_log2, bj.x) - mb);
          e[3] = ex2(fmaf(pr[half8][3], scale_log2, bj.y) - mb);
          if (where == 2) {
            const int j = key0 + kc + 8 * half8 + 2 * t;
            if (!in_band(j, ra, half)) e[0] = 0.0f;
            if (!in_band(j + 1, ra, half)) e[1] = 0.0f;
            if (!in_band(j, rb, half)) e[2] = 0.0f;
            if (!in_band(j + 1, rb, half)) e[3] = 0.0f;
          }
          sa += e[0] + e[1];
          sb += e[2] + e[3];
#pragma unroll
          for (int i = 0; i < 4; ++i) pr[half8][i] = e[i];
        }
        const uint32_t pa[4] = {pack_bf16(pr[0][0], pr[0][1]), pack_bf16(pr[0][2], pr[0][3]),
                                pack_bf16(pr[1][0], pr[1][1]), pack_bf16(pr[1][2], pr[1][3])};
#pragma unroll
        for (int np = 0; np < DH / 16; ++np) {
          uint32_t vb[4];
          ldmatrix_x4_trans(vb, vs + (kc + (lane & 15)) * (DH + kPad) + np * 16 + (lane >> 4) * 8);
          mma_16816(acc[2 * np], pa, vb[0], vb[1]);
          mma_16816(acc[2 * np + 1], pa, vb[2], vb[3]);
        }
      }
    }
    __syncthreads();
  }
  if (!active) return;
  // a row that saw no valid key in its band is written as 0 (acc / inf);
  // every lane joins both sums
  const float ta = row_sum4(sa), tb = row_sum4(sb);
  store_o<DH>(o + b * L.ob + h * L.oh, L.os, row0, S, g, t, acc,
              ma < kNoValidKey ? INFINITY : ta, mb < kNoValidKey ? INFINITY : tb);
}

bool bad_args(const void* q, const void* k, const void* v, const void* o,
              const long long* st, int B, int H, int S, int dh) {
  if (B < 1 || H < 1 || S < 1 || (dh != 32 && dh != 64)) return true;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) & 15) return true;
  for (int i = 0; i < 12; ++i)
    if (st[i] < 0 || st[i] % 8 != 0) return true;
  return (long long)B * H * ((S + 31) / 32) > 0x7fffffffLL;  // CTAs at 32 rows
}

Layout layout_of(const long long* st) {
  return Layout{st[0], st[1], st[2], st[3], st[4],  st[5],
                st[6], st[7], st[8], st[9], st[10], st[11]};
}

template <int DH, int P, int W, bool kNormaliseFirst>
int launch_two_sweep(const void* q, const void* k, const void* v, const void* mask, void* o,
                     const Layout& L, int B, int H, int S, float scale, cudaStream_t s) {
  const size_t smem = two_sweep_smem<DH, P>(S);
  auto kernel = attention_two_sweep<DH, P, W, kNormaliseFirst>;
  if (smem > 48 * 1024) {  // above the default a launch may ask for
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int nqb = (S + W * 16 - 1) / (W * 16);
  kernel<<<B * (H / P) * nqb, P * W * 32, smem, s>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)mask, (bf16*)o, L, H / P, S,
      nqb, scale * kLog2e);
  return (int)cudaGetLastError();
}

template <int DH>
int launch_flash(const void* q, const void* k, const void* v, const void* mask, void* o,
                 const Layout& L, int B, int H, int S, float scale, cudaStream_t s) {
  constexpr int kRows = kFlashWarps * 16;
  const int nqb = (S + kRows - 1) / kRows;
  attention_flash<DH, kFlashWarps><<<B * H * nqb, kFlashWarps * 32, 0, s>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)mask, (bf16*)o, L, H, S, nqb,
      scale * kLog2e);
  return (int)cudaGetLastError();
}

template <int DH>
int launch_window(const void* q, const void* k, const void* v, const void* mask, void* o,
                  const Layout& L, int B, int H, int S, int half, float scale, cudaStream_t s) {
  constexpr int kRows = kWindowWarps * 16;
  const size_t smem = window_smem<DH>(S, kRows, half);
  auto kernel = attention_window_band<DH, kWindowWarps>;
  if (smem > 48 * 1024) {  // above the default a launch may ask for
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int nqb = (S + kRows - 1) / kRows;
  kernel<<<B * H * nqb, kWindowWarps * 32, smem, s>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)mask, (bf16*)o, L, H, S, nqb,
      half, scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, o: bf16 [B, H, S, dh] views with element strides st[0..11] =
// (b, h, s) of q, k, v, o; mask: f32 [B, S] contiguous, 1 = valid key, 0 =
// padding (d, e and f skip the keys past a row's last nonzero one).
int cs_attention_full(const void* q, const void* k, const void* v, const void* mask, void* o,
                      const long long* st, int B, int H, int S, int dh, float scale,
                      void* stream) {
  if (bad_args(q, k, v, o, st, B, H, S, dh)) return kErrBadArg;
  const Layout L = layout_of(st);
  cudaStream_t s = (cudaStream_t)stream;
  if (dh == 32) return launch_two_sweep<32, 1, kFullWarps, false>(q, k, v, mask, o, L, B, H, S,
                                                                  scale, s);
  return launch_two_sweep<64, 1, kFullWarps, false>(q, k, v, mask, o, L, B, H, S, scale, s);
}

int cs_attention_flash(const void* q, const void* k, const void* v, const void* mask, void* o,
                       const long long* st, int B, int H, int S, int dh, float scale,
                       void* stream) {
  if (bad_args(q, k, v, o, st, B, H, S, dh)) return kErrBadArg;
  const Layout L = layout_of(st);
  cudaStream_t s = (cudaStream_t)stream;
  if (dh == 32) return launch_flash<32>(q, k, v, mask, o, L, B, H, S, scale, s);
  return launch_flash<64>(q, k, v, mask, o, L, B, H, S, scale, s);
}

// Kernel f: q, k, v, o as for cs_attention_full with dh = 32; pack = 2 or 4
// heads a CTA, H a multiple of pack.
int cs_attention_packed(const void* q, const void* k, const void* v, const void* mask, void* o,
                        const long long* st, int B, int H, int S, int dh, int pack, float scale,
                        void* stream) {
  if (bad_args(q, k, v, o, st, B, H, S, dh) || dh != kPackedDh || (pack != 2 && pack != 4) ||
      H % pack != 0)
    return kErrBadArg;
  const Layout L = layout_of(st);
  cudaStream_t s = (cudaStream_t)stream;
  if (pack == 4)
    return launch_two_sweep<kPackedDh, 4, kPackedWarpsP4, true>(q, k, v, mask, o, L, B, H, S,
                                                                scale, s);
  return launch_two_sweep<kPackedDh, 2, kPackedWarpsP2, true>(q, k, v, mask, o, L, B, H, S,
                                                              scale, s);
}

// The windowed kernel: q, k, v, o and mask as for cs_attention_full, any S;
// each query row i over the keys j with |i - j| <= window / 2 (window >= 1).
int cs_attention_window(const void* q, const void* k, const void* v, const void* mask, void* o,
                        const long long* st, int B, int H, int S, int dh, int window,
                        float scale, void* stream) {
  if (bad_args(q, k, v, o, st, B, H, S, dh) || window < 1) return kErrBadArg;
  const Layout L = layout_of(st);
  cudaStream_t s = (cudaStream_t)stream;
  if (dh == 32) return launch_window<32>(q, k, v, mask, o, L, B, H, S, window / 2, scale, s);
  return launch_window<64>(q, k, v, mask, o, L, B, H, S, window / 2, scale, s);
}

}  // extern "C"
