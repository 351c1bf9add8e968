// Encoder attention kernels for Hopper (sm_90a), bound to Python via ctypes.
//
// Replaces the three Pallas attention kernels of the JAX package:
//   cs_attention_full   <- pallas_attention_full (codesearch_tpu/ops/attention.py,
//                          _full_kernel)                                kernel d
//   cs_attention_flash  <- pallas_attention (same file, _flash_kernel)    kernel e
//   cs_attention_packed <- packed_attention (examples/ablate_head_packing.py,
//                          _packed_kernel)                              kernel f
// All compute non-causal attention over a [B, H, S, Dh] bf16 batch with a
// [B, S] padding mask added to the scores as (1 - m) * -1e30 (never -inf, so
// a fully masked row stays finite: it averages V). Dh is 32 or 64 for d and
// e, 32 for f.
//
// What bounds them on an H100: per (batch, head) the score matrix is S x S,
// 2*S*S*Dh flops each for QK^T and PV, against 3*S*Dh*2 bytes of Q, K, V.
// At bge-small's S=512, Dh=32 that is ~170 flops per byte of K and V read,
// below the card's ~295 bf16 flops per byte: what keeps these kernels fast is
// never writing the S x S scores to device memory (the plain version writes
// and rereads them several times in f32) and feeding the products to the
// tensor cores (mma.sync m16n8k16, bf16 in, f32 accumulate).
//
// Design. A CTA owns one (batch, head) and 64 query rows; each of its four
// warps owns 16 rows and holds them as mma A-fragments in registers. K rows
// sit in shared memory as [key][Dh] and V transposed as [Dh][key], so both
// B-fragments are single 32-bit loads; rows are padded by 8 bf16 so that the
// eight row groups of a fragment load hit eight different banks.
//   d (full)   K and V of the whole sequence are staged in shared memory once.
//              Exact softmax in two sweeps over the keys: the first takes the
//              row max, the second forms p = exp(s - max) in f32, sums it,
//              rounds p to bf16 (as _full_kernel casts p to V's dtype) and
//              accumulates p @ V in f32; the sum divides at the end. Shared
//              memory is (S*(Dh+8) + Dh*(S+8)) * 2 + 4*S bytes (S rounded up to
//              16): the 227 KB a block may opt into on an H100 bounds S at 1552
//              for Dh=32 and 832 for Dh=64. cs_attention_full_max_seq reports
//              the bound for the current card; the Python wrapper sends longer
//              sequences to e.
//   e (flash)  K and V stream through shared memory in tiles of 64 keys with
//              a running max and sum in f32 (_flash_kernel's online softmax).
//              Its PV product keeps p near f32: p = hi + lo with hi and lo
//              bf16, two products; the scores are (q . k) * scale, exact bf16
//              products summed in f32, where _flash_kernel scales q first.
// Keys past S (S is any length; the tiles are 16 or 64 keys) take p = 0 and
// do not enter the max; query rows past S are computed on zeros and not
// stored. Q, K, V and O may be strided views (last dimension contiguous,
// other strides multiples of 8 elements), so the encoder hands over its fused
// QKV projection without copies and takes O in [B, S, H, Dh] order.
//
//   f (packed) The TPU kernel packs P heads into one block-diagonal product
//              only to fill the MXU's 128-deep array (4x the MACs at P=4);
//              that construction is not carried over. On Hopper packing means
//              that one CTA owns the P heads (P = 2 or 4) of one head group of
//              one batch element, for 64 query rows: the mask row is loaded
//              once for the P heads, the PV output tile is P * 32 wide, and the
//              CTA writes whole [rows, P * 32] slices of the [B, S, H, Dh]
//              output. Each head has its own group of four warps (P * 4 warps
//              a CTA), so a thread holds one head's fragments, as in d and e:
//              a first version that looped over the P heads in every warp
//              held P heads' accumulators per thread, and at that register
//              count it took 6.1 ms at P=4 against d's 2.25 ms (B=256, H=12,
//              S=512; H100 80GB HBM3 at 700 W). The
//              TPU kernel holds the whole [S, P * S] score tile; here K and V
//              of P heads at S=512 alone are 256 KB, past the 227 KB a block
//              may use, so K and V stream through shared memory in tiles of 64
//              keys, double-buffered with cp.async (zero-filled past S). f
//              normalises before the bf16 cast (p = e / max(sum, 1e-30), then
//              bf16(p) @ V), so the exact row max and sum must be known before
//              any p @ V: sweep 1 streams K for a running max and sum in f32;
//              sweep 2 streams K and V, forms p (e times the rounded
//              reciprocal of the sum, within one f32 ulp of the quotient),
//              rounds it to bf16 and accumulates p @ V in f32 with mma.sync. K
//              and V sit in shared memory as [key][Dh + 8]; V's B-fragments
//              come from ldmatrix.trans. Bound on this card: at bge-small's
//              shapes (B=256, H=12, S=512) f needs 103 GFLOP and moves 403 MB
//              of Q, K, V and O, so memory bounds it (0.120 ms at 3.35 TB/s
//              against 0.104 ms at 989 TFLOP/s). This design computes q . k
//              and exp twice per score and sits well above that bound; a
//              simple kernel that is right comes first (wgmma/TMA are later
//              work). S is bounded only by the index arithmetic; the wrapper
//              holds it to PACKED_MAX_SEQ, the longest sequence it is checked at.
//
// Every kernel launches on the caller's stream and allocates nothing; every
// entry point returns the CUDA error of its launch (0 on success, -1 for a
// bad argument).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kMaskNeg = -1.0e30f;  // _NEG_INF of attention.py
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerCta = kWarps * 16;
constexpr int kPad = 8;        // bf16 of padding per shared-memory row
constexpr int kFlashKeys = 64; // keys per streamed tile of e
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

// Raw scores q . k of the warp's 16 rows against 8 keys [n0, n0 + 8) of the
// shared K block (row stride DH + kPad).
template <int DH>
__device__ __forceinline__ void score_tile(const uint32_t (&qa)[DH / 16][4], const bf16* ks,
                                           int n0, int g, int t, float (&c)[4]) {
  c[0] = c[1] = c[2] = c[3] = 0.0f;
  const bf16* kr = ks + (n0 + g) * (DH + kPad) + 2 * t;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    mma_16816(c, qa[kk], ld32(kr + kk * 16), ld32(kr + kk * 16 + 8));
}

// Stages rows [r0, r0 + n) of this head's K and V into shared memory: K as
// [n][DH + kPad], V transposed as [DH][vstride], rows past S as zeros. Thread
// order puts 32 consecutive keys in a warp, so the transposed stores of one
// value index fall in 16 consecutive words (no bank conflicts).
template <int DH>
__device__ __forceinline__ void stage_kv(const bf16* kg, long long ks_, const bf16* vg,
                                         long long vs_, int r0, int n, int S, bf16* ks,
                                         bf16* vt, int vstride) {
  constexpr int kVec = 8;  // bf16 per 16-byte load
  for (int i = threadIdx.x; i < n * (DH / kVec); i += blockDim.x) {
    const int r = i % n, c = (i / n) * kVec;
    uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
    if (r0 + r < S) {
      kv = *reinterpret_cast<const uint4*>(kg + (r0 + r) * ks_ + c);
      vv = *reinterpret_cast<const uint4*>(vg + (r0 + r) * vs_ + c);
    }
    *reinterpret_cast<uint4*>(ks + r * (DH + kPad) + c) = kv;
    const bf16* ve = reinterpret_cast<const bf16*>(&vv);
#pragma unroll
    for (int j = 0; j < kVec; ++j) vt[(c + j) * vstride + r] = ve[j];
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

// ---- d: whole sequence in shared memory, exact two-sweep softmax ----------
template <int DH>
__global__ void __launch_bounds__(kThreads)
attention_full(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const float* __restrict__ mask,
               bf16* __restrict__ o, Layout L, int H, int S, int n_qblocks, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int s16 = (S + 15) & ~15;
  const int vstride = s16 + kPad;
  bf16* ks = reinterpret_cast<bf16*>(smem);     // [s16][DH + kPad]
  bf16* vt = ks + s16 * (DH + kPad);            // [DH][s16 + kPad]
  float* bias = reinterpret_cast<float*>(vt + DH * vstride);  // [s16]
  const int qb = blockIdx.x % n_qblocks, bh = blockIdx.x / n_qblocks;
  const int b = bh / H, h = bh % H;
  stage_kv<DH>(k + b * L.kb + h * L.kh, L.ks, v + b * L.vb + h * L.vh, L.vs, 0, s16, S, ks, vt,
               vstride);
  for (int j = threadIdx.x; j < s16; j += blockDim.x)
    bias[j] = j < S ? mask_bias(mask[(size_t)b * S + j]) : 0.0f;
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = qb * kRowsPerCta + warp * 16;
  if (row0 >= S) return;  // no barrier follows
  uint32_t qa[DH / 16][4];
  load_q<DH>(q + b * L.qb + h * L.qh, L.qs, row0, S, g, t, qa);

  // sweep 1: the exact row max (keys past S excluded)
  float ma = -INFINITY, mb = -INFINITY;
  for (int n0 = 0; n0 < s16; n0 += 8) {
    float c[4];
    score_tile<DH>(qa, ks, n0, g, t, c);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = n0 + 2 * t + (i & 1);
      if (key < S) {
        const float s = __fadd_rn(__fmul_rn(c[i], scale), bias[key]);
        if (i < 2) ma = fmaxf(ma, s); else mb = fmaxf(mb, s);
      }
    }
  }
  ma = row_max4(ma);
  mb = row_max4(mb);

  // sweep 2: p = exp(s - max), its f32 sum, and bf16(p) @ V in f32
  float acc[DH / 8][4];
#pragma unroll
  for (int nt = 0; nt < DH / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;
  float la = 0.0f, lb = 0.0f;
  for (int kc = 0; kc < s16; kc += 16) {
    float p[2][4];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float c[4];
      score_tile<DH>(qa, ks, kc + 8 * half, g, t, c);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = kc + 8 * half + 2 * t + (i & 1);
        float e = 0.0f;
        if (key < S) e = expf(__fadd_rn(__fmul_rn(c[i], scale), bias[key]) - (i < 2 ? ma : mb));
        p[half][i] = e;
        if (i < 2) la += e; else lb += e;
      }
    }
    const uint32_t pa[4] = {pack_bf16(p[0][0], p[0][1]), pack_bf16(p[0][2], p[0][3]),
                            pack_bf16(p[1][0], p[1][1]), pack_bf16(p[1][2], p[1][3])};
#pragma unroll
    for (int nt = 0; nt < DH / 8; ++nt) {
      const bf16* vr = vt + (nt * 8 + g) * vstride + kc + 2 * t;
      mma_16816(acc[nt], pa, ld32(vr), ld32(vr + 8));
    }
  }
  la = row_sum4(la);
  lb = row_sum4(lb);
  store_o<DH>(o + b * L.ob + h * L.oh, L.os, row0, S, g, t, acc, la, lb);
}

// ---- e: K/V tiles of 64 keys, online softmax in f32 -----------------------
template <int DH>
__global__ void __launch_bounds__(kThreads)
attention_flash(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const float* __restrict__ mask,
                bf16* __restrict__ o, Layout L, int H, int S, int n_qblocks, float scale) {
  __shared__ __align__(16) bf16 ks[kFlashKeys * (DH + kPad)];
  __shared__ __align__(16) bf16 vt[DH * (kFlashKeys + kPad)];
  __shared__ float bias[kFlashKeys];
  const int qb = blockIdx.x % n_qblocks, bh = blockIdx.x / n_qblocks;
  const int b = bh / H, h = bh % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = qb * kRowsPerCta + warp * 16;
  const bool active = row0 < S;  // warp-uniform; idle warps still join the barriers
  uint32_t qa[DH / 16][4];
  load_q<DH>(q + b * L.qb + h * L.qh, L.qs, row0, S, g, t, qa);
  const bf16* kg = k + b * L.kb + h * L.kh;
  const bf16* vg = v + b * L.vb + h * L.vh;

  float acc[DH / 8][4];
#pragma unroll
  for (int nt = 0; nt < DH / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;
  float ma = kMaskNeg, mb = kMaskNeg, la = 0.0f, lb = 0.0f;  // _flash_kernel's m0, l0
  for (int k0 = 0; k0 < S; k0 += kFlashKeys) {
    __syncthreads();  // the previous tile is consumed
    stage_kv<DH>(kg, L.ks, vg, L.vs, k0, kFlashKeys, S, ks, vt, kFlashKeys + kPad);
    for (int j = threadIdx.x; j < kFlashKeys; j += blockDim.x)
      bias[j] = k0 + j < S ? mask_bias(mask[(size_t)b * S + k0 + j]) : 0.0f;
    __syncthreads();
    if (!active) continue;
    float s[kFlashKeys / 8][4];
    float ca = -INFINITY, cb = -INFINITY;
#pragma unroll
    for (int j = 0; j < kFlashKeys / 8; ++j) {
      score_tile<DH>(qa, ks, 8 * j, g, t, s[j]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = 8 * j + 2 * t + (i & 1);
        const float x = __fadd_rn(__fmul_rn(s[j][i], scale), bias[key]);
        s[j][i] = x;
        if (k0 + key < S) {
          if (i < 2) ca = fmaxf(ca, x); else cb = fmaxf(cb, x);
        }
      }
    }
    const float na = fmaxf(ma, row_max4(ca)), nb = fmaxf(mb, row_max4(cb));
    const float alpha_a = expf(ma - na), alpha_b = expf(mb - nb);
    ma = na;
    mb = nb;
    float ra = 0.0f, rb = 0.0f;
#pragma unroll
    for (int j = 0; j < kFlashKeys / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = 8 * j + 2 * t + (i & 1);
        const float e = k0 + key < S ? expf(s[j][i] - (i < 2 ? na : nb)) : 0.0f;
        s[j][i] = e;
        if (i < 2) ra += e; else rb += e;
      }
    la = la * alpha_a + row_sum4(ra);
    lb = lb * alpha_b + row_sum4(rb);
#pragma unroll
    for (int nt = 0; nt < DH / 8; ++nt) {
      acc[nt][0] *= alpha_a;
      acc[nt][1] *= alpha_a;
      acc[nt][2] *= alpha_b;
      acc[nt][3] *= alpha_b;
    }
#pragma unroll
    for (int kc = 0; kc < kFlashKeys / 16; ++kc) {
      uint32_t hi[4], lo[4];
      const float pv[4][2] = {{s[2 * kc][0], s[2 * kc][1]}, {s[2 * kc][2], s[2 * kc][3]},
                              {s[2 * kc + 1][0], s[2 * kc + 1][1]},
                              {s[2 * kc + 1][2], s[2 * kc + 1][3]}};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const __nv_bfloat162 h2 = __floats2bfloat162_rn(pv[r][0], pv[r][1]);
        hi[r] = *reinterpret_cast<const uint32_t*>(&h2);
        lo[r] = pack_bf16(pv[r][0] - __low2float(h2), pv[r][1] - __high2float(h2));
      }
#pragma unroll
      for (int nt = 0; nt < DH / 8; ++nt) {
        const bf16* vr = vt + (nt * 8 + g) * (kFlashKeys + kPad) + 16 * kc + 2 * t;
        const uint32_t b0 = ld32(vr), b1 = ld32(vr + 8);
        mma_16816(acc[nt], hi, b0, b1);
        mma_16816(acc[nt], lo, b0, b1);
      }
    }
  }
  if (!active) return;
  store_o<DH>(o + b * L.ob + h * L.oh, L.os, row0, S, g, t, acc, fmaxf(la, 1e-30f),
              fmaxf(lb, 1e-30f));
}

// ---- f: P heads of one group per CTA, K/V streamed, normalise-then-cast ---
constexpr int kPackedDh = 32;
constexpr int kPackedKeys = 64;              // keys per streamed tile of f
constexpr int kPackedRow = kPackedDh + kPad; // bf16 per shared K or V row

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

// Four transposed 8x8 bf16 tiles: from [key][Dh + kPad] rows of V, lane l
// naming row (l & 15) at column (l >> 4) * 8, r0 r1 are the B-fragments
// (keys 0-7, 8-15) of one 8-wide column tile and r2 r3 those of the next.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// Queues the copy of keys [k0, k0 + kPackedKeys) of the P heads' K (and V)
// into one buffer, zeros past S, and writes the tile's mask bias (loaded once
// for the P heads).
template <int P>
__device__ __forceinline__ void packed_tile(const bf16* kg, const bf16* vg, const Layout& L,
                                            const float* mrow, int k0, int S, bf16* kd,
                                            bf16* vd, float* bias, bool with_v) {
  constexpr int kChunks = kPackedDh / 8;  // 16-byte chunks per key row
  for (int i = threadIdx.x; i < P * kPackedKeys * kChunks; i += P * kThreads) {
    const int c = (i % kChunks) * 8;
    const int r = (i / kChunks) % kPackedKeys;
    const int p = i / (kChunks * kPackedKeys);
    const bool ok = k0 + r < S;
    const long long key = ok ? k0 + r : 0;
    const int at = (p * kPackedKeys + r) * kPackedRow + c;
    cp_async16(kd + at, kg + p * L.kh + key * L.ks + c, ok);
    if (with_v) cp_async16(vd + at, vg + p * L.vh + key * L.vs + c, ok);
  }
  for (int j = threadIdx.x; j < kPackedKeys; j += P * kThreads)
    bias[j] = k0 + j < S ? mask_bias(mrow[k0 + j]) : 0.0f;
}

template <int P>
__global__ void __launch_bounds__(P * kThreads)
attention_packed(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const float* __restrict__ mask,
                 bf16* __restrict__ o, Layout L, int G, int S, int n_qblocks, float scale) {
  constexpr int D = kPackedDh;
  constexpr int kTile = P * kPackedKeys * kPackedRow;  // bf16 of one K (or V) buffer
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* kbuf = reinterpret_cast<bf16*>(smem);                 // [2][P][64][D + kPad]
  bf16* vbuf = kbuf + 2 * kTile;                              // [2][P][64][D + kPad]
  float* bias = reinterpret_cast<float*>(vbuf + 2 * kTile);   // [2][64]
  const int qb = blockIdx.x % n_qblocks, bg = blockIdx.x / n_qblocks;
  const int b = bg / G, h0 = (bg % G) * P;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int p = warp / kWarps;  // the warp's head within the group
  const int row0 = qb * kRowsPerCta + (warp % kWarps) * 16;
  const bool active = row0 < S;  // warp-uniform; idle warps still copy and join barriers
  const int n_tiles = (S + kPackedKeys - 1) / kPackedKeys;
  const int head_rows = p * kPackedKeys * kPackedRow;  // this head's K/V rows in a buffer
  const bf16* kg = k + b * L.kb + h0 * L.kh;
  const bf16* vg = v + b * L.vb + h0 * L.vh;
  const float* mrow = mask + (size_t)b * S;

  uint32_t qa[D / 16][4];
  load_q<D>(q + b * L.qb + (h0 + p) * L.qh, L.qs, row0, S, g, t, qa);

  // sweep 1: running row max and sum of exp in f32 (keys past S excluded)
  float ma = -INFINITY, mb = -INFINITY, la = 0.0f, lb = 0.0f;
  packed_tile<P>(kg, vg, L, mrow, 0, S, kbuf, vbuf, bias, false);
  cp_async_commit();
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int buf = tile & 1;
    if (tile + 1 < n_tiles) {
      packed_tile<P>(kg, vg, L, mrow, (tile + 1) * kPackedKeys, S, kbuf + (buf ^ 1) * kTile,
                     vbuf, bias + (buf ^ 1) * kPackedKeys, false);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (active) {
      const int k0 = tile * kPackedKeys;
      const float* bs = bias + buf * kPackedKeys;
      const bf16* ks = kbuf + buf * kTile + head_rows;
      float s[kPackedKeys / 8][4];
      float ca = -INFINITY, cb = -INFINITY;
#pragma unroll
      for (int j = 0; j < kPackedKeys / 8; ++j) {
        score_tile<D>(qa, ks, 8 * j, g, t, s[j]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = 8 * j + 2 * t + (i & 1);
          const float x = __fadd_rn(__fmul_rn(s[j][i], scale), bs[key]);
          s[j][i] = x;
          if (k0 + key < S) {
            if (i < 2) ca = fmaxf(ca, x); else cb = fmaxf(cb, x);
          }
        }
      }
      const float na = fmaxf(ma, row_max4(ca)), nb = fmaxf(mb, row_max4(cb));
      float ra = 0.0f, rb = 0.0f;
#pragma unroll
      for (int j = 0; j < kPackedKeys / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (k0 + 8 * j + 2 * t + (i & 1) < S) {
            if (i < 2) ra += expf(s[j][i] - na); else rb += expf(s[j][i] - nb);
          }
      la = la * expf(ma - na) + row_sum4(ra);
      lb = lb * expf(mb - nb) + row_sum4(rb);
      ma = na;
      mb = nb;
    }
    __syncthreads();  // this buffer is consumed before the next copy into it
  }

  // sweep 2: p = exp(s - max) / max(sum, 1e-30) in f32, rounded to bf16, and
  // p @ V accumulated in f32
  const float ia = __frcp_rn(fmaxf(la, 1e-30f)), ib = __frcp_rn(fmaxf(lb, 1e-30f));
  float acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;
  packed_tile<P>(kg, vg, L, mrow, 0, S, kbuf, vbuf, bias, true);
  cp_async_commit();
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int buf = tile & 1;
    if (tile + 1 < n_tiles) {
      packed_tile<P>(kg, vg, L, mrow, (tile + 1) * kPackedKeys, S, kbuf + (buf ^ 1) * kTile,
                     vbuf + (buf ^ 1) * kTile, bias + (buf ^ 1) * kPackedKeys, true);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (active) {
      const int k0 = tile * kPackedKeys;
      const float* bs = bias + buf * kPackedKeys;
      const bf16* ks = kbuf + buf * kTile + head_rows;
      const bf16* vs = vbuf + buf * kTile + head_rows;
#pragma unroll
      for (int kc = 0; kc < kPackedKeys; kc += 16) {
        float pr[2][4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float c[4];
          score_tile<D>(qa, ks, kc + 8 * half, g, t, c);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int key = kc + 8 * half + 2 * t + (i & 1);
            float e = 0.0f;
            if (k0 + key < S)
              e = __fmul_rn(expf(__fadd_rn(__fmul_rn(c[i], scale), bs[key]) - (i < 2 ? ma : mb)),
                            i < 2 ? ia : ib);
            pr[half][i] = e;
          }
        }
        const uint32_t pa[4] = {pack_bf16(pr[0][0], pr[0][1]), pack_bf16(pr[0][2], pr[0][3]),
                                pack_bf16(pr[1][0], pr[1][1]), pack_bf16(pr[1][2], pr[1][3])};
#pragma unroll
        for (int np = 0; np < D / 16; ++np) {
          uint32_t vb[4];
          ldmatrix_x4_trans(vb, vs + (kc + (lane & 15)) * kPackedRow + np * 16 + (lane >> 4) * 8);
          mma_16816(acc[2 * np], pa, vb[0], vb[1]);
          mma_16816(acc[2 * np + 1], pa, vb[2], vb[3]);
        }
      }
    }
    __syncthreads();
  }
  if (!active) return;
  const int ra = row0 + g, rb = row0 + g + 8;
  bf16* og = o + b * L.ob + (h0 + p) * L.oh;
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    const int c = nt * 8 + 2 * t;
    if (ra < S)
      *reinterpret_cast<uint32_t*>(og + ra * L.os + c) = pack_bf16(acc[nt][0], acc[nt][1]);
    if (rb < S)
      *reinterpret_cast<uint32_t*>(og + rb * L.os + c) = pack_bf16(acc[nt][2], acc[nt][3]);
  }
}

size_t packed_smem_bytes(int pack) {
  return (size_t)4 * pack * kPackedKeys * kPackedRow * sizeof(bf16) +
         2 * kPackedKeys * sizeof(float);
}

size_t full_smem_bytes(int S, int dh) {
  const size_t s16 = (size_t)((S + 15) & ~15);
  return s16 * (dh + kPad) * 2 + (size_t)dh * (s16 + kPad) * 2 + s16 * 4;
}

bool bad_args(const void* q, const void* k, const void* v, const void* o,
              const long long* st, int B, int H, int S, int dh) {
  if (B < 1 || H < 1 || S < 1 || (dh != 32 && dh != 64)) return true;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) & 15) return true;
  for (int i = 0; i < 12; ++i)
    if (st[i] < 0 || st[i] % 8 != 0) return true;
  return (long long)B * H * ((S + kRowsPerCta - 1) / kRowsPerCta) > 0x7fffffffLL;
}

Layout layout_of(const long long* st) {
  return Layout{st[0], st[1], st[2], st[3], st[4],  st[5],
                st[6], st[7], st[8], st[9], st[10], st[11]};
}

template <int DH>
int launch_full(const void* q, const void* k, const void* v, const void* mask, void* o,
                const Layout& L, int B, int H, int S, float scale, cudaStream_t s) {
  const size_t smem = full_smem_bytes(S, DH);
  cudaError_t e = cudaFuncSetAttribute(attention_full<DH>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int nqb = (S + kRowsPerCta - 1) / kRowsPerCta;
  attention_full<DH><<<B * H * nqb, kThreads, smem, s>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)mask, (bf16*)o, L, H, S, nqb,
      scale);
  return (int)cudaGetLastError();
}

template <int DH>
int launch_flash(const void* q, const void* k, const void* v, const void* mask, void* o,
                 const Layout& L, int B, int H, int S, float scale, cudaStream_t s) {
  const int nqb = (S + kRowsPerCta - 1) / kRowsPerCta;
  attention_flash<DH><<<B * H * nqb, kThreads, 0, s>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)mask, (bf16*)o, L, H, S, nqb,
      scale);
  return (int)cudaGetLastError();
}

template <int P>
int launch_packed(const void* q, const void* k, const void* v, const void* mask, void* o,
                  const Layout& L, int B, int H, int S, float scale, cudaStream_t s) {
  const size_t smem = packed_smem_bytes(P);
  cudaError_t e = cudaFuncSetAttribute(attention_packed<P>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int nqb = (S + kRowsPerCta - 1) / kRowsPerCta;
  attention_packed<P><<<B * (H / P) * nqb, P * kThreads, smem, s>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)mask, (bf16*)o, L, H / P, S,
      nqb, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Kernel d's bound on S at head size dh on the current device: the longest
// multiple of 16 whose shared memory fits what a block may opt into; -1 for a
// bad dh or a CUDA error.
int cs_attention_full_max_seq(int dh) {
  int dev, limit;
  if ((dh != 32 && dh != 64) || cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
          cudaSuccess)
    return kErrBadArg;
  int s = 0;
  while (full_smem_bytes(s + 16, dh) <= (size_t)limit) s += 16;
  return s;
}

// q, k, v, o: bf16 [B, H, S, dh] views with element strides st[0..11] =
// (b, h, s) of q, k, v, o; mask: f32 [B, S] contiguous, 1 = valid key.
int cs_attention_full(const void* q, const void* k, const void* v, const void* mask, void* o,
                      const long long* st, int B, int H, int S, int dh, float scale,
                      void* stream) {
  if (bad_args(q, k, v, o, st, B, H, S, dh)) return kErrBadArg;
  const Layout L = layout_of(st);
  cudaStream_t s = (cudaStream_t)stream;
  if (dh == 32) return launch_full<32>(q, k, v, mask, o, L, B, H, S, scale, s);
  return launch_full<64>(q, k, v, mask, o, L, B, H, S, scale, s);
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
  if (pack == 4) return launch_packed<4>(q, k, v, mask, o, L, B, H, S, scale, s);
  return launch_packed<2>(q, k, v, mask, o, L, B, H, S, scale, s);
}

}  // extern "C"
