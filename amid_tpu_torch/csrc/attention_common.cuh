// Pieces the attention forwards (attention_fwd.cu, attention_fwd_long.cu)
// and backwards (attention_bwd.cu, attention_bwd_long.cu) share: the dropout
// counter hash, the 3xTF32 tensor-core product, the quad reductions of an
// accumulator row and the argument blocks of the C entry points.
//
// 3xTF32. One TF32 product keeps 11 significant bits of each operand, about
// three decimal digits: too few for the fp32 tolerances the kernels are held
// to. Each fp32 operand x is split into hi = tf32(x) and lo = tf32(x - hi)
// (cvt.rna: round to nearest, ties away from zero), and a product is summed
// as lo*hi + hi*lo + hi*hi in fp32 on the tensor cores
// (mma.sync.m16n8k8.f32.tf32.tf32.f32). Only the lo*lo term, about 2^-22 of
// the product, is left out.
//
// Fragments of mma.m16n8k8 (row.col), with g = lane / 4 and t = lane % 4:
//   A (16 x 8): a0 = A[g][t], a1 = A[g+8][t], a2 = A[g][t+4], a3 = A[g+8][t+4]
//   B (8 x 8):  b0 = B[t][g], b1 = B[t+4][g]
//   C (16 x 8): c0 = C[g][2t], c1 = C[g][2t+1], c2 = C[g+8][2t], c3 = C[g+8][2t+1]
// A product of two accumulators' worth (P.V, dS.K and the like) reuses the C
// fragment as the A fragment without a shuffle by numbering the reduced axis
// in the order the accumulator holds it: reduction index t stands for column
// 2t and index t+4 for column 2t+1 (a0 = c0, a1 = c2, a2 = c1, a3 = c3). The
// B operand then reads rows 2t and 2t+1 of its 8-row slice. The sum is the
// same, taken in another order.
//
// bf16-operand mode (the JAX kernel's mxu_bf16: every product's operands
// rounded to bf16, fp32 sums). The one-head sources (attention_fwd.cu,
// attention_bwd.cu) are compiled twice: as they are, and with
// AMID_ATTN_BF16=1 into libraries of their own (ops/_build.py's variants),
// where kBf16 is set; the long paths' bf16 mode has native bf16 kernels
// (attention_long_bf16.cuh). A bf16 value is exact in TF32 (10
// mantissa bits against bf16's 7), so the mode keeps every fragment layout,
// tile and route: `split` rounds the operand to bf16 (cvt.rn.bf16.f32,
// nearest even) as its hi half and leaves lo at 0, and a product issues the
// hi*hi term alone, one mma.sync where 3xTF32 issues three: bf16 operands,
// fp32 accumulation, exactly.
//
// Shared-memory tiles have a row pitch of dh + 4 floats. The two patterns
// the kernels read, row g column t (B of Q.K^T) and row 2t column g (B of
// P.V), then fall on 32 different banks for the 32 lanes.
//
// Head widths. Every kernel is instantiated at the template widths 8, 16,
// 32, 64 and 128 and takes any dh from 1 to 128 at the smallest template
// width DH that holds it (template_dh): lanes at or past dh read as zero
// (so they add nothing to Q.K^T, and P.V and the gradients leave zeros
// there) and are never written; the scale is the caller's 1/sqrt(dh) of
// the real width; the dropout hash does not see the width. Head h starts at
// column h * dh of a row, so a head whose rows do not start on 16 bytes
// (dh not a multiple of 4) is read element by element where 16-byte copies
// read the others. A head as wide as its template width takes instances in
// which dh is that compile-time constant, so its code is that of a kernel
// with no padding: the one-head kernels' PAD template flag, the fp32 long
// paths' second build with AMID_ATTN_PAD=1 (ops/_build.py's VARIANTS), whose
// instances alone take a padded width.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#ifndef AMID_ATTN_BF16
#define AMID_ATTN_BF16 0
#endif
#ifndef AMID_ATTN_PAD
#define AMID_ATTN_PAD 0
#endif

namespace amid_attention {

constexpr bool kBf16 = AMID_ATTN_BF16 != 0;  // the bf16-operand build
constexpr bool kPadBuild = AMID_ATTN_PAD != 0;  // the fp32 long paths' padded-width build
constexpr uint32_t kMixKey0 = 0x9E3779B9u;
constexpr int kMaxWarps = 8;  // warps of one block

// Refusals of the entry points (negative; a positive value is a cudaError_t).
enum Refusal {
  kBadHeadWidth = -1,  // dh above kMaxHeadDim
  kBadShape = -2,      // B, T or H below 1, or D not a multiple of H
  kTooLong = -3,       // the block's shared memory is above the card's limit
  kMisaligned = -4,    // a row of q, k, v or dout not on 16 bytes (the long path)
};

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// mix(x, v) = fmix32(x ^ (v * 0x9E3779B1 + 0x7F4A7C15)): element (b, h, i, j)
// is kept when mix(mix(mix(mix(K0, seed), b*H + h), i), j) >> 8 >= threshold.
__device__ __forceinline__ uint32_t mix(uint32_t x, uint32_t v) {
  return fmix32(x ^ (v * 0x9E3779B1u + 0x7F4A7C15u));
}

// The largest and the sum of a value over the 4 lanes of a quad: one row of
// an mma or wgmma accumulator (lanes 4g to 4g + 3 hold row g's columns).
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__host__ __device__ constexpr int pitch(int dh) { return dh + 4; }

constexpr int kMaxHeadDim = 128;

// The template width a head of width dh runs at (0: none, dh above 128)
__host__ __device__ constexpr int template_dh(int dh) {
  return dh < 1 || dh > kMaxHeadDim ? 0
         : dh <= 8                  ? 8
         : dh <= 16                 ? 16
         : dh <= 32                 ? 32
         : dh <= 64                 ? 64
                                    : 128;
}

// Columns col and col + 1 of one head's row of a [B, T, D] output, those
// below dh: a float2 where the head is as wide as its template (dh = DH, a
// multiple of 8, so the pair is 8-byte aligned), else one by one
template <int DH>
__device__ __forceinline__ void store2(float* row, int col, int dh, float a, float b) {
  if (dh == DH) {
    *reinterpret_cast<float2*>(row + col) = make_float2(a, b);
    return;
  }
  if (col < dh) row[col] = a;
  if (col + 1 < dh) row[col + 1] = b;
}

// Rounds up to a whole number of 16-row tiles.
__host__ __device__ inline int tiles16(int t) { return (t + 15) / 16; }

struct Split {
  uint32_t hi, lo;
};

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x rounded to bf16 (nearest even), as fp32 bits: a valid TF32 operand
__device__ __forceinline__ uint32_t to_bf16_bits(float x) {
  unsigned short h;
  asm("cvt.rn.bf16.f32 %0, %1;" : "=h"(h) : "f"(x));
  return (uint32_t)h << 16;
}

// x as the hi and lo halves of 3xTF32; in the bf16 build, bf16(x) and 0
__device__ __forceinline__ Split split(float x) {
  if constexpr (kBf16) return {to_bf16_bits(x), 0u};
  const uint32_t hi = to_tf32(x);
  return {hi, to_tf32(x - __uint_as_float(hi))};
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An A fragment kept as its hi and lo halves.
struct FragA {
  uint32_t hi[4], lo[4];
};

__device__ __forceinline__ FragA split_a(float a0, float a1, float a2, float a3) {
  FragA f;
  const float a[4] = {a0, a1, a2, a3};
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const Split s = split(a[r]);
    f.hi[r] = s.hi;
    f.lo[r] = s.lo;
  }
  return f;
}

// d += A B in 3xTF32, B given by its two fp32 elements; in the bf16 build
// the hi*hi product alone
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a, float b0, float b1) {
  const Split s0 = split(b0), s1 = split(b1);
  if constexpr (!kBf16) {
    mma_tf32(d, a.lo, s0.hi, s1.hi);
    mma_tf32(d, a.hi, s0.lo, s1.lo);
  }
  mma_tf32(d, a.hi, s0.hi, s1.hi);
}

// The entry points' arguments: one block of 8-byte fields that the Python side
// packs in one call (pointers as integers; null pointers as 0). `seed` points
// to one int64 on the device (its low 32 bits key the dropout hash), read by
// the kernel only when `dropout` is set, so that a CUDA graph replays a launch
// with the seed its step drew on the device. `row_offset` is the global row of
// the call's batch row 0: the hash keys row b as (row_offset + b) * H + h, so
// that a data-parallel rank holding rows [b0, b0 + B) of a global batch draws
// the masks a call on the whole batch draws for them (0 off a mesh).
struct FwdArgs {
  long long q, k, v, bias, out, row_max, row_inv_sum;
  long long B, T, D, H;
  long long q_sb, q_st, k_sb, k_st, v_sb, v_st, bias_sb, bias_si;
  long long dropout, keep_threshold, seed, stream, row_offset;
  double scale, inv_keep;
};

struct BwdArgs {
  long long q, k, v, bias, out, dout, row_max, row_inv_sum, dq, dk, dv;
  long long B, T, D, H;
  long long q_sb, q_st, k_sb, k_st, v_sb, v_st, o_sb, o_st, g_sb, g_st, bias_sb, bias_si;
  long long dropout, keep_threshold, seed, stream, row_offset;
  double scale, inv_keep;
};

template <typename T>
T* ptr(long long value) {
  return reinterpret_cast<T*>(static_cast<uintptr_t>(value));
}

// The forward kernels' parameters (attention_fwd.cu, attention_fwd_long.cu),
// from one FwdArgs block.
struct FwdParams {
  const float *q, *k, *v, *bias;
  float *out, *row_max, *row_inv_sum;
  int T, D, H, dh;  // dh = D / H, at most the instance's template width
  long long q_sb, q_st, k_sb, k_st, v_sb, v_st, bias_sb, bias_si;
  float scale, inv_keep;
  uint32_t keep_threshold;
  const long long* seed;  // one int64 on the device, read when dropout is on
  uint32_t bh_offset;     // row_offset * H: added to b * H + h in the hash
  int dropout;
};

inline FwdParams fwd_params(const FwdArgs& a) {
  return {ptr<const float>(a.q), ptr<const float>(a.k), ptr<const float>(a.v),
          ptr<const float>(a.bias), ptr<float>(a.out), ptr<float>(a.row_max),
          ptr<float>(a.row_inv_sum), (int)a.T, (int)a.D, (int)a.H, (int)(a.D / a.H),
          a.q_sb, a.q_st, a.k_sb, a.k_st, a.v_sb, a.v_st, a.bias_sb, a.bias_si,
          (float)a.scale, (float)a.inv_keep, (uint32_t)a.keep_threshold,
          ptr<const long long>(a.seed), (uint32_t)(a.row_offset * a.H),
          (int)a.dropout};
}

// The backward kernels' parameters (attention_bwd.cu, attention_bwd_long.cu),
// from one BwdArgs block.
struct BwdParams {
  const float *q, *k, *v, *bias, *out, *dout, *row_max, *row_inv_sum;
  float *dq, *dk, *dv;
  int T, D, H, dh;  // dh = D / H, at most the instance's template width
  long long q_sb, q_st, k_sb, k_st, v_sb, v_st, o_sb, o_st, g_sb, g_st, bias_sb, bias_si;
  float scale, inv_keep;
  uint32_t keep_threshold;
  const long long* seed;  // one int64 on the device, read when dropout is on
  uint32_t bh_offset;     // row_offset * H: added to b * H + h in the hash
  int dropout;
};

inline BwdParams bwd_params(const BwdArgs& a) {
  return {ptr<const float>(a.q), ptr<const float>(a.k), ptr<const float>(a.v),
          ptr<const float>(a.bias), ptr<const float>(a.out), ptr<const float>(a.dout),
          ptr<const float>(a.row_max), ptr<const float>(a.row_inv_sum),
          ptr<float>(a.dq), ptr<float>(a.dk), ptr<float>(a.dv),
          (int)a.T, (int)a.D, (int)a.H, (int)(a.D / a.H),
          a.q_sb, a.q_st, a.k_sb, a.k_st, a.v_sb, a.v_st, a.o_sb, a.o_st, a.g_sb, a.g_st,
          a.bias_sb, a.bias_si,
          (float)a.scale, (float)a.inv_keep, (uint32_t)a.keep_threshold,
          ptr<const long long>(a.seed), (uint32_t)(a.row_offset * a.H),
          (int)a.dropout};
}

// Warps of a block that walks `tiles` 16-row tiles in as few rounds of at
// most kMaxWarps warps as it can, with the tiles spread evenly over them.
inline int warps_for(int tiles) {
  const int rounds = (tiles + kMaxWarps - 1) / kMaxWarps;
  return (tiles + rounds - 1) / rounds;
}

}  // namespace amid_attention
