// Pieces the attention forwards (attention_fwd*.cu) and backwards
// (attention_bwd*.cu) share: the dropout counter hash, the 3xTF32
// tensor-core product, the bf16 mma.sync product and its fragment loads,
// the quad reductions of an accumulator row and the argument blocks of the
// C entry points.
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
// rounded to bf16, fp32 sums) has kernels of its own: the one-head pair
// (attention_fwd_bf16.cu, attention_bwd_bf16.cu) on mma.sync.m16n8k16 bf16
// with the pieces at the end of this header, the long paths
// (attention_long_bf16.cuh) on wgmma k16 bf16.
//
// Shared-memory tiles of the fp32 kernels have a row pitch of dh + 4
// floats. The two patterns the kernels read, row g column t (B of Q.K^T)
// and row 2t column g (B of P.V), then fall on 32 different banks for the
// 32 lanes.
//
// Head widths. Every kernel is instantiated at the template widths 8, 16,
// 32, 64 and 128 and takes any dh from 1 to 128 at the smallest template
// width DH that holds it (template_dh); the long paths also at 256, for
// any dh from 129 to 256 (long_template_dh; the bf16 ones in builds of their
// own with AMID_BF16_WIDE=1): lanes at or past dh read as zero
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

#ifndef AMID_ATTN_PAD
#define AMID_ATTN_PAD 0
#endif

namespace amid_attention {

constexpr bool kPadBuild = AMID_ATTN_PAD != 0;  // the fp32 long paths' padded-width build
constexpr uint32_t kMixKey0 = 0x9E3779B9u;
constexpr int kMaxWarps = 8;  // warps of one block

// Refusals of the entry points (negative; a positive value is a cudaError_t).
enum Refusal {
  kBadHeadWidth = -1,  // dh above kMaxHeadDim (kMaxLongHeadDim on the long paths), or not the build's
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

constexpr int kMaxLongHeadDim = 256;  // the long paths' widest template width

// The template width a head of width dh runs at on the long paths, fp32 and
// bf16 (0: none, dh above 256)
__host__ __device__ constexpr int long_template_dh(int dh) {
  return dh <= kMaxHeadDim ? template_dh(dh) : dh <= kMaxLongHeadDim ? 256 : 0;
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

// x as the hi and lo halves of 3xTF32
__device__ __forceinline__ Split split(float x) {
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

// d += A B in 3xTF32, B given by its two fp32 elements
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a, float b0, float b1) {
  const Split s0 = split(b0), s1 = split(b1);
  mma_tf32(d, a.lo, s0.hi, s1.hi);
  mma_tf32(d, a.hi, s0.lo, s1.lo);
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

// ---------------------------------------------------------------------------
// bf16 pieces: the one-head bf16 kernels' mma.sync products and fragment
// loads; padded_dh and pack_bf16x2 also serve the long ones
// ---------------------------------------------------------------------------
// Fragments of mma.m16n8k16 (row.col, bf16 in pairs, lo element in the low
// half), g = lane / 4, t = lane % 4:
//   A (16 x 16): a0 = A[g][2t, 2t+1], a1 = A[g+8][2t, 2t+1],
//                a2 = A[g][2t+8, 2t+9], a3 = A[g+8][2t+8, 2t+9]
//   B (16 x 8):  b0 = B[2t, 2t+1][g], b1 = B[2t+8, 2t+9][g]
//   C (16 x 8):  as m16n8k8's.
// Each register of A or B is one 8 x 8 block of 16-bit values in the
// layout ldmatrix gives (lane holds row g, columns 2t and 2t + 1); .trans
// and movmatrix give a block's transpose in the same layout. So two n8
// accumulator tiles, packed by cvt.rn.bf16x2, are the A fragment of one k16
// step over their 16 columns, and a tile kept with its rows and columns
// swapped is the A fragment of the transposed product after one movmatrix
// a register.

// a k16 step reads 16 columns: a head of width up to 8 runs at 16
__host__ __device__ constexpr int padded_dh(int dh) { return dh < 16 ? 16 : dh; }

// two fp32 values rounded to bf16 (nearest even) in one register, lo in the
// low half
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// d += A B, bf16 operands, fp32 accumulator
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 blocks of 16-bit values from shared memory: lanes 8i to 8i + 7
// give the row addresses (16 bytes each) of block i, which lands in r[i].
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// the same, each block transposed
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// bf16 elements of a one-head bf16 kernel's staged row: dh_pad + 8, so that
// the 8 rows an ldmatrix reads (16 bytes each) fall on 8 different 16-byte
// bank groups
__host__ __device__ constexpr int bf16_pitch(int dh) { return padded_dh(dh) + 8; }

// whether every row of a [B, T, D] input starts on 16 bytes (its address,
// batch and time strides), so that a head as wide as its template width
// (a multiple of 8: h * dh floats) can be read 16 bytes at a time
inline bool rows_on16(long long base, long long sb, long long st) {
  return base % 16 == 0 && sb % 4 == 0 && st % 4 == 0;
}

// 8 fp32 values of one row from column c on, the columns from dh on zero:
// two 16-byte loads where `vec` (the row on 16 bytes, dh = DH), else one by one
__device__ __forceinline__ void load8(const float* row, int c, int dh, bool vec, float (&f)[8]) {
  if (vec) {
    const float4 x0 = __ldg(reinterpret_cast<const float4*>(row + c));
    const float4 x1 = __ldg(reinterpret_cast<const float4*>(row + c) + 1);
    f[0] = x0.x, f[1] = x0.y, f[2] = x0.z, f[3] = x0.w;
    f[4] = x1.x, f[5] = x1.y, f[6] = x1.z, f[7] = x1.w;
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) f[e] = c + e < dh ? __ldg(row + c + e) : 0.f;
  }
}

// 8 fp32 values rounded to bf16, as one 16-byte store's worth
__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  return make_uint4(pack_bf16x2(f[0], f[1]), pack_bf16x2(f[2], f[3]),
                    pack_bf16x2(f[4], f[5]), pack_bf16x2(f[6], f[7]));
}

// columns c and c + 1 of a row as one bf16 pair (0 past dh, or where the row
// is not `in`): an A fragment's register read from device memory
__device__ __forceinline__ uint32_t load2_bf16(const float* row, int c, int dh, bool in,
                                               bool vec) {
  if (!in || c >= dh) return 0u;
  if (vec) {
    const float2 x = __ldg(reinterpret_cast<const float2*>(row + c));
    return pack_bf16x2(x.x, x.y);
  }
  return pack_bf16x2(__ldg(row + c), c + 1 < dh ? __ldg(row + c + 1) : 0.f);
}

// an 8 x 8 block of 16-bit values held one register a lane, transposed
__device__ __forceinline__ uint32_t movm_t(uint32_t x) {
  uint32_t r;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(r) : "r"(x));
  return r;
}

}  // namespace amid_attention
