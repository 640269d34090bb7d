// The pieces of the long-sequence attention kernels (attention_fwd_long.cu,
// attention_bwd_long.cu): each block owns 128 rows of one (b, h), two
// warpgroups of 64, and streams the other side through an asynchronous ring
// of raw stages (cp.async into shared memory, completing on mbarriers), each
// landed stage split once into TF32 halves in the layouts that wgmma reads
// as K-major shared-memory operands; the products are
// wgmma.mma_async m64nNk8 .f32.tf32.tf32, three a k-step (3xTF32, as
// attention_common.cuh's mma3). The bf16 mode of the long paths has
// kernels of its own (attention_long_bf16.cuh).

#pragma once

#include "attention_common.cuh"
#include "hopper.cuh"

namespace amid_long {

using namespace amid_attention;
using namespace amid_hopper;

constexpr int kThreads = 256;  // two warpgroups
constexpr int kOwn = 128;      // rows a block owns, 64 a warpgroup

// ---------------------------------------------------------------------------
// wgmma, tf32 inputs, fp32 accumulator
// ---------------------------------------------------------------------------
// mma_ss: d[64 x N] += A[64 x 8] B[N x 8]^T, A and B K-major in shared
// memory (descriptors; the N = 32 stages of dh = 64, 16 of dh = 128). mma_rs: the same with
// A in registers: a = A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4] of the
// warp's 16 rows (g = lane / 4, t = lane % 4). The accumulator gives a
// thread rows 16 warp + g (d[4j], d[4j+1]) and + 8 (d[4j+2], d[4j+3]) of
// columns 8j + 2t + {0, 1}.
#define BWL_L4 "%0, %1, %2, %3"
#define BWL_L8 BWL_L4 ", %4, %5, %6, %7"
#define BWL_L16 BWL_L8 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define BWL_L32                                                                        \
  BWL_L16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, " \
          "%31"
#define BWL_L64                                                                      \
  BWL_L32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, " \
          "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "   \
          "%62, %63"
#define BWL_L128 BWL_L64 ", " \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, " \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
#define BWL_R(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define BWL_O4 BWL_R(0)
#define BWL_O8 BWL_O4, BWL_R(4)
#define BWL_O16 BWL_O8, BWL_R(8), BWL_R(12)
#define BWL_O32 BWL_O16, BWL_R(16), BWL_R(20), BWL_R(24), BWL_R(28)
#define BWL_O64 BWL_O32, BWL_R(32), BWL_R(36), BWL_R(40), BWL_R(44), BWL_R(48), BWL_R(52), \
                BWL_R(56), BWL_R(60)
#define BWL_O128 BWL_O64, BWL_R(64), BWL_R(68), BWL_R(72), BWL_R(76), BWL_R(80), BWL_R(84), \
                 BWL_R(88), BWL_R(92), BWL_R(96), BWL_R(100), BWL_R(104), BWL_R(108),      \
                 BWL_R(112), BWL_R(116), BWL_R(120), BWL_R(124)

template <int N>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t a, uint64_t b);
template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b);

template <>
__device__ __forceinline__ void mma_ss<32>(float (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {" BWL_L16
      "}, %16, %17, p, 1, 1;\n}\n"
      : BWL_O16
      : "l"(a), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void mma_ss<16>(float (&d)[8], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {" BWL_L8
      "}, %8, %9, p, 1, 1;\n}\n"
      : BWL_O8
      : "l"(a), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void mma_rs<256>(float (&d)[128], const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 {" BWL_L128
      "}, {%128, %129, %130, %131}, %132, p, 1, 1;\n}\n"
      : BWL_O128
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void mma_rs<128>(float (&d)[64], const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {" BWL_L64
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : BWL_O64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void mma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {" BWL_L32
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : BWL_O32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void mma_rs<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {" BWL_L16
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : BWL_O16
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void mma_rs<16>(float (&d)[8], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {" BWL_L8
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : BWL_O8
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void mma_rs<8>(float (&d)[4], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {" BWL_L4
      "}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : BWL_O4
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d += A B as three TF32 products (lo hi, hi lo, hi hi): A from registers
// or shared memory
template <int N>
__device__ __forceinline__ void mma3_rs(float (&d)[N / 2], const uint32_t (&a_hi)[4],
                                        const uint32_t (&a_lo)[4], uint64_t b_hi,
                                        uint64_t b_lo) {
  mma_rs<N>(d, a_lo, b_hi);
  mma_rs<N>(d, a_hi, b_lo);
  mma_rs<N>(d, a_hi, b_hi);
}
template <int N>
__device__ __forceinline__ void mma3_ss(float (&d)[N / 2], uint64_t a_hi, uint64_t a_lo,
                                        uint64_t b_hi, uint64_t b_lo) {
  mma_ss<N>(d, a_lo, b_hi);
  mma_ss<N>(d, a_hi, b_lo);
  mma_ss<N>(d, a_hi, b_hi);
}

// ---------------------------------------------------------------------------
// tiles in shared memory
// ---------------------------------------------------------------------------
template <int DH>
struct Plan {
  // the owned side's A operands of S and dP: split once into registers
  // (dh <= 32), or into [128][dh] shared-memory tiles (dh >= 64: registers
  // would not hold them; the long backward keeps them raw at dh >= 128,
  // raw_owned in attention_bwd_long.cu; the long forward at dh = 256 has a
  // layout of its own, attention_fwd_long.cu's wide kernel)
  static constexpr bool REG_A = DH <= 32;
  static constexpr int C = DH / 4;  // 16-byte chunks of a row
  // rows a stage streams: the tiles of a stage grow with dh, the block's
  // shared memory (227 KB) does not (the long forward streams 16 at dh = 256)
  static constexpr int NS = DH == 256 ? 8 : DH == 128 ? 16 : DH == 64 ? 32 : 64;
  static constexpr int L = DH >= 32 ? 1 : 32 / DH;  // raw rows in one 128-byte line
  static constexpr int TILE = NS * DH;              // floats of a [NS][dh] tile
  static constexpr int TR = NS * DH + NS;           // of a [dh][NS] tile (chunk padding)
  static constexpr int OWN = REG_A ? 0 : kOwn * DH;  // of an owned [128][dh] tile
  static constexpr int TR_LBO = 16 * DH + 16;       // bytes between a [dh][NS] tile's chunks
};

// raw [NS][dh] tile: row r's chunk c at chunk c ^ swizzle(r)
template <int DH>
__device__ __forceinline__ int raw_at(int r, int c) {
  using P = Plan<DH>;
  return r * DH + ((c ^ ((r / P::L) & (P::C - 1))) << 2);
}

// split [rows][dh] tile: core matrix (r / 8, c) at (r / 8 * C + c) * 128
// bytes, row r % 8 of it 16 bytes further each: LBO 128, SBO 32 dh bytes
template <int DH>
__device__ __forceinline__ int tile_at(int r, int c) {
  return ((r >> 3) * Plan<DH>::C + c) * 32 + ((r & 7) << 2);
}
template <int DH>
__device__ __forceinline__ uint64_t tile_desc(const float* t) {
  return matrix_desc(smem_u32(t), 128, 32 * DH);
}

// split [dh][NS] tile, row d, column p: core matrix (d / 8, p / 4) at
// (p / 4) * TR_LBO + (d / 8) * 128 bytes: LBO TR_LBO, SBO 128
template <int DH>
__device__ __forceinline__ int tr_at(int d, int p) {
  return (p >> 2) * (4 * DH + 4) + (d >> 3) * 32 + ((d & 7) << 2) + (p & 3);
}
template <int DH>
__device__ __forceinline__ uint64_t tr_desc(const float* t) {
  return matrix_desc(smem_u32(t), Plan<DH>::TR_LBO, 128);
}

// the column of streamed row r in a [dh][NS] tile: in each group of 8, the
// accumulator's order (reduced index t is row 2t, t + 4 is row 2t + 1)
__device__ __forceinline__ int perm8(int r) {
  return (r & ~7) | ((r & 7) >> 1) | ((r & 1) << 2);
}

__device__ __forceinline__ void split4(const float4 x, float4& hi, float4& lo) {
  const Split a = split(x.x), b = split(x.y), c = split(x.z), d = split(x.w);
  hi = make_float4(__uint_as_float(a.hi), __uint_as_float(b.hi), __uint_as_float(c.hi),
                   __uint_as_float(d.hi));
  lo = make_float4(__uint_as_float(a.lo), __uint_as_float(b.lo), __uint_as_float(c.lo),
                   __uint_as_float(d.lo));
}

// cp.async of rows [row0, row0 + NS) of a head of width dh (row stride st)
// into a raw tile; rows past T and columns from dh on are zeros. 16 bytes a
// copy where dh is a multiple of 4 (the rows then start on 16 bytes), else
// 4 bytes a copy. Outside the padded build dh is DH (kPadBuild,
// attention_common.cuh): no column test.
template <int DH>
__device__ __forceinline__ void copy_rows(float* raw, const float* head, long long st,
                                          int row0, int T, int dh, int tid) {
  using P = Plan<DH>;
  if (!kPadBuild || (dh & 3) == 0) {
    for (int item = tid; item < P::NS * P::C; item += kThreads) {
      const int r = item / P::C, c = item - r * P::C;
      const int i = row0 + r;
      const bool in = i < T && (!kPadBuild || 4 * c < dh);
      cp_async16(smem_u32(raw + raw_at<DH>(r, c)), head + (long long)(in ? i : 0) * st + 4 * c,
                 in);
    }
  } else {
    for (int item = tid; item < P::NS * DH; item += kThreads) {
      const int r = item / DH, col = item - r * DH;
      const int i = row0 + r;
      const bool in = i < T && col < dh;
      cp_async4(smem_u32(raw + raw_at<DH>(r, col >> 2) + (col & 3)),
                head + (long long)(in ? i : 0) * st + (in ? col : 0), in);
    }
  }
}

// cp.async of values [row0, row0 + NS) of a contiguous vector; zeros past T
template <int NS>
__device__ __forceinline__ void copy_vals(float* dst, const float* src, int row0, int T,
                                          int tid) {
  for (int r = tid; r < NS; r += kThreads) {
    const int i = row0 + r;
    const bool in = i < T;
    cp_async4(smem_u32(dst + r), src + (in ? i : 0), in);
  }
}

// A landed raw tile as TF32 halves, in one pass: with Rows [NS][dh] hi and
// lo, with Tr [dh][NS] hi and lo, each group of 8 rows in the order perm8
// gives
template <int DH, bool Rows, bool Tr>
__device__ __forceinline__ void split_stage(const float* raw, float* hi, float* lo, float* thi,
                                            float* tlo, int tid) {
  using P = Plan<DH>;
  for (int item = tid; item < P::NS * P::C; item += kThreads) {
    const int c = item / P::NS, r = item - c * P::NS;
    float4 h, l;
    split4(*reinterpret_cast<const float4*>(raw + raw_at<DH>(r, c)), h, l);
    if constexpr (Rows) {
      *reinterpret_cast<float4*>(hi + tile_at<DH>(r, c)) = h;
      *reinterpret_cast<float4*>(lo + tile_at<DH>(r, c)) = l;
    }
    if constexpr (Tr) {
      const int p = perm8(r);
      const float hv[4] = {h.x, h.y, h.z, h.w}, lv[4] = {l.x, l.y, l.z, l.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        thi[tr_at<DH>(4 * c + e, p)] = hv[e];
        tlo[tr_at<DH>(4 * c + e, p)] = lv[e];
      }
    }
  }
}

// Chunk c (columns 4c to 4c + 3) of row i of a head of width dh: zeros past
// T and from column dh on; one 16-byte load where dh is a multiple of 4
__device__ __forceinline__ float4 load_chunk(const float* head, long long st, int i, int c,
                                             int T, int dh) {
  float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
  if (i >= T || (kPadBuild && 4 * c >= dh)) return x;
  const float* row = head + (long long)i * st + 4 * c;
  if (!kPadBuild || (dh & 3) == 0) return __ldg(reinterpret_cast<const float4*>(row));
  x.x = __ldg(row);
  if (4 * c + 1 < dh) x.y = __ldg(row + 1);
  if (4 * c + 2 < dh) x.z = __ldg(row + 2);
  if (4 * c + 3 < dh) x.w = __ldg(row + 3);
  return x;
}

// rows [row0, row0 + 128) of a head as TF32 halves in [128][dh] tiles
// (plain loads, once a block); rows past T are zeros
template <int DH>
__device__ __forceinline__ void load_owned(const float* head, long long st, int row0, int T,
                                           int dh, float* hi, float* lo, int tid) {
  for (int item = tid; item < kOwn * Plan<DH>::C; item += kThreads) {
    const int c = item / kOwn, r = item - c * kOwn;
    float4 h, l;
    split4(load_chunk(head, st, row0 + r, c, T, dh), h, l);
    *reinterpret_cast<float4*>(hi + tile_at<DH>(r, c)) = h;
    *reinterpret_cast<float4*>(lo + tile_at<DH>(r, c)) = l;
  }
}

// raw owned [128][dh] tile: row r's chunk c at chunk c ^ (r % 8), so that a
// warp's A fragment reads (rows g and g + 8, columns 8k + t and + 4) fall on
// 32 banks
template <int DH>
__device__ __forceinline__ int own_at(int r, int col) {
  return r * DH + (col ^ ((r & 7) << 2));
}

// rows [row0, row0 + ROWS) of a head in a raw owned tile (fp32, plain
// loads, once a block); rows past T are zeros
template <int DH, int ROWS = kOwn>
__device__ __forceinline__ void load_owned_raw(const float* head, long long st, int row0,
                                               int T, int dh, float* raw, int tid) {
  static_assert(DH >= 32, "the swizzle permutes 8 chunks of a row");
  for (int item = tid; item < ROWS * Plan<DH>::C; item += kThreads) {
    const int c = item / ROWS, r = item - c * ROWS;
    *reinterpret_cast<float4*>(raw + own_at<DH>(r, 4 * c)) =
        load_chunk(head, st, row0 + r, c, T, dh);
  }
}

// The hi and lo A fragments of k-step k from a raw owned tile: block rows
// rl and rl + 8 (rl % 8 = g), columns 8k + t and 8k + t + 4
template <int DH>
__device__ __forceinline__ void raw_frag(const float* raw, int rl, int k, int t4,
                                         uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const int c = 8 * k + t4;
  const float v[4] = {raw[own_at<DH>(rl, c)], raw[own_at<DH>(rl + 8, c)],
                      raw[own_at<DH>(rl, c + 4)], raw[own_at<DH>(rl + 8, c + 4)]};
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const Split sp = split(v[x]);
    hi[x] = sp.hi;
    lo[x] = sp.lo;
  }
}

// The warp's 16 owned rows of a head as the A fragments (hi, lo) of its
// k-steps over dh: rows r0, r0 + 8, columns 8 k + t and 8 k + t + 4 (plain
// loads, once a block); rows past T are zeros
template <int DH>
__device__ __forceinline__ void owned_frags(const float* head, long long st, int r0, int T,
                                            int dh, int t4, uint32_t (&hi)[DH / 8][4],
                                            uint32_t (&lo)[DH / 8][4]) {
  const bool in0 = r0 < T, in1 = r0 + 8 < T;
  const float* a = head + (long long)(in0 ? r0 : 0) * st;
  const float* b = head + (long long)(in1 ? r0 + 8 : 0) * st;
#pragma unroll
  for (int k = 0; k < DH / 8; ++k) {
    const int c = 8 * k + t4;
    const bool lo_in = !kPadBuild || c < dh, hi_in = !kPadBuild || c + 4 < dh;
    const float v[4] = {in0 && lo_in ? a[c] : 0.f, in1 && lo_in ? b[c] : 0.f,
                        in0 && hi_in ? a[c + 4] : 0.f, in1 && hi_in ? b[c + 4] : 0.f};
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const Split sp = split(v[x]);
      hi[k][x] = sp.hi;
      lo[k][x] = sp.lo;
    }
  }
}

// dS or Pd of 8 streamed rows (one k-step) as the hi and lo A fragments
__device__ __forceinline__ void frag(const float (&v)[4], uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const float a[4] = {v[0], v[2], v[1], v[3]};
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const Split s = split(a[x]);
    hi[x] = s.hi;
    lo[x] = s.lo;
  }
}

// S = Q K^T and, with Two, dP = dO V^T of one stage (or S^T = K Q^T and
// dP^T = V dO^T), 3xTF32, with the owned A operands of raw tiles: each
// k-step's fragments split into one of two buffers, its products committed
// as a group, so that the split of k-step k + 1 runs beside them. With
// DEPTH > 1 (dh = 256, whose 32 k-steps of small products a stage would
// otherwise wait on one another through one accumulator) k-step k sums into
// partial k % DEPTH from a buffer of its own, DEPTH groups in flight, and
// the partials are added into sa (pa) in pairs at the end.
template <int DH, int NS, bool Two, int DEPTH = 1>
__device__ __forceinline__ void products_raw(float (&sa)[NS / 2], float (&pa)[NS / 2],
                                             const float* a_raw, const float* b_raw, int rl,
                                             int t4, uint64_t sb_hi, uint64_t sb_lo,
                                             uint64_t pb_hi, uint64_t pb_lo) {
  constexpr int NB = DEPTH > 1 ? DEPTH : 2;  // fragment buffers: groups in flight
  constexpr int NP = DEPTH > 1 ? DEPTH : 1;  // partial sums
  static_assert(DEPTH == 1 || (DEPTH & (DEPTH - 1)) == 0, "partials are added in pairs");
  uint32_t ah[NB][4], al[NB][4], bh[NB][4], bl[NB][4];
  float sp[NP][NS / 2], pp[NP][NS / 2];
  if constexpr (DEPTH > 1) {
#pragma unroll
    for (int r = 0; r < NP; ++r) {
#pragma unroll
      for (int x = 0; x < NS / 2; ++x) sp[r][x] = pp[r][x] = 0.f;
      fence_regs(sp[r]);
      fence_regs(pp[r]);
    }
  }
#pragma unroll
  for (int k = 0; k < DH / 8; ++k) {
    const int u = k % NB;
    if (k >= NB) wgmma_wait<NB - 1>();  // k-step k - NB is done: its buffers are free
    fence_regs(ah[u]);
    fence_regs(al[u]);
    if constexpr (Two) {
      fence_regs(bh[u]);
      fence_regs(bl[u]);
    }
    raw_frag<DH>(a_raw, rl, k, t4, ah[u], al[u]);
    if constexpr (Two) raw_frag<DH>(b_raw, rl, k, t4, bh[u], bl[u]);
    fence_regs(ah[u]);
    fence_regs(al[u]);
    if constexpr (Two) {
      fence_regs(bh[u]);
      fence_regs(bl[u]);
    }
    wgmma_fence();
    if constexpr (DEPTH > 1) {
      mma3_rs<NS>(sp[k % NP], ah[u], al[u], sb_hi + 16 * k, sb_lo + 16 * k);
      if constexpr (Two) mma3_rs<NS>(pp[k % NP], bh[u], bl[u], pb_hi + 16 * k, pb_lo + 16 * k);
    } else {
      mma3_rs<NS>(sa, ah[u], al[u], sb_hi + 16 * k, sb_lo + 16 * k);
      if constexpr (Two) mma3_rs<NS>(pa, bh[u], bl[u], pb_hi + 16 * k, pb_lo + 16 * k);
    }
    wgmma_commit();
  }
  wgmma_wait<0>();
#pragma unroll
  for (int u = 0; u < NB; ++u) {
    fence_regs(ah[u]);
    fence_regs(al[u]);
    if constexpr (Two) {
      fence_regs(bh[u]);
      fence_regs(bl[u]);
    }
  }
  if constexpr (DEPTH > 1) {
#pragma unroll
    for (int r = 0; r < NP; ++r) {
      fence_regs(sp[r]);
      fence_regs(pp[r]);
    }
#pragma unroll
    for (int step = NP / 2; step >= 1; step /= 2) {
#pragma unroll
      for (int r = 0; r < step; ++r) {
#pragma unroll
        for (int x = 0; x < NS / 2; ++x) {
          sp[r][x] += sp[r + step][x];
          if constexpr (Two) pp[r][x] += pp[r + step][x];
        }
      }
    }
#pragma unroll
    for (int x = 0; x < NS / 2; ++x) {
      sa[x] += sp[0][x];
      if constexpr (Two) pa[x] += pp[0][x];
    }
  }
}

// whether every row of a [B, T, D] input starts on 16 bytes (cp.async), at a
// head width dh that is a multiple of 4; other widths are copied 4 bytes at a
// time and need nothing more
inline bool rows_aligned(long long base, long long sb, long long st, long long dh) {
  return dh % 4 != 0 || (base % 16 == 0 && sb % 4 == 0 && st % 4 == 0);
}

}  // namespace amid_long
