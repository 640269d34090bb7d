// The pieces of the native bf16 long-sequence attention kernels
// (attention_fwd_long_bf16.cu, attention_bwd_long_bf16.cu): the pack
// pre-pass, the tile layout, the shared-memory descriptors and the wgmma
// m64nNk16 .f32.bf16.bf16 products.
//
// The packed layout. The pre-pass rounds each operand (q, k, v and, for the
// backward, dout) to bf16 once a call (cvt.rn: nearest even) and writes it
// head-major, [B, H, T_pad, dh_pad], in the order wgmma reads without
// swizzle: core matrices of 8 rows x 8 columns (16 bytes a row, 128 bytes
// contiguous), core matrix (r / 8, c / 8) at byte ((r / 8) * CB + c / 8) * 128
// of its head, CB = dh_pad / 8. T_pad is T rounded up to kPadRows (rows past T
// zero; the forward at template width 256 packs K and V alone, to whole
// 64-key stages), dh_pad is dh's template width on the long paths (attention_common.cuh,
// long_template_dh: 256 for dh 129 to 256), or 16 at dh <= 8 (a k16 step
// reads 16 columns); the padding columns are zero. So
// any run of rows of one head, a streamed stage or a block's owned rows, is
// one contiguous block, landed by one cp.async.bulk.
//
// One tile, two readings (no transposed copies):
//   * K-major (the B of S = Q K^T, or an owned A): the reduced axis is dh.
//     LBO (between core matrices along the reduced axis) 128 bytes, SBO
//     (along the rows) 16 dh_pad bytes; a k16 step moves 256 bytes.
//   * MN-major (the B of O += P V, dQ += dS K, dK += dS^T Q, dV += Pd^T dO,
//     with the transpose immediate set): the reduced axis is the rows. LBO
//     (along the rows) 16 dh_pad bytes, SBO (along dh) 128 bytes; a k16 step
//     (16 rows) moves 32 dh_pad bytes. This is the no-swizzle canonical
//     layout ((1,n),(8,k)) : ((SBO),(16 B, LBO)) of the PTX ISA's wgmma
//     shared-memory matrix layouts (CUTLASS's make_gmma_desc<Major::MN>,
//     LayoutType::INTERLEAVE).
// P, dS and Pd leave their fp32 accumulator as k16 A fragments without a
// shuffle: column groups 2 kk and 2 kk + 1 of an m64nN accumulator are the
// A fragment of k-step kk, two values a register (cvt.rn.bf16x2.f32).

#pragma once

#include <cuda_bf16.h>

#include "attention_common.cuh"
#include "hopper.cuh"

namespace amid_bf16 {

using namespace amid_attention;
using namespace amid_hopper;

constexpr int kThreads = 256;  // two consumer warpgroups; thread 0 also issues the copies
constexpr int kOwn = 128;      // rows a block owns, 64 a warpgroup
constexpr int kPadRows = 128;  // T_pad: T rounded up to this (a multiple of kOwn and of a stage)

inline long long padded_t(long long T) { return (T + kPadRows - 1) / kPadRows * kPadRows; }

// the sizes of one head width's tiles, for stages of NS rows
template <int DH, int NS>
struct Tiles {
  static constexpr int DHP = padded_dh(DH);
  static constexpr int CB = DHP / 8;         // core matrices across a row
  static constexpr int TILE = NS * DHP * 2;  // bytes of a streamed [NS][dh_pad] tile
  static constexpr int OWN = kOwn * DHP * 2;  // bytes of an owned [128][dh_pad] tile
  static constexpr int WG_OWN = OWN / 2;     // a warpgroup's 64 owned rows
  static constexpr int KSTEPS = DHP / 16;    // k16 steps over dh
  static constexpr int RSTEPS = NS / 16;     // k16 steps over a stage's rows
  static constexpr uint64_t RSTEP = 2 * DHP;  // a k16 step over rows, in descriptor units
};

template <int DHP>
__device__ __forceinline__ uint64_t kmajor_desc(const void* tile) {
  return matrix_desc(smem_u32(tile), 128, 16 * DHP);
}
template <int DHP>
__device__ __forceinline__ uint64_t mnmajor_desc(const void* tile) {
  return matrix_desc(smem_u32(tile), 16 * DHP, 128);
}

// The A fragment of one k16 step from the 8 values a thread holds of two
// accumulator column groups j0 = 2 kk and j1 = 2 kk + 1 (v[4 x + e]: group
// j_x, element e): registers (row g, cols 2t, 2t+1), (row g+8, ...), (row g,
// cols 2t+8, 2t+9), (row g+8, ...).
__device__ __forceinline__ void a_frag(const float (&v)[8], uint32_t (&a)[4]) {
  a[0] = pack_bf16x2(v[0], v[1]);
  a[1] = pack_bf16x2(v[2], v[3]);
  a[2] = pack_bf16x2(v[4], v[5]);
  a[3] = pack_bf16x2(v[6], v[7]);
}

// ---------------------------------------------------------------------------
// wgmma m64nNk16, bf16 operands, fp32 accumulator (d +=)
// ---------------------------------------------------------------------------
// mma_ss: A [64 x 16] and B [N x 16] K-major in shared memory (descriptors).
// mma_rs_t: A in registers, B MN-major in shared memory (transposed B). The
// accumulator gives a thread rows 16 warp + g (d[4j], d[4j+1]) and + 8
// (d[4j+2], d[4j+3]) of columns 8j + 2t + {0, 1}, g = lane / 4, t = lane % 4.
#define BFL_L8 "%0, %1, %2, %3, %4, %5, %6, %7"
#define BFL_L16 BFL_L8 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define BFL_L32                                                                        \
  BFL_L16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, " \
          "%31"
#define BFL_L64                                                                      \
  BFL_L32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, " \
          "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "   \
          "%62, %63"
#define BFL_L128 BFL_L64 ", " \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, " \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
#define BFL_R(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define BFL_O8 BFL_R(0), BFL_R(4)
#define BFL_O16 BFL_O8, BFL_R(8), BFL_R(12)
#define BFL_O32 BFL_O16, BFL_R(16), BFL_R(20), BFL_R(24), BFL_R(28)
#define BFL_O64 BFL_O32, BFL_R(32), BFL_R(36), BFL_R(40), BFL_R(44), BFL_R(48), BFL_R(52), \
                BFL_R(56), BFL_R(60)
#define BFL_O128 BFL_O64, BFL_R(64), BFL_R(68), BFL_R(72), BFL_R(76), BFL_R(80), BFL_R(84), \
                 BFL_R(88), BFL_R(92), BFL_R(96), BFL_R(100), BFL_R(104), BFL_R(108),      \
                 BFL_R(112), BFL_R(116), BFL_R(120), BFL_R(124)

template <int N>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t a, uint64_t b);
template <int N>
__device__ __forceinline__ void mma_rs_t(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b);

template <>
__device__ __forceinline__ void mma_ss<64>(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" BFL_L32
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : BFL_O32
      : "l"(a), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void mma_ss<32>(float (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {" BFL_L16
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : BFL_O16
      : "l"(a), "l"(b), "r"(1));
}
// m64n256k16: the output of a head of template width 256 (the dh = 256
// builds, attention_*_long_bf16.cu with AMID_BF16_WIDE=1), 128 registers a thread
template <>
__device__ __forceinline__ void mma_rs_t<256>(float (&d)[128], const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {" BFL_L128
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : BFL_O128
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void mma_rs_t<128>(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" BFL_L64
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : BFL_O64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void mma_rs_t<64>(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" BFL_L32
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : BFL_O32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void mma_rs_t<32>(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {" BFL_L16
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : BFL_O16
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void mma_rs_t<16>(float (&d)[8], const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {" BFL_L8
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : BFL_O8
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// ---------------------------------------------------------------------------
// the pack pre-pass
// ---------------------------------------------------------------------------
// Up to four [B, T, H * dh] fp32 inputs, each into its packed [B, H, T_pad,
// dh_pad] bf16 region of the scratch (region z at out + z * region). One
// thread writes one 16-byte chunk (8 columns of one row); consecutive
// threads write consecutive chunks, so a warp writes 512 contiguous bytes.
// Where dh is a multiple of 8 (rows on 16 bytes) a chunk is read as two
// float4s, else value by value, the columns from dh on as zeros.
struct PackArgs {
  const float* src[4];
  long long sb[4], st[4];
  __nv_bfloat16* out;
  long long region;  // bf16 elements of one packed input
  int T, Tp, H, dh, dhp;
};

__global__ void pack_kernel(const PackArgs a) {
  const int z = blockIdx.y;
  const float* src = a.src[z];
  const long long sb = a.sb[z], st = a.st[z];
  uint4* out = reinterpret_cast<uint4*>(a.out + z * a.region);
  const int cb_n = a.dhp / 8, rb_n = a.Tp / 8;
  const long long chunks = a.region / 8;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < chunks;
       e += (long long)gridDim.x * blockDim.x) {
    const int r8 = (int)(e & 7);
    long long q = e >> 3;
    const int cb = (int)(q % cb_n);
    q /= cb_n;
    const int rb = (int)(q % rb_n);
    const long long bh = q / rb_n;
    const int row = rb * 8 + r8, col = cb * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row < a.T && col < a.dh) {
      const long long b = bh / a.H, h = bh - b * a.H;
      const float* x = src + b * sb + row * st + h * a.dh + col;
      float f[8];
      if ((a.dh & 7) == 0) {
        const float4 x0 = __ldg(reinterpret_cast<const float4*>(x)),
                     x1 = __ldg(reinterpret_cast<const float4*>(x) + 1);
        f[0] = x0.x, f[1] = x0.y, f[2] = x0.z, f[3] = x0.w;
        f[4] = x1.x, f[5] = x1.y, f[6] = x1.z, f[7] = x1.w;
      } else {
#pragma unroll
        for (int c = 0; c < 8; ++c) f[c] = col + c < a.dh ? __ldg(x + c) : 0.f;
      }
      v = make_uint4(pack_bf16x2(f[0], f[1]), pack_bf16x2(f[2], f[3]),
                     pack_bf16x2(f[4], f[5]), pack_bf16x2(f[6], f[7]));
    }
    out[e] = v;
  }
}

// A bias that broadcasts over queries (BERT4Rec's key padding [1|B,1,1,T]):
// each of its `rows` rows padded to T_pad with -inf (a padded key gets P = 0)
__global__ void bias_rows_kernel(const float* __restrict__ bias, long long bias_sb,
                                 float* __restrict__ out, int rows, int T, int Tp) {
  const long long n = (long long)rows * Tp;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    const long long r = e / Tp;
    const int j = (int)(e - r * Tp);
    out[e] = j < T ? bias[r * bias_sb + j] : -INFINITY;
  }
}

// grid-stride launch of `n` items, 256 threads a block
inline dim3 blocks_for(long long n) {
  long long g = (n + 255) / 256;
  return dim3((unsigned)(g < 65535 * 16 ? (g < 1 ? 1 : g) : 65535 * 16));
}

// Packs `nsrc` inputs (the first of `src`, with their strides) to `Tp` rows
// a head (0: padded_t(T)) and launches nothing else; the caller checks
// cudaGetLastError.
inline void launch_pack(const float* const* src, const long long* sb, const long long* st,
                        int nsrc, __nv_bfloat16* out, long long B, int T, int H, int dh,
                        cudaStream_t stream, int Tp = 0) {
  PackArgs a;
  for (int z = 0; z < 4; ++z) {
    a.src[z] = z < nsrc ? src[z] : nullptr;
    a.sb[z] = z < nsrc ? sb[z] : 0;
    a.st[z] = z < nsrc ? st[z] : 0;
  }
  a.out = out;
  a.T = T;
  a.Tp = Tp > 0 ? Tp : (int)padded_t(T);
  a.H = H;
  a.dh = dh;
  a.dhp = padded_dh(long_template_dh(dh));
  a.region = B * H * a.Tp * (long long)a.dhp;
  dim3 grid = blocks_for(a.region / 8);
  grid.y = nsrc;
  pack_kernel<<<grid, 256, 0, stream>>>(a);
}

// whether every row of a [B, T, D] input starts on 16 bytes (the float4
// loads of the pre-pass), at a head width dh that is a multiple of 4; other
// widths are read value by value and need nothing more
inline bool rows_aligned(long long base, long long sb, long long st, long long dh) {
  return dh % 4 != 0 || (base % 16 == 0 && sb % 4 == 0 && st % 4 == 0);
}

}  // namespace amid_bf16
