// Batch max-affinity for Hopper (sm_90a):
//
//     out[b, c] = max_{i, j} a[b, i, :] . bank[c, j, :]
//
// a: [B, N, D], bank: [C, M, D] -> out [B, C] fp32. Inputs are rounded to
// bf16 (round to nearest even), products are exact and sums run in fp32 on
// the tensor cores. Forward only: the hard gate built from the result passes
// no gradient.
//
// Two entry points, one __global__ template (affinity_wgmma_kernel<K, U>,
// slot width W = 8 K, U query users a slot):
//
// * max_affinity_blocked (K6, U = 1) replaces amid_tpu/ops/pallas_affinity.py::
//   _affinity_kernel (pallas_call in max_affinity_pallas), the blocked kernel
//   for long sequences.
// * max_affinity_smalln (K7, U = 8, 4 or 2) replaces ::_affinity_smalln_kernel
//   (pallas_call in max_affinity_pallas_smalln), the kernel for short query
//   sequences (N <= 80).
//
// Neither writes an [N, M] score block anywhere: the scores live in
// accumulator registers and are folded into maxima there.
//
// Bound on the H100 (data sheet): operations. 2*B*C*N*M*D = 377 GFLOP at
// B = C = 256, N = M = 150, D = 128: 0.38 ms at the bf16 tensor-core peak of
// 989 TFLOP/s (the inputs are 39 MB: 0.012 ms). At N = M = 20: 6.7 GFLOP,
// 0.0068 ms.
//
// The bank is one matrix: for a query user b the scores are bank_flat
// [C*M, D] x a_b^T [D, N], and A[b, c] is the max over the rows of peer
// c = row / M of each row's max over the user's columns.
//
// * A pre-pass (pack_kernel) rounds both inputs to bf16 once per call and
//   writes them in the operand layout wgmma reads without swizzle: K-major
//   core matrices of 8 rows x 16 bytes, each 128 contiguous bytes. Rows are
//   padded with zeros to planes of kKWidth = 128 columns (a zero adds
//   nothing to a dot product; one plane up to D = 128, see "Any D" below),
//   so the products of a tile and plane are always eight k16 steps and
//   unrolled: ptxas serialises wgmma issued from a loop it cannot unroll
//   (it waits for each product before the next). Row group g = r / 8,
//   16-byte column chunk k and row r % 8 sit at element (g * 128 + k * 8 +
//   r % 8) * 8, so any run of whole row groups is contiguous: a 64-row bank
//   tile is one bulk copy of 16 KB (cp.async.bulk, the TMA engine's linear
//   mode, completing on an mbarrier), with no tensor map.
// * The query side is cut into slots of W rows (W a multiple of 8, at most
//   160: wgmma's N); slot row w is column w of the accumulator. K6 (U = 1):
//   one slot per user when N <= 160, else 2 or 4 chunks of a user (KC).
//   K7 (U > 1): U users a slot, interleaved so that a user's columns sit at
//   fixed places in every group of 8: with S = 8 / U, column 8 j + q holds
//   row j * S + q % S of the slot's user q / S (U = 8: user q, row j). The
//   user of a column then depends on U alone, not on N, so the fold needs
//   no division and no runtime index into registers, and with U >= 4 a
//   thread's columns belong to one or two users whole (U = 2: a pair of
//   threads). U = 8 for N <= 20 (W = 8 N: 8 users in 160 columns at N = 20,
//   no padding), 4 up to N = 40, 2 up to N = 80 (W = 8 ceil(N U / 8)).
// * Padding never wins a max: a slot's rows past a user's last repeat that
//   last row, so a padding column scores what a real one of the same user
//   does and no column is masked (a zero row would score 0 and beat an
//   all-negative maximum); slots past the last user repeat it and are not
//   written out; bank rows outside the block's peers are skipped by index.
// * A block holds four slots resident in shared memory (two per consumer
//   warpgroup: two accumulators of W / 2 floats a thread) and streams the
//   bank's 64-row tiles through a ring of `stages` buffers (full and empty
//   mbarriers per buffer). Thread 0 issues the copies: the first `stages`
//   tiles up front, then, at the end of tile i, tile i - 1 + stages into the
//   buffer both warpgroups released during tile i. No producer warp: a
//   wgmma kernel's registers are allotted per warpgroup, so a 9th warp
//   would cut every thread to 168 registers, below the two accumulators of
//   W = 152 (ptxas then serialises the products and puts them on the
//   stack). Each bank tile read from L2 serves four query slots: 4 users
//   in K6 at N <= 160, 32 in K7 at N <= 20 (four m64n160k16 products a
//   k-step at N = 20, where K6 issues four m64n24k16).
// * Per tile a warpgroup issues the eight wgmma m64nWk16 steps of each of
//   its two slots (one commit group a slot), waits for them, releases the
//   buffer and folds both accumulators. The two warpgroups take turns
//   (named barriers 1 and 2): a warpgroup passes the turn once its first
//   slot is done, so the other one's products queue behind its second slot
//   and the tensor cores run one warpgroup's products while the other
//   folds. Two warpgroups that issue at once would finish, and fold, at
//   once. Nothing is in flight while a thread branches on its own index
//   (the fold, the copies): ptxas would otherwise wait for every product
//   before the next.
// * The fold (a thread holds rows r and r + 8 of the tile, 16 rows a warp,
//   and W / 4 columns of each): first over the thread's columns of each
//   user (K6: then across the quad; K7, U = 2: across a pair), then over
//   the warp's rows by peer. When the warp's rows lie in one or two peers
//   (always for M >= 16) each peer's rows are max-reduced across the warp
//   by shuffles and one thread a (user, peer) folds the value into the
//   block's [users, peers] table in shared memory with an atomic max;
//   otherwise each row folds its own value. A max is exact, so the order of
//   the folds does not change the result.
// * Bit-equal: every score is the same eight k16 products of the same
//   zero-padded operands in the same order in K6 and K7, whatever the slot
//   width, so the two kernels agree bit for bit wherever both take a shape.
// * The grid is (query groups of four slots) x (slices of the peers). Slices
//   split the bank only at peer boundaries, so every out[b, c] is written by
//   exactly one block, once, with a plain store: no atomics in device
//   memory, a deterministic result. The wrapper picks the slice count that
//   minimises waves x tiles per block on 132 SMs (ops/affinity.py).
// * Shared memory: 4 W * 256 bytes of query slots, stages * 16 KB of ring,
//   4 U * 4 bytes per peer of the slice (the [users, peers] table), 8 per
//   barrier: 223,304 bytes at W = 152 (K6, N = 150), four stages, 128
//   peers; 231,496 at W = 160 (K7, N = 20), four stages, 16 peers: one
//   block an SM.
//
// * Any D. The pack pads a row with zeros to a multiple of 128 columns and
//   writes each 128-column chunk as a plane of its own (the planes of the
//   bank, then those of the query slots). Up to D = 128 there is one plane
//   and the design above holds. Above it (the chunked instances, CH), a
//   160-row slot of 1,024 columns would take 327,680 bytes and a 64-row
//   bank tile 131,072, so neither stays whole in shared memory: each stage
//   of the ring holds one plane of a bank tile (16 KB) and the same plane
//   of the block's four query slots (4 W * 256 bytes), both landed by bulk
//   copies on the stage's full barrier, and a tile is ceil(D / 128) stages
//   in a row. The products of a tile's planes accumulate in the same
//   wgmma accumulators (the scale flag clears them at the first k-step of
//   the first plane only) and the fold runs after the last plane. Slots are
//   then at most kChunkedMaxWidth = 80 rows wide, so that two stages and
//   the [users, peers] table fit (K6 at N = 150: two slots of 80 a user;
//   K7: N <= 40).
// * Any N (K6). A user's query takes KC slots, KC in {1, 2, 4} or a
//   multiple of 4 (the slots past its last row repeat that row). With KC
//   > 4 a block holds four slots of one user, KC / 4 blocks share each
//   out[b, c], and each folds its maximum into it with an atomic max on the
//   float's order-preserving integer image, after the wrapper's memset of
//   out to 0xff bytes (an image below every float's in both of the orders
//   atomic_max_float uses). A max is order-free, so the result is the same
//   bits from call to call.
//
// What bounds K7 at N = M = 20: 6.7 GFLOP is 0.0068 ms of tensor cores, and
// every block also reads its 160 KB of query slots and its slice of the bank
// from L2 before and while it multiplies; the pre-pass is a second kernel of
// the call. K7 folds 80 accumulators a slot per tile into 4 values with no
// shuffle before the row fold, where K6 at W = 24 pays a fold for every thin
// m64n24 product.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"

namespace {

using namespace amid_hopper;

constexpr int kTileRows = 64;          // bank rows per tile: wgmma's M
constexpr int kKWidth = 128;           // operand columns of a plane, D padded with zeros
constexpr int kKSteps = kKWidth / 16;  // wgmma k16 products per tile and slot
constexpr int kTileBytes = kTileRows * kKWidth * 2;
constexpr int kSlots = 4;              // query slots resident per block
constexpr int kWgThreads = 256;        // two warpgroups, two slots each
constexpr int kMaxWidthSteps = 20;     // slot width W = 8 * K, K <= 20
constexpr int kMaxStages = 8;
constexpr int kMaxPeers = 256;         // peers per slice
constexpr int kSmallnMaxN = 80;        // K7: at least two users a slot of 160
constexpr int kChunkedMaxWidth = 80;   // slot rows of the chunked instances (D > 128)
constexpr int kMaxD = 65536;           // columns a row may have

// Refusals of the entry points (negative; a positive value is a cudaError_t).
enum Refusal { kBadShape = -1, kBadPlan = -2, kLongQuery = -3 };

// Shared-memory matrix descriptor of a K-major operand without swizzle:
// start address, leading byte offset 128 (the two 16-byte column chunks of a
// k16 step), stride byte offset 16 * 128 (the next 8-row group), all >> 4.
__device__ __forceinline__ uint64_t operand_desc(uint32_t addr) {
  return matrix_desc(addr, 128, 16 * kKWidth);
}

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// d[64 x 8K] (+)= A[64 x 16] . B[8K x 16]^T, both bf16 K-major in shared
// memory; d += when `accumulate`, else d =. The accumulator of m64nNk16 gives
// a thread rows warp*16 + lane/4 (d[4j], d[4j+1]) and + 8 (d[4j+2],
// d[4j+3]) of columns 8j + 2*(lane%4) + {0, 1}.
template <int K>
__device__ __forceinline__ void wgmma_bf16(float (&d)[4 * K], uint64_t a, uint64_t b,
                                           int accumulate);

// The operand list of one instruction: descriptors and the scale flag first
// (%0 %1 %2), then the 4K accumulators (%3 ...), so that the K-th list is
// the (K-1)-th with four more entries.
#define AFF_G0 "%3, %4, %5, %6"
#define AFF_G1 AFF_G0 ", %7, %8, %9, %10"
#define AFF_G2 AFF_G1 ", %11, %12, %13, %14"
#define AFF_G3 AFF_G2 ", %15, %16, %17, %18"
#define AFF_G4 AFF_G3 ", %19, %20, %21, %22"
#define AFF_G5 AFF_G4 ", %23, %24, %25, %26"
#define AFF_G6 AFF_G5 ", %27, %28, %29, %30"
#define AFF_G7 AFF_G6 ", %31, %32, %33, %34"
#define AFF_G8 AFF_G7 ", %35, %36, %37, %38"
#define AFF_G9 AFF_G8 ", %39, %40, %41, %42"
#define AFF_G10 AFF_G9 ", %43, %44, %45, %46"
#define AFF_G11 AFF_G10 ", %47, %48, %49, %50"
#define AFF_G12 AFF_G11 ", %51, %52, %53, %54"
#define AFF_G13 AFF_G12 ", %55, %56, %57, %58"
#define AFF_G14 AFF_G13 ", %59, %60, %61, %62"
#define AFF_G15 AFF_G14 ", %63, %64, %65, %66"
#define AFF_G16 AFF_G15 ", %67, %68, %69, %70"
#define AFF_G17 AFF_G16 ", %71, %72, %73, %74"
#define AFF_G18 AFF_G17 ", %75, %76, %77, %78"
#define AFF_G19 AFF_G18 ", %79, %80, %81, %82"
#define AFF_R(i) "+f"(d[4 * i]), "+f"(d[4 * i + 1]), "+f"(d[4 * i + 2]), "+f"(d[4 * i + 3])
#define AFF_C0 AFF_R(0)
#define AFF_C1 AFF_C0, AFF_R(1)
#define AFF_C2 AFF_C1, AFF_R(2)
#define AFF_C3 AFF_C2, AFF_R(3)
#define AFF_C4 AFF_C3, AFF_R(4)
#define AFF_C5 AFF_C4, AFF_R(5)
#define AFF_C6 AFF_C5, AFF_R(6)
#define AFF_C7 AFF_C6, AFF_R(7)
#define AFF_C8 AFF_C7, AFF_R(8)
#define AFF_C9 AFF_C8, AFF_R(9)
#define AFF_C10 AFF_C9, AFF_R(10)
#define AFF_C11 AFF_C10, AFF_R(11)
#define AFF_C12 AFF_C11, AFF_R(12)
#define AFF_C13 AFF_C12, AFF_R(13)
#define AFF_C14 AFF_C13, AFF_R(14)
#define AFF_C15 AFF_C14, AFF_R(15)
#define AFF_C16 AFF_C15, AFF_R(16)
#define AFF_C17 AFF_C16, AFF_R(17)
#define AFF_C18 AFF_C17, AFF_R(18)
#define AFF_C19 AFF_C18, AFF_R(19)
#define AFF_WGMMA(K, N, I)                                                              \
  template <>                                                                         \
  __device__ __forceinline__ void wgmma_bf16<K>(float (&d)[4 * K], uint64_t a,         \
                                                uint64_t b, int accumulate) {         \
    asm volatile(                                                                     \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %2, 0;\n"                                   \
        "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {" AFF_G##I           \
        "}, %0, %1, p, 1, 1, 0, 0;\n}\n"                                              \
        : "+l"(a), "+l"(b), "+r"(accumulate), AFF_C##I);                              \
  }
AFF_WGMMA(1, 8, 0)
AFF_WGMMA(2, 16, 1)
AFF_WGMMA(3, 24, 2)
AFF_WGMMA(4, 32, 3)
AFF_WGMMA(5, 40, 4)
AFF_WGMMA(6, 48, 5)
AFF_WGMMA(7, 56, 6)
AFF_WGMMA(8, 64, 7)
AFF_WGMMA(9, 72, 8)
AFF_WGMMA(10, 80, 9)
AFF_WGMMA(11, 88, 10)
AFF_WGMMA(12, 96, 11)
AFF_WGMMA(13, 104, 12)
AFF_WGMMA(14, 112, 13)
AFF_WGMMA(15, 120, 14)
AFF_WGMMA(16, 128, 15)
AFF_WGMMA(17, 136, 16)
AFF_WGMMA(18, 144, 17)
AFF_WGMMA(19, 152, 18)
AFF_WGMMA(20, 160, 19)

__device__ __forceinline__ void atomic_max_float(float* addr, float v) {
  // sign bit clear: the int order is the float order; set: the reverse of
  // the unsigned order (the slot starts at -inf, 0xff800000)
  if (__float_as_int(v) >= 0)
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
  else
    atomicMin(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
}

// Where a block's rows go: peers [c_lo, c_lo + peers) of slice blockIdx.y,
// their bank rows [row_lo, row_hi), and the block's [users][peers] maxima.
struct Fold {
  float* omax;  // already offset by -c_lo
  int peers, M, row_lo, row_hi;
};

// Folds one accumulator (rows of bank tile `tile`, columns of one slot of
// the block's user `lu`) into the block's maxima.
template <int K>
__device__ __forceinline__ void fold_tile(const float (&acc)[4 * K], int tile, int lu,
                                          const Fold& f, int warp, int lane) {
  // two chains a row: the fold is bound by the latency of its max chain
  float m[2][2] = {{-INFINITY, -INFINITY}, {-INFINITY, -INFINITY}};
#pragma unroll
  for (int j = 0; j < K; ++j) {
    m[0][j & 1] = fmaxf(m[0][j & 1], fmaxf(acc[4 * j], acc[4 * j + 1]));
    m[1][j & 1] = fmaxf(m[1][j & 1], fmaxf(acc[4 * j + 2], acc[4 * j + 3]));
  }
  float m0 = fmaxf(m[0][0], m[0][1]), m1 = fmaxf(m[1][0], m[1][1]);
  m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 1));
  m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 2));
  m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 1));
  m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 2));
  float* row_of_user = f.omax + lu * f.peers;
  const int first = tile * kTileRows + warp * 16;  // the warp's 16 rows
  if (first >= f.row_lo && first + 15 < f.row_hi && first / f.M == (first + 15) / f.M) {
    float m = fmaxf(m0, m1);
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 4));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 8));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 16));
    if (lane == 0) atomic_max_float(row_of_user + first / f.M, m);
  } else {
    const int r = first + (lane >> 2) + ((lane & 3) == 1 ? 8 : 0);
    if ((lane & 3) < 2 && r >= f.row_lo && r < f.row_hi)
      atomic_max_float(row_of_user + r / f.M, (lane & 3) == 0 ? m0 : m1);
  }
}

// Folds one accumulator of a K7 slot (U > 1 users; rows of bank tile
// `tile`, the slot's first user `lu0`) into the block's maxima. The thread's
// column 8 j + 2 t + e (t = lane % 4) belongs to the slot's user
// (2 t + e) / (8 / U): U = 8 gives the thread users 2 t and 2 t + 1, U = 4
// user t, U = 2 user t / 2, shared with lane t ^ 1.
template <int K, int U>
__device__ __forceinline__ void fold_users(const float (&acc)[4 * K], int tile, int lu0,
                                           const Fold& f, int warp, int lane) {
  constexpr int UT = U == 8 ? 2 : 1;  // users of one thread
  const int t = lane & 3, g = lane >> 2;
  // v[x][h]: the max of the thread's columns of its user x in row h (rows
  // g and g + 8); two chains each, as the max chain bounds the fold
  float v[UT][2];
  if constexpr (U == 8) {
    float m[2][2][2];
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int h = 0; h < 2; ++h) m[e][h][0] = m[e][h][1] = -INFINITY;
#pragma unroll
    for (int j = 0; j < K; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          m[e][h][j & 1] = fmaxf(m[e][h][j & 1], acc[4 * j + 2 * h + e]);
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int h = 0; h < 2; ++h) v[e][h] = fmaxf(m[e][h][0], m[e][h][1]);
  } else {
    float m[2][2] = {{-INFINITY, -INFINITY}, {-INFINITY, -INFINITY}};
#pragma unroll
    for (int j = 0; j < K; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        m[h][j & 1] = fmaxf(m[h][j & 1], fmaxf(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      v[0][h] = fmaxf(m[h][0], m[h][1]);
      if constexpr (U == 2) v[0][h] = fmaxf(v[0][h], __shfl_xor_sync(0xffffffffu, v[0][h], 1));
    }
  }
  const int user = lu0 + (U == 8 ? 2 * t : U == 4 ? t : t >> 1);  // of v[0]; v[1] is user + 1
  const bool writer = U != 2 || (t & 1) == 0;  // U = 2: one lane of each pair
  const int first = tile * kTileRows + warp * 16;  // the warp's 16 rows
  const int lo = first > f.row_lo ? first : f.row_lo;
  const int hi = first + 16 < f.row_hi ? first + 16 : f.row_hi;
  if (lo >= hi) return;  // no row of the block's peers
  const int p_lo = lo / f.M, p_hi = (hi - 1) / f.M;
  const int r0 = first + g, r1 = r0 + 8;
  if (p_hi - p_lo <= 1) {
    // one or two peers: each peer's rows max-reduced across the warp, then
    // one lane a user folds the value (U = 8: lanes g = 0 and 1)
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int p = p_lo + k;
      if (p > p_hi) break;
      const int a = p * f.M > lo ? p * f.M : lo, b = p * f.M + f.M < hi ? p * f.M + f.M : hi;
      const bool in0 = r0 >= a && r0 < b, in1 = r1 >= a && r1 < b;
      float w[UT];
#pragma unroll
      for (int x = 0; x < UT; ++x) {
        w[x] = fmaxf(in0 ? v[x][0] : -INFINITY, in1 ? v[x][1] : -INFINITY);
        w[x] = fmaxf(w[x], __shfl_xor_sync(0xffffffffu, w[x], 4));
        w[x] = fmaxf(w[x], __shfl_xor_sync(0xffffffffu, w[x], 8));
        w[x] = fmaxf(w[x], __shfl_xor_sync(0xffffffffu, w[x], 16));
      }
      if (writer && g < UT)
        atomic_max_float(f.omax + (user + g) * f.peers + p, g == 0 ? w[0] : w[UT - 1]);
    }
  } else {
    // three or more peers in 16 rows (M < 16): each row folds its own value
    if (writer) {
#pragma unroll
      for (int x = 0; x < UT; ++x)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = h ? r1 : r0;
          if (r >= lo && r < hi) atomic_max_float(f.omax + (user + x) * f.peers + r / f.M, v[x][h]);
        }
    }
  }
}

// pack_kernel: both inputs as bf16 in the operand layout (header), in
// planes of kKWidth columns (plane p: columns [128 p, 128 p + 128), those
// past D zero): the dc planes of the bank, then the dc planes of the query
// slots. The bank has bank_rows rows (a multiple of 64; rows past R = C*M
// repeat row R - 1); the query slots are W rows each: slot s, row w holds
// user min((s / KC) U + (w % 8) / S, B - 1) (S = 8 / U), its row
// min((s % KC) W + (w / 8) S + w % 8 % S, N - 1) (U = 1: chunk s % KC of
// user s / KC, row w of the chunk). One thread writes one 16-byte chunk;
// consecutive threads write consecutive chunks. `vec`: rows start on 16
// bytes and D is a multiple of 4 (16-byte loads), else element by element.
__global__ void pack_kernel(const float* __restrict__ a, const float* __restrict__ bank,
                            __nv_bfloat16* __restrict__ out, long long bank_chunks,
                            long long query_chunks, int dc, int D, long long R, int B, int N,
                            int W, int KC, int U, int vec) {
  const int S = 8 / U;
  const long long bank_all = bank_chunks * dc, total_chunks = bank_all + query_chunks * dc;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < total_chunks;
       e += (long long)gridDim.x * blockDim.x) {
    const bool in_bank = e < bank_all;
    const long long plane_chunks = in_bank ? bank_chunks : query_chunks;
    long long q = in_bank ? e : e - bank_all;
    const int plane = (int)(q / plane_chunks);
    q -= plane * plane_chunks;
    const long long group = q / kKWidth;  // 8-row group: 128 chunks of 16 bytes
    const int rem = (int)(q - group * kKWidth);
    const long long r = group * 8 + (rem & 7);
    const int col = plane * kKWidth + (rem >> 3) * 8;
    if (col >= D) {
      *reinterpret_cast<uint4*>(out + e * 8) = make_uint4(0u, 0u, 0u, 0u);
      continue;
    }
    const float* src;
    if (in_bank) {
      src = bank + (r < R ? r : R - 1) * D;
    } else {
      const long long s = r / W;
      const int w = (int)(r - s * W);
      long long user = (s / KC) * U + (w & 7) / S;
      if (user > B - 1) user = B - 1;
      long long row = (s % KC) * W + (w >> 3) * S + (w & 7) % S;
      if (row > N - 1) row = N - 1;
      src = a + (user * N + row) * D;
    }
    float x[8];
    if (vec) {
      const float4 x0 = *reinterpret_cast<const float4*>(src + col);
      const float4 x1 = col + 4 < D ? *reinterpret_cast<const float4*>(src + col + 4)
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
      x[0] = x0.x, x[1] = x0.y, x[2] = x0.z, x[3] = x0.w;
      x[4] = x1.x, x[5] = x1.y, x[6] = x1.z, x[7] = x1.w;
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) x[i] = col + i < D ? src[col + i] : 0.f;
    }
    __nv_bfloat162 h[4] = {__floats2bfloat162_rn(x[0], x[1]), __floats2bfloat162_rn(x[2], x[3]),
                           __floats2bfloat162_rn(x[4], x[5]), __floats2bfloat162_rn(x[6], x[7])};
    *reinterpret_cast<uint4*>(out + e * 8) = *reinterpret_cast<uint4*>(h);
  }
}

// CH: the chunked instances (D > 128: each stage a plane of a bank tile and
// of the four query slots); dc planes, each bank_plane (query_plane) bf16
// values apart
template <int K, int U, bool CH>
__global__ void __launch_bounds__(kWgThreads, 1)
affinity_wgmma_kernel(const __nv_bfloat16* __restrict__ bank,
                      const __nv_bfloat16* __restrict__ query, float* __restrict__ out,
                      int B, int C, int M, int KC, int stages, int peers, int dc,
                      long long bank_plane, long long query_plane) {
  constexpr int W = 8 * K, tile_bytes = kTileBytes, slot_bytes = W * kKWidth * 2;
  constexpr int stage_bytes = tile_bytes + (CH ? kSlots * slot_bytes : 0);
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* ring = smem + (CH ? 0 : kSlots * slot_bytes);
  float* omax = reinterpret_cast<float*>(ring + stages * stage_bytes);  // [4 U][peers]
  uint64_t* bars = reinterpret_cast<uint64_t*>(omax + kSlots * U * peers);
  // bars: full[stages], empty[stages], then the query's

  const int tid = threadIdx.x;
  // query users of this block, the first of them; KC > 4: four slots of one user
  const int users = KC > kSlots ? 1 : kSlots * U / KC;
  const int u0 = KC > kSlots ? blockIdx.x * kSlots / KC : blockIdx.x * users;
  const int c_lo = blockIdx.y * peers;
  const int c_hi = C - c_lo < peers ? C : c_lo + peers;
  const int row_lo = c_lo * M, row_hi = c_hi * M;
  const int t_lo = row_lo / kTileRows, n_tiles = (row_hi + kTileRows - 1) / kTileRows - t_lo;
  const int n_items = CH ? n_tiles * dc : n_tiles;  // stages streamed: (tile, plane)

  for (int i = tid; i < kSlots * U * peers; i += kWgThreads) omax[i] = -INFINITY;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(smem_u32(bars + s), 1);
      mbar_init(smem_u32(bars + stages + s), kWgThreads);
    }
    mbar_init(smem_u32(bars + 2 * stages), 1);
    mbar_init_fence();
  }
  __syncthreads();
  const uint32_t qbar = smem_u32(bars + 2 * stages);
  const __nv_bfloat16* block_query = query + (size_t)blockIdx.x * kSlots * W * kKWidth;
  // item i of this block goes to buffer i % stages (full barrier bars[s],
  // empty barrier bars[stages + s]); thread 0 issues every copy
  auto load_item = [&](int i) {
    const int s = i % stages;
    const int tile = CH ? i / dc : i, plane = CH ? i - tile * dc : 0;
    mbar_expect_tx(smem_u32(bars + s), stage_bytes);
    bulk_copy(smem_u32(ring + s * stage_bytes),
              bank + plane * bank_plane + (size_t)(t_lo + tile) * kTileRows * kKWidth,
              tile_bytes, smem_u32(bars + s));
    if constexpr (CH)
      bulk_copy(smem_u32(ring + s * stage_bytes + tile_bytes), block_query + plane * query_plane,
                kSlots * slot_bytes, smem_u32(bars + s));
  };
  if (tid == 0) {
    if constexpr (!CH) {
      mbar_expect_tx(qbar, kSlots * slot_bytes);
      bulk_copy(smem_u32(smem), block_query, kSlots * slot_bytes, qbar);
    }
    for (int i = 0; i < stages && i < n_items; ++i) load_item(i);
  }

  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const Fold fold = {omax - c_lo, peers, M, row_lo, row_hi};
  // the block's user of each slot (K6), or of the slot's first column (K7)
  const int lu_a = U == 1 ? 2 * wg / KC : 2 * wg * U;
  const int lu_b = U == 1 ? (2 * wg + 1) / KC : (2 * wg + 1) * U;
  // the slots of this warpgroup, at the start of the resident slots or of a
  // stage's (CH: the stage's offset is added per item)
  const uint32_t slots = CH ? tile_bytes : 0;
  const uint64_t q_a = operand_desc(smem_u32(smem + slots + 2 * wg * slot_bytes));
  const uint64_t q_b = operand_desc(smem_u32(smem + slots + (2 * wg + 1) * slot_bytes));
  float acc_a[4 * K], acc_b[4 * K];
#pragma unroll
  for (int j = 0; j < 4 * K; ++j) acc_a[j] = acc_b[j] = 0.f;
  if constexpr (!CH) mbar_wait(qbar, 0);

  // named barriers 1 and 2 pass the turn to issue products between the two
  // warpgroups (128 threads arrive, the other 128 wait)
  const int my_turn = 1 + wg, their_turn = 2 - wg;
  for (int i = 0; i < n_items; ++i) {
    const int s = i % stages;
    const int tile = CH ? i / dc : i, plane = CH ? i - tile * dc : 0;
    mbar_wait(smem_u32(bars + s), (i / stages) & 1);
    if (wg == 1 || i > 0) named_sync(my_turn);
    const uint64_t bank_tile = operand_desc(smem_u32(ring + s * stage_bytes));
    // CH: this stage's plane of the slots (a stage is a multiple of 16 bytes)
    const uint64_t at = CH ? (uint64_t)(s * stage_bytes / 16) : 0;
    // both slots of the item (a k16 step is 256 bytes: 16 in the descriptor);
    // the first k-step of a tile's first plane clears the accumulators
    wgmma_fence();
    fence_regs(acc_a);
    fence_regs(acc_b);
#pragma unroll
    for (int k = 0; k < kKSteps; ++k)
      wgmma_bf16<K>(acc_a, bank_tile + 16 * k, q_a + at + 16 * k, k | plane);
    wgmma_commit();
#pragma unroll
    for (int k = 0; k < kKSteps; ++k)
      wgmma_bf16<K>(acc_b, bank_tile + 16 * k, q_b + at + 16 * k, k | plane);
    wgmma_commit();
    // slot a is done and slot b still runs: the other warpgroup may issue
    wgmma_wait<1>();
    if (wg == 0 || i + 1 < n_items) named_arrive(their_turn);
    wgmma_wait<0>();
    fence_regs(acc_a);
    fence_regs(acc_b);
    mbar_arrive(smem_u32(bars + stages + s));  // every thread: the buffer is read
    if (!CH || plane == dc - 1) {  // the tile's last plane: its scores are whole
      if constexpr (U == 1) {
        fold_tile<K>(acc_a, t_lo + tile, lu_a, fold, warp, lane);
        fold_tile<K>(acc_b, t_lo + tile, lu_b, fold, warp, lane);
      } else {
        fold_users<K, U>(acc_a, t_lo + tile, lu_a, fold, warp, lane);
        fold_users<K, U>(acc_b, t_lo + tile, lu_b, fold, warp, lane);
      }
    }
    if (tid == 0 && i > 0 && i - 1 + stages < n_items) {
      // the other warpgroup released item i - 1 one item ago
      mbar_wait(smem_u32(bars + stages + (i - 1) % stages), ((i - 1) / stages) & 1);
      load_item(i - 1 + stages);
    }
  }
  __syncthreads();
  const int np = c_hi - c_lo;
  for (int i = tid; i < users * np; i += kWgThreads) {
    const int lu = i / np, p = i - lu * np;
    const int b = u0 + lu;
    if (b >= B) continue;
    float* dst = out + (size_t)b * C + c_lo + p;
    if (KC > kSlots)  // the user's other blocks fold into the same element
      atomic_max_float(dst, omax[lu * peers + p]);
    else
      *dst = omax[lu * peers + p];
  }
}

size_t wgmma_smem(int W, int U, int stages, int peers, int dc) {
  const size_t slots = (size_t)kSlots * W * kKWidth * 2;
  return (dc > 1 ? (size_t)stages * (kTileBytes + slots) : slots + (size_t)stages * kTileBytes) +
         (size_t)kSlots * U * peers * sizeof(float) + (size_t)(2 * stages + 1) * 8;
}

template <int K, int U, bool CH>
cudaError_t launch_wgmma(const __nv_bfloat16* bank, const __nv_bfloat16* query, float* out,
                         int groups, int slices, int B, int C, int M, int KC, int stages,
                         int peers, int dc, long long bank_plane, long long query_plane,
                         size_t smem, cudaStream_t s) {
  // every instance may take all 227 KB a block can have; asked once
  static const cudaError_t opted_in = cudaFuncSetAttribute(
      affinity_wgmma_kernel<K, U, CH>, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
  if (opted_in != cudaSuccess) return opted_in;
  affinity_wgmma_kernel<K, U, CH><<<dim3(groups, slices), kWgThreads, smem, s>>>(
      bank, query, out, B, C, M, KC, stages, peers, dc, bank_plane, query_plane);
  return cudaGetLastError();
}

bool bad_shape(long long B, long long C, long long N, long long M, long long D) {
  return B < 1 || C < 1 || N < 1 || M < 1 || B > 0x7fffffffLL || C > 0x7fffffffLL ||
         N > 0x7fffffffLL || M > 0x7fffffffLL || D < 1 || D > kMaxD;
}

template <typename T>
T* pointer(long long value) {
  return reinterpret_cast<T*>(static_cast<uintptr_t>(value));
}

// Both entry points: the packed arguments, KC chunks a user, U users a slot.
int run(const long long* a, long long KC, long long U) {
  const long long B = a[5], C = a[6], N = a[7], M = a[8], D = a[9];
  const long long W = a[10], slices = a[12], peers = a[13], stages = a[14];
  if (bad_shape(B, C, N, M, D) || C * M > 0x7fffffffLL - kTileRows) return kBadShape;
  const long long dc = (D + kKWidth - 1) / kKWidth;  // 128-column planes
  const long long max_w = dc > 1 ? kChunkedMaxWidth : 8 * kMaxWidthSteps;
  if (W < 8 || W > max_w || W % 8 || W * KC < N * U || peers < 1 || peers > kMaxPeers ||
      slices < 1 || slices > 65535 || slices * peers < C || stages < 2 ||
      stages > kMaxStages)
    return kBadPlan;
  const size_t smem = wgmma_smem((int)W, (int)U, (int)stages, (int)peers, (int)dc);
  if (smem > 232448) return kBadPlan;
  const long long groups = (B * KC + kSlots * U - 1) / (kSlots * U);
  if (groups > 0x7fffffffLL) return kBadShape;
  const long long bank_rows = (C * M + kTileRows - 1) / kTileRows * kTileRows;
  const long long bank_chunks = bank_rows * kKWidth / 8;  // of one plane
  const long long query_chunks = groups * kSlots * W * kKWidth / 8;
  cudaStream_t s = pointer<CUstream_st>(a[4]);
  __nv_bfloat16* scratch = pointer<__nv_bfloat16>(a[2]);
  float* out = pointer<float>(a[3]);
  cudaError_t e;
  if (KC > kSlots) {  // the blocks of a user fold into out: start below every float
    e = cudaMemsetAsync(out, 0xff, (size_t)B * C * sizeof(float), s);
    if (e != cudaSuccess) return (int)e;
  }
  long long blocks = ((bank_chunks + query_chunks) * dc + 255) / 256;
  if (blocks > 4096) blocks = 4096;
  const int vec = D % 4 == 0 && a[0] % 16 == 0 && a[1] % 16 == 0;
  pack_kernel<<<(unsigned)blocks, 256, 0, s>>>(
      pointer<const float>(a[0]), pointer<const float>(a[1]), scratch, bank_chunks,
      query_chunks, (int)dc, (int)D, C * M, (int)B, (int)N, (int)W, (int)KC, (int)U, vec);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long bank_plane = bank_chunks * 8, query_plane = query_chunks * 8;
  const __nv_bfloat16* query = scratch + dc * bank_plane;
#define AFF_LAUNCH(K, U, CH)                                                             \
  case (CH) * 1024 + (U) * 32 + (K):                                                     \
    e = launch_wgmma<K, U, CH>(scratch, query, out, (int)groups, (int)slices, (int)B,    \
                               (int)C, (int)M, (int)KC, (int)stages, (int)peers,         \
                               (int)dc, bank_plane, query_plane, smem, s);               \
    break;
#define AFF_LOW(U, CH)                                                                    \
  AFF_LAUNCH(1, U, CH) AFF_LAUNCH(2, U, CH) AFF_LAUNCH(3, U, CH) AFF_LAUNCH(4, U, CH)    \
  AFF_LAUNCH(5, U, CH) AFF_MID(U, CH)
#define AFF_MID(U, CH) \
  AFF_LAUNCH(6, U, CH) AFF_LAUNCH(7, U, CH) AFF_LAUNCH(8, U, CH) AFF_LAUNCH(9, U, CH) \
  AFF_LAUNCH(10, U, CH)
#define AFF_HIGH(U) \
  AFF_LAUNCH(11, U, false) AFF_LAUNCH(12, U, false) AFF_LAUNCH(13, U, false) \
  AFF_LAUNCH(14, U, false) AFF_LAUNCH(15, U, false) AFF_LAUNCH(16, U, false) \
  AFF_LAUNCH(17, U, false) AFF_LAUNCH(18, U, false) AFF_LAUNCH(19, U, false) \
  AFF_LAUNCH(20, U, false)
  // one plane: K6 at every width; K7 at the widths its plan gives: W = 8 N
  // with 8 users a slot (N <= 20), 88..160 with 4 (N 21..40) and 2 (N
  // 41..80). Chunked (W <= 80): K6 at every width, K7 W = 8 N with 8 users
  // (N <= 10), 48..80 with 4 (N 11..20) and 2 (N 21..40)
  switch ((dc > 1) * 1024 + U * 32 + W / 8) {
    AFF_LOW(1, false) AFF_HIGH(1) AFF_HIGH(2) AFF_HIGH(4) AFF_LOW(8, false) AFF_HIGH(8)
    AFF_LOW(1, true) AFF_MID(2, true) AFF_MID(4, true) AFF_LOW(8, true)
    default: return kBadPlan;
  }
#undef AFF_HIGH
#undef AFF_MID
#undef AFF_LOW
#undef AFF_LAUNCH
  return (int)e;
}

}  // namespace

extern "C" {

// Shared memory per block, in bytes, of either kernel: slot width W, U
// users a slot (1: the blocked kernel), `stages` ring buffers, `peers` per
// slice, dc 128-column planes (above 1: the chunked instances).
size_t affinity_smem_bytes(int W, int U, int stages, int peers, int dc) {
  return wgmma_smem(W, U, stages, peers, dc);
}

// The blocked kernel (K6). The arguments come as one array of 64-bit
// integers (pointers as integers), packed by the Python side in one call:
// {a, bank, scratch, out, stream, B, C, N, M, D, W, KC, slices, peers, stages}.
// a: contiguous fp32 [B, N, D]; bank: contiguous fp32 [C, M, D]; out:
// contiguous fp32 [B, C]; scratch: room for (ceil64(C*M) + 4 * groups * W)
// * 128 * dc bf16 values, 16-byte aligned (groups = ceil(B * KC / 4), dc =
// ceil(D / 128)). The plan (W, KC, slices, peers, stages) is
// ops/affinity.py::blocked_plan's: W a multiple of 8 up to 160 (80 where
// D > 128) with W * KC >= N, KC in {1, 2} or a multiple of 4, slices *
// peers >= C, peers <= 256, 2 <= stages <= 8, the shared memory within
// 232,448 bytes. Any D from 1 to 65,536. Returns a Refusal, or the first
// failing launch's cudaError_t (0 on success).
int max_affinity_blocked(const long long* a) {
  const long long KC = a[11];
  if (!(KC == 1 || KC == 2 || (KC >= 4 && KC % 4 == 0))) return kBadPlan;
  return run(a, KC, 1);
}

// The small-N kernel (K7): the same array with U, the users a slot, in
// place of KC: {..., W, U, slices, peers, stages}; groups = ceil(B / (4 U)).
// N <= 80 (kLongQuery otherwise); the plan is ops/affinity.py::
// smalln_plan's: U = 8 for N <= 20, 4 for N <= 40, 2 for N <= 80, W = 8 *
// ceil(N * U / 8) (where D > 128, W <= 80: U = 8 for N <= 10, 4 for N <=
// 20, 2 for N <= 40).
int max_affinity_smalln(const long long* a) {
  const long long N = a[7], U = a[11];
  if (N > kSmallnMaxN) return kLongQuery;
  if (!(U == 2 || U == 4 || U == 8)) return kBadPlan;
  return run(a, 1, U);
}

}  // extern "C"
