// Fused scoring head for Hopper (sm_90a), one or two user representations
// against the same candidates in one call:
//
//     out[u, b, c] = sigmoid( relu(user_u[b] Wu^T + items[b, c] Wi^T + b1) . w2 + b2 )
//
// Replaces amid_tpu/ops/pallas_scoring.py::_scoring_kernel (pallas_call in
// _scoring_fwd_pallas, wrapper scoring_head_pallas). Forward only, as on the
// TPU: the backward recomputes the hidden layer in plain tensor code
// (ops/scoring.py). The [B, C, H] hidden tensor is never written to device
// memory.
//
// Bound on the H100 (data sheet): bytes. At C = 1000 the items are 131 MB
// (39 us at 3.35 TB/s); the item product is 2.1 GFLOP, done once for both
// users (31 us at the 67 TFLOP/s fp32 peak). At C = 2 the call is
// launch-sized.
//
// Design. Two kernels on one stream:
// * user_half_kernel: up[u][b][h] = user_u[b] . Wu[h] + b1[h] for every user
//   ([U, B, H8], zero past H) into a scratch row after the output. A block
//   stages Wu transposed ([D][H8 + 1] floats: lanes h read consecutive
//   addresses) and each warp takes a (u, b) pair, lane h summing over D. At C = 2 this half of the first layer is as large as the item half,
//   so it runs over the whole card, not inside the blocks that meet the user.
// * scoring_head_kernel: the candidates are one list of B * C rows (row
//   r = b * C + c, read through the items' two strides) cut into 64-row
//   tiles; each block (4 warps) walks a contiguous range of tiles. It issues
//   the cp.async copy of its first tile and stages Wi transposed ([D8][H8 +
//   4] fp32, zero-padded to multiples of 8) and w2 while it lands. The copies
//   walk their rows' (user, candidate) by additions: a division per 16-byte
//   copy would cost more than the products.
// * The item product X = tile [64, D] Wi^T in fp32 on the CUDA cores, 32
//   hidden units a pass. The product is bound by shared-memory wavefronts,
//   so a thread holds 8 rows x 8 units (lanes: 8 row groups x 4 unit
//   groups) and each step of four columns takes 8 + 8 16-byte loads for 256
//   FMAs; the four warps split D (warp w takes the steps 4w, 4w + 16, ...)
//   and leave their parts of X in shared memory ([4][64][33]: conflict-free
//   writes and reads), where the epilogue sums them. Item rows have a pitch
//   of D8 + 4 floats, so the 8 rows a quarter-warp reads lie in 8 distinct
//   16-byte bank groups; Wi is read as a broadcast. With H <= 32 the parts
//   of X take the tile's place once it is read, so a block needs 52 KB at
//   D = 128 and four share an SM: the copy of one block's next tile, issued
//   after its epilogue, overlaps the other blocks' products. (On an H100
//   SXM at 700 W, at B = 256, C = 1000: two double-buffered blocks an SM
//   ran about 15% slower, too few warps to cover the shared-memory latency
//   of the register tiles; 3xTF32 on mma.sync reached about 50 TFLOP/s,
//   below the CUDA cores' 67.)
// * Epilogue: thread t takes row t / 2 and 16 units: for each user it adds
//   relu(X + up) * w2 over them, a shuffle completes the sum over H and the
//   even lane writes sigmoid(logit + b2). X is computed once and serves both
//   users.
// Shared memory of the main kernel: (D8 * (H8 + 4) + H8 + max(64 * (D8 + 4),
// 4 * 64 * 33)) * 4 bytes when H <= 32 (the sum of the two past it): 52 KB at
// D = 128, H = 32 (KW in place of D8 in the tile's part: "Wide rows").
//
// Wide rows (scoring_head_chunked_kernel): where Wi^T and a whole tile of
// D8 + 4 floats a row do not fit in a block's 227 KB (D8 (H8 + 4) + H8 +
// 64 (D8 + 4) floats: above D = 560 at H = 32; BERT4Rec at --emb_dim 1024
// needs 410,752 bytes), the tile is staged KW columns at a time (KW the
// widest multiple of 16 that fits beside Wi^T: 320 at D = 1024, H = 32),
// each chunk read into the same accumulators before the next is copied. A
// warp's 4-column steps fall on the same columns in every chunk (KW is a
// multiple of 16), so the products are summed in the same order as by the
// whole-tile kernel and the two agree bit for bit. No copy overlaps the
// products there; Wi^T and at least 16 columns of a tile must fit (D up to
// 1,376 at H = 32, 704 at H = 64): beyond, the wide kernel takes the shape.
//
// Any D and H (scoring_head_wide_kernel, user_half_wide_kernel): where
// neither kernel above takes the shape (Wi^T and 16 columns of a tile do not
// fit, or D is not a multiple of 4, which the 16-byte copies need), the main
// kernel stages Wi^T in chunks too: a chunk is kWideCols columns of the
// tile and the same rows of Wi^T for the pass's 32 units ([256][36] floats),
// so a block needs 101 KB whatever D and H are, and two share an SM. Each
// pass of 32 units walks the chunks of D into the accumulators it has, so a
// tile's chunks are copied once a pass. A D that is not a multiple of 4 is
// copied 4 bytes at a time, the columns up to the next multiple of 4 zeroed
// (a 4-column step reads them; Wi^T's rows there are zero too). The
// user-half kernel's wide form stages Wu^T in chunks of kUserRows columns of
// D and kUserUnits units (a lane sums four units) and takes any D. Shapes the
// kernels above take keep them: their code is as it was. Bound at
// configuration (d)'s D = 1,024, H = 64, B = 256, C = 1000: the item product
// is 33.6 GFLOP, 0.50 ms at the 67 TFLOP/s fp32 peak, against 1.05 GB of
// items, 0.31 ms; this design reads each tile once a pass (twice at H = 64),
// stages Wi^T anew for every tile, and overlaps no copy with the products.
//
// bf16-operand mode (`bf16` set; the JAX head's dots under the bfloat16
// context, ops/scoring.py): the operands of both products are rounded to
// bf16 (round to nearest even) where they are loaded: Wu and the user rows
// as the user-half kernel stages them, Wi and w2 as the main kernel stages
// them, each candidate tile in one pass once it has landed, and the hidden
// unit relu(X + up) in the epilogue. The products of bf16 values are exact
// in fp32, so the arithmetic after the rounding is the fp32 mode's. Both
// kernels are compiled for each mode (template argument BF), so the fp32
// instances are the code they were before the mode existed.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

template <typename T>
T* ptr(long long value) {
  return reinterpret_cast<T*>(static_cast<uintptr_t>(value));
}

constexpr int kThreads = 128;  // four warps
constexpr int kTileRows = 64;
constexpr int kRedPitch = 33;  // floats per row of a warp's part of X (32 units)

// The entry point's argument block (ops/scoring.py packs it): 8-byte fields.
struct ScoreArgs {
  long long user0, user1, user_sb0, user_sb1;  // user_u: [B, D], rows user_sb_u apart
  long long items, items_sb, items_sc;  // [B, C, D], unit stride along D
  long long wu, wu_s, wi, wi_s, b1, w2, b2;  // [H, D] halves (row strides), [H], [1, H], [1]
  long long out;  // contiguous [U, B, C]
  long long U, B, C, D, H, tiles_per_block, up, stream;  // up: scratch, U * B * H8 floats
  long long bf16;  // 1: round the products' operands to bf16
};

struct Params {
  const float* user[2];
  long long user_sb[2];
  const float* items;
  long long items_sb, items_sc;
  const float *wu, *wi, *b1, *w2, *b2;
  long long wu_s, wi_s;
  float* out;
  float* up;  // [U][B][H8]
  int rows;  // B * C
  int B, C, D, H, D8, H8, tiles, tiles_per_block;
  int KW;  // columns of a staged tile: D8, or a chunk (the chunked kernel)
};

// x rounded to bf16 (nearest even) and back to fp32
__device__ __forceinline__ float bf16_round(float x) {
  unsigned short h;
  asm("cvt.rn.bf16.f32 %0, %1;" : "=h"(h) : "f"(x));
  return __uint_as_float((uint32_t)h << 16);
}

// an operand as the mode wants it
template <bool BF>
__device__ __forceinline__ float operand(float x) {
  if constexpr (BF) return bf16_round(x);
  return x;
}

__host__ __device__ inline int pitch(int d8) { return d8 + 4; }

constexpr int kWideCols = 256;   // columns of the wide kernel's staged chunk
constexpr int kPass = 32;        // hidden units a pass of the main kernels
constexpr int kUserRows = 128;   // Wu^T rows (columns of D) a chunk, wide user half
constexpr int kUserUnits = 128;  // hidden units a pass of the wide user half

// Shared memory of the main kernel with tiles of kw columns a row
size_t smem_with(int D, int H, int kw) {
  const int d8 = (D + 7) & ~7, h8 = (H + 7) & ~7;
  const size_t tile = (size_t)kTileRows * pitch(kw), red = (size_t)4 * kTileRows * kRedPitch;
  return sizeof(float) * ((size_t)d8 * (h8 + 4) + h8 +
                          (h8 <= 32 ? (tile > red ? tile : red) : tile + red));
}

// The wide kernel's: a chunk of the tile (the parts of X in its place), the
// chunk's rows of Wi^T for a pass's units, the pass's w2
constexpr size_t wide_smem_bytes() {
  return sizeof(float) * ((size_t)kTileRows * (kWideCols + 4) + kWideCols * (kPass + 4) + kPass);
}

// The main kernel that takes (D, H): the whole-tile kernel where Wi^T and a
// whole tile fit, the chunked one where Wi^T and 16 columns of a tile do,
// both at D a multiple of 4; the wide kernel at every other shape
enum MainKernel { kWholeTile, kChunked, kWide };

MainKernel main_kernel(int D, int H) {
  if (D % 4 != 0) return kWide;
  if (smem_with(D, H, (D + 7) & ~7) <= 232448) return kWholeTile;
  return smem_with(D, H, 16) <= 232448 ? kChunked : kWide;
}

// The columns of a staged tile: the whole row (D8), the widest multiple of
// 16 that fits beside Wi^T (the chunked kernel), or kWideCols (the wide one)
int tile_cols(int D, int H) {
  switch (main_kernel(D, H)) {
    case kWholeTile: return (D + 7) & ~7;
    case kWide: return kWideCols;
    default:
      for (int kw = (((D + 7) & ~7) - 1) / 16 * 16;; kw -= 16)
        if (smem_with(D, H, kw) <= 232448) return kw;
  }
}

size_t smem_bytes(int D, int H) {
  return main_kernel(D, H) == kWide ? wide_smem_bytes() : smem_with(D, H, tile_cols(D, H));
}

// whether the user-half kernel stages Wu^T whole (its four-chain sum reads D
// in steps of 4), else its wide form
bool user_half_whole(int D, int H) {
  return D % 4 == 0 &&
         sizeof(float) * (size_t)D * (((H + 7) & ~7) + 1 + kThreads / 32) <= 232448;
}

size_t user_half_smem_bytes(int D, int H) {
  return user_half_whole(D, H)
             ? sizeof(float) * (size_t)D * (((H + 7) & ~7) + 1 + kThreads / 32)
             : sizeof(float) * (size_t)kUserRows * (kUserUnits + 1 + kThreads / 32);
}

// cp.async of V floats (16 bytes, or 4 at a D not a multiple of 4)
template <int V>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (V == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

// Issues the copies of tile `tile` into `buf` ([64][pitch(KW)] floats), V
// floats at a time (16 bytes; 4 at a D not a multiple of 4): columns
// [col0, col0 + V chunks) of each row (the whole row by default); thread
// tid takes chunks tid, tid + 128, ... of the tile's 64 * chunks, walking
// their (row, chunk) and the row's (user, candidate) forward by additions
// (one division a tile). Rows past the last candidate are left as they are.
template <int V = 4>
__device__ __forceinline__ void load_tile(const Params& p, float* buf, int tile, int tid,
                                          int col0 = 0, int chunks = 0) {
  if (chunks == 0) chunks = p.D / V;
  const int P = pitch(p.KW);
  const int step_rows = kThreads / chunks, step_chunks = kThreads - step_rows * chunks;
  int rr = tid / chunks, ch = tid - rr * chunks;
  int r = tile * kTileRows + rr;
  int b = r / p.C, c = r - b * p.C;
  while (rr < kTileRows && r < p.rows) {
    cp_async<V>(buf + rr * P + ch * V,
                p.items + b * p.items_sb + c * p.items_sc + col0 + ch * V);
    int dr = step_rows;
    ch += step_chunks;
    if (ch >= chunks) {
      ch -= chunks;
      ++dr;
    }
    rr += dr;
    r += dr;
    for (c += dr; c >= p.C; c -= p.C) ++b;
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// up[u][b][h] = user_u[b] . Wu[h] + b1[h] (0 for h >= H): a block stages
// Wu transposed, each warp takes one (u, b) pair at a time, copies the user
// row into shared memory and lane h sums over D in four chains.
template <bool BF>
__global__ void __launch_bounds__(kThreads)
user_half_kernel(const Params p, int pairs) {
  extern __shared__ __align__(16) float wut[];  // [D][H8 + 1], then [4][D] user rows
  const int hp = p.H8 + 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* xs = wut + p.D * hp + warp * p.D;
#pragma unroll 8
  for (int i = threadIdx.x; i < p.H8 * p.D; i += kThreads) {
    const int h = i / p.D, d = i - h * p.D;
    wut[d * hp + h] = h < p.H ? operand<BF>(p.wu[h * p.wu_s + d]) : 0.f;
  }
  __syncthreads();
  for (int e = blockIdx.x * (kThreads / 32) + warp; e < pairs;
       e += gridDim.x * (kThreads / 32)) {
    const int u = e / p.B, b = e - u * p.B;
    const float* x = p.user[u] + (long long)b * p.user_sb[u];
    for (int d = lane; d < p.D; d += 32) xs[d] = operand<BF>(x[d]);
    __syncwarp();
    for (int h = lane; h < p.H8; h += 32) {
      float s[4] = {0.f, 0.f, 0.f, 0.f};  // four chains: the sum is latency-bound
      for (int d = 0; d < p.D; d += 4) {
#pragma unroll
        for (int k = 0; k < 4; ++k) s[k] = fmaf(xs[d + k], wut[(d + k) * hp + h], s[k]);
      }
      p.up[(long long)e * p.H8 + h] = h < p.H ? (s[0] + s[1]) + (s[2] + s[3]) + p.b1[h] : 0.f;
    }
    __syncwarp();  // the row is read before the next one is copied
  }
}

template <int U, bool BF>
__global__ void __launch_bounds__(kThreads, 4)  // four blocks an SM: at most 128 registers
scoring_head_kernel(const Params p) {
  extern __shared__ __align__(16) float sm[];
  const int P = pitch(p.D8), WP = p.H8 + 4;
  float* wit = sm;                          // [D8][WP]: Wi transposed
  float* w2s = wit + p.D8 * WP;             // [H8]
  float* buf = w2s + p.H8;                  // [64][P]: one candidate tile
  // [4][64][kRedPitch]: each warp's part of X; in place of the tile when one
  // pass covers H (the tile is read by then)
  float* red = p.H8 <= 32 ? buf : buf + kTileRows * P;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rg = lane & 7, hg = lane >> 3;  // rows rg + 8m; units 8hg .. 8hg + 7 of a pass
  const int row = tid >> 1, half = tid & 1;  // the epilogue's row and 16 units of a pass
  const int t0 = blockIdx.x * p.tiles_per_block;
  const int t1 = min(p.tiles, t0 + p.tiles_per_block);
  load_tile(p, buf, t0, tid);

  // padding columns [D, D8) of the tile stay zero; cp.async never writes them
  for (int i = tid; i < kTileRows * (p.D8 - p.D); i += kThreads) {
    const int r = i / (p.D8 - p.D);
    buf[r * P + p.D + (i - r * (p.D8 - p.D))] = 0.f;
  }
  // unrolled: the loads are in flight together, not one L2 latency each
#pragma unroll 8
  for (int i = tid; i < p.H8 * p.D8; i += kThreads) {
    const int h = i / p.D8, d = i - h * p.D8;
    wit[d * WP + h] = h < p.H && d < p.D ? operand<BF>(p.wi[h * p.wi_s + d]) : 0.f;
  }
  for (int h = tid; h < p.H8; h += kThreads) w2s[h] = h < p.H ? operand<BF>(p.w2[h]) : 0.f;
  const float bias2 = p.b2[0];

  for (int tile = t0; tile < t1; ++tile) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // the tile has landed (and, the first time, Wi and w2 are staged)
    if constexpr (BF) {  // the tile's values as bf16 operands, in place
      for (int i = tid; i < kTileRows * P; i += kThreads) buf[i] = bf16_round(buf[i]);
      __syncthreads();
    }
    const int r = tile * kTileRows + row;  // the epilogue's candidate row
    const int b = min(r, p.rows - 1) / p.C;
    float logit[U];
#pragma unroll
    for (int u = 0; u < U; ++u) logit[u] = 0.f;
    for (int h0 = 0; h0 < p.H8; h0 += 32) {
      // this warp's part of X[64][32 units from h0]: the 4-column steps
      // k0 = 4 (warp + 4 i), a thread's 8 rows x 8 units in registers
      const int h = h0 + 8 * hg;
      float acc[8][8];
#pragma unroll
      for (int m = 0; m < 8; ++m) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[m][j] = 0.f;
      }
      if (h < p.H8) {
        for (int k0 = 4 * warp; k0 < p.D8; k0 += 16) {
          float4 x[8];
#pragma unroll
          for (int m = 0; m < 8; ++m)
            x[m] = *reinterpret_cast<const float4*>(buf + (rg + 8 * m) * P + k0);
#pragma unroll
          for (int dk = 0; dk < 4; ++dk) {
            const float4 wl = *reinterpret_cast<const float4*>(wit + (k0 + dk) * WP + h);
            const float4 wh = *reinterpret_cast<const float4*>(wit + (k0 + dk) * WP + h + 4);
            const float w[8] = {wl.x, wl.y, wl.z, wl.w, wh.x, wh.y, wh.z, wh.w};
#pragma unroll
            for (int m = 0; m < 8; ++m) {
              const float xv = dk == 0 ? x[m].x : dk == 1 ? x[m].y : dk == 2 ? x[m].z : x[m].w;
#pragma unroll
              for (int j = 0; j < 8; ++j) acc[m][j] = fmaf(xv, w[j], acc[m][j]);
            }
          }
        }
      }
      __syncthreads();  // the tile is read (and the previous pass's parts)
      float* mine = red + warp * kTileRows * kRedPitch;
#pragma unroll
      for (int m = 0; m < 8; ++m) {
#pragma unroll
        for (int j = 0; j < 8; ++j) mine[(rg + 8 * m) * kRedPitch + 8 * hg + j] = acc[m][j];
      }
      __syncthreads();  // X's parts are written
      // the epilogue: row `row`, units h0 + 16 half .. + 15
      for (int j = 0; j < 16; ++j) {
        const int hh = h0 + 16 * half + j;
        if (hh < p.H8) {
          const float* x = red + row * kRedPitch + 16 * half + j;
          const float xs = (x[0] + x[kTileRows * kRedPitch]) +
                           (x[2 * kTileRows * kRedPitch] + x[3 * kTileRows * kRedPitch]);
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const float up = p.up[((long long)u * p.B + b) * p.H8 + hh];
            logit[u] = fmaf(operand<BF>(fmaxf(xs + up, 0.f)), w2s[hh], logit[u]);
          }
        }
      }
    }
    __syncthreads();  // X's parts are read: the buffer takes the next tile
    if (tile + 1 < t1) load_tile(p, buf, tile + 1, tid);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float s = logit[u] + __shfl_xor_sync(0xffffffffu, logit[u], 1);
      if (half == 0 && r < p.rows)
        p.out[(long long)u * p.rows + r] = 1.f / (1.f + expf(-(s + bias2)));
    }
  }
}

// The main kernel for rows too wide for a whole tile (header, "Wide rows"):
// the tile staged KW columns at a time, each chunk's products summed into the
// accumulators of the pass before the next chunk is copied
template <int U, bool BF>
__global__ void __launch_bounds__(kThreads)
scoring_head_chunked_kernel(const Params p) {
  extern __shared__ __align__(16) float sm[];
  const int P = pitch(p.KW), WP = p.H8 + 4;
  float* wit = sm;                          // [D8][WP]: Wi transposed
  float* w2s = wit + p.D8 * WP;             // [H8]
  float* buf = w2s + p.H8;                  // [64][P]: KW columns of a candidate tile
  float* red = p.H8 <= 32 ? buf : buf + kTileRows * P;  // [4][64][kRedPitch]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rg = lane & 7, hg = lane >> 3;  // rows rg + 8m; units 8hg .. 8hg + 7 of a pass
  const int row = tid >> 1, half = tid & 1;  // the epilogue's row and 16 units of a pass
  const int t0 = blockIdx.x * p.tiles_per_block;
  const int t1 = min(p.tiles, t0 + p.tiles_per_block);
#pragma unroll 8
  for (int i = tid; i < p.H8 * p.D8; i += kThreads) {
    const int h = i / p.D8, d = i - h * p.D8;
    wit[d * WP + h] = h < p.H && d < p.D ? operand<BF>(p.wi[h * p.wi_s + d]) : 0.f;
  }
  for (int h = tid; h < p.H8; h += kThreads) w2s[h] = h < p.H ? operand<BF>(p.w2[h]) : 0.f;
  const float bias2 = p.b2[0];

  for (int tile = t0; tile < t1; ++tile) {
    const int r = tile * kTileRows + row;  // the epilogue's candidate row
    const int b = min(r, p.rows - 1) / p.C;
    float logit[U];
#pragma unroll
    for (int u = 0; u < U; ++u) logit[u] = 0.f;
    for (int h0 = 0; h0 < p.H8; h0 += 32) {
      const int h = h0 + 8 * hg;
      float acc[8][8];
#pragma unroll
      for (int m = 0; m < 8; ++m) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[m][j] = 0.f;
      }
      for (int col0 = 0; col0 < p.D; col0 += p.KW) {
        const int cols = min(p.KW, p.D - col0);  // a multiple of 4
        __syncthreads();  // the buffer is free (the last chunk, or X's parts, is read)
        load_tile(p, buf, tile, tid, col0, cols / 4);
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
        __syncthreads();  // the chunk has landed (and, the first time, Wi and w2 are staged)
        if constexpr (BF) {  // the chunk's values as bf16 operands, in place
          for (int i = tid; i < kTileRows * P; i += kThreads) buf[i] = bf16_round(buf[i]);
          __syncthreads();
        }
        if (h < p.H8) {
          for (int k0 = 4 * warp; k0 < cols; k0 += 16) {
            float4 x[8];
#pragma unroll
            for (int m = 0; m < 8; ++m)
              x[m] = *reinterpret_cast<const float4*>(buf + (rg + 8 * m) * P + k0);
#pragma unroll
            for (int dk = 0; dk < 4; ++dk) {
              const float* wrow = wit + (col0 + k0 + dk) * WP + h;
              const float4 wl = *reinterpret_cast<const float4*>(wrow);
              const float4 wh = *reinterpret_cast<const float4*>(wrow + 4);
              const float w[8] = {wl.x, wl.y, wl.z, wl.w, wh.x, wh.y, wh.z, wh.w};
#pragma unroll
              for (int m = 0; m < 8; ++m) {
                const float xv = dk == 0 ? x[m].x : dk == 1 ? x[m].y : dk == 2 ? x[m].z : x[m].w;
#pragma unroll
                for (int j = 0; j < 8; ++j) acc[m][j] = fmaf(xv, w[j], acc[m][j]);
              }
            }
          }
        }
      }
      __syncthreads();  // the last chunk is read (and the previous pass's parts)
      float* mine = red + warp * kTileRows * kRedPitch;
#pragma unroll
      for (int m = 0; m < 8; ++m) {
#pragma unroll
        for (int j = 0; j < 8; ++j) mine[(rg + 8 * m) * kRedPitch + 8 * hg + j] = acc[m][j];
      }
      __syncthreads();  // X's parts are written
      for (int j = 0; j < 16; ++j) {
        const int hh = h0 + 16 * half + j;
        if (hh < p.H8) {
          const float* x = red + row * kRedPitch + 16 * half + j;
          const float xs = (x[0] + x[kTileRows * kRedPitch]) +
                           (x[2 * kTileRows * kRedPitch] + x[3 * kTileRows * kRedPitch]);
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const float up = p.up[((long long)u * p.B + b) * p.H8 + hh];
            logit[u] = fmaf(operand<BF>(fmaxf(xs + up, 0.f)), w2s[hh], logit[u]);
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float s = logit[u] + __shfl_xor_sync(0xffffffffu, logit[u], 1);
      if (half == 0 && r < p.rows)
        p.out[(long long)u * p.rows + r] = 1.f / (1.f + expf(-(s + bias2)));
    }
  }
}

// The user half at any D and H (header, "Any D and H"): each warp takes one
// (u, b) pair of the block's four at a time; for each pass of kUserUnits
// units the block stages Wu^T kUserRows columns of D at a time ([rows][units
// + 1] floats: lanes read consecutive addresses), each warp its user row's
// same columns, and lane l sums units l, l + 32, l + 64, l + 96 over them.
template <bool BF>
__global__ void __launch_bounds__(kThreads)
user_half_wide_kernel(const Params p, int pairs) {
  extern __shared__ __align__(16) float wut[];  // [kUserRows][HP], then [4][kUserRows]
  constexpr int HP = kUserUnits + 1;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* xs = wut + kUserRows * HP + warp * kUserRows;
  for (int e0 = blockIdx.x * (kThreads / 32); e0 < pairs; e0 += gridDim.x * (kThreads / 32)) {
    const int e = e0 + warp;  // this warp's pair, where e < pairs
    const int u = e / p.B, b = e - u * p.B;
    const float* x = e < pairs ? p.user[u] + (long long)b * p.user_sb[u] : nullptr;
    for (int h0 = 0; h0 < p.H8; h0 += kUserUnits) {
      float acc[kUserUnits / 32] = {};
      for (int d0 = 0; d0 < p.D; d0 += kUserRows) {
        const int rows = min(kUserRows, p.D - d0);
        __syncthreads();  // the last chunk is read
        for (int i = tid; i < kUserUnits * rows; i += kThreads) {
          const int hh = i / rows, d = i - hh * rows;
          wut[d * HP + hh] =
              h0 + hh < p.H ? operand<BF>(p.wu[(long long)(h0 + hh) * p.wu_s + d0 + d]) : 0.f;
        }
        if (x != nullptr)
          for (int d = lane; d < rows; d += 32) xs[d] = operand<BF>(x[d0 + d]);
        __syncthreads();  // the chunk is staged
        if (x != nullptr) {
          for (int d = 0; d < rows; ++d) {
            const float xv = xs[d];
#pragma unroll
            for (int k = 0; k < kUserUnits / 32; ++k)
              acc[k] = fmaf(xv, wut[d * HP + lane + 32 * k], acc[k]);
          }
        }
      }
      if (x != nullptr) {
#pragma unroll
        for (int k = 0; k < kUserUnits / 32; ++k) {
          const int h = h0 + lane + 32 * k;
          if (h < p.H8) p.up[(long long)e * p.H8 + h] = h < p.H ? acc[k] + p.b1[h] : 0.f;
        }
      }
    }
  }
}

// The main kernel at any D and H (header, "Any D and H"): for each pass of
// kPass units, the tile and Wi^T's rows for the pass's units staged
// kWideCols columns of D at a time, each chunk's products summed into the
// pass's accumulators before the next chunk is copied
template <int U, bool BF>
__global__ void __launch_bounds__(kThreads)
scoring_head_wide_kernel(const Params p) {
  extern __shared__ __align__(16) float sm[];
  constexpr int P = kWideCols + 4, WP = kPass + 4;
  constexpr int BUF = kTileRows * P > 4 * kTileRows * kRedPitch ? kTileRows * P
                                                                 : 4 * kTileRows * kRedPitch;
  float* buf = sm;                 // [64][P]: kWideCols columns of a candidate tile
  float* red = sm;                 // [4][64][kRedPitch]: in the chunk's place
  float* wit = sm + BUF;           // [kWideCols][WP]: the chunk's rows of Wi^T, the pass's units
  float* w2s = wit + kWideCols * WP;  // [kPass]: the pass's w2
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rg = lane & 7, hg = lane >> 3;  // rows rg + 8m; units 8hg .. 8hg + 7 of a pass
  const int row = tid >> 1, half = tid & 1;  // the epilogue's row and 16 units of a pass
  const int t0 = blockIdx.x * p.tiles_per_block;
  const int t1 = min(p.tiles, t0 + p.tiles_per_block);
  const bool vec = (p.D & 3) == 0;  // 16-byte copies, else 4-byte ones
  const float bias2 = p.b2[0];

  for (int tile = t0; tile < t1; ++tile) {
    const int r = tile * kTileRows + row;  // the epilogue's candidate row
    const int b = min(r, p.rows - 1) / p.C;
    float logit[U];
#pragma unroll
    for (int u = 0; u < U; ++u) logit[u] = 0.f;
    for (int h0 = 0; h0 < p.H8; h0 += kPass) {
      const int h = 8 * hg;  // this thread's units in the pass
      float acc[8][8];
#pragma unroll
      for (int m = 0; m < 8; ++m) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[m][j] = 0.f;
      }
      for (int col0 = 0; col0 < p.D; col0 += kWideCols) {
        const int cols = min(kWideCols, p.D - col0);
        const int cols4 = (cols + 3) & ~3;  // what the 4-column steps read
        __syncthreads();  // the buffer and Wi^T's rows are free (the last chunk, X's parts, w2 read)
        if (vec)
          load_tile<4>(p, buf, tile, tid, col0, cols / 4);
        else
          load_tile<1>(p, buf, tile, tid, col0, cols);
        for (int i = tid; i < kTileRows * (cols4 - cols); i += kThreads) {
          const int rr = i / (cols4 - cols);
          buf[rr * P + cols + (i - rr * (cols4 - cols))] = 0.f;
        }
#pragma unroll 4
        for (int i = tid; i < kPass * cols4; i += kThreads) {
          const int hh = i / cols4, d = i - hh * cols4;
          wit[d * WP + hh] = h0 + hh < p.H && d < cols
                                 ? operand<BF>(p.wi[(long long)(h0 + hh) * p.wi_s + col0 + d])
                                 : 0.f;
        }
        if (col0 == 0 && tid < kPass) w2s[tid] = h0 + tid < p.H ? operand<BF>(p.w2[h0 + tid]) : 0.f;
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
        __syncthreads();  // the chunk has landed, Wi^T's rows are staged
        if constexpr (BF) {  // the chunk's values as bf16 operands, in place
          for (int i = tid; i < kTileRows * P; i += kThreads) buf[i] = bf16_round(buf[i]);
          __syncthreads();
        }
        if (h0 + h < p.H8) {
          for (int k0 = 4 * warp; k0 < cols4; k0 += 16) {
            float4 x[8];
#pragma unroll
            for (int m = 0; m < 8; ++m)
              x[m] = *reinterpret_cast<const float4*>(buf + (rg + 8 * m) * P + k0);
#pragma unroll
            for (int dk = 0; dk < 4; ++dk) {
              const float* wrow = wit + (k0 + dk) * WP + h;
              const float4 wl = *reinterpret_cast<const float4*>(wrow);
              const float4 wh = *reinterpret_cast<const float4*>(wrow + 4);
              const float w[8] = {wl.x, wl.y, wl.z, wl.w, wh.x, wh.y, wh.z, wh.w};
#pragma unroll
              for (int m = 0; m < 8; ++m) {
                const float xv = dk == 0 ? x[m].x : dk == 1 ? x[m].y : dk == 2 ? x[m].z : x[m].w;
#pragma unroll
                for (int j = 0; j < 8; ++j) acc[m][j] = fmaf(xv, w[j], acc[m][j]);
              }
            }
          }
        }
      }
      __syncthreads();  // the last chunk is read: X's parts take its place
      float* mine = red + warp * kTileRows * kRedPitch;
#pragma unroll
      for (int m = 0; m < 8; ++m) {
#pragma unroll
        for (int j = 0; j < 8; ++j) mine[(rg + 8 * m) * kRedPitch + 8 * hg + j] = acc[m][j];
      }
      __syncthreads();  // X's parts are written
      for (int j = 0; j < 16; ++j) {
        const int hh = 16 * half + j;
        if (h0 + hh < p.H8) {
          const float* x = red + row * kRedPitch + hh;
          const float xs = (x[0] + x[kTileRows * kRedPitch]) +
                           (x[2 * kTileRows * kRedPitch] + x[3 * kTileRows * kRedPitch]);
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const float up = p.up[((long long)u * p.B + b) * p.H8 + h0 + hh];
            logit[u] = fmaf(operand<BF>(fmaxf(xs + up, 0.f)), w2s[hh], logit[u]);
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float s = logit[u] + __shfl_xor_sync(0xffffffffu, logit[u], 1);
      if (half == 0 && r < p.rows)
        p.out[(long long)u * p.rows + r] = 1.f / (1.f + expf(-(s + bias2)));
    }
  }
}

// Every kernel may take all 227 KB of shared memory a block can have;
// asked once per kernel (a launch asks for what it needs).
template <int U, bool BF>
cudaError_t launch(const Params& p, MainKernel which, unsigned grid, size_t smem,
                   size_t smem_up, cudaStream_t s) {
  static const cudaError_t opted_in = cudaFuncSetAttribute(
      scoring_head_kernel<U, BF>, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
  static const cudaError_t opted_in_chunked = cudaFuncSetAttribute(
      scoring_head_chunked_kernel<U, BF>, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
  if (opted_in_chunked != cudaSuccess) return opted_in_chunked;
  static const cudaError_t opted_in_wide = cudaFuncSetAttribute(
      scoring_head_wide_kernel<U, BF>, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
  if (opted_in_wide != cudaSuccess) return opted_in_wide;
  static const cudaError_t opted_in_up = cudaFuncSetAttribute(
      user_half_kernel<BF>, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
  static const cudaError_t opted_in_up_wide = cudaFuncSetAttribute(
      user_half_wide_kernel<BF>, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
  if (opted_in != cudaSuccess) return opted_in;
  if (opted_in_up != cudaSuccess) return opted_in_up;
  if (opted_in_up_wide != cudaSuccess) return opted_in_up_wide;
  const int pairs = U * p.B, per_block = kThreads / 32;
  int up_blocks = (pairs + per_block - 1) / per_block;  // one pair a warp
  if (up_blocks > 1024) up_blocks = 1024;
  if (user_half_whole(p.D, p.H))
    user_half_kernel<BF><<<up_blocks, kThreads, smem_up, s>>>(p, pairs);
  else
    user_half_wide_kernel<BF><<<up_blocks, kThreads, smem_up, s>>>(p, pairs);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if (which == kWholeTile)
    scoring_head_kernel<U, BF><<<grid, kThreads, smem, s>>>(p);
  else if (which == kChunked)
    scoring_head_chunked_kernel<U, BF><<<grid, kThreads, smem, s>>>(p);
  else
    scoring_head_wide_kernel<U, BF><<<grid, kThreads, smem, s>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one block of the main kernel and of the user-half kernel
// needs, in bytes, and the main kernel's number (0 whole tile, 1 chunked,
// 2 wide) and tile columns, of the shape's kernels.
size_t scoring_head_smem_bytes(int D, int H) { return smem_bytes(D, H); }
size_t scoring_user_half_smem_bytes(int D, int H) { return user_half_smem_bytes(D, H); }
int scoring_head_main_kernel(int D, int H) { return (int)main_kernel(D, H); }
int scoring_head_tile_cols(int D, int H) { return tile_cols(D, H); }

// One launch for U = 1 or 2 user representations. The arguments come as one
// array of 8-byte fields in ScoreArgs' order (pointers as integers; user1 is
// 0 when U = 1), packed by the Python side in one call. user_u: fp32 [B, D], unit
// stride along D, rows user_sb_u floats apart; items: fp32 [B, C, D], unit
// stride along D, strides items_sb and items_sc floats, 16-byte aligned rows
// where D is a multiple of 4; wu, wi: fp32 [H, D] (unit stride along D,
// rows wu_s / wi_s apart); b1, w2: [H]; b2: [1]; out: contiguous fp32 [U,
// B, C]. Any D and H.
// up: scratch for U * B * ceil8(H) floats. tiles_per_block is
// ops/scoring.py::scoring_plan's: the main kernel's grid is
// ceil(tiles / tiles_per_block) blocks over ceil(B * C / 64) tiles. Returns
// -1 for arguments it does not take, else the first failing launch's
// cudaError_t (0 on success). bf16 = 1 asks for the bf16-operand mode.
int scoring_head(const long long* fields) {
  ScoreArgs args;
  memcpy(&args, fields, sizeof(args));
  const ScoreArgs* a = &args;
  const long long U = a->U, B = a->B, C = a->C, D = a->D, H = a->H;
  if (!(U == 1 || U == 2) || B < 0 || C < 0 || D < 1 || D > 0x7fffffffLL ||
      H < 1 || H > 0x7fffffffLL || C > 0x7fffffffLL || a->tiles_per_block < 1)
    return -1;
  const long long rows = B * C;
  if (rows == 0) return 0;
  if (rows > 0x7fffffffLL - kTileRows) return -1;
  const long long tiles = (rows + kTileRows - 1) / kTileRows;
  const long long grid = (tiles + a->tiles_per_block - 1) / a->tiles_per_block;
  if (tiles > 0x7fffffffLL || grid > 0x7fffffffLL) return -1;
  const size_t smem = smem_bytes((int)D, (int)H);
  const size_t smem_up = user_half_smem_bytes((int)D, (int)H);
  if (smem > 232448 || smem_up > 232448) return -1;
  Params p;
  p.user[0] = ptr<const float>(a->user0);
  p.user[1] = ptr<const float>(U == 2 ? a->user1 : a->user0);
  p.user_sb[0] = a->user_sb0;
  p.user_sb[1] = U == 2 ? a->user_sb1 : a->user_sb0;
  p.items = ptr<const float>(a->items);
  p.items_sb = a->items_sb;
  p.items_sc = a->items_sc;
  p.wu = ptr<const float>(a->wu);
  p.wu_s = a->wu_s;
  p.wi = ptr<const float>(a->wi);
  p.wi_s = a->wi_s;
  p.b1 = ptr<const float>(a->b1);
  p.w2 = ptr<const float>(a->w2);
  p.b2 = ptr<const float>(a->b2);
  p.out = ptr<float>(a->out);
  p.up = ptr<float>(a->up);
  p.rows = (int)rows;
  p.B = (int)B;
  p.C = (int)C;
  p.D = (int)D;
  p.H = (int)H;
  p.D8 = (int)((D + 7) & ~7LL);
  p.H8 = (int)((H + 7) & ~7LL);
  p.tiles = (int)tiles;
  p.tiles_per_block = (int)a->tiles_per_block;
  p.KW = tile_cols((int)D, (int)H);
  const MainKernel which = main_kernel((int)D, (int)H);
  cudaStream_t s = ptr<CUstream_st>(a->stream);
  const unsigned g = (unsigned)grid;
  cudaError_t e = a->bf16 ? (U == 2 ? launch<2, true>(p, which, g, smem, smem_up, s)
                                    : launch<1, true>(p, which, g, smem, smem_up, s))
                          : (U == 2 ? launch<2, false>(p, which, g, smem, smem_up, s)
                                    : launch<1, false>(p, which, g, smem, smem_up, s));
  return (int)e;
}

}  // extern "C"
