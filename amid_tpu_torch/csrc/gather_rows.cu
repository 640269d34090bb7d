// Embedding row gather for Hopper (sm_90a): out[n, :] = table[ids[n], :].
//
// Replaces amid_tpu/ops/pallas_embedding.py::_gather_kernel (pallas_call in
// _gather_pallas, wrapper embedding_gather_pallas). The backward of the
// gather, a scatter-add into a zero [V, D] table, which the TPU package
// leaves to plain XLA (`_bwd`, `.at[ids].add`), is the second entry point,
// gather_rows_grad, at the end of this file.
//
// Contract. ids are int32 or int64; an id outside [0, V) is clamped to the
// nearest valid row (what a JAX gather does with an out-of-bounds index), so
// the kernel never reads outside the table whatever the caller passes. The
// table's rows have unit stride and `table_stride` elements between rows.
//
// One launch serves up to four lookups ("segments") into the same table.
// Segment k holds n_k ids, `per_user_k` of them for each user (the first axis
// of the id array); user u's rows land as one contiguous block of
// per_user_k * width floats at dst_k + u * dst_stride_k. A plain lookup is
// one segment with a contiguous destination; the model's candidate block
// [B, 1 + K, D] is two segments (target, negatives) whose destinations are
// views of one tensor, so no concatenation follows the gather.
//
// Design. The TPU kernel prefetches the ids to scalar memory and issues one
// DMA per row, 16 rows in flight per grid cell. Here a warp takes kRows rows
// at a time: lanes 0..kRows-1 each read one id (one coalesced load), clamp it
// and work out the row's source and destination, the warp shares those by
// shuffle, and every lane then issues its 16-byte piece of all kRows rows
// before the first store (float4 when width, strides and pointers allow it,
// floats otherwise). The grid is capped at 16 blocks per SM and strides over
// the rows, so at the large shapes a block lives for many rows. Sources are
// read through the read-only path with the default policy, not streamed: most
// rows are read once, but the padding row of left-padded histories is read by
// every user and should stay cached. Destinations are written with a
// streaming store (the evaluation block is 131 MB against 50 MB of L2, and
// this launch does not read it back). Offsets are 64-bit: the table holds
// 458 MB.
//
// Bound on the H100 (data sheet): pure data movement, n*width*4 bytes read
// and written plus the ids: 262 MB at n = 255,744, width = 128 (78 us at
// 3.35 TB/s); 1.3 MB for a [256, 20] sequence (launch-sized).
//
// The entry point validates what needs only numbers and returns a negative
// code for a refusal (see the enum), 0 for success, or the launch's positive
// cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace amid_hopper;

constexpr int kWarps = 8;        // warps per block
constexpr int kRows = 8;         // rows a warp keeps in flight
constexpr int kMaxSegments = 4;
constexpr int kBlocksPerSM = 16; // grid cap: a block strides over the rows beyond it

enum Refusal {
  kBadTable = -1,     // V < 1 or width < 1
  kTableStride = -2,  // the table's rows do not have unit stride
  kBadSegments = -3,  // segment count outside 1..4, a negative count, or ids
                      // per user that do not divide the segment's ids
  kTooManyRows = -4,  // more than 2^31 - 1 rows in one launch
};

struct Segments {
  const void* ids[kMaxSegments];
  float* dst[kMaxSegments];
  long long dst_stride[kMaxSegments];  // floats between two users' blocks
  unsigned per_user[kMaxSegments];     // ids per user
  unsigned start[kMaxSegments];        // first row of the launch that is this segment's
  int n;
};

// The source and destination of row g of the launch.
template <typename IdT>
__device__ __forceinline__ void locate(const Segments& s, unsigned g, const float* table,
                                       long long table_stride, long long V, int width,
                                       const float*& src, float*& dst) {
  const void* ids = s.ids[0];
  float* base = s.dst[0];
  long long stride = s.dst_stride[0];
  unsigned per = s.per_user[0], first = 0;
#pragma unroll
  for (int k = 1; k < kMaxSegments; ++k) {
    if (k < s.n && g >= s.start[k]) {
      ids = s.ids[k]; base = s.dst[k]; stride = s.dst_stride[k];
      per = s.per_user[k]; first = s.start[k];
    }
  }
  const unsigned local = g - first;
  const unsigned user = local / per, j = local - user * per;
  long long id = (long long)static_cast<const IdT*>(ids)[local];
  id = id < 0 ? 0 : (id >= V ? V - 1 : id);
  src = table + id * table_stride;
  dst = base + user * stride + (long long)j * width;
}

// VecT is float4 (width, strides and pointers 16-byte aligned) or float.
template <typename IdT, typename VecT>
__global__ void __launch_bounds__(kWarps * 32)
gather_rows_kernel(const float* __restrict__ table, long long table_stride, long long V,
                   int width, Segments s, unsigned total) {
  const int lane = threadIdx.x & 31;
  const int vecs = width / (int)(sizeof(VecT) / sizeof(float));
  const unsigned long long step = (unsigned long long)gridDim.x * kWarps * kRows;
  for (unsigned long long base =
           ((unsigned long long)blockIdx.x * kWarps + (threadIdx.x >> 5)) * kRows;
       base < total; base += step) {
    const float* my_src = nullptr;
    float* my_dst = nullptr;
    if (lane < kRows && base + lane < total)
      locate<IdT>(s, (unsigned)base + lane, table, table_stride, V, width, my_src, my_dst);
    const VecT* src[kRows];
    VecT* dst[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      src[r] = reinterpret_cast<const VecT*>(
          __shfl_sync(0xffffffffu, reinterpret_cast<unsigned long long>(my_src), r));
      dst[r] = reinterpret_cast<VecT*>(
          __shfl_sync(0xffffffffu, reinterpret_cast<unsigned long long>(my_dst), r));
    }
    for (int c = lane; c < vecs; c += 32) {
      VecT v[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (src[r] != nullptr) v[r] = __ldg(src[r] + c);
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (src[r] != nullptr) __stcs(dst[r] + c, v[r]);
    }
  }
}

template <typename IdT, typename VecT>
cudaError_t launch(const float* table, long long table_stride, long long V, int width,
                   const Segments& s, unsigned total, int device, cudaStream_t stream) {
  int sms = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) {
    cudaGetLastError();  // handed to the caller; not left for the next launch to find
    return err;
  }
  const long long want = ((long long)total + kWarps * kRows - 1) / (kWarps * kRows);
  const long long cap = (long long)sms * kBlocksPerSM;
  const unsigned blocks = (unsigned)(want < cap ? want : cap);
  gather_rows_kernel<IdT, VecT><<<blocks, kWarps * 32, 0, stream>>>(
      table, table_stride, V, width, s, total);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

int run(const float* table, long long table_stride0, long long table_stride1, long long V,
        long long width, int ids64, Segments& s, const long long* counts, int device,
        void* stream) {
  if (V < 1 || width < 1 || width > 0x7fffffffLL) return kBadTable;
  if (table_stride1 != 1) return kTableStride;
  if (s.n < 1 || s.n > kMaxSegments) return kBadSegments;
  bool vec = width % 4 == 0 && table_stride0 % 4 == 0 && aligned16(table);
  long long total = 0;
  for (int k = 0; k < s.n; ++k) {
    const long long n = counts[k], per = s.per_user[k];
    if (n < 0 || (n > 0 && (per < 1 || n % per != 0))) return kBadSegments;
    s.start[k] = (unsigned)total;
    total += n;
    if (total > 0x7fffffffLL) return kTooManyRows;
    vec = vec && aligned16(s.dst[k]) && s.dst_stride[k] % 4 == 0;
    if (n == 0) s.per_user[k] = 1;  // never divided by: the segment owns no row
  }
  if (total == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int w = (int)width;
  const unsigned t = (unsigned)total;
  cudaError_t err;
  if (ids64)
    err = vec ? launch<long long, float4>(table, table_stride0, V, w, s, t, device, st)
              : launch<long long, float>(table, table_stride0, V, w, s, t, device, st);
  else
    err = vec ? launch<int, float4>(table, table_stride0, V, w, s, t, device, st)
              : launch<int, float>(table, table_stride0, V, w, s, t, device, st);
  return (int)err;
}

template <typename T>
T* pointer(long long value) {
  return reinterpret_cast<T*>(static_cast<uintptr_t>(value));
}

// ---------------------------------------------------------------------------
// The gather's backward: out[clamp(ids[i]), :] += g[i, :] for every position
// i of up to four (ids, g) segments taken one after another, into a [V,
// width] table that is zero elsewhere; no float atomics, and every row's sum
// in an order the ids alone fix.
//
// Why not atomics. An atomic add per element (`index_add_`) sums each row's
// gradients in the order the adds arrive, so two calls differ in the last
// bits; Adam turns last-bit noise in a gradient that is zero but for
// rounding into updates of full size, and a replayed training step then parts
// from the eager one. Why not one thread per row of the table. Left-padded
// histories send the padding row about half of all gradients a step: a
// serial sum over them takes milliseconds.
//
// The order. Positions are cut into tiles of kGradTile. A row's gradients in
// one tile are summed in position order, from 0; the row's tile sums are
// then summed in tile order, from 0 (ops/embedding.py::
// embedding_gather_grad_ordered computes the same sums in plain PyTorch, bit
// for bit). It depends on the positions' ids and nothing else: two calls
// give the same bits, and so does a CUDA graph's replay.
//
// Design: two kernels at most, no sort, no memset, no library.
//   1. grad_tiles_kernel, one block a tile (128 positions, so 10,240 rows
//      make 80 blocks and 76,800 make 600): reads its ids (int32 or int64,
//      clamped, as 32-bit keys), ranks them by (key, position) in shared
//      memory (each thread against all 128, 16-byte reads), lands the
//      gradient rows in that order by cp.async and sums each key's run, one
//      thread a column: one partial row per distinct key of the tile, the
//      distinct keys ascending, and a directory of where each owner block's
//      rows start among them (computed while the rows land).
//   2. grad_rows_kernel, one block per `g` rows of the table (32 at the lazy
//      step's 11,264-row leaf, 848 at the 894,820-row table), launched as a
//      programmatic dependent of pass 1: its blocks write their rows' zeros
//      while pass 1 runs, then wait for it, collect the tiles' partials of
//      their rows from the directory, sort them by row (a counting sort,
//      stable in tile order), land them by cp.async and fold each row in
//      tile order, each position's meta packed so that the fold's reads
//      pipeline. The padding row's run is spread over all tiles of pass 1
//      and comes to its owner as one partial a tile.
//   Up to kDirectMax positions (a target and its negatives: 512),
//   grad_direct_kernel alone: one warp a position, which loads its own
//   gradient row while every block reads the ids, owns the row if no earlier
//   position has its key and folds the key's other positions in the same
//   order; zero blocks beside them write the rows no key reaches. One launch,
//   one dependent read.
//
// Bound on the H100 (data sheet): the gradient rows read once, the ids, and
// the table written once: n * width * 4 + 4 n + V * width * 4 bytes, 11.0 MB
// at the lazy step's 10,240 rows into 11,264 x 128 (3.3 us at 3.35 TB/s),
// 497 MB at 76,800 rows into the 894,820-row table (the zeros: 148 us).
// What is left above it: the partials' round trip through L2 (pass 1 writes
// as many bytes as it reads), pass 2's chain of three dependent reads
// (directory, keys, partials) and the padding row's owner folding one
// partial a tile; at the large table, zeros written at about 3 TB/s.

constexpr int kGradTile = 128;       // positions a tile: the order's first level
constexpr int kGradThreads = 128;    // threads a block of either pass
constexpr int kSlice = 128;          // columns staged at a time (one a thread)
constexpr int kDirectMax = 1024;     // n up to this: one launch (8 ids a thread)
constexpr int kMinRows = 32;         // rows an owner block takes at least
constexpr int kMaxRows = 1024;       // and at most
constexpr int kOwnersPerSM = 8;      // owner blocks an SM, where kMinRows would ask more
constexpr int kList = 1024;          // partials an owner block sorts at a time
constexpr int kChunk = 64;           // partials' rows staged at a time

enum GradRefusal {
  kGradScratch = -5,  // the scratch is smaller than gather_rows_grad_scratch says
};

struct GradSegs {
  const void* ids[kMaxSegments];
  const float* g[kMaxSegments];
  long long g_stride[kMaxSegments];  // floats between two gradient rows
  int start[kMaxSegments];           // the segment's first position
  int n;
};

// What pass 1 writes and pass 2 reads (the scratch), and the owners' rows.
struct GradWork {
  float* part;   // [n_tiles * kGradTile][width]: tile t's partials at rows t * kGradTile + d
  int* tkeys;    // [n_tiles * kGradTile]: tile t's distinct keys, ascending
  int* dir;      // [n_tiles][nb + 1]: how many of tile t's distinct keys lie below b * g
  long long g;   // rows an owner block takes
  int nb;        // owner blocks
  int n_tiles;
};

struct GradPlan {
  int n_tiles, nb, direct;
  long long g, tkeys_off, dir_off, bytes;
};

__host__ GradPlan grad_plan(long long n, long long V, long long width, int sms) {
  GradPlan p = {};
  p.n_tiles = (int)((n + kGradTile - 1) / kGradTile);
  p.direct = n <= kDirectMax;
  long long nb = (V + kMinRows - 1) / kMinRows;
  const long long cap = (long long)sms * kOwnersPerSM;
  if (nb > cap) {
    const long long least = (V + kMaxRows - 1) / kMaxRows;
    nb = cap > least ? cap : least;
  }
  p.g = (V + nb - 1) / nb;
  p.nb = (int)((V + p.g - 1) / p.g);
  if (p.direct) return p;  // no scratch
  // the partials, the keys, the directory (nb + 1 entries a tile: at most
  // about 7% of the partials' bytes)
  auto up16 = [](long long b) { return (b + 15) / 16 * 16; };
  p.tkeys_off = up16((long long)p.n_tiles * kGradTile * width * 4);
  p.dir_off = up16(p.tkeys_off + (long long)p.n_tiles * kGradTile * 4);
  p.bytes = p.dir_off + (long long)p.n_tiles * (p.nb + 1) * 4;
  return p;
}

// The key (clamped id) of position i and its gradient row.
template <bool IDS64>
__device__ __forceinline__ int grad_locate(const GradSegs& s, int i, long long V,
                                           const float*& src) {
  const void* ids = s.ids[0];
  const float* g = s.g[0];
  long long stride = s.g_stride[0];
  int first = 0;
#pragma unroll
  for (int k = 1; k < kMaxSegments; ++k) {
    if (k < s.n && i >= s.start[k]) {
      ids = s.ids[k]; g = s.g[k]; stride = s.g_stride[k]; first = s.start[k];
    }
  }
  const int local = i - first;
  long long id = IDS64 ? static_cast<const long long*>(ids)[local]
                       : (long long)static_cast<const int*>(ids)[local];
  id = id < 0 ? 0 : (id >= V ? V - 1 : id);
  src = g + (long long)local * stride;
  return (int)id;
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Issues the cp.async of columns [c0, c0 + sw) of `rows` rows (row r from
// src_of(r)) into stage[r][0, sw); the caller waits (cp_async_wait_all and
// a barrier) before it reads them.
template <bool VEC, typename Src>
__device__ __forceinline__ void issue_rows(float* stage, int rows, int c0, int sw, Src src_of,
                                           int tid) {
  if (VEC) {
    const int chunks = sw >> 2;
    for (int item = tid; item < rows * chunks; item += kGradThreads) {
      const int r = item / chunks, c = item - r * chunks;
      cp_async16(smem_u32(stage + r * kSlice + 4 * c), src_of(r) + c0 + 4 * c, true);
    }
  } else {
    for (int item = tid; item < rows * sw; item += kGradThreads) {
      const int r = item / sw, c = item - r * sw;
      cp_async4(smem_u32(stage + r * kSlice + c), src_of(r) + c0 + c, true);
    }
  }
}

// An exclusive prefix sum over the block's 128 threads; `total` the sum.
__device__ __forceinline__ int block_scan(int v, int& total, int* wsum, int tid) {
  const int lane = tid & 31, w = tid >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) wsum[w] = x;
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int j = 0; j < kGradThreads / 32; ++j) {
    before += j < w ? wsum[j] : 0;
    total += wsum[j];
  }
  __syncthreads();
  return before + x - v;
}

// the row pass may launch (programmatic dependent launch): it waits for this
// grid's writes (grid_wait) before it reads them
__device__ __forceinline__ void grid_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void grid_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

constexpr size_t tile_smem() { return (size_t)kGradTile * kSlice * 4; }
constexpr int kRunEnd = (int)0x80000000u;  // a tile's sorted position where a key's run ends

template <bool IDS64, bool VEC>
__global__ void __launch_bounds__(kGradThreads)
grad_tiles_kernel(const GradSegs s, int n, long long V, int width, const GradWork wk) {
  __shared__ __align__(16) int key_in[kGradTile];
  __shared__ int sk[kGradTile];      // the keys in (key, position) order
  __shared__ const float* ssrc[kGradTile];
  __shared__ int meta[kGradTile];    // sorted position: its key's number, kRunEnd where its run ends
  __shared__ int dkeys[kGradTile];   // the distinct keys, ascending
  __shared__ int wsum[kGradThreads / 32];
  extern __shared__ __align__(16) float stage[];  // [kGradTile][kSlice]
  grid_launch_dependents();
  const int tid = threadIdx.x, t = blockIdx.x;
  const int i0 = t * kGradTile, len = min(kGradTile, n - i0);
  int key = 0x7fffffff;  // past len: after every key
  const float* src = nullptr;
  if (tid < len) key = grad_locate<IDS64>(s, i0 + tid, V, src);
  key_in[tid] = key;
  __syncthreads();
  int rank = 0;
#pragma unroll
  for (int j4 = 0; j4 < kGradTile / 4; ++j4) {
    const int4 k4 = reinterpret_cast<const int4*>(key_in)[j4];
    const int kk[4] = {k4.x, k4.y, k4.z, k4.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) rank += (kk[u] < key) | ((kk[u] == key) & (4 * j4 + u < tid));
  }
  if (tid < len) {
    sk[rank] = key;
    ssrc[rank] = src;
  }
  __syncthreads();
  const bool head = tid < len && (tid == 0 || sk[tid] != sk[tid - 1]);
  const bool end = tid < len && (tid + 1 == len || sk[tid + 1] != sk[tid]);
  const unsigned ball = __ballot_sync(0xffffffffu, head);
  const int lane = tid & 31;
  if (lane == 0) wsum[tid >> 5] = __popc(ball);
  __syncthreads();
  int nd = 0, incl = __popc(ball & ((2u << lane) - 1u));
#pragma unroll
  for (int j = 0; j < kGradThreads / 32; ++j) {
    nd += wsum[j];
    incl += j < (tid >> 5) ? wsum[j] : 0;
  }
  meta[tid] = tid < len ? (incl - 1) | (end ? kRunEnd : 0) : 0;
  if (head) {
    dkeys[incl - 1] = sk[tid];
    wk.tkeys[(long long)t * kGradTile + incl - 1] = sk[tid];
  }
  __syncthreads();
  for (int c0 = 0; c0 < width; c0 += kSlice) {
    const int sw = min(kSlice, width - c0);
    issue_rows<VEC>(stage, len, c0, sw, [&](int r) { return ssrc[r]; }, tid);
    if (c0 == 0) {  // the directory, while the rows land
      for (int b = tid; b <= wk.nb; b += kGradThreads) {
        const long long bound = (long long)b * wk.g;
        int lo = 0, hi = nd;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (dkeys[mid] < bound) lo = mid + 1; else hi = mid;
        }
        wk.dir[(long long)t * (wk.nb + 1) + b] = lo;
      }
    }
    cp_async_wait_all();
    __syncthreads();
    if (tid < sw) {  // past len: no run ends, whatever the stage holds
      float* dst = wk.part + (long long)t * kGradTile * width + c0 + tid;
      float acc = 0.f;
#pragma unroll 16
      for (int r = 0; r < kGradTile; ++r) {
        const int mt = meta[r];
        acc += stage[r * kSlice + tid];
        if (mt < 0) {
          dst[(long long)(mt & 0x7fffffff) * width] = acc;
          acc = 0.f;
        }
      }
    }
    __syncthreads();  // the stage is free
  }
}

// An owner block's shared memory: the stage of kChunk rows; its list of
// kList (source row, table row, tile), the list's order by row, each sorted
// position's source and meta; its rows' counts, and which of them an earlier
// list wrote.
constexpr size_t rows_smem() {
  return (size_t)kChunk * kSlice * 4 + (size_t)kList * (8 + 8 + 4 + 4 + 4 + 4) +
         (size_t)kMaxRows * 4 + kMaxRows / 8;
}
// the meta of a sorted list position: the table row (from bit 4 on) and
constexpr int kNewRow = 1;   // the row's first term in this list
constexpr int kNewTile = 2;  // a term of another tile than the one before
constexpr int kLast = 4;     // the row's last term in this list
constexpr int kSeen = 8;     // the row was written by an earlier list

// The meta and source of sorted position q of a list of m (srt written).
__device__ __forceinline__ void place(int q, int m, const int* srt, const int* erow,
                                      const int* etile, const unsigned* seen,
                                      const float* const* esrc, int* qmeta, const float** qsrc) {
  const int e = srt[q];
  const int row = erow[e], tile = etile[e];
  const bool first = q == 0 || erow[srt[q - 1]] != row;
  int mt = row << 4 | (first ? kNewRow : (etile[srt[q - 1]] != tile ? kNewTile : 0));
  if (q + 1 == m || erow[srt[q + 1]] != row) mt |= kLast;
  if ((seen[row >> 5] >> (row & 31)) & 1u) mt |= kSeen;
  qmeta[q] = mt;
  qsrc[q] = esrc[e];
}

// Pass 2: block b owns rows [b g, b g + g) of the table.
template <bool IDS64, bool VEC>
__global__ void __launch_bounds__(kGradThreads)
grad_rows_kernel(const GradSegs s, int n, long long V, int width, const GradWork wk,
                 float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char sm[];
  constexpr int cap = kList, chunk = kChunk;
  float* stage = reinterpret_cast<float*>(sm);                         // [chunk][kSlice]
  const float** esrc = reinterpret_cast<const float**>(stage + chunk * kSlice);  // [cap]
  const float** qsrc = esrc + cap;                  // [cap] in row order
  int* erow = reinterpret_cast<int*>(qsrc + cap);   // [cap] the row in the block's range
  int* etile = erow + cap;                          // [cap] its tile
  int* srt = etile + cap;                           // [cap] the list sorted by row
  int* qmeta = srt + cap;                           // [cap] in row order
  int* cnt = qmeta + cap;                           // [kMaxRows]
  unsigned* seen = reinterpret_cast<unsigned*>(cnt + kMaxRows);  // [kMaxRows / 32]
  __shared__ int wsum[kGradThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31;
  const long long r0 = (long long)blockIdx.x * wk.g;
  const int R = (int)min(wk.g, V - r0);
  for (int x = tid; x < (R + 31) / 32; x += kGradThreads) seen[x] = 0u;
  // every row of the range zero first, while pass 1 runs (a row a gradient
  // reaches is written again below, after barriers)
  if (VEC) {
    const int chunks = width >> 2;
    float4* row0 = reinterpret_cast<float4*>(out + r0 * width);
    for (long long item = tid; item < (long long)R * chunks; item += kGradThreads)
      row0[item] = make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    for (long long item = tid; item < (long long)R * width; item += kGradThreads)
      out[r0 * width + item] = 0.f;
  }
  grid_wait();  // then pass 1's directory, keys and partials

  // thread tid owns tiles [ta, tb), so the list runs in tile order; tile
  // t's distinct keys in this block's rows are [dir(t)[0], dir(t)[1])
  const int per = (wk.n_tiles + kGradThreads - 1) / kGradThreads;
  const int ta = min(wk.n_tiles, tid * per), tb = min(wk.n_tiles, ta + per);
  auto dir = [&](int t) { return wk.dir + (long long)t * (wk.nb + 1) + blockIdx.x; };
  int mine = 0;
  for (int t = ta; t < tb; ++t) mine += dir(t)[1] - dir(t)[0];
  int total;
  const int base = block_scan(mine, total, wsum, tid);
  // the partials in lists of at most cap, in tile order
  for (int w0 = 0; w0 < total; w0 += cap) {
    int pos = base;
    for (int t = ta; t < tb && pos < w0 + cap; ++t) {
      const int lo = dir(t)[0], hi = dir(t)[1];
      if (pos + (hi - lo) <= w0) {
        pos += hi - lo;
        continue;
      }
      for (int j = lo; j < hi; ++j, ++pos) {
        if (pos < w0 || pos >= w0 + cap) continue;
        const long long at = (long long)t * kGradTile + j;
        erow[pos - w0] = (int)(wk.tkeys[at] - r0);
        esrc[pos - w0] = wk.part + at * width;
        etile[pos - w0] = t;
      }
    }
    __syncthreads();
    // Sort the list by row, stable (a counting sort), then fold each row in
    // list order: the tile sums in tile order onto the row's earlier value
    // (0, or what an earlier list wrote)
    const int m = min(cap, total - w0);
    for (int r = tid; r < R; r += kGradThreads) cnt[r] = 0;
    __syncthreads();
    for (int e = tid; e < m; e += kGradThreads) atomicAdd(&cnt[erow[e]], 1);
    __syncthreads();
    {  // cnt -> the first sorted slot of each row
      const int rows_per = (R + kGradThreads - 1) / kGradThreads;
      const int a = min(R, tid * rows_per), b = min(R, a + rows_per);
      int mine_rows = 0;
      for (int r = a; r < b; ++r) mine_rows += cnt[r];
      int rows_total;
      int run = block_scan(mine_rows, rows_total, wsum, tid);
      for (int r = a; r < b; ++r) {
        const int c = cnt[r];
        cnt[r] = run;
        run += c;
      }
    }
    __syncthreads();
    if (tid < 32) {  // one warp places the list in order: stable
      const unsigned lt = (1u << lane) - 1u;
      for (int e0 = 0; e0 < m; e0 += 32) {
        const int e = e0 + lane;
        const bool valid = e < m;
        const int row = valid ? erow[e] : -1 - lane;
        const unsigned peers = __match_any_sync(0xffffffffu, row);
        if (valid) srt[cnt[row] + __popc(peers & lt)] = e;
        __syncwarp();
        if (valid && lane == 31 - __clz(peers)) cnt[row] += __popc(peers);
        __syncwarp();
      }
    }
    __syncthreads();
    for (int q = tid; q < m; q += kGradThreads)
      place(q, m, srt, erow, etile, seen, esrc, qmeta, qsrc);
    __syncthreads();
    for (int c0 = 0; c0 < width; c0 += kSlice) {
      const int sw = min(kSlice, width - c0);
      float* col = out + r0 * width + c0 + tid;
      float outer = 0.f, inner = 0.f;
      for (int k0 = 0; k0 < m; k0 += chunk) {
        const int kc = min(chunk, m - k0);
        issue_rows<VEC>(stage, kc, c0, sw, [&](int r) { return qsrc[k0 + r]; }, tid);
        cp_async_wait_all();
        __syncthreads();
        if (tid < sw) {
#pragma unroll 8
          for (int q = 0; q < kc; ++q) {
            const int mt = qmeta[k0 + q];
            const float x = stage[q * kSlice + tid];
            if (mt & kNewRow) {
              outer = (mt & kSeen) ? col[(long long)(mt >> 4) * width] : 0.f;
              inner = 0.f;
            } else if (mt & kNewTile) {
              outer += inner;
              inner = 0.f;
            }
            inner += x;
            if (mt & kLast) col[(long long)(mt >> 4) * width] = outer + inner;
          }
        }
        __syncthreads();  // the stage is free
      }
    }
    if (w0 + cap < total) {  // a later list: the rows this one wrote
      for (int e = tid; e < m; e += kGradThreads)
        atomicOr(&seen[erow[e] >> 5], 1u << (erow[e] & 31));
      __syncthreads();
    }
  }
}

// The one-launch path (n <= kDirectMax): `nb` zero blocks, then one warp a
// position. Every block reads all n keys. A zero block writes zeros to the
// rows of its range that no key reaches. A position's warp owns its key's
// row if no earlier position has the key: it folds the row's gradients,
// its own first (loaded while the keys land), in the order of pass 1 and
// pass 2 (from 0 within a tile, then the tile sums from 0), and writes it.
template <bool IDS64, bool VEC>
__global__ void __launch_bounds__(kGradThreads)
grad_direct_kernel(const GradSegs s, int n, long long V, int width, long long g, int nb,
                   float* __restrict__ out) {
  __shared__ int keys[kDirectMax];
  __shared__ unsigned touched[kMaxRows / 32];
  const int tid = threadIdx.x, lane = tid & 31;
  const bool zero_block = (int)blockIdx.x < nb;
  const int i = zero_block ? n : ((int)blockIdx.x - nb) * (kGradThreads / 32) + (tid >> 5);
  constexpr int kW = VEC ? 4 : 1;  // floats a lane takes of a column chunk
  const int chunks = width / kW;
  const float* self = nullptr;
  int key = -1;
  float own[kW] = {};  // the first chunk of this position's own row
  if (i < n) {
    key = grad_locate<IDS64>(s, i, V, self);
    if (lane < chunks) {
      if (VEC) {
        const float4 x = __ldg(reinterpret_cast<const float4*>(self) + lane);
        own[0] = x.x, own[1] = x.y, own[2] = x.z, own[3] = x.w;
      } else {
        own[0] = __ldg(self + lane);
      }
    }
  }
  for (int j = tid; j < n; j += kGradThreads) {
    const float* unused;
    keys[j] = grad_locate<IDS64>(s, j, V, unused);
  }
  const long long r0 = (long long)blockIdx.x * g;
  const int R = zero_block ? (int)min(g, V - r0) : 0;
  for (int x = tid; x < (R + 31) / 32; x += kGradThreads) touched[x] = 0u;
  __syncthreads();
  if (zero_block) {
    for (int j = tid; j < n; j += kGradThreads) {
      const long long r = keys[j] - r0;
      if (r >= 0 && r < R) atomicOr(&touched[r >> 5], 1u << (r & 31));
    }
    __syncthreads();
    for (long long item = tid; item < (long long)R * chunks; item += kGradThreads) {
      const int r = (int)(item / chunks);
      if (!((touched[r >> 5] >> (r & 31)) & 1u)) {
        if (VEC)
          reinterpret_cast<float4*>(out + r0 * width)[item] = make_float4(0.f, 0.f, 0.f, 0.f);
        else
          out[r0 * width + item] = 0.f;
      }
    }
    return;
  }
  if (i >= n) return;
  for (int j0 = 0; j0 < i; j0 += 32)  // an earlier position owns the row
    if (__any_sync(0xffffffffu, j0 + lane < i && keys[j0 + lane] == key)) return;
  float* row = out + (long long)key * width;
  for (int c0 = 0; c0 < chunks; c0 += 32) {
    const int c = c0 + lane;
    const bool active = c < chunks;
    float outer[kW], inner[kW];
#pragma unroll
    for (int x = 0; x < kW; ++x) outer[x] = inner[x] = 0.f;
    int cur_tile = i / kGradTile;
    for (int j0 = i & ~31; j0 < n; j0 += 32) {
      const int jl = j0 + lane;
      unsigned hits = __ballot_sync(0xffffffffu, jl >= i && jl < n && keys[jl] == key);
      while (hits) {
        const int j = j0 + __ffs(hits) - 1;
        hits &= hits - 1;
        float v[kW];
        if (j == i && c0 == 0) {
#pragma unroll
          for (int x = 0; x < kW; ++x) v[x] = own[x];
        } else {
          const float* src = self;
          if (j != i) grad_locate<IDS64>(s, j, V, src);
#pragma unroll
          for (int x = 0; x < kW; ++x) v[x] = 0.f;
          if (active) {
            if (VEC) {
              const float4 y = __ldg(reinterpret_cast<const float4*>(src) + c);
              v[0] = y.x, v[1] = y.y, v[2] = y.z, v[3] = y.w;
            } else {
              v[0] = __ldg(src + c);
            }
          }
        }
        if (j / kGradTile != cur_tile) {
#pragma unroll
          for (int x = 0; x < kW; ++x) {
            outer[x] += inner[x];
            inner[x] = 0.f;
          }
          cur_tile = j / kGradTile;
        }
#pragma unroll
        for (int x = 0; x < kW; ++x) inner[x] += v[x];
      }
    }
    if (active) {
      if (VEC)
        reinterpret_cast<float4*>(row)[c] = make_float4(outer[0] + inner[0], outer[1] + inner[1],
                                                        outer[2] + inner[2], outer[3] + inner[3]);
      else
        row[c] = outer[0] + inner[0];
    }
  }
}

template <typename K>
cudaError_t smem_opt_in(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// the shared-memory opt-in of every instance, once (not a stream operation:
// it stays out of a CUDA graph's capture)
cudaError_t grad_opt_in() {
  static const cudaError_t e = [] {
    const size_t t = tile_smem(), r = rows_smem();
    cudaError_t x = smem_opt_in(grad_tiles_kernel<false, false>, t);
    if (x == cudaSuccess) x = smem_opt_in(grad_tiles_kernel<false, true>, t);
    if (x == cudaSuccess) x = smem_opt_in(grad_tiles_kernel<true, false>, t);
    if (x == cudaSuccess) x = smem_opt_in(grad_tiles_kernel<true, true>, t);
    if (x == cudaSuccess) x = smem_opt_in(grad_rows_kernel<false, false>, r);
    if (x == cudaSuccess) x = smem_opt_in(grad_rows_kernel<false, true>, r);
    if (x == cudaSuccess) x = smem_opt_in(grad_rows_kernel<true, false>, r);
    if (x == cudaSuccess) x = smem_opt_in(grad_rows_kernel<true, true>, r);
    return x;
  }();
  return e;
}

template <bool IDS64, bool VEC>
cudaError_t launch_grad(const GradSegs& s, int n, long long V, int width, const GradWork& wk,
                        bool direct, float* out, cudaStream_t st) {
  if (!direct) {
    grad_tiles_kernel<IDS64, VEC><<<wk.n_tiles, kGradThreads, tile_smem(), st>>>(s, n, V, width,
                                                                                 wk);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    // pass 2 starts while pass 1 runs (programmatic dependent launch): its
    // blocks write their zeros, then wait for pass 1's grid
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(wk.nb);
    cfg.blockDim = dim3(kGradThreads);
    cfg.dynamicSmemBytes = rows_smem();
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t x = cudaLaunchKernelEx(&cfg, grad_rows_kernel<IDS64, VEC>, s, n, V, width,
                                             wk, out);
    if (x != cudaSuccess) {
      cudaGetLastError();
      return x;
    }
  } else {
    const int blocks = wk.nb + (n + kGradThreads / 32 - 1) / (kGradThreads / 32);
    grad_direct_kernel<IDS64, VEC><<<blocks, kGradThreads, 0, st>>>(s, n, V, width, wk.g, wk.nb,
                                                                     out);
  }
  return cudaGetLastError();
}

int sm_count(int device, int& sms) {
  const cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) cudaGetLastError();  // handed to the caller
  return (int)err;
}

int run_grad(GradSegs& s, const long long* counts, long long V, long long width, int ids64,
             float* out, unsigned char* scratch, long long scratch_bytes, int device,
             void* stream) {
  if (V < 1 || V > 0x7fffffffLL || width < 1 || width > 0x7fffffffLL) return kBadTable;
  if (s.n < 1 || s.n > kMaxSegments) return kBadSegments;
  long long n = 0;
  bool vec = width % 4 == 0;
  for (int k = 0; k < s.n; ++k) {
    if (counts[k] < 0) return kBadSegments;
    s.start[k] = (int)n;
    n += counts[k];
    if (n > 0x7fffffffLL) return kTooManyRows;
    vec = vec && (counts[k] == 0 || (aligned16(s.g[k]) && s.g_stride[k] % 4 == 0));
  }
  int sms = 0;
  int err = sm_count(device, sms);
  if (err) return err;
  const GradPlan p = grad_plan(n, V, width, sms);
  if (scratch_bytes < p.bytes) return kGradScratch;
  err = (int)grad_opt_in();
  if (err) return err;
  const GradWork wk = {reinterpret_cast<float*>(scratch),
                       reinterpret_cast<int*>(scratch + p.tkeys_off),
                       reinterpret_cast<int*>(scratch + p.dir_off), p.g, p.nb, p.n_tiles};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nn = (int)n, w = (int)width;
  const bool direct = p.direct != 0;
  if (ids64)
    return (int)(vec ? launch_grad<true, true>(s, nn, V, w, wk, direct, out, st)
                     : launch_grad<true, false>(s, nn, V, w, wk, direct, out, st));
  return (int)(vec ? launch_grad<false, true>(s, nn, V, w, wk, direct, out, st)
                   : launch_grad<false, false>(s, nn, V, w, wk, direct, out, st));
}

}  // namespace

extern "C" {

// Up to four lookups into one table in one launch. The arguments come as one
// array of 64-bit integers (pointers as integers), which the Python side packs
// in one call: converting one argument costs less than converting ten.
// a = {table, table_stride0, table_stride1, V, width, ids64, n_segments,
// device, stream}, then for each segment {ids, n, ids per user, destination,
// destination stride}. table: fp32 [V, width] with those strides in elements;
// ids: [n] contiguous, all segments int32 (ids64 == 0) or int64; user u's rows
// are written as one contiguous block at destination + u * stride floats, and
// the caller keeps the users' blocks apart. device: the index of the card the
// tensors lie on (its SM count sizes the grid); stream: a stream of that card.
int gather_rows(const long long* a) {
  const long long n_segments = a[6];
  if (n_segments < 1 || n_segments > kMaxSegments) return kBadSegments;
  Segments s = {};
  s.n = (int)n_segments;
  long long counts[kMaxSegments] = {0, 0, 0, 0};
  for (int k = 0; k < s.n; ++k) {
    const long long* seg = a + 9 + 5 * k;
    if (seg[2] < 0 || seg[2] > 0x7fffffffLL) return kBadSegments;
    s.ids[k] = pointer<const void>(seg[0]);
    counts[k] = seg[1];
    s.per_user[k] = (unsigned)seg[2];
    s.dst[k] = pointer<float>(seg[3]);
    s.dst_stride[k] = seg[4];
  }
  return run(pointer<const float>(a[0]), a[1], a[2], a[3], a[4], (int)a[5], s, counts,
             (int)a[7], pointer<void>(a[8]));
}

// The gather's backward, in a fixed order (see above), writing every row of
// `out`. a = {n_segments, V, width, ids64, out, scratch, scratch_bytes,
// device, stream}, then for each segment {ids, n, g, g_stride}: ids [n]
// contiguous, all segments int32 (ids64 == 0) or int64, each clamped to [0,
// V); g: fp32 rows of `width` unit-stride floats, g_stride floats apart;
// out: fp32 [V, width] contiguous (every element written); scratch:
// gather_rows_grad_scratch(total n, V, width, device) bytes, 16-byte
// aligned. Returns 0, a refusal (kBadTable, kBadSegments, kTooManyRows,
// kGradScratch) or a cudaError_t.
int gather_rows_grad(const long long* a) {
  const long long n_segments = a[0];
  if (n_segments < 1 || n_segments > kMaxSegments) return kBadSegments;
  GradSegs s = {};
  s.n = (int)n_segments;
  long long counts[kMaxSegments] = {0, 0, 0, 0};
  for (int k = 0; k < s.n; ++k) {
    const long long* seg = a + 9 + 4 * k;
    s.ids[k] = pointer<const void>(seg[0]);
    counts[k] = seg[1];
    s.g[k] = pointer<const float>(seg[2]);
    s.g_stride[k] = seg[3];
  }
  return run_grad(s, counts, a[1], a[2], (int)a[3], pointer<float>(a[4]),
                  pointer<unsigned char>(a[5]), a[6], (int)a[7], pointer<void>(a[8]));
}

// Bytes of scratch gather_rows_grad needs for n positions into [V, width] on
// `device` (0 up to kDirectMax positions), or a negative cudaError_t.
long long gather_rows_grad_scratch(long long n, long long V, long long width, int device) {
  int sms = 0;
  const int err = sm_count(device, sms);
  if (err) return -err;
  return grad_plan(n < 0 ? 0 : n, V < 1 ? 1 : V, width < 1 ? 1 : width, sms).bytes;
}

// Positions a tile: the first level of the order.
int gather_rows_grad_chunk() { return kGradTile; }

}  // extern "C"
