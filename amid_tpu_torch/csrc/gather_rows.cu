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

namespace {

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
// The gather's backward: out[keys[i], :] += g[order[i], :] for every i, into
// a zero [V, width] table, in a fixed order.
//
// Why not atomics. An atomic add per element (`index_add_`) sums each row's
// gradients in the order the adds arrive, so two calls differ in the last
// bits; Adam turns last-bit noise in a gradient that is zero but for
// rounding into updates of full size, and a replayed training step then parts
// from the eager one. Why not one thread per row of the table. Left-padded
// histories send the padding row tens of thousands of gradients a step: a
// serial sum over them (what a sorted `index_put_` does) takes milliseconds.
//
// Design. The caller sorts the ids (stable) and passes them as `keys` with
// the permutation `order`. Pass 1: a block sums kGradChunk consecutive sorted
// rows, one thread a column, in row order, closing a run at each change of
// key; a run that starts and ends inside the chunk is written to its row of
// the table, and each chunk keeps its first run's sum (head) and its last
// run's (tail). Pass 2: the block of the chunk where a longer run starts adds
// the following chunks' heads to its tail in chunk order (a binary search
// over the sorted keys finds the run's last chunk) and writes the row. Every
// row's sum thus has one order, fixed by the keys alone: two calls are
// bit-equal. A run is written once, by one block: no atomics, no races.
//
// Bound on the H100 (data sheet): the gradient rows read once (n * width * 4
// bytes), the keys and order (16 bytes a row) and each distinct row written
// once: 39 MB at n = 76,800, width = 128 (12 us at 3.35 TB/s). The zero
// table itself is the caller's (a memset of V * width * 4 bytes).

constexpr int kGradChunk = 256;   // sorted rows one block of pass 1 sums
constexpr int kGradThreads = 128; // threads a block: one column each, looping past 128
constexpr int kGradUnroll = 8;    // rows whose loads are issued before they are added

__device__ __forceinline__ void store_row(float* out, long long key, long long V, int width,
                                          int col, float value) {
  if (key >= 0 && key < V) out[key * width + col] = value;
}

__global__ void __launch_bounds__(kGradThreads)
grad_chunks_kernel(const long long* __restrict__ keys, const long long* __restrict__ order,
                   const float* __restrict__ g, long long g_stride, float* __restrict__ out,
                   float* __restrict__ head, float* __restrict__ tail, int n, long long V,
                   int width) {
  __shared__ long long sk[kGradChunk];
  __shared__ long long so[kGradChunk];
  const int c = blockIdx.x;
  const int c0 = c * kGradChunk;
  const int len = min(kGradChunk, n - c0);
  for (int i = threadIdx.x; i < len; i += blockDim.x) {
    sk[i] = keys[c0 + i];
    so[i] = order[c0 + i];
  }
  __syncthreads();
  // the first run continues one from the chunk before; the last, into the next
  const bool cont_in = c0 > 0 && keys[c0 - 1] == sk[0];
  const bool cont_out = c0 + len < n && keys[c0 + len] == sk[len - 1];
  for (int col = threadIdx.x; col < width; col += blockDim.x) {
    float acc = 0.f;
    int start = 0;  // first row of the open run
    for (int i0 = 0; i0 < len; i0 += kGradUnroll) {
      float v[kGradUnroll];
#pragma unroll
      for (int u = 0; u < kGradUnroll; ++u)
        v[u] = i0 + u < len ? __ldg(g + so[i0 + u] * g_stride + col) : 0.f;
#pragma unroll
      for (int u = 0; u < kGradUnroll; ++u) {
        const int i = i0 + u;
        if (i >= len) break;
        if (i > start && sk[i] != sk[i - 1]) {  // the run [start, i) closes
          if (start == 0) head[(long long)c * width + col] = acc;
          if (!(start == 0 && cont_in)) store_row(out, sk[start], V, width, col, acc);
          acc = 0.f;
          start = i;
        }
        acc += v[u];
      }
    }
    // the last run [start, len)
    if (start == 0) head[(long long)c * width + col] = acc;
    tail[(long long)c * width + col] = acc;
    if (!(start == 0 && cont_in) && !cont_out) store_row(out, sk[start], V, width, col, acc);
  }
}

__global__ void __launch_bounds__(kGradThreads)
grad_spans_kernel(const long long* __restrict__ keys, float* __restrict__ out,
                  const float* __restrict__ head, const float* __restrict__ tail, int n,
                  long long V, int width) {
  const int c = blockIdx.x;
  const int c0 = c * kGradChunk;
  const int len = min(kGradChunk, n - c0);
  const long long key = keys[c0 + len - 1];
  if (!(c0 + len < n && keys[c0 + len] == key)) return;  // the last run ends here
  if (keys[c0] == key && c0 > 0 && keys[c0 - 1] == key) return;  // it started earlier
  int lo = c0 + len, hi = n;  // keys[lo] == key; the run's last row is in [lo, hi)
  while (hi - lo > 1) {
    const int mid = lo + (hi - lo) / 2;
    if (keys[mid] == key) lo = mid; else hi = mid;
  }
  const int last = lo / kGradChunk;
  for (int col = threadIdx.x; col < width; col += blockDim.x) {
    float acc = tail[(long long)c * width + col];
    for (int cc = c + 1; cc <= last; ++cc) acc += head[(long long)cc * width + col];
    store_row(out, key, V, width, col, acc);
  }
}

int run_grad(const long long* keys, const long long* order, const float* g, long long g_stride,
             float* out, float* scratch, long long n, long long V, long long width,
             void* stream) {
  if (V < 1 || width < 1 || width > 0x7fffffffLL) return kBadTable;
  if (n < 0 || n > 0x7fffffffLL) return kTooManyRows;
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int chunks = (int)((n + kGradChunk - 1) / kGradChunk);
  float* head = scratch;
  float* tail = scratch + (long long)chunks * width;
  grad_chunks_kernel<<<chunks, kGradThreads, 0, st>>>(keys, order, g, g_stride, out, head,
                                                      tail, (int)n, V, (int)width);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  grad_spans_kernel<<<chunks, kGradThreads, 0, st>>>(keys, out, head, tail, (int)n, V,
                                                     (int)width);
  return (int)cudaGetLastError();
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

// The gather's backward into a zero table, in a fixed order (see above).
// a = {keys, order, g, g_stride, out, scratch, n, V, width, stream}. keys:
// int64 [n], the ids sorted ascending (stable), each in [0, V) (a key outside
// is skipped); order: int64 [n], for each sorted position the row of g it
// takes; g: fp32 rows of `width` unit-stride floats, g_stride floats apart;
// out: fp32 [V, width] contiguous, zero; scratch: fp32 [2 * ceil(n / 256),
// width]. Returns 0, a refusal (kBadTable, kTooManyRows) or a cudaError_t.
int gather_rows_grad(const long long* a) {
  return run_grad(pointer<const long long>(a[0]), pointer<const long long>(a[1]),
                  pointer<const float>(a[2]), a[3], pointer<float>(a[4]),
                  pointer<float>(a[5]), a[6], a[7], a[8], pointer<void>(a[9]));
}

int gather_rows_grad_chunk() { return kGradChunk; }

}  // extern "C"
