// Unique-row scatter for Hopper (sm_90a): dst[ids[n], :] = src[n, :] in place.
//
// Replaces amid_tpu/ops/pallas_scatter.py::_scatter3_kernel (the fused
// table / mu / nu write-back of the lazy table Adam, pallas_call in
// scatter_set_unique3_pallas) and ::_scatter_kernel (its single-array form,
// pallas_call in scatter_set_unique_pallas). One launch writes row ids[n] of
// each destination from row n of its source, for up to three
// source/destination pairs that share the ids, and skips every n with
// ids[n] < 0 or ids[n] >= V (the sentinel tail of a padded unique-id list).
//
// Contract (the caller's, as on the TPU): the in-range ids are duplicate
// free. Two equal ids would be a data race between two warps; which row wins
// is then undefined.
//
// Design. The TPU kernel issues one DMA per row from ids prefetched to scalar
// memory. Here the grid is a few blocks per SM and strides over the rows. A
// warp takes R rows at a time: lanes 0..R-1 read the R ids in one coalesced
// load, the warp shares them by shuffle, and every lane issues its 16-byte
// piece of all R rows of every pair before its first store, so R * n_pairs
// loads are in flight per lane (R = 8 for one pair, 4 for three; n_pairs is a
// template parameter and both loops unroll into registers). Sources are read
// with a streaming load and destinations written with a streaming store:
// neither is touched again by this launch, and the three tables hold 458 MB
// each against 50 MB of L2. Rows move as float4 when width, strides and
// pointers allow 16-byte accesses, as floats otherwise.
//
// Bound on the H100 (data sheet): pure data movement. Each pair reads and
// writes U*width*4 bytes, plus the ids: at U = 11,264, width = 128 and three
// pairs 34.6 MB (10.3 us at 3.35 TB/s); at U = 77,824, 239 MB (71.4 us).
//
// The entry point validates what needs only numbers and returns a negative
// code for a refusal (see the enum), 0 for success, or the launch's positive
// cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;        // warps per block
constexpr int kMaxPairs = 3;
constexpr int kBlocksPerSM = 4;  // grid cap: a block strides over the rows beyond it

enum Refusal {
  kBadShape = -1,    // n_pairs outside 1..3, U < 0, V < 0 or width < 1
  kRowStride = -2,   // update rows without unit stride along the row
};

struct Pairs {
  float* dst[kMaxPairs];
  const float* src[kMaxPairs];
  long long src_stride[kMaxPairs];  // elements between source rows
};

template <typename IdT, typename VecT, int NP, int R>
__global__ void __launch_bounds__(kWarps * 32)
scatter_rows_kernel(Pairs p, const IdT* __restrict__ ids, int U, long long V, int width) {
  const int lane = threadIdx.x & 31;
  const int vecs = width / (int)(sizeof(VecT) / sizeof(float));
  const long long step = (long long)gridDim.x * kWarps * R;
  for (long long base = ((long long)blockIdx.x * kWarps + (threadIdx.x >> 5)) * R; base < U;
       base += step) {
    long long mine = -1;
    if (lane < R && base + lane < U) {
      mine = (long long)ids[base + lane];
      if (mine >= V) mine = -1;
    }
    long long id[R];
#pragma unroll
    for (int r = 0; r < R; ++r) id[r] = __shfl_sync(0xffffffffu, mine, r);
    for (int c = lane; c < vecs; c += 32) {
      VecT v[R][NP];
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (id[r] >= 0) {
#pragma unroll
          for (int a = 0; a < NP; ++a)
            v[r][a] = __ldcs(
                reinterpret_cast<const VecT*>(p.src[a] + (base + r) * p.src_stride[a]) + c);
        }
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (id[r] >= 0) {
#pragma unroll
          for (int a = 0; a < NP; ++a)
            __stcs(reinterpret_cast<VecT*>(p.dst[a] + id[r] * width) + c, v[r][a]);
        }
    }
  }
}

template <typename IdT, typename VecT, int NP, int R>
cudaError_t launch(const Pairs& p, const void* ids, int U, long long V, int width, int device,
                   cudaStream_t stream) {
  int sms = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) {
    cudaGetLastError();  // handed to the caller; not left for the next launch to find
    return err;
  }
  const long long want = ((long long)U + kWarps * R - 1) / (kWarps * R);
  const long long cap = (long long)sms * kBlocksPerSM;
  scatter_rows_kernel<IdT, VecT, NP, R>
      <<<(unsigned)(want < cap ? want : cap), kWarps * 32, 0, stream>>>(
          p, static_cast<const IdT*>(ids), U, V, width);
  return cudaGetLastError();
}

template <typename IdT, typename VecT>
cudaError_t launch_pairs(const Pairs& p, int n_pairs, const void* ids, int U, long long V,
                         int width, int device, cudaStream_t stream) {
  switch (n_pairs) {
    case 1: return launch<IdT, VecT, 1, 8>(p, ids, U, V, width, device, stream);
    case 2: return launch<IdT, VecT, 2, 4>(p, ids, U, V, width, device, stream);
    default: return launch<IdT, VecT, 3, 4>(p, ids, U, V, width, device, stream);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

int run(int n_pairs, const Pairs& p, const long long* inner, const void* ids, int ids64,
        long long U, long long V, long long width, int device, void* stream) {
  if (n_pairs < 1 || n_pairs > kMaxPairs || U < 0 || U > 0x7fffffffLL || V < 0 || width < 1 ||
      width > 0x7fffffffLL)
    return kBadShape;
  bool vec = width % 4 == 0;
  for (int a = 0; a < n_pairs; ++a) {
    if (inner[a] != 1) return kRowStride;
    vec = vec && p.src_stride[a] % 4 == 0 && aligned16(p.dst[a]) && aligned16(p.src[a]);
  }
  if (U == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int u = (int)U, w = (int)width;
  cudaError_t err;
  if (ids64)
    err = vec ? launch_pairs<long long, float4>(p, n_pairs, ids, u, V, w, device, s)
              : launch_pairs<long long, float>(p, n_pairs, ids, u, V, w, device, s);
  else
    err = vec ? launch_pairs<int, float4>(p, n_pairs, ids, u, V, w, device, s)
              : launch_pairs<int, float>(p, n_pairs, ids, u, V, w, device, s);
  return (int)err;
}

template <typename T>
T* pointer(long long value) {
  return reinterpret_cast<T*>(static_cast<uintptr_t>(value));
}

}  // namespace

extern "C" {

// The arguments come as one array of 64-bit integers (pointers as integers),
// which the Python side packs in one call: converting one argument costs less
// than converting twenty. a = {n_pairs, ids, ids64, U, V, width, device,
// stream}, then for each pair {dst, src, source row stride, source inner
// stride}. dst: contiguous fp32 [V, width]; src: fp32 [U, width] with those
// strides in elements, the inner one 1. ids: [U] contiguous, int32
// (ids64 == 0) or int64. device: the index of the card the tensors lie on
// (its SM count sizes the grid); stream: a stream of that card.
int scatter_rows(const long long* a) {
  const long long n_pairs = a[0];
  if (n_pairs < 1 || n_pairs > kMaxPairs) return kBadShape;
  Pairs p = {};
  long long inner[kMaxPairs] = {1, 1, 1};
  for (int k = 0; k < (int)n_pairs; ++k) {
    const long long* pair = a + 8 + 4 * k;
    p.dst[k] = pointer<float>(pair[0]);
    p.src[k] = pointer<const float>(pair[1]);
    p.src_stride[k] = pair[2];
    inner[k] = pair[3];
  }
  return run((int)n_pairs, p, inner, pointer<const void>(a[1]), (int)a[2], a[3], a[4], a[5],
             (int)a[6], pointer<void>(a[7]));
}

}  // extern "C"
