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
// memory; here one warp copies one row of every pair: its lanes read the id
// from global memory (one broadcast load), then move the row as float4 (when
// width, strides and pointers allow 16-byte accesses) or as floats. Rows are
// 512 bytes at D = 128, so each warp issues full 128-byte lines.
//
// Bound on the H100 (data sheet): pure data movement. Each pair reads and
// writes U*width*4 bytes, plus the ids: at U = 11,264, width = 128 and three
// pairs 34.6 MB (10.3 us at 3.35 TB/s); at U = 77,824, 239 MB (71.4 us).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kMaxPairs = 3;

struct Pairs {
  float* dst[kMaxPairs];
  const float* src[kMaxPairs];
  long long src_stride[kMaxPairs];  // elements between source rows
};

template <typename IdT, bool VEC>
__global__ void __launch_bounds__(kWarps * 32)
scatter_rows_kernel(Pairs p, int n_pairs, const IdT* __restrict__ ids, int U,
                    long long V, int width) {
  const int n = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (n >= U) return;
  const int lane = threadIdx.x & 31;
  const long long id = (long long)ids[n];
  if (id < 0 || id >= V) return;
  for (int a = 0; a < n_pairs; ++a) {
    const float* s = p.src[a] + (long long)n * p.src_stride[a];
    float* d = p.dst[a] + id * width;
    if (VEC) {
      const float4* s4 = reinterpret_cast<const float4*>(s);
      float4* d4 = reinterpret_cast<float4*>(d);
      for (int c = lane; c < width / 4; c += 32) d4[c] = s4[c];
    } else {
      for (int c = lane; c < width; c += 32) d[c] = s[c];
    }
  }
}

template <typename IdT>
cudaError_t launch(const Pairs& p, int n_pairs, const void* ids, int U,
                   long long V, int width, int vec, cudaStream_t stream) {
  const int blocks = (U + kWarps - 1) / kWarps;
  const IdT* typed = static_cast<const IdT*>(ids);
  if (vec)
    scatter_rows_kernel<IdT, true><<<blocks, kWarps * 32, 0, stream>>>(
        p, n_pairs, typed, U, V, width);
  else
    scatter_rows_kernel<IdT, false><<<blocks, kWarps * 32, 0, stream>>>(
        p, n_pairs, typed, U, V, width);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dstK: contiguous fp32 [V, width]; srcK: fp32 [U, width] with unit stride
// along the row and `ssK` elements between rows; pairs beyond n_pairs are
// ignored. ids: [U] int32 (ids64 == 0) or int64. vec != 0 promises that every
// pointer is 16-byte aligned and width and every stride are multiples of 4.
// Returns the launch's cudaError_t (0 on success).
int scatter_rows(int n_pairs, float* dst0, float* dst1, float* dst2,
                 const float* src0, const float* src1, const float* src2,
                 long long ss0, long long ss1, long long ss2, const void* ids,
                 int ids64, int U, long long V, int width, int vec,
                 void* stream) {
  if (n_pairs < 1 || n_pairs > kMaxPairs || U < 0 || width < 1)
    return (int)cudaErrorInvalidValue;
  if (U == 0) return 0;
  Pairs p;
  p.dst[0] = dst0; p.dst[1] = dst1; p.dst[2] = dst2;
  p.src[0] = src0; p.src[1] = src1; p.src[2] = src2;
  p.src_stride[0] = ss0; p.src_stride[1] = ss1; p.src_stride[2] = ss2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(ids64 ? launch<long long>(p, n_pairs, ids, U, V, width, vec, s)
                     : launch<int>(p, n_pairs, ids, U, V, width, vec, s));
}

}  // extern "C"
