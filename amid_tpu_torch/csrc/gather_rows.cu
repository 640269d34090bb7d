// Embedding row gather for Hopper (sm_90a): out[n, :] = table[ids[n], :].
//
// Replaces amid_tpu/ops/pallas_embedding.py::_gather_kernel (pallas_call in
// _gather_pallas, wrapper embedding_gather_pallas). The backward of the
// gather is a scatter-add into a zero [V, D] table, which the TPU package
// leaves to plain XLA and the port to `index_add_` (ops/embedding.py).
//
// Contract. ids are int32 or int64; an id outside [0, V) is clamped to the
// nearest valid row (what a JAX gather does with an out-of-bounds index), so
// the kernel never reads outside the table whatever the caller passes. The
// table's rows have unit stride and `table_stride` elements between rows; the
// output is contiguous [n, width].
//
// Design. The TPU kernel prefetches the ids to scalar memory and issues one
// DMA per row, 16 rows in flight per grid cell; here one warp copies one row:
// its lanes read the id from global memory (one broadcast load), then move
// the row as float4 (when width, stride and pointers allow 16-byte accesses)
// or as floats. Rows are 512 bytes at D = 128, so a warp issues full 128-byte
// lines. Offsets are 64-bit: the evaluation gather writes 256 x 999 rows
// (131 MB), and the table holds 458 MB.
//
// Bound on the H100 (data sheet): pure data movement, n*width*4 bytes read
// and written plus the ids: 262 MB at n = 255,744, width = 128 (78 us at
// 3.35 TB/s); 1.3 MB for a [256, 20] sequence (launch-sized).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;

template <typename IdT, bool VEC>
__global__ void __launch_bounds__(kWarps * 32)
gather_rows_kernel(const float* __restrict__ table, long long table_stride,
                   const IdT* __restrict__ ids, float* __restrict__ out,
                   long long n, long long V, int width) {
  const long long r = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= n) return;
  const int lane = threadIdx.x & 31;
  long long id = (long long)ids[r];
  id = id < 0 ? 0 : (id >= V ? V - 1 : id);
  const float* s = table + id * table_stride;
  float* d = out + r * (long long)width;
  if (VEC) {
    const float4* s4 = reinterpret_cast<const float4*>(s);
    float4* d4 = reinterpret_cast<float4*>(d);
    for (int c = lane; c < width / 4; c += 32) d4[c] = s4[c];
  } else {
    for (int c = lane; c < width; c += 32) d[c] = s[c];
  }
}

template <typename IdT>
cudaError_t launch(const float* table, long long table_stride, const void* ids,
                   float* out, long long n, long long V, int width, int vec,
                   cudaStream_t stream) {
  const unsigned blocks = (unsigned)((n + kWarps - 1) / kWarps);
  const IdT* typed = static_cast<const IdT*>(ids);
  if (vec)
    gather_rows_kernel<IdT, true><<<blocks, kWarps * 32, 0, stream>>>(
        table, table_stride, typed, out, n, V, width);
  else
    gather_rows_kernel<IdT, false><<<blocks, kWarps * 32, 0, stream>>>(
        table, table_stride, typed, out, n, V, width);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// table: fp32 [V, width], unit stride along the row, `table_stride` elements
// between rows; ids: [n] int32 (ids64 == 0) or int64; out: contiguous fp32
// [n, width]. vec != 0 promises 16-byte aligned pointers and width and
// table_stride multiples of 4. Returns the launch's cudaError_t (0 on
// success).
int gather_rows(const float* table, long long table_stride, const void* ids,
                int ids64, float* out, long long n, long long V, int width,
                int vec, void* stream) {
  if (n < 0 || V < 1 || width < 1 || (n + kWarps - 1) / kWarps > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(ids64 ? launch<long long>(table, table_stride, ids, out, n, V, width, vec, s)
                     : launch<int>(table, table_stride, ids, out, n, V, width, vec, s));
}

}  // extern "C"
