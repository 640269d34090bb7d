// Batch max-affinity for Hopper (sm_90a):
//
//     out[b, c] = max_{i, j} a[b, i, :] . bank[c, j, :]
//
// a: [B, N, D], bank: [C, M, D] -> out [B, C] fp32. Inputs are rounded to
// bf16 (round to nearest even), products are exact and sums run in fp32 on
// the tensor cores (mma.sync m16n8k16). Forward only: the hard gate built
// from the result passes no gradient.
//
// Two kernels, one function:
//
// * affinity_kernel replaces amid_tpu/ops/pallas_affinity.py::_affinity_kernel
//   (pallas_call in max_affinity_pallas), the blocked kernel for long
//   sequences.
// * affinity_smalln_kernel replaces ::_affinity_smalln_kernel (pallas_call in
//   max_affinity_pallas_smalln), the schedule for short sequences whose peer
//   tiles stay resident.
//
// Neither writes an [N, M] score block anywhere: a warp holds a 16 x 32 block
// of scores in its accumulator registers and folds it into one running max.
//
// A pre-pass (to_bf16_kernel, same stream) rounds both inputs into a scratch
// buffer once per call, so the main kernels move half the bytes per tile.
//
// Shared-memory rows hold D + 8 bf16 values: the 16-byte pad makes the eight
// rows a fragment load touches fall into distinct banks. A time axis that is
// not a multiple of the fragment height (16 rows of a, 8 rows of the bank) is
// padded with copies of its own last row, which cannot change a maximum; the
// batch axes B and C are never padded.
//
// affinity_kernel. One block per query user b (and per slice of the peers
// when B alone would not fill the card): the user's [N, D] rows are staged in
// shared memory once, then the block walks its peers, staging each peer's
// [M, D] tile in turn. For one peer the work is cut into items of (16 query
// rows) x (32 peer rows); the 8 warps take items round robin, load the A
// fragments of the item's rows into registers (32 at D = 128), run D/16
// mma steps against four B fragments and fold the 16 accumulators into the
// warp's max. Two barriers per peer: tile staged, tile consumed.
// Shared memory: (ceil16(N) + ceil8(M)) * (D + 8) * 2 bytes: 85 KB at
// N = M = 150, so two blocks share an SM and one stages while the other
// multiplies; the largest N + M at D = 128 is about 850.
//
// affinity_smalln_kernel. For short sequences the blocked kernel leaves most
// warps idle (N = M = 20 gives 2 items per peer) and pays two barriers per
// peer. Here a block holds 16 peers' tiles resident in shared memory and
// gives each of its 8 warps one query user. The warp loops over the query's
// time axis in tiles of 16 rows, keeps that tile's A fragments in registers,
// and for every resident peer max-accumulates the tile's best score into the
// block's resident [8, 16] output tile; one barrier in all. It fits while
// 16 * ceil8(M) * (D + 8) * 2 bytes plus the output tile stay under half an
// SM's shared memory (M <= 24 at D = 128).
//
// Bound on the H100 (data sheet): operations. 2*B*C*N*M*D = 377 GFLOP at
// B = C = 256, N = M = 150, D = 128: 0.38 ms at the bf16 tensor-core peak of
// 989 TFLOP/s (the inputs are 39 MB: 0.012 ms). At N = M = 20: 6.7 GFLOP,
// 0.0068 ms.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;     // bf16 values of padding per shared-memory row
constexpr int kColTiles = 4;  // 8-column tiles of scores per warp item
constexpr int kPeers = 16;  // resident peers per block of the small-N kernel

__global__ void to_bf16_kernel(const float* __restrict__ a, long long na,
                               const float* __restrict__ b, long long nb,
                               __nv_bfloat16* __restrict__ out) {
  // na and nb are multiples of 4; out holds a's values, then b's
  const long long n4 = (na + nb) / 4;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (long long)gridDim.x * blockDim.x) {
    const long long e = i * 4;
    const float4 x = e < na ? *reinterpret_cast<const float4*>(a + e)
                            : *reinterpret_cast<const float4*>(b + (e - na));
    __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
    __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
    uint2 packed;
    packed.x = *reinterpret_cast<uint32_t*>(&lo);
    packed.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(out + e) = packed;
  }
}

// D(16x8, fp32) += A(16x16, bf16, row major) * B(16x8, bf16, column major)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copies `rows_pad` rows of D bf16 values from a contiguous [rows, D] array
// into shared memory rows of D + kPad values, 16 bytes at a time; rows past
// `rows` repeat the last row.
template <int D>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst,
                                           const __nv_bfloat16* __restrict__ src,
                                           int rows, int rows_pad, int tid) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  const uint4* s = reinterpret_cast<const uint4*>(src);
  for (int i = tid; i < rows_pad * CH; i += kThreads) {
    const int r = i / CH, ch = i - r * CH;
    const int rs = r < rows ? r : rows - 1;
    *reinterpret_cast<uint4*>(dst + r * (D + kPad) + ch * 8) = s[rs * CH + ch];
  }
}

// The largest score of 16 query rows (their A fragments in `afr`) against
// 8 * kColTiles peer rows starting at column tile `ct0` of a staged tile with
// `ct_n` column tiles; column tiles past the end repeat the last one.
template <int D>
__device__ __forceinline__ float item_max(const uint32_t (&afr)[D / 16][4],
                                          const uint32_t* tile32,
                                          int ct0, int ct_n, int g, int t) {
  constexpr int KS = D / 16, LDW = (D + kPad) / 2;
  float acc[kColTiles][4];
  const uint32_t* brow[kColTiles];
#pragma unroll
  for (int j = 0; j < kColTiles; ++j) {
    const int ct = ct0 + j < ct_n ? ct0 + j : ct_n - 1;
    brow[j] = tile32 + (ct * 8 + g) * LDW + t;
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  }
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
    for (int j = 0; j < kColTiles; ++j)
      mma_bf16(acc[j], afr[ks], brow[j][ks * 8], brow[j][ks * 8 + 4]);
  }
  float mx = -INFINITY;
#pragma unroll
  for (int j = 0; j < kColTiles; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) mx = fmaxf(mx, acc[j][e]);
  }
  return mx;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
affinity_kernel(const __nv_bfloat16* __restrict__ a,
                const __nv_bfloat16* __restrict__ bank, float* __restrict__ out,
                int C, int N, int M) {
  constexpr int KS = D / 16, LD = D + kPad, LDW = LD / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n_pad = (N + 15) & ~15, m_pad = (M + 7) & ~7;
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [n_pad][LD]
  __nv_bfloat16* Bs = As + n_pad * LD;                             // [m_pad][LD]
  float* red = reinterpret_cast<float*>(Bs + m_pad * LD);          // [kWarps]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x;

  stage_rows<D>(As, a + (size_t)b * N * D, N, n_pad, tid);
  const uint32_t* As32 = reinterpret_cast<const uint32_t*>(As);
  const uint32_t* Bs32 = reinterpret_cast<const uint32_t*>(Bs);
  const int rt_n = n_pad / 16, ct_n = m_pad / 8;
  const int chunk_n = (ct_n + kColTiles - 1) / kColTiles;

  for (int c = blockIdx.y; c < C; c += gridDim.y) {
    stage_rows<D>(Bs, bank + (size_t)c * M * D, M, m_pad, tid);
    __syncthreads();  // the peer's tile (and, the first time, As) is staged
    float mx = -INFINITY;
    for (int it = warp; it < rt_n * chunk_n; it += kWarps) {
      const int rt = it / chunk_n, chunk = it - rt * chunk_n;
      uint32_t afr[KS][4];
      const uint32_t* r0 = As32 + (rt * 16 + g) * LDW + t;
      const uint32_t* r1 = r0 + 8 * LDW;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        afr[ks][0] = r0[ks * 8];
        afr[ks][1] = r1[ks * 8];
        afr[ks][2] = r0[ks * 8 + 4];
        afr[ks][3] = r1[ks * 8 + 4];
      }
      mx = fmaxf(mx, item_max<D>(afr, Bs32, chunk * kColTiles, ct_n, g, t));
    }
    mx = warp_max(mx);
    if (lane == 0) red[warp] = mx;
    __syncthreads();  // the tile is consumed; red[] is complete
    if (tid == 0) {
      float m = red[0];
      for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red[w]);
      out[(size_t)b * C + c] = m;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
affinity_smalln_kernel(const __nv_bfloat16* __restrict__ a,
                       const __nv_bfloat16* __restrict__ bank,
                       float* __restrict__ out, int B, int C, int N, int M) {
  constexpr int KS = D / 16, LD = D + kPad, LDW = LD / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int m_pad = (M + 7) & ~7;
  __nv_bfloat16* Bs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kPeers][m_pad][LD]
  float* otile = reinterpret_cast<float*>(Bs + kPeers * m_pad * LD);  // [kWarps][kPeers]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int c0 = blockIdx.y * kPeers;
  const int peers = C - c0 < kPeers ? C - c0 : kPeers;
  const int q = blockIdx.x * kWarps + warp;  // this warp's query user

  for (int p = 0; p < peers; ++p)
    stage_rows<D>(Bs + p * m_pad * LD, bank + (size_t)(c0 + p) * M * D, M, m_pad, tid);
  if (lane < kPeers) otile[warp * kPeers + lane] = -INFINITY;
  __syncthreads();
  if (q >= B) return;

  const uint32_t* a32 = reinterpret_cast<const uint32_t*>(a + (size_t)q * N * D);
  const uint32_t* Bs32 = reinterpret_cast<const uint32_t*>(Bs);
  const int ct_n = m_pad / 8;
  for (int rt = 0; rt < (N + 15) / 16; ++rt) {  // the query's time axis
    const int row0 = rt * 16 + g < N ? rt * 16 + g : N - 1;
    const int row1 = rt * 16 + g + 8 < N ? rt * 16 + g + 8 : N - 1;
    const uint32_t* r0 = a32 + row0 * (D / 2) + t;
    const uint32_t* r1 = a32 + row1 * (D / 2) + t;
    uint32_t afr[KS][4];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      afr[ks][0] = r0[ks * 8];
      afr[ks][1] = r1[ks * 8];
      afr[ks][2] = r0[ks * 8 + 4];
      afr[ks][3] = r1[ks * 8 + 4];
    }
    for (int p = 0; p < peers; ++p) {
      float mx = -INFINITY;
      for (int ct0 = 0; ct0 < ct_n; ct0 += kColTiles)
        mx = fmaxf(mx, item_max<D>(afr, Bs32 + p * m_pad * LDW, ct0, ct_n, g, t));
      mx = warp_max(mx);
      if (lane == 0) otile[warp * kPeers + p] = fmaxf(otile[warp * kPeers + p], mx);
    }
  }
  __syncwarp();
  if (lane < peers) out[(size_t)q * C + c0 + lane] = otile[warp * kPeers + lane];
}

size_t blocked_smem(int N, int M, int D) {
  return (size_t)(((N + 15) & ~15) + ((M + 7) & ~7)) * (D + kPad) * 2 +
         kWarps * sizeof(float);
}

size_t smalln_smem(int M, int D) {
  return (size_t)kPeers * ((M + 7) & ~7) * (D + kPad) * 2 +
         (size_t)kWarps * kPeers * sizeof(float);
}

cudaError_t round_inputs(const float* a, long long na, const float* bank,
                         long long nb, __nv_bfloat16* scratch, cudaStream_t s) {
  const long long n4 = (na + nb) / 4;
  long long blocks = (n4 + 255) / 256;
  if (blocks > 4096) blocks = 4096;
  to_bf16_kernel<<<(unsigned)blocks, 256, 0, s>>>(a, na, bank, nb, scratch);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_blocked(const __nv_bfloat16* a, const __nv_bfloat16* bank,
                           float* out, int B, int C, int N, int M, int grid_y,
                           cudaStream_t s) {
  const size_t smem = blocked_smem(N, M, D);
  cudaError_t e = cudaFuncSetAttribute(
      affinity_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  affinity_kernel<D><<<dim3(B, grid_y), kThreads, smem, s>>>(a, bank, out, C, N, M);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_smalln(const __nv_bfloat16* a, const __nv_bfloat16* bank,
                          float* out, int B, int C, int N, int M, cudaStream_t s) {
  const size_t smem = smalln_smem(M, D);
  cudaError_t e = cudaFuncSetAttribute(
      affinity_smalln_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((B + kWarps - 1) / kWarps, (C + kPeers - 1) / kPeers);
  affinity_smalln_kernel<D><<<grid, kThreads, smem, s>>>(a, bank, out, B, C, N, M);
  return cudaGetLastError();
}

bool bad_shape(int B, int C, int N, int M, int D) {
  return B < 1 || C < 1 || N < 1 || M < 1 ||
         !(D == 16 || D == 32 || D == 64 || D == 128);
}

}  // namespace

extern "C" {

// Shared memory per block, in bytes, of the blocked and the small-N kernel.
size_t affinity_smem_bytes(int N, int M, int D) { return blocked_smem(N, M, D); }
size_t affinity_smalln_smem_bytes(int M, int D) { return smalln_smem(M, D); }

// a: contiguous fp32 [B, N, D]; bank: contiguous fp32 [C, M, D]; scratch:
// room for (B*N + C*M)*D bf16 values, 16-byte aligned; out: contiguous fp32
// [B, C]. D is 16, 32, 64 or 128. grid_y (blocked kernel only, 1..65535):
// how many blocks share one query user's peers. Both return the first
// failing launch's cudaError_t (0 on success).
int max_affinity_blocked(const float* a, const float* bank, void* scratch,
                         float* out, int B, int C, int N, int M, int D,
                         int grid_y, void* stream) {
  if (bad_shape(B, C, N, M, D) || grid_y < 1 || grid_y > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  __nv_bfloat16* a16 = static_cast<__nv_bfloat16*>(scratch);
  const long long na = (long long)B * N * D, nb = (long long)C * M * D;
  cudaError_t e = round_inputs(a, na, bank, nb, a16, s);
  if (e != cudaSuccess) return (int)e;
  switch (D) {
    case 16: e = launch_blocked<16>(a16, a16 + na, out, B, C, N, M, grid_y, s); break;
    case 32: e = launch_blocked<32>(a16, a16 + na, out, B, C, N, M, grid_y, s); break;
    case 64: e = launch_blocked<64>(a16, a16 + na, out, B, C, N, M, grid_y, s); break;
    default: e = launch_blocked<128>(a16, a16 + na, out, B, C, N, M, grid_y, s); break;
  }
  return (int)e;
}

int max_affinity_smalln(const float* a, const float* bank, void* scratch,
                        float* out, int B, int C, int N, int M, int D,
                        void* stream) {
  if (bad_shape(B, C, N, M, D) || (C + kPeers - 1) / kPeers > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  __nv_bfloat16* a16 = static_cast<__nv_bfloat16*>(scratch);
  const long long na = (long long)B * N * D, nb = (long long)C * M * D;
  cudaError_t e = round_inputs(a, na, bank, nb, a16, s);
  if (e != cudaSuccess) return (int)e;
  switch (D) {
    case 16: e = launch_smalln<16>(a16, a16 + na, out, B, C, N, M, s); break;
    case 32: e = launch_smalln<32>(a16, a16 + na, out, B, C, N, M, s); break;
    case 64: e = launch_smalln<64>(a16, a16 + na, out, B, C, N, M, s); break;
    default: e = launch_smalln<128>(a16, a16 + na, out, B, C, N, M, s); break;
  }
  return (int)e;
}

}  // extern "C"
