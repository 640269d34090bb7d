// Fused scoring head for Hopper (sm_90a):
//
//     out[b, c] = sigmoid( relu(u[b] Wu^T + items[b, c] Wi^T + b1) . w2 + b2 )
//
// Replaces amid_tpu/ops/pallas_scoring.py::_scoring_kernel (pallas_call in
// _scoring_fwd_pallas, wrapper scoring_head_pallas). Forward only, as on the
// TPU: the backward recomputes the hidden layer in plain tensor code
// (ops/scoring.py). The [B, C, H] hidden tensor is never written to device
// memory.
//
// Design. The TPU kernel tiles (8 users) x (128 candidates) and runs two MXU
// products per user. Here a block serves one user: it stages Wi transposed
// ([D][H + 1] floats, 17 KB at D = 128, H = 32: lanes read consecutive
// addresses, so no bank conflict) and the user's half of the first layer,
// upart[h] = u . Wu[h] + b1[h], in shared memory. Each warp then walks the
// user's candidates four at a time: it copies their rows into its own
// shared-memory tile (coalesced float4 loads), and lane h accumulates hidden
// unit h of all four (one conflict-free load of Wi and four broadcast float4
// loads of the items per four input columns); relu, the product with w2 and
// a shuffle reduction give the four logits. H above 32 is served in passes of
// 32 hidden units.
//
// Bound on the H100 (data sheet): bytes. At C = 1000 the items are 131 MB
// (39 us at 3.35 TB/s) against 2.1 GFLOP (31 us at 67 TFLOP/s fp32); at
// C = 2 the call is launch-sized.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 4;  // candidates a warp scores together

__host__ __device__ inline int tile_offset(int D, int H) {
  // floats before the warps' item tiles, rounded up to 16 bytes
  return (D * (H + 1) + 2 * H + 3) & ~3;
}

__global__ void __launch_bounds__(kThreads)
scoring_head_kernel(const float* __restrict__ user, long long user_stride,
                    const float* __restrict__ items, long long items_bstride,
                    long long items_cstride,
                    const float* __restrict__ wu, long long wu_stride,
                    const float* __restrict__ wi, long long wi_stride,
                    const float* __restrict__ b1, const float* __restrict__ w2,
                    const float* __restrict__ b2, float* __restrict__ out,
                    int C, int D, int H) {
  extern __shared__ __align__(16) float sm[];
  const int HP = H + 1;
  float* wiT = sm;               // [D][H + 1]
  float* upart = wiT + D * HP;   // [H]: u . Wu[h] + b1[h]
  float* w2s = upart + H;        // [H]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* tile = sm + tile_offset(D, H) + warp * kRows * D;  // [kRows][D]
  const int b = blockIdx.x;

  for (int i = tid; i < H * D; i += kThreads) {
    const int h = i / D, d = i - h * D;
    wiT[d * HP + h] = wi[h * wi_stride + d];
  }
  const float* u = user + b * user_stride;
  for (int h = warp; h < H; h += kWarps) {
    float s = 0.f;
    for (int d = lane; d < D; d += 32) s = fmaf(u[d], wu[h * wu_stride + d], s);
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) upart[h] = s + b1[h];
  }
  for (int h = tid; h < H; h += kThreads) w2s[h] = w2[h];
  __syncthreads();

  const float bias2 = b2[0];
  const float* my_items = items + b * items_bstride;
  float* my_out = out + (long long)b * C;
  for (int c0 = (blockIdx.y * kWarps + warp) * kRows; c0 < C;
       c0 += gridDim.y * kWarps * kRows) {
    for (int r = 0; r < kRows; ++r) {
      float4* dst = reinterpret_cast<float4*>(tile + r * D);
      if (c0 + r < C) {
        const float4* src =
            reinterpret_cast<const float4*>(my_items + (c0 + r) * items_cstride);
        for (int k = lane; k < D / 4; k += 32) dst[k] = src[k];
      } else {
        for (int k = lane; k < D / 4; k += 32) dst[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    __syncwarp();
    float logit[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) logit[r] = 0.f;
    for (int h0 = 0; h0 < H; h0 += 32) {
      const bool live = h0 + lane < H;
      const int h = live ? h0 + lane : H - 1;
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
      for (int d = 0; d < D; d += 4) {
        const float w0 = wiT[d * HP + h], w1 = wiT[(d + 1) * HP + h];
        const float w2v = wiT[(d + 2) * HP + h], w3 = wiT[(d + 3) * HP + h];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float4 x = *reinterpret_cast<const float4*>(tile + r * D + d);
          acc[r] = fmaf(x.x, w0, acc[r]);
          acc[r] = fmaf(x.y, w1, acc[r]);
          acc[r] = fmaf(x.z, w2v, acc[r]);
          acc[r] = fmaf(x.w, w3, acc[r]);
        }
      }
      const float up = upart[h], wo = live ? w2s[h] : 0.f;
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        logit[r] = fmaf(fmaxf(acc[r] + up, 0.f), wo, logit[r]);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float s = logit[r];
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == r && c0 + r < C) my_out[c0 + r] = 1.f / (1.f + expf(-(s + bias2)));
    }
    __syncwarp();  // the tile is rewritten by the next group
  }
}

}  // namespace

extern "C" {

// Shared memory one block needs, in bytes.
size_t scoring_head_smem_bytes(int D, int H) {
  return sizeof(float) * ((size_t)tile_offset(D, H) + (size_t)kWarps * kRows * D);
}

// user: fp32 [B, D] (unit stride along D, `user_stride` between rows);
// items: fp32 [B, C, D] (unit stride along D, 16-byte aligned rows);
// wu, wi: fp32 [H, D] halves of the first layer's weight (unit stride along
// D); b1, w2: [H]; b2: [1]; out: contiguous fp32 [B, C]. D must be a multiple
// of 4. grid_y blocks (at most 65535) share one user's candidates. Returns the launch's
// cudaError_t (0 on success).
int scoring_head(const float* user, long long user_stride, const float* items,
                 long long items_bstride, long long items_cstride,
                 const float* wu, long long wu_stride, const float* wi,
                 long long wi_stride, const float* b1, const float* w2,
                 const float* b2, float* out, int B, int C, int D, int H,
                 int grid_y, void* stream) {
  if (B < 0 || C < 0 || D < 4 || D % 4 != 0 || H < 1 || grid_y < 1 || grid_y > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || C == 0) return 0;
  const size_t smem = scoring_head_smem_bytes(D, H);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        scoring_head_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  scoring_head_kernel<<<dim3(B, grid_y), kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      user, user_stride, items, items_bstride, items_cstride, wu, wu_stride, wi,
      wi_stride, b1, w2, b2, out, C, D, H);
  return (int)cudaGetLastError();
}

}  // extern "C"
