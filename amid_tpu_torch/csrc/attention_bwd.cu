// Fused multi-head attention backward for Hopper (sm_90a), fp32.
//
// Replaces amid_tpu/ops/pallas_attention.py::_bwd_kernel (pallas_call in
// _vjp_bwd). With P = softmax(Q K^T / sqrt(dh) + bias) per head and
// Pd = P * keep / (1 - rate) the dropped probabilities of the forward:
//   dV  = Pd^T dO
//   dPd = dO V^T ;  dP = dPd * keep / (1 - rate)
//   dS  = P o (dP - rowsum(dP o P))
//   dQ  = dS K / sqrt(dh) ;  dK = dS^T Q / sqrt(dh)
// The residuals are the TPU kernel's (q, k, v, bias, seed): P is recomputed
// and the dropout mask regenerated from the forward's counter hash of
// (seed, b, h, i, j) (attention_fwd.cu); no [B, H, T, T] block is stored in
// device memory.
//
// Design. As in the forward, one block owns one (batch row b, head h) and
// reads the head's dh columns of q, k, v, dO through their strides (the TPU
// kernel's lane-masked full-width products are not carried over):
//   * the head's Q, K, V, dO slices [T, dh] sit in dynamic shared memory with
//     a row pitch of dh + 1 floats, beside one [T, T] tile of P (odd pitch),
//     the per-row D_i = rowsum(dP o P) and the per-row dropout keys;
//   * pass A, one warp per QUERY row i, lanes over the keys: scores, warp
//     max, exp, warp sum -> row i of P into the tile; dP_ij = dO_i . V_j with
//     the mask applied; D_i by a warp sum; dS_ij into a per-warp row buffer;
//     dQ_i = scale * sum_j dS_ij K_j with the lanes split into key groups of
//     dh columns, summed by xor-shuffles;
//   * pass B, one warp per KEY row j, lanes over the queries: P_ij from the
//     tile, dP_ij recomputed (dh multiply-adds, cheaper than a second
//     [T, T] tile, which would not fit at T = 150), the mask regenerated,
//     dK_j and dV_j accumulated in registers and reduced over the warp. No
//     two warps add into one output row, so there are no atomics and the
//     result does not depend on the order in which warps run.
//
// Bound on the H100 (data sheet): at B=256, T=150, D=128, H=8 one call does
// five products, 10*B*H*T*T*dh = 7.37 GFLOP (110 us at 67 TFLOP/s fp32
// without tensor cores) and moves 7 arrays of 19.7 MB (41 us at 3.35 TB/s),
// so it is bound by operations. This design does six products (dP twice)
// with one shared-memory load per multiply-add, far below the fp32 rate;
// tensor-core tiles are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr uint32_t kMixKey0 = 0x9E3779B9u;

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t mix(uint32_t x, uint32_t v) {
  return fmix32(x ^ (v * 0x9E3779B1u + 0x7F4A7C15u));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__host__ __device__ inline int tile_pitch(int T) { return T | 1; }

template <int DH>
__global__ void __launch_bounds__(kWarps * 32)
attention_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ bias,
                     const float* __restrict__ dout, float* __restrict__ dq,
                     float* __restrict__ dk, float* __restrict__ dv, int T,
                     int D, int H, long long q_sb, long long q_st,
                     long long k_sb, long long k_st, long long v_sb,
                     long long v_st, long long g_sb, long long g_st,
                     long long bias_sb, long long bias_si, float scale,
                     int dropout, uint32_t keep_threshold, float inv_keep,
                     uint32_t seed) {
  constexpr int LD = DH + 1;                      // padded row pitch
  constexpr int GROUPS = DH >= 32 ? 1 : 32 / DH;  // key groups in dS.K
  constexpr int COLS = DH >= 32 ? DH / 32 : 1;    // dQ columns per lane
  const int TP = tile_pitch(T);

  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + T * LD;
  float* vs = ks + T * LD;
  float* gs = vs + T * LD;        // dO slice
  float* tile = gs + T * LD;      // [T][TP] rows of P
  float* rowbuf = tile + T * TP;  // [kWarps][T] one dS row per warp
  float* dsum = rowbuf + kWarps * T;                        // [T] D_i
  uint32_t* rowkey = reinterpret_cast<uint32_t*>(dsum + T); // [T]

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const float* qb = q + b * q_sb + h * DH;
  const float* kb = k + b * k_sb + h * DH;
  const float* vb = v + b * v_sb + h * DH;
  const float* gb = dout + b * g_sb + h * DH;
  for (int idx = threadIdx.x; idx < T * DH; idx += blockDim.x) {
    const int t = idx / DH;
    const int c = idx - t * DH;
    qs[t * LD + c] = qb[t * q_st + c];
    ks[t * LD + c] = kb[t * k_st + c];
    vs[t * LD + c] = vb[t * v_st + c];
    gs[t * LD + c] = gb[t * g_st + c];
  }
  if (dropout) {
    const uint32_t bh_key = mix(mix(kMixKey0, seed), (uint32_t)bh);
    for (int i = threadIdx.x; i < T; i += blockDim.x)
      rowkey[i] = mix(bh_key, (uint32_t)i);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float* bias_b = bias + b * bias_sb;
  const long long out_base = (long long)b * T * D + h * DH;

  // ---- pass A: one warp per query row ----------------------------------
  {
    float* drow = rowbuf + warp * T;
    const int grp = DH >= 32 ? 0 : lane / DH;
    const int col = DH >= 32 ? lane : lane - grp * DH;
    for (int i = warp; i < T; i += kWarps) {
      float qr[DH], gr[DH];
#pragma unroll
      for (int c = 0; c < DH; ++c) {
        qr[c] = qs[i * LD + c];
        gr[c] = gs[i * LD + c];
      }
      float* prow = tile + i * TP;
      const float* brow = bias_b + i * bias_si;

      float m = -INFINITY;
      for (int j = lane; j < T; j += 32) {
        const float* kj = ks + j * LD;
        float acc = 0.f;
#pragma unroll
        for (int c = 0; c < DH; ++c) acc = fmaf(qr[c], kj[c], acc);
        const float s = acc * scale + brow[j];
        prow[j] = s;
        m = fmaxf(m, s);
      }
      m = warp_max(m);

      float l = 0.f;
      for (int j = lane; j < T; j += 32) {
        const float e = expf(prow[j] - m);
        prow[j] = e;
        l += e;
      }
      l = warp_sum(l);
      const float inv_l = 1.f / l;

      const uint32_t row_key = dropout ? rowkey[i] : 0u;
      float dacc = 0.f;
      for (int j = lane; j < T; j += 32) {
        const float p = prow[j] * inv_l;
        prow[j] = p;
        const float* vj = vs + j * LD;
        float dp = 0.f;
#pragma unroll
        for (int c = 0; c < DH; ++c) dp = fmaf(gr[c], vj[c], dp);
        if (dropout) {
          const uint32_t bits = mix(row_key, (uint32_t)j);
          dp = (bits >> 8) >= keep_threshold ? dp * inv_keep : 0.f;
        }
        drow[j] = dp;
        dacc = fmaf(dp, p, dacc);
      }
      const float di = warp_sum(dacc);
      for (int j = lane; j < T; j += 32)
        drow[j] = prow[j] * (drow[j] - di);
      if (lane == 0) dsum[i] = di;
      __syncwarp();

      float acc[COLS];
#pragma unroll
      for (int c = 0; c < COLS; ++c) acc[c] = 0.f;
      for (int j = grp; j < T; j += GROUPS) {
        const float ds = drow[j];
        const float* kj = ks + j * LD + col;
#pragma unroll
        for (int c = 0; c < COLS; ++c) acc[c] = fmaf(ds, kj[32 * c], acc[c]);
      }
      if (DH < 32) {
#pragma unroll
        for (int off = 16; off >= DH; off >>= 1)
          acc[0] += __shfl_xor_sync(0xffffffffu, acc[0], off);
      }
      if (grp == 0) {
#pragma unroll
        for (int c = 0; c < COLS; ++c)
          dq[out_base + (long long)i * D + col + 32 * c] = acc[c] * scale;
      }
      __syncwarp();  // drow is rewritten by this warp's next row
    }
  }
  __syncthreads();

  // ---- pass B: one warp per key row ------------------------------------
  for (int j = warp; j < T; j += kWarps) {
    float dkr[DH], dvr[DH];
#pragma unroll
    for (int c = 0; c < DH; ++c) {
      dkr[c] = 0.f;
      dvr[c] = 0.f;
    }
    const float* vj = vs + j * LD;
    for (int i = lane; i < T; i += 32) {
      const float p = tile[i * TP + j];
      const float* gi = gs + i * LD;
      const float* qi = qs + i * LD;
      float dp = 0.f;
#pragma unroll
      for (int c = 0; c < DH; ++c) dp = fmaf(gi[c], vj[c], dp);
      float kf = 1.f;
      if (dropout) {
        const uint32_t bits = mix(rowkey[i], (uint32_t)j);
        kf = (bits >> 8) >= keep_threshold ? inv_keep : 0.f;
      }
      const float pd = p * kf;
      const float ds = p * (dp * kf - dsum[i]);
#pragma unroll
      for (int c = 0; c < DH; ++c) {
        dkr[c] = fmaf(ds, qi[c], dkr[c]);
        dvr[c] = fmaf(pd, gi[c], dvr[c]);
      }
    }
    const long long row = out_base + (long long)j * D;
#pragma unroll
    for (int c = 0; c < DH; ++c) {
      const float sk = warp_sum(dkr[c]);
      const float sv = warp_sum(dvr[c]);
      if (lane == (c & 31)) {
        dk[row + c] = sk * scale;
        dv[row + c] = sv;
      }
    }
  }
}

template <int DH>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const float* bias, const float* dout, float* dq, float* dk,
                   float* dv, int B, int T, int D, int H, long long q_sb,
                   long long q_st, long long k_sb, long long k_st,
                   long long v_sb, long long v_st, long long g_sb,
                   long long g_st, long long bias_sb, long long bias_si,
                   float scale, int dropout, uint32_t keep_threshold,
                   float inv_keep, uint32_t seed, size_t smem,
                   cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        attention_bwd_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  attention_bwd_kernel<DH><<<B * H, kWarps * 32, smem, stream>>>(
      q, k, v, bias, dout, dq, dk, dv, T, D, H, q_sb, q_st, k_sb, k_st, v_sb,
      v_st, g_sb, g_st, bias_sb, bias_si, scale, dropout, keep_threshold,
      inv_keep, seed);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one block needs, in bytes: Q, K, V, dO slices with padded
// rows, the [T, T] tile of P with an odd pitch, one dS row per warp, D_i and
// the per-row dropout keys.
size_t attention_bwd_smem_bytes(int T, int dh) {
  return sizeof(float) * ((size_t)4 * T * (dh + 1) + (size_t)T * tile_pitch(T) +
                          (size_t)kWarps * T + (size_t)2 * T);
}

// Launches the kernel on `stream`. q/k/v/dout are [B, T, D] fp32 with unit
// stride along D and the given batch/time strides (in elements); dq, dk, dv
// are contiguous [B, T, D]. Returns the launch's cudaError_t (0 on success);
// an unsupported head width returns cudaErrorInvalidValue.
int attention_bwd(const float* q, const float* k, const float* v,
                  const float* bias, const float* dout, float* dq, float* dk,
                  float* dv, int B, int T, int D, int H, long long q_sb,
                  long long q_st, long long k_sb, long long k_st,
                  long long v_sb, long long v_st, long long g_sb,
                  long long g_st, long long bias_sb, long long bias_si,
                  float scale, int dropout, uint32_t keep_threshold,
                  float inv_keep, uint32_t seed, void* stream) {
  const int dh = D / H;
  const size_t smem = attention_bwd_smem_bytes(T, dh);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define AMID_ATTN_CASE(W)                                                     \
  case W:                                                                     \
    return (int)launch<W>(q, k, v, bias, dout, dq, dk, dv, B, T, D, H, q_sb,  \
                          q_st, k_sb, k_st, v_sb, v_st, g_sb, g_st, bias_sb,  \
                          bias_si, scale, dropout, keep_threshold, inv_keep,  \
                          seed, smem, s);
  switch (dh) {
    AMID_ATTN_CASE(8)
    AMID_ATTN_CASE(16)
    AMID_ATTN_CASE(32)
    AMID_ATTN_CASE(64)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef AMID_ATTN_CASE
}

}  // extern "C"
