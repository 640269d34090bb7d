// Fused multi-head attention forward for Hopper (sm_90a), fp32 in and out,
// products on the tensor cores in 3xTF32 (attention_common.cuh).
//
// Replaces amid_tpu/ops/pallas_attention.py::_fwd_kernel (pallas_call in
// _fused_fwd_impl): o = dropout(softmax(Q K^T / sqrt(dh) + bias)) V per head,
// with the h heads packed in D ([B, T, D] in, [B, T, D] out) and an additive
// bias of shape [1|B, 1, 1|T, T]. No score or probability block leaves the SM.
// When asked (non-null pointers, i.e. when a gradient will be wanted) it also
// writes each row's statistics for the backward: row_max m_i (the largest
// score) and row_inv_sum 1 / l_i, l_i = sum_j exp(s_ij - m_i), each
// [B, H, T] fp32. The two are kept apart, not as m + log l: SASRec's masked
// scores are -1e9, where fp32 has a spacing of 64, so a log-sum-exp of a
// fully masked row would round back to -1e9 and lose the 1/T.
//
// Design. One block owns one (batch row b, head h) and reads head h's dh
// columns through the strides (q, k, v may be column slices of one
// projection):
//   * grid = B * H blocks; each block has as many warps as it has 16-row
//     query tiles, at most 8 (T=150: 10 tiles -> 5 warps of 2 tiles each);
//   * K and V of the head, [T, dh] padded to a multiple of 8 keys with zero
//     rows, are staged in dynamic shared memory with a row pitch of dh + 4;
//   * each warp owns 16 query rows at a time. Its Q fragment (split into
//     hi/lo once) stays in registers. The keys are walked in chunks of 32
//     (chunks of 64 held more registers per thread and ran slower):
//     S = Q K^T as m16n8k8 tiles, the scale and the bias, the chunk's row max
//     by quad shuffles on the accumulator (row = lane/4 and lane/4 + 8), an
//     online softmax (rescale of the running sum and output when the max
//     grows), the dropout hash per element at its real (i, j), then P.V as a
//     second set of m16n8k8 tiles whose A fragment is the accumulator itself
//     (the reordered reduction of attention_common.cuh);
//   * keys past T score -inf (P = 0): a fully masked real row averages over
//     its T keys, not over the padded ones. Query rows past T write nothing;
//   * a head of width dh runs at its template width DH (attention_common.cuh),
//     in the instance with PAD set unless dh = DH: the staged K and V and
//     the Q fragments are zero at columns dh to DH, output columns from dh
//     on are not written. At DH = 128 the Q fragments
//     (128 registers) and the output (64) would not fit beside the rest:
//     there Q is read and split again at each chunk, from L1 and L2.
//
// Dropout (rate > 0) keeps element (b, h, i, j) when
//   bits >> 8 >= keep_threshold,  bits = mix(mix(mix(mix(K0, seed), b*H+h), i), j)
// and scales kept values by 1/(1 - rate): the mask of
// ops/attention.py::dropout_keep_mask, bit for bit.
//
// Bound on the H100 (data sheet): at B=256, T=150, D=128, H=8 one call must
// read q, k, v and the bias and write o, about 78.7 MB (23.5 us at
// 3.35 TB/s), and does 4*B*H*T*T*dh = 2.95 GFLOP (6 us at the 495 TFLOP/s
// TF32 tensor-core peak; 3xTF32 issues three products for each), so it is
// bound by bytes. What holds this design back: mma.sync, not wgmma; the
// exp and the hash per element on the CUDA cores; every block reads all
// keys, also the causally masked ones (the kernel does not read the bias's
// structure).

#include <stdint.h>
#include <string.h>

#include "attention_common.cuh"

namespace {

using namespace amid_attention;

constexpr int kChunk = 32;  // keys per online-softmax step: 4 n-tiles of 8

// PAD: dh = p.dh, below DH; else dh = DH
template <int DH, bool PAD>
__global__ void __launch_bounds__(kMaxWarps * 32)
attention_fwd_kernel(const FwdParams p) {
  constexpr int P = pitch(DH);
  constexpr int KS = DH / 8;  // k-steps of Q.K^T, n-tiles of P.V
  constexpr bool kHoldQ = DH <= 64;  // Q's fragments held in registers
  const int T = p.T, dh = PAD ? p.dh : DH;
  const int TK = (T + 7) & ~7;

  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + TK * P;

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const float* qb = p.q + b * p.q_sb + h * dh;
  const float* kb = p.k + b * p.k_sb + h * dh;
  const float* vb = p.v + b * p.v_sb + h * dh;
  for (int idx = threadIdx.x; idx < TK * DH; idx += blockDim.x) {
    const int t = idx / DH;
    const int c = idx - t * DH;
    const bool in = t < T && (!PAD || c < dh);
    ks[t * P + c] = in ? kb[t * p.k_st + c] : 0.f;
    vs[t * P + c] = in ? vb[t * p.v_st + c] : 0.f;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int warps = blockDim.x >> 5;
  const float* bias_b = p.bias + b * p.bias_sb;
  const uint32_t bh_key =
      p.dropout ? mix(mix(kMixKey0, (uint32_t)*p.seed), (uint32_t)bh + p.bh_offset) : 0u;
  float* out_b = p.out + (long long)b * T * p.D + h * dh;

  for (int qt = threadIdx.x >> 5; qt < tiles16(T); qt += warps) {
    const int r0 = qt * 16 + g, r1 = r0 + 8;  // this lane's two query rows
    const bool in0 = r0 < T, in1 = r1 < T;
    FragA qa[kHoldQ ? KS : 1];
    if constexpr (kHoldQ) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const int c = kk * 8 + t4;
        const float* q0 = qb + r0 * p.q_st + c;
        const float* q1 = qb + r1 * p.q_st + c;
        const bool lo = !PAD || c < dh, hi = !PAD || c + 4 < dh;
        qa[kk] = split_a(in0 && lo ? q0[0] : 0.f, in1 && lo ? q1[0] : 0.f,
                         in0 && hi ? q0[4] : 0.f, in1 && hi ? q1[4] : 0.f);
      }
    }
    // padded rows read row 0 of the bias; their results are never written
    const float* brow0 = bias_b + (in0 ? r0 : 0) * p.bias_si;
    const float* brow1 = bias_b + (in1 ? r1 : 0) * p.bias_si;
    const uint32_t key0 = p.dropout ? mix(bh_key, (uint32_t)r0) : 0u;
    const uint32_t key1 = p.dropout ? mix(bh_key, (uint32_t)r1) : 0u;

    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    float o[KS][4];
#pragma unroll
    for (int n = 0; n < KS; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

    for (int j0 = 0; j0 < T; j0 += kChunk) {
      float s[kChunk / 8][4];
      if constexpr (kHoldQ) {
#pragma unroll
        for (int nt = 0; nt < kChunk / 8; ++nt) {
          s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
          const int jb = j0 + nt * 8;
          if (jb < TK) {
            const float* krow = ks + (jb + g) * P + t4;
#pragma unroll
            for (int kk = 0; kk < KS; ++kk)
              mma3(s[nt], qa[kk], krow[kk * 8], krow[kk * 8 + 4]);
          }
        }
      } else {  // the same sums, k-step by k-step, each fragment split at its use
#pragma unroll
        for (int nt = 0; nt < kChunk / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          const int c = kk * 8 + t4;
          const float* q0 = qb + r0 * p.q_st + c;
          const float* q1 = qb + r1 * p.q_st + c;
          const bool lo = !PAD || c < dh, hi = !PAD || c + 4 < dh;
          const FragA qf = split_a(in0 && lo ? q0[0] : 0.f, in1 && lo ? q1[0] : 0.f,
                                   in0 && hi ? q0[4] : 0.f, in1 && hi ? q1[4] : 0.f);
#pragma unroll
          for (int nt = 0; nt < kChunk / 8; ++nt) {
            const int jb = j0 + nt * 8;
            if (jb < TK) {
              const float* krow = ks + (jb + g) * P + t4 + kk * 8;
              mma3(s[nt], qf, krow[0], krow[4]);
            }
          }
        }
      }
      float cm0 = -INFINITY, cm1 = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < kChunk / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = j0 + nt * 8 + 2 * t4 + e;
          if (j < T) {
            s[nt][e] = s[nt][e] * p.scale + brow0[j];
            s[nt][2 + e] = s[nt][2 + e] * p.scale + brow1[j];
          } else {
            s[nt][e] = s[nt][2 + e] = -INFINITY;
          }
          cm0 = fmaxf(cm0, s[nt][e]);
          cm1 = fmaxf(cm1, s[nt][2 + e]);
        }
      }
      // every chunk holds a real key, so the new maxima are finite
      const float mn0 = fmaxf(m0, quad_max(cm0)), mn1 = fmaxf(m1, quad_max(cm1));
      const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      l0 *= al0;
      l1 *= al1;
#pragma unroll
      for (int n = 0; n < KS; ++n) {
        o[n][0] *= al0;
        o[n][1] *= al0;
        o[n][2] *= al1;
        o[n][3] *= al1;
      }
#pragma unroll
      for (int nt = 0; nt < kChunk / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float e0 = expf(s[nt][e] - m0), e1 = expf(s[nt][2 + e] - m1);
          l0 += e0;
          l1 += e1;
          if (p.dropout) {
            const uint32_t j = (uint32_t)(j0 + nt * 8 + 2 * t4 + e);
            e0 = (mix(key0, j) >> 8) >= p.keep_threshold ? e0 * p.inv_keep : 0.f;
            e1 = (mix(key1, j) >> 8) >= p.keep_threshold ? e1 * p.inv_keep : 0.f;
          }
          s[nt][e] = e0;
          s[nt][2 + e] = e1;
        }
      }
#pragma unroll
      for (int nt = 0; nt < kChunk / 8; ++nt) {
        const int jb = j0 + nt * 8;
        if (jb < TK) {
          const FragA pa = split_a(s[nt][0], s[nt][2], s[nt][1], s[nt][3]);
          const float* vrow = vs + (jb + 2 * t4) * P + g;
#pragma unroll
          for (int n = 0; n < KS; ++n) mma3(o[n], pa, vrow[n * 8], vrow[P + n * 8]);
        }
      }
    }
    const float inv0 = 1.f / quad_sum(l0), inv1 = 1.f / quad_sum(l1);
#pragma unroll
    for (int n = 0; n < KS; ++n) {
      const int c = n * 8 + 2 * t4;
      if (in0) store2<DH>(out_b + (long long)r0 * p.D, c, dh, o[n][0] * inv0, o[n][1] * inv0);
      if (in1) store2<DH>(out_b + (long long)r1 * p.D, c, dh, o[n][2] * inv1, o[n][3] * inv1);
    }
    if (p.row_max != nullptr && t4 == 0) {
      const long long base = (long long)bh * T;
      if (in0) {
        p.row_max[base + r0] = m0;
        p.row_inv_sum[base + r0] = inv0;
      }
      if (in1) {
        p.row_max[base + r1] = m1;
        p.row_inv_sum[base + r1] = inv1;
      }
    }
  }
}

// at the template width of dh; SIZE_MAX at a width no instance takes
size_t smem_bytes(int T, int dh) {
  const int dt = template_dh(dh);
  if (dt == 0) return SIZE_MAX;
  return sizeof(float) * 2 * (size_t)((T + 7) & ~7) * pitch(dt);
}

template <int DH, bool PAD>
cudaError_t launch_one(const FwdParams& p, int B, size_t smem, cudaStream_t stream) {
  // every width may take all 227 KB a block can have; asked once, at the first
  // launch (not a stream operation: it stays out of a CUDA graph's capture)
  static const cudaError_t opted_in = cudaFuncSetAttribute(
      attention_fwd_kernel<DH, PAD>, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
  if (opted_in != cudaSuccess) return opted_in;
  attention_fwd_kernel<DH, PAD><<<B * p.H, warps_for(tiles16(p.T)) * 32, smem, stream>>>(p);
  return cudaGetLastError();
}

// dh = DH: the instance with dh a compile-time constant, below 128 (no
// old width's code moves); at DH = 128 one instance, dh read at run time
template <int DH>
cudaError_t launch(const FwdParams& p, int B, size_t smem, cudaStream_t stream) {
  if constexpr (DH == 128) {
    return launch_one<DH, true>(p, B, smem, stream);
  } else {
    return p.dh == DH ? launch_one<DH, false>(p, B, smem, stream)
                      : launch_one<DH, true>(p, B, smem, stream);
  }
}

}  // namespace

extern "C" {

// Shared memory one block needs, in bytes: K and V of one head, padded to a
// multiple of 8 rows, with a row pitch of DH + 4 floats (DH = dh's template
// width); SIZE_MAX for dh above 128.
size_t attention_fwd_smem_bytes(int T, int dh) { return smem_bytes(T, dh); }

// Launches the kernel. `raw` is one FwdArgs block (attention_common.cuh):
// q, k, v [B, T, D] fp32 with unit stride along D and the given batch and
// time strides in elements; bias [1|B, 1, 1|T, T] read through its batch and
// query strides (0 for a broadcast dimension); out contiguous [B, T, D];
// row_max and row_inv_sum contiguous [B, H, T], or both 0 (not written);
// stream a cudaStream_t of the tensors' card. Returns 0, a Refusal, or the
// launch's cudaError_t.
int attention_fwd(const void* raw) {
  FwdArgs a;
  memcpy(&a, raw, sizeof a);
  if (a.B < 1 || a.T < 1 || a.H < 1 || a.D % a.H != 0) return kBadShape;
  const int dh = (int)(a.D / a.H);
  if (template_dh(dh) == 0) return kBadHeadWidth;
  const size_t smem = smem_bytes((int)a.T, dh);
  if (smem > 232448) return kTooLong;
  const FwdParams p = fwd_params(a);
  cudaStream_t s = ptr<CUstream_st>(a.stream);
  const int B = (int)a.B;
  switch (template_dh(dh)) {
    case 8: return (int)launch<8>(p, B, smem, s);
    case 16: return (int)launch<16>(p, B, smem, s);
    case 32: return (int)launch<32>(p, B, smem, s);
    case 64: return (int)launch<64>(p, B, smem, s);
    default: return (int)launch<128>(p, B, smem, s);
  }
}

}  // extern "C"
