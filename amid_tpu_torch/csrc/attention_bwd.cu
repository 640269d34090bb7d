// Fused multi-head attention backward for Hopper (sm_90a), fp32 in and out,
// products on the tensor cores in 3xTF32 (attention_common.cuh).
//
// Replaces amid_tpu/ops/pallas_attention.py::_bwd_kernel (pallas_call in
// _vjp_bwd). One sweep, FlashAttention-2's arithmetic: with the forward's
// row statistics m_i and 1/l_i (attention_fwd.cu) and its output O,
//   P   = exp(S - m) / l,  S = Q K^T / sqrt(dh) + bias
//   D_i = rowsum(dO o O)_i            (= rowsum(dP o P)_i, dropout or not)
//   dV  = Pd^T dO,                    Pd = P * keep / (1 - rate)
//   dP  = (dO V^T) * keep / (1 - rate)
//   dS  = P o (dP - D)
//   dK  = dS^T Q / sqrt(dh),  dQ = dS K / sqrt(dh)
// Five products (S, dP, dV, dK, dQ) and one hash per element. The dropout
// mask is regenerated from the forward's counter hash of (seed, b, h, i, j).
// The residuals are (q, k, v, bias, out, row_max, row_inv_sum, seed); no
// [B, H, T, T] block is stored in device memory.
//
// Design. One block owns one (batch row b, head h):
//   * Q, dO and K of the head ([T, dh], padded with zero rows to a multiple
//     of 16) sit in dynamic shared memory with a row pitch of dh + 4, beside
//     the dQ accumulator [T, dh], the per-row m, 1/l (0 on padded rows, so
//     their P is 0), D_i and dropout key, and one 16 x 16 dS tile per warp;
//   * each warp owns a 16-row KEY tile at a time: its K and V fragments
//     (hi/lo) stay in registers, and so do dK and dV. From dh=64 on the held
//     halves would need more than 255 registers (ptxas spills): there V is
//     staged in shared memory too, and K and V are split again at each use.
//     The warp walks every query tile, computing S^T = K Q^T and
//     dP^T = V dO^T as m16n8k8 tiles (the key fragment outermost, so a
//     fragment split at its use dies before the next). The accumulators hold
//     keys in rows and queries in columns: then P, Pd and dS element by
//     element, and dV += Pd^T dO, dK += dS^T Q with the accumulators as A
//     fragments (the reordered reduction);
//   * dQ of a query tile sums over every key tile, so over warps. No float
//     atomics: at step s the warp with key tile kt works on query tile
//     (kt + s) mod NT, so no two warps touch one query tile in one step; the
//     warp writes its dS tile to its own shared buffer, reads it back
//     transposed as the A fragment of dS K, and adds the 16 x dh result into
//     the shared dQ rows; the block syncs between steps. Every sum is taken
//     in an order fixed by the tile numbers, so two calls give the same bits;
//   * each step reads its 16 x 16 bias elements before the products, so the
//     loads (strided: keys run along the lanes, queries along the bias's
//     rows) overlap the tensor-core work instead of waiting behind it;
//   * keys and queries past T get P = 0 and write nothing;
//   * a head of width dh runs at its template width DH (attention_common.cuh),
//     in the instance with PAD set unless dh = DH: the staged tiles and the
//     held fragments are zero at columns dh to DH, and no column from dh on
//     is written. dK and dV stay in registers at every width (128 at DH =
//     128); there a warp's 16 x DH part of dQ is summed 8 columns at a time
//     and added to the shared rows at once, in the same order.
//
// Bound on the H100 (data sheet): at B=256, T=150, D=128, H=8 one call reads
// q, k, v, dO, out and the bias and writes dq, dk, dv: the function's own
// bytes (q, k, v, bias, dO in; dq, dk, dv out) are 137.7 MB, 41 us at
// 3.35 TB/s; it does 10*B*H*T*T*dh = 7.37 GFLOP, 15 us at the 495 TFLOP/s
// TF32 tensor-core peak (3xTF32 issues three products for each), so it is
// bound by bytes. What holds this design back: mma.sync, not wgmma; the exp,
// hash and bias read per element on the CUDA cores; causally masked tiles
// are computed like the others; a block barrier per query step.

#include <stdint.h>
#include <string.h>

#include "attention_common.cuh"

namespace {

using namespace amid_attention;

constexpr int kScratchPitch = 20;  // 16 queries + 4: rows 2t and 2t+1 on distinct banks

// PAD: dh = p.dh, below DH; else dh = DH
template <int DH, bool PAD>
__global__ void __launch_bounds__(kMaxWarps * 32)
attention_bwd_kernel(const BwdParams p) {
  constexpr int P = pitch(DH);
  constexpr int KS = DH / 8;  // k-steps over dh; n-tiles of dV, dK, dQ
  constexpr int SP = kScratchPitch;
  constexpr bool kHoldKV = DH < 64;  // K's and V's hi/lo fragments held in registers
  const int T = p.T, dh = PAD ? p.dh : DH;
  const int NT = tiles16(T);
  const int TQ = NT * 16;
  const int warps = blockDim.x >> 5;

  extern __shared__ float smem[];
  float* qs = smem;            // [TQ][P] Q
  float* gs = qs + TQ * P;     // [TQ][P] dO
  float* ks = gs + TQ * P;     // [TQ][P] K
  float* dqs = ks + TQ * P;    // [TQ][P] dQ accumulator
  float* mrow = dqs + TQ * P;  // [TQ] m_i
  float* lrow = mrow + TQ;     // [TQ] 1/l_i, 0 on padded rows
  float* drow = lrow + TQ;     // [TQ] D_i
  uint32_t* rkey = reinterpret_cast<uint32_t*>(drow + TQ);  // [TQ] dropout key of row i
  float* scratch = reinterpret_cast<float*>(rkey + TQ);     // [warps][16][SP]
  float* vs = scratch + warps * 16 * SP;                    // [TQ][P] V, at dh=64 only

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const float* qb = p.q + b * p.q_sb + h * dh;
  const float* kb = p.k + b * p.k_sb + h * dh;
  const float* vb = p.v + b * p.v_sb + h * dh;
  const float* gb = p.dout + b * p.g_sb + h * dh;
  const float* ob = p.out + b * p.o_sb + h * dh;
  for (int idx = threadIdx.x; idx < TQ * DH; idx += blockDim.x) {
    const int t = idx / DH;
    const int c = idx - t * DH;
    const bool in = t < T && (!PAD || c < dh);
    qs[t * P + c] = in ? qb[t * p.q_st + c] : 0.f;
    gs[t * P + c] = in ? gb[t * p.g_st + c] : 0.f;
    ks[t * P + c] = in ? kb[t * p.k_st + c] : 0.f;
    dqs[t * P + c] = 0.f;
    if constexpr (!kHoldKV) vs[t * P + c] = in ? vb[t * p.v_st + c] : 0.f;
  }
  const uint32_t bh_key =
      p.dropout ? mix(mix(kMixKey0, (uint32_t)*p.seed), (uint32_t)bh + p.bh_offset) : 0u;
  const long long stat = (long long)bh * T;
  for (int i = threadIdx.x; i < TQ; i += blockDim.x) {
    const bool in = i < T;
    mrow[i] = in ? p.row_max[stat + i] : 0.f;
    lrow[i] = in ? p.row_inv_sum[stat + i] : 0.f;
    rkey[i] = p.dropout ? mix(bh_key, (uint32_t)i) : 0u;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < TQ; i += blockDim.x) {
    float d = 0.f;
    if (i < T) {
      const float* orow = ob + i * p.o_st;
#pragma unroll
      for (int c = 0; c < DH; ++c)
        if (!PAD || c < dh) d = fmaf(gs[i * P + c], orow[c], d);
    }
    drow[i] = d;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const float* bias_b = p.bias + b * p.bias_sb;
  const long long out_base = (long long)b * T * p.D + h * dh;
  float* scr = scratch + warp * 16 * SP;

  // every warp runs the same number of rounds and steps (block barriers); a
  // warp whose key tile is past the end only keeps the barriers
  const int rounds_end = (NT + warps - 1) / warps * warps;
  for (int kt = warp; kt < rounds_end; kt += warps) {
    const bool active = kt < NT;
    const int j0 = kt * 16;
    const int ja = j0 + g, jb = ja + 8;  // this lane's two keys
    auto frag = [&](const float* x, int kk) {  // rows ja, jb of a staged [TQ][P] tile
      const int c = kk * 8 + t4;
      return split_a(x[ja * P + c], x[jb * P + c], x[ja * P + c + 4], x[jb * P + c + 4]);
    };
    FragA ka[kHoldKV ? KS : 1], va[kHoldKV ? KS : 1];
    float dk[KS][4], dv[KS][4];
    if (active) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        if constexpr (kHoldKV) {
          const int c = kk * 8 + t4;
          const float* v0 = vb + ja * p.v_st + c;
          const float* v1 = vb + jb * p.v_st + c;
          const bool lo = !PAD || c < dh, hi = !PAD || c + 4 < dh;
          const bool in0 = ja < T, in1 = jb < T;
          ka[kk] = frag(ks, kk);
          va[kk] = split_a(in0 && lo ? v0[0] : 0.f, in1 && lo ? v1[0] : 0.f,
                           in0 && hi ? v0[4] : 0.f, in1 && hi ? v1[4] : 0.f);
        }
        dk[kk][0] = dk[kk][1] = dk[kk][2] = dk[kk][3] = 0.f;
        dv[kk][0] = dv[kk][1] = dv[kk][2] = dv[kk][3] = 0.f;
      }
    }
    for (int s = 0; s < NT; ++s) {
      if (active) {
        const int qt = kt + s < NT ? kt + s : kt + s - NT;
        const int i0 = qt * 16;
        // the bias is read before the products, so its loads overlap them
        // (indices clamped: elements past T are zeroed below)
        float bv[2][4];
#pragma unroll
        for (int n = 0; n < 2; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = min(e < 2 ? ja : jb, T - 1);
            const int i = min(i0 + n * 8 + 2 * t4 + (e & 1), T - 1);
            bv[n][e] = bias_b[i * p.bias_si + j];
          }
        }
        float st[2][4], dp[2][4];  // S^T and dP^T: keys in rows, queries in columns
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          st[n][0] = st[n][1] = st[n][2] = st[n][3] = 0.f;
          dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
        }
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          FragA kf, vf;
          if constexpr (kHoldKV) {
            kf = ka[kk];
            vf = va[kk];
          } else {
            kf = frag(ks, kk);
            vf = frag(vs, kk);
          }
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            const int row = (i0 + n * 8 + g) * P + t4 + kk * 8;
            mma3(st[n], kf, qs[row], qs[row + 4]);
            mma3(dp[n], vf, gs[row], gs[row + 4]);
          }
        }
        // element (n, e): key ja (e < 2) or jb, query i0 + 8n + 2*t4 + e % 2
#pragma unroll
        for (int n = 0; n < 2; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = e < 2 ? ja : jb;
            const int i = i0 + n * 8 + 2 * t4 + (e & 1);
            float pv = 0.f, kf = 1.f;
            if (i < T && j < T) {
              pv = expf(st[n][e] * p.scale + bv[n][e] - mrow[i]) * lrow[i];
              if (p.dropout)
                kf = (mix(rkey[i], (uint32_t)j) >> 8) >= p.keep_threshold ? p.inv_keep : 0.f;
            }
            st[n][e] = pv * kf;                      // Pd
            dp[n][e] = pv * (dp[n][e] * kf - drow[i]);  // dS
          }
        }
        // dV += Pd^T dO and dK += dS^T Q: the reduced axis is the n-tile's
        // 8 queries, in the accumulators' order (rows 2t, 2t+1 of the B tile)
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const FragA pa = split_a(st[n][0], st[n][2], st[n][1], st[n][3]);
          const FragA sa = split_a(dp[n][0], dp[n][2], dp[n][1], dp[n][3]);
          const int row = (i0 + n * 8 + 2 * t4) * P + g;
#pragma unroll
          for (int c = 0; c < KS; ++c) {
            mma3(dv[c], pa, gs[row + c * 8], gs[row + P + c * 8]);
            mma3(dk[c], sa, qs[row + c * 8], qs[row + P + c * 8]);
          }
        }
        // dQ (16 queries x dh) += dS K, dS read back transposed from scratch
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          *reinterpret_cast<float2*>(scr + g * SP + n * 8 + 2 * t4) =
              make_float2(dp[n][0], dp[n][1]);
          *reinterpret_cast<float2*>(scr + (g + 8) * SP + n * 8 + 2 * t4) =
              make_float2(dp[n][2], dp[n][3]);
        }
        __syncwarp();
        if constexpr (DH < 128) {
          float dq[KS][4];
#pragma unroll
          for (int c = 0; c < KS; ++c) dq[c][0] = dq[c][1] = dq[c][2] = dq[c][3] = 0.f;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int kr = half * 8 + 2 * t4;  // local key rows 2t and 2t+1
            const FragA da = split_a(scr[kr * SP + g], scr[kr * SP + g + 8],
                                     scr[(kr + 1) * SP + g], scr[(kr + 1) * SP + g + 8]);
            const float* krow = ks + (j0 + kr) * P + g;
#pragma unroll
            for (int c = 0; c < KS; ++c) mma3(dq[c], da, krow[c * 8], krow[P + c * 8]);
          }
          __syncwarp();  // scratch is rewritten at the next step
#pragma unroll
          for (int c = 0; c < KS; ++c) {
            float2* d0 = reinterpret_cast<float2*>(dqs + (i0 + g) * P + c * 8 + 2 * t4);
            float2* d1 = reinterpret_cast<float2*>(dqs + (i0 + g + 8) * P + c * 8 + 2 * t4);
            const float2 x0 = *d0, x1 = *d1;
            *d0 = make_float2(x0.x + dq[c][0], x0.y + dq[c][1]);
            *d1 = make_float2(x1.x + dq[c][2], x1.y + dq[c][3]);
          }
        } else {  // 8 columns at a time: dq[KS][4] beside dK and dV would spill
          FragA da[2];
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int kr = half * 8 + 2 * t4;
            da[half] = split_a(scr[kr * SP + g], scr[kr * SP + g + 8],
                               scr[(kr + 1) * SP + g], scr[(kr + 1) * SP + g + 8]);
          }
          __syncwarp();  // scratch is rewritten at the next step
#pragma unroll
          for (int c = 0; c < KS; ++c) {
            float dq[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const float* krow = ks + (j0 + half * 8 + 2 * t4) * P + g + c * 8;
              mma3(dq, da[half], krow[0], krow[P]);
            }
            float2* d0 = reinterpret_cast<float2*>(dqs + (i0 + g) * P + c * 8 + 2 * t4);
            float2* d1 = reinterpret_cast<float2*>(dqs + (i0 + g + 8) * P + c * 8 + 2 * t4);
            const float2 x0 = *d0, x1 = *d1;
            *d0 = make_float2(x0.x + dq[0], x0.y + dq[1]);
            *d1 = make_float2(x1.x + dq[2], x1.y + dq[3]);
          }
        }
      }
      __syncthreads();
    }
    if (active) {
#pragma unroll
      for (int c = 0; c < KS; ++c) {
        const int col = c * 8 + 2 * t4;
        if (ja < T) {
          const long long row = out_base + (long long)ja * p.D;
          store2<DH>(p.dk + row, col, dh, dk[c][0] * p.scale, dk[c][1] * p.scale);
          store2<DH>(p.dv + row, col, dh, dv[c][0], dv[c][1]);
        }
        if (jb < T) {
          const long long row = out_base + (long long)jb * p.D;
          store2<DH>(p.dk + row, col, dh, dk[c][2] * p.scale, dk[c][3] * p.scale);
          store2<DH>(p.dv + row, col, dh, dv[c][2], dv[c][3]);
        }
      }
    }
  }
  // the last step ended with a block barrier: dQ is complete
  for (int idx = threadIdx.x; idx < T * DH; idx += blockDim.x) {
    const int t = idx / DH;
    const int c = idx - t * DH;
    if (!PAD || c < dh) p.dq[out_base + (long long)t * p.D + c] = dqs[t * P + c] * p.scale;
  }
}

// at the template width of dh; SIZE_MAX at a width no instance takes
size_t smem_bytes(int T, int dh) {
  const int dt = template_dh(dh);
  if (dt == 0) return SIZE_MAX;
  const size_t tq = (size_t)tiles16(T) * 16;
  const size_t warps = (size_t)warps_for(tiles16(T));
  const size_t tiles = dt < 64 ? 4 : 5;  // Q, dO, K, dQ (and V from DH = 64 on)
  return sizeof(float) * (tiles * tq * pitch(dt) + 4 * tq + warps * 16 * kScratchPitch);
}

template <int DH, bool PAD>
cudaError_t launch_one(const BwdParams& p, int B, size_t smem, cudaStream_t stream) {
  // every width may take all 227 KB a block can have; asked once, at the first
  // launch (not a stream operation: it stays out of a CUDA graph's capture)
  static const cudaError_t opted_in = cudaFuncSetAttribute(
      attention_bwd_kernel<DH, PAD>, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
  if (opted_in != cudaSuccess) return opted_in;
  attention_bwd_kernel<DH, PAD><<<B * p.H, warps_for(tiles16(p.T)) * 32, smem, stream>>>(p);
  return cudaGetLastError();
}

// dh = DH: the instance with dh a compile-time constant, below 128 (no
// old width's code moves); at DH = 128 one instance, dh read at run time
template <int DH>
cudaError_t launch(const BwdParams& p, int B, size_t smem, cudaStream_t stream) {
  if constexpr (DH == 128) {
    return launch_one<DH, true>(p, B, smem, stream);
  } else {
    return p.dh == DH ? launch_one<DH, false>(p, B, smem, stream)
                      : launch_one<DH, true>(p, B, smem, stream);
  }
}

}  // namespace

extern "C" {

// Shared memory one block needs, in bytes: Q, dO, K (and V from DH = 64 on)
// and the dQ accumulator of one head padded to a multiple of 16 rows (row
// pitch DH + 4, DH = dh's template width), four per-row values and one
// 16 x 20 dS tile per warp; SIZE_MAX for dh above 128.
size_t attention_bwd_smem_bytes(int T, int dh) { return smem_bytes(T, dh); }

// Launches the kernel. `raw` is one BwdArgs block (attention_common.cuh):
// q, k, v, out, dout [B, T, D] fp32 with unit stride along D and the given
// batch and time strides in elements; bias as in attention_fwd; row_max and
// row_inv_sum the forward's contiguous [B, H, T]; dq, dk, dv contiguous
// [B, T, D]; stream a cudaStream_t of the tensors' card. Returns 0, a
// Refusal, or the launch's cudaError_t.
int attention_bwd(const void* raw) {
  BwdArgs a;
  memcpy(&a, raw, sizeof a);
  if (a.B < 1 || a.T < 1 || a.H < 1 || a.D % a.H != 0) return kBadShape;
  const int dh = (int)(a.D / a.H);
  if (template_dh(dh) == 0) return kBadHeadWidth;
  const size_t smem = smem_bytes((int)a.T, dh);
  if (smem > 232448) return kTooLong;
  const BwdParams p = bwd_params(a);
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
