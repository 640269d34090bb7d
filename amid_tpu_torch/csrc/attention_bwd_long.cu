// Fused multi-head attention backward for long sequences, for Hopper
// (sm_90a): fp32 in and out, products on the tensor cores in 3xTF32
// (attention_common.cuh). The same function as attention_bwd.cu, for the
// lengths whose head does not fit one block's shared memory there.
//
// Replaces amid_tpu/ops/pallas_attention.py::_bwd_kernel (pallas_call in
// _vjp_bwd) beyond the one-sweep kernel's reach. The Pallas kernel blocks the
// batch so that [TB, T, T] stays in VMEM at any T; the one-sweep kernel keeps
// a whole head (Q, dO, K, dQ, [T, dh] each) in shared memory, 227 KB a block,
// which at dh=32 holds T up to 368. BERT4Rec's encoder sees T=600 (amazon's
// T=150, doubled by InnerComp and again by InterComp).
//
// Arithmetic, as in attention_bwd.cu, from the forward's output O and row
// statistics m_i, 1/l_i:
//   P   = exp(S - m) / l,  S = Q K^T / sqrt(dh) + bias
//   D_i = rowsum(dO o O)_i
//   dP  = (dO V^T) * keep / (1 - rate),  Pd = P * keep / (1 - rate)
//   dS  = P o (dP - D)
//   dV  = Pd^T dO,  dK = dS^T Q / sqrt(dh),  dQ = dS K / sqrt(dh)
// with the dropout mask regenerated from the forward's counter hash of
// (seed, b, h, i, j). No [B, H, T, T] block is stored in device memory, no
// float atomics are used, and every sum is taken in an order fixed by the
// tile numbers, so two calls give the same bits.
//
// Design: FlashAttention-2's split into two kernels, launched one after the
// other on the caller's stream. Each owns one side and streams the other
// from device memory (mostly L2) in stages of 64 rows.
//   * dQ kernel, first. One block of 4 warps per (b, h, 64 queries). The
//     block stages its queries' Q and dO in shared memory, computes their
//     D_i and writes them to a [B, H, T] scratch for the second kernel. Each
//     warp owns 16 queries: its Q and dO fragments (hi/lo) stay in registers
//     (at dh=64 they are split again at each use from shared memory: held,
//     they would need more than the 255 registers a thread has), and so does
//     its dQ accumulator. It walks every key in stages of 64 staged keys (K
//     and V in shared memory), 8 keys at a time: S = Q K^T and dP = dO V^T as
//     m16n8k8 tiles, P, dS element by element, then dQ += dS K with the
//     accumulator as the A fragment (the reordered reduction of
//     attention_common.cuh).
//   * dK/dV kernel, second. One block of 4 warps per (b, h, 64 keys). Each
//     warp owns 16 keys: the one-sweep kernel's warp body, keys in rows and
//     queries in columns, K and V fragments and the dK, dV accumulators in
//     registers (K and V staged in shared memory at dh=64). It walks every
//     query in stages of 64 staged queries (Q, dO, m, 1/l, D_i and the
//     dropout keys of the rows in shared memory).
//   * D_i is computed once, by the dQ kernel, which owns the queries: the
//     dK/dV blocks read it from the scratch instead of reading O again.
//   * Padded rows (past T) have 1/l = 0 and P = 0 and write nothing; a fully
//     masked row (m = -1e9, 1/l = 1/T) gives P = 1/T on every key, as in the
//     one-sweep kernel.
//
// Bound on the H100 (data sheet) at BERT4Rec's shape B=256, H=4, dh=32,
// T=600: 10*B*H*T*T*dh = 118 GFLOP, 0.238 ms at the 495 TFLOP/s TF32
// tensor-core peak (3xTF32 issues three products for each), against 550 MB
// of q, k, v, dO read and dq, dk, dv written, 0.164 ms at 3.35 TB/s: bound
// by operations. This design computes S and dP twice (seven products where
// the one-sweep kernel has five) and re-reads the streamed side from L2 once
// per block of the other side. What else holds it back: mma.sync, not wgmma;
// the exp, the hash and the bias read per element on the CUDA cores; a block
// barrier per stage with no copy in flight across it.

#include <string.h>

#include "attention_common.cuh"

namespace {

using namespace amid_attention;

constexpr int kWarps = 4;           // warps a block
constexpr int kRows = kWarps * 16;  // rows a block owns, and rows a stage holds

// Shared memory of either kernel: two [kRows][dh + 4] tiles of the streamed
// side, two of the owned side where the kernel stages it (dQ: always; dK/dV:
// at dh=64), and four per-row values.
size_t smem_bytes(int dh, int tiles) {
  return sizeof(float) * ((size_t)tiles * kRows * pitch(dh) + 4 * kRows);
}

template <int DH>
__global__ void __launch_bounds__(kWarps * 32)
attention_bwd_dq_kernel(const BwdParams p, float* dsum) {
  constexpr int P = pitch(DH);
  constexpr int KS = DH / 8;        // k-steps over dh; n-tiles of dQ
  constexpr bool kHold = DH < 64;   // the warp's Q and dO fragments held in registers
  const int T = p.T;

  extern __shared__ float smem[];
  float* qs = smem;                 // [kRows][P] the block's Q
  float* gs = qs + kRows * P;       // [kRows][P] the block's dO
  float* ks = gs + kRows * P;       // [kRows][P] a stage's K
  float* vs = ks + kRows * P;       // [kRows][P] a stage's V
  float* mrow = vs + kRows * P;     // [kRows] m_i
  float* lrow = mrow + kRows;       // [kRows] 1/l_i, 0 past T
  float* drow = lrow + kRows;       // [kRows] D_i
  uint32_t* rkey = reinterpret_cast<uint32_t*>(drow + kRows);  // [kRows] dropout key of row i

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int q0 = blockIdx.y * kRows;
  const float* qb = p.q + b * p.q_sb + h * DH;
  const float* kb = p.k + b * p.k_sb + h * DH;
  const float* vb = p.v + b * p.v_sb + h * DH;
  const float* gb = p.dout + b * p.g_sb + h * DH;
  const float* ob = p.out + b * p.o_sb + h * DH;
  for (int idx = threadIdx.x; idx < kRows * DH; idx += blockDim.x) {
    const int r = idx / DH;
    const int c = idx - r * DH;
    const int i = q0 + r;
    const bool in = i < T;
    qs[r * P + c] = in ? qb[i * p.q_st + c] : 0.f;
    gs[r * P + c] = in ? gb[i * p.g_st + c] : 0.f;
  }
  const uint32_t bh_key =
      p.dropout ? mix(mix(kMixKey0, (uint32_t)*p.seed), (uint32_t)bh) : 0u;
  const long long stat = (long long)bh * T;
  for (int r = threadIdx.x; r < kRows; r += blockDim.x) {
    const int i = q0 + r;
    const bool in = i < T;
    mrow[r] = in ? p.row_max[stat + i] : 0.f;
    lrow[r] = in ? p.row_inv_sum[stat + i] : 0.f;
    rkey[r] = p.dropout ? mix(bh_key, (uint32_t)i) : 0u;
  }
  __syncthreads();
  // D_i of the block's queries, summed as the one-sweep kernel sums it
  for (int r = threadIdx.x; r < kRows; r += blockDim.x) {
    const int i = q0 + r;
    float d = 0.f;
    if (i < T) {
      const float* orow = ob + i * p.o_st;
#pragma unroll
      for (int c = 0; c < DH; ++c) d = fmaf(gs[r * P + c], orow[c], d);
      dsum[stat + i] = d;
    }
    drow[r] = d;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int ra = warp * 16 + g, rb = ra + 8;  // this lane's two query rows in the block
  const int ia = q0 + ra, ib = q0 + rb;
  const bool active = q0 + warp * 16 < T;
  auto frag = [&](const float* x, int kk) {  // rows ra, rb of a staged [kRows][P] tile
    const int c = kk * 8 + t4;
    return split_a(x[ra * P + c], x[rb * P + c], x[ra * P + c + 4], x[rb * P + c + 4]);
  };
  FragA qa[kHold ? KS : 1], ga[kHold ? KS : 1];
  float dq[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    if constexpr (kHold) {
      qa[kk] = frag(qs, kk);
      ga[kk] = frag(gs, kk);
    }
    dq[kk][0] = dq[kk][1] = dq[kk][2] = dq[kk][3] = 0.f;
  }
  const float m2[2] = {mrow[ra], mrow[rb]}, l2[2] = {lrow[ra], lrow[rb]};
  const float d2[2] = {drow[ra], drow[rb]};
  const uint32_t key2[2] = {rkey[ra], rkey[rb]};
  const float* bias_b = p.bias + b * p.bias_sb;

  for (int j0 = 0; j0 < T; j0 += kRows) {
    __syncthreads();  // the last stage's K and V are no longer read
    for (int idx = threadIdx.x; idx < kRows * DH; idx += blockDim.x) {
      const int r = idx / DH;
      const int c = idx - r * DH;
      const int j = j0 + r;
      const bool in = j < T;
      ks[r * P + c] = in ? kb[j * p.k_st + c] : 0.f;
      vs[r * P + c] = in ? vb[j * p.v_st + c] : 0.f;
    }
    __syncthreads();
    if (!active) continue;
    const int ntiles = (min(kRows, T - j0) + 7) / 8;  // 8-key tiles holding a key < T
    for (int n = 0; n < ntiles; ++n) {
      const int jl = n * 8;
      // element e: query ia (e < 2) or ib, key j0 + jl + 2*t4 + e % 2; the bias
      // is read before the products so that its loads overlap them (indices
      // clamped: elements past T get P = 0 below)
      float bv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = min(e < 2 ? ia : ib, T - 1);
        const int j = min(j0 + jl + 2 * t4 + (e & 1), T - 1);
        bv[e] = bias_b[i * p.bias_si + j];
      }
      float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        FragA qf, gf;
        if constexpr (kHold) {
          qf = qa[kk];
          gf = ga[kk];
        } else {
          qf = frag(qs, kk);
          gf = frag(gs, kk);
        }
        const int kr = (jl + g) * P + kk * 8 + t4;  // B = K^T, V^T: key g, dims t and t+4
        mma3(s, qf, ks[kr], ks[kr + 4]);
        mma3(dp, gf, vs[kr], vs[kr + 4]);
      }
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int i = r ? ib : ia;
        const int j = j0 + jl + 2 * t4 + (e & 1);
        float pv = 0.f, kf = 1.f;
        if (i < T && j < T) {
          pv = expf(s[e] * p.scale + bv[e] - m2[r]) * l2[r];
          if (p.dropout)
            kf = (mix(key2[r], (uint32_t)j) >> 8) >= p.keep_threshold ? p.inv_keep : 0.f;
        }
        ds[e] = pv * (dp[e] * kf - d2[r]);
      }
      // dQ += dS K: the reduced axis is the tile's 8 keys, in the
      // accumulator's order (rows 2t, 2t+1 of the B tile)
      const FragA sa = split_a(ds[0], ds[2], ds[1], ds[3]);
      const int row = (jl + 2 * t4) * P + g;
#pragma unroll
      for (int c = 0; c < KS; ++c) mma3(dq[c], sa, ks[row + c * 8], ks[row + P + c * 8]);
    }
  }
  if (!active) return;
  const long long out_base = (long long)b * T * p.D + h * DH;
#pragma unroll
  for (int c = 0; c < KS; ++c) {
    const int col = c * 8 + 2 * t4;
    if (ia < T)
      *reinterpret_cast<float2*>(p.dq + out_base + (long long)ia * p.D + col) =
          make_float2(dq[c][0] * p.scale, dq[c][1] * p.scale);
    if (ib < T)
      *reinterpret_cast<float2*>(p.dq + out_base + (long long)ib * p.D + col) =
          make_float2(dq[c][2] * p.scale, dq[c][3] * p.scale);
  }
}

template <int DH>
__global__ void __launch_bounds__(kWarps * 32)
attention_bwd_dkdv_kernel(const BwdParams p, const float* dsum) {
  constexpr int P = pitch(DH);
  constexpr int KS = DH / 8;          // k-steps over dh; n-tiles of dV, dK
  constexpr bool kHoldKV = DH < 64;   // K's and V's hi/lo fragments held in registers
  const int T = p.T;

  extern __shared__ float smem[];
  float* qs = smem;                 // [kRows][P] a stage's Q
  float* gs = qs + kRows * P;       // [kRows][P] a stage's dO
  float* mrow = gs + kRows * P;     // [kRows] m_i
  float* lrow = mrow + kRows;       // [kRows] 1/l_i, 0 past T
  float* drow = lrow + kRows;       // [kRows] D_i
  uint32_t* rkey = reinterpret_cast<uint32_t*>(drow + kRows);  // [kRows] dropout key of row i
  float* ks = reinterpret_cast<float*>(rkey + kRows);  // [kRows][P] the block's K, at dh=64
  float* vs = ks + kRows * P;                          // [kRows][P] the block's V, at dh=64

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int k0 = blockIdx.y * kRows;
  const float* qb = p.q + b * p.q_sb + h * DH;
  const float* kb = p.k + b * p.k_sb + h * DH;
  const float* vb = p.v + b * p.v_sb + h * DH;
  const float* gb = p.dout + b * p.g_sb + h * DH;
  if constexpr (!kHoldKV) {
    for (int idx = threadIdx.x; idx < kRows * DH; idx += blockDim.x) {
      const int r = idx / DH;
      const int c = idx - r * DH;
      const int j = k0 + r;
      const bool in = j < T;
      ks[r * P + c] = in ? kb[j * p.k_st + c] : 0.f;
      vs[r * P + c] = in ? vb[j * p.v_st + c] : 0.f;
    }
  }
  const uint32_t bh_key =
      p.dropout ? mix(mix(kMixKey0, (uint32_t)*p.seed), (uint32_t)bh) : 0u;
  const long long stat = (long long)bh * T;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int la = warp * 16 + g;  // this lane's first key row in the block
  const int ja = k0 + la, jb = ja + 8;  // this lane's two keys
  const bool active = k0 + warp * 16 < T;
  __syncthreads();  // K and V staged (dh=64)
  auto frag = [&](const float* x, int kk) {  // key rows la, la + 8 of a staged tile
    const int c = kk * 8 + t4;
    return split_a(x[la * P + c], x[(la + 8) * P + c], x[la * P + c + 4],
                   x[(la + 8) * P + c + 4]);
  };
  FragA ka[kHoldKV ? KS : 1], va[kHoldKV ? KS : 1];
  float dk[KS][4], dv[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    if constexpr (kHoldKV) {
      const int c = kk * 8 + t4;
      const bool in0 = ja < T, in1 = jb < T;
      const float* k0p = kb + ja * p.k_st + c;
      const float* k1p = kb + jb * p.k_st + c;
      const float* v0p = vb + ja * p.v_st + c;
      const float* v1p = vb + jb * p.v_st + c;
      ka[kk] = split_a(in0 ? k0p[0] : 0.f, in1 ? k1p[0] : 0.f, in0 ? k0p[4] : 0.f,
                       in1 ? k1p[4] : 0.f);
      va[kk] = split_a(in0 ? v0p[0] : 0.f, in1 ? v1p[0] : 0.f, in0 ? v0p[4] : 0.f,
                       in1 ? v1p[4] : 0.f);
    }
    dk[kk][0] = dk[kk][1] = dk[kk][2] = dk[kk][3] = 0.f;
    dv[kk][0] = dv[kk][1] = dv[kk][2] = dv[kk][3] = 0.f;
  }
  const float* bias_b = p.bias + b * p.bias_sb;

  for (int s0 = 0; s0 < T; s0 += kRows) {
    __syncthreads();  // the last stage's rows are no longer read
    for (int idx = threadIdx.x; idx < kRows * DH; idx += blockDim.x) {
      const int r = idx / DH;
      const int c = idx - r * DH;
      const int i = s0 + r;
      const bool in = i < T;
      qs[r * P + c] = in ? qb[i * p.q_st + c] : 0.f;
      gs[r * P + c] = in ? gb[i * p.g_st + c] : 0.f;
    }
    for (int r = threadIdx.x; r < kRows; r += blockDim.x) {
      const int i = s0 + r;
      const bool in = i < T;
      mrow[r] = in ? p.row_max[stat + i] : 0.f;
      lrow[r] = in ? p.row_inv_sum[stat + i] : 0.f;
      drow[r] = in ? dsum[stat + i] : 0.f;
      rkey[r] = p.dropout ? mix(bh_key, (uint32_t)i) : 0u;
    }
    __syncthreads();
    if (!active) continue;
    const int qtiles = (min(kRows, T - s0) + 15) / 16;  // 16-query tiles holding a query < T
    for (int qt = 0; qt < qtiles; ++qt) {
      const int il = qt * 16;  // the tile's first row in the stage
      // element (n, e): key ja (e < 2) or jb, query s0 + il + 8n + 2*t4 + e % 2
      float bv[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = min(e < 2 ? ja : jb, T - 1);
          const int i = min(s0 + il + n * 8 + 2 * t4 + (e & 1), T - 1);
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
          const int row = (il + n * 8 + g) * P + t4 + kk * 8;
          mma3(st[n], kf, qs[row], qs[row + 4]);
          mma3(dp[n], vf, gs[row], gs[row + 4]);
        }
      }
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = e < 2 ? ja : jb;
          const int r = il + n * 8 + 2 * t4 + (e & 1);  // the query's row in the stage
          float pv = 0.f, kf = 1.f;
          if (s0 + r < T && j < T) {
            pv = expf(st[n][e] * p.scale + bv[n][e] - mrow[r]) * lrow[r];
            if (p.dropout)
              kf = (mix(rkey[r], (uint32_t)j) >> 8) >= p.keep_threshold ? p.inv_keep : 0.f;
          }
          st[n][e] = pv * kf;                         // Pd
          dp[n][e] = pv * (dp[n][e] * kf - drow[r]);  // dS
        }
      }
      // dV += Pd^T dO and dK += dS^T Q: the reduced axis is the n-tile's 8
      // queries, in the accumulators' order (rows 2t, 2t+1 of the B tile)
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const FragA pa = split_a(st[n][0], st[n][2], st[n][1], st[n][3]);
        const FragA sa = split_a(dp[n][0], dp[n][2], dp[n][1], dp[n][3]);
        const int row = (il + n * 8 + 2 * t4) * P + g;
#pragma unroll
        for (int c = 0; c < KS; ++c) {
          mma3(dv[c], pa, gs[row + c * 8], gs[row + P + c * 8]);
          mma3(dk[c], sa, qs[row + c * 8], qs[row + P + c * 8]);
        }
      }
    }
  }
  if (!active) return;
  const long long out_base = (long long)b * T * p.D + h * DH;
#pragma unroll
  for (int c = 0; c < KS; ++c) {
    const int col = c * 8 + 2 * t4;
    if (ja < T) {
      *reinterpret_cast<float2*>(p.dk + out_base + (long long)ja * p.D + col) =
          make_float2(dk[c][0] * p.scale, dk[c][1] * p.scale);
      *reinterpret_cast<float2*>(p.dv + out_base + (long long)ja * p.D + col) =
          make_float2(dv[c][0], dv[c][1]);
    }
    if (jb < T) {
      *reinterpret_cast<float2*>(p.dk + out_base + (long long)jb * p.D + col) =
          make_float2(dk[c][2] * p.scale, dk[c][3] * p.scale);
      *reinterpret_cast<float2*>(p.dv + out_base + (long long)jb * p.D + col) =
          make_float2(dv[c][2], dv[c][3]);
    }
  }
}

template <int DH>
cudaError_t launch(const BwdParams& p, float* dsum, int B, cudaStream_t stream) {
  const size_t dq_smem = smem_bytes(DH, 4);
  const size_t kv_smem = smem_bytes(DH, DH < 64 ? 2 : 4);
  // asked once, at the first launch (not a stream operation: it stays out of
  // a CUDA graph's capture)
  static const cudaError_t opted_in = [&] {
    cudaError_t e = cudaFuncSetAttribute(attention_bwd_dq_kernel<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)dq_smem);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(attention_bwd_dkdv_kernel<DH>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kv_smem);
  }();
  if (opted_in != cudaSuccess) return opted_in;
  const dim3 grid(B * p.H, (p.T + kRows - 1) / kRows);
  attention_bwd_dq_kernel<DH><<<grid, kWarps * 32, dq_smem, stream>>>(p, dsum);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  attention_bwd_dkdv_kernel<DH><<<grid, kWarps * 32, kv_smem, stream>>>(p, dsum);
  return cudaGetLastError();
}

// The entry point's argument block: the one-sweep kernel's BwdArgs, then the
// address of the [B, H, T] fp32 scratch that holds D_i between the kernels.
struct BwdLongArgs {
  BwdArgs a;
  long long dsum;
};

}  // namespace

extern "C" {

// Longest T the path takes: the grid's second dimension counts 64-row blocks.
int attention_bwd_long_max_t() { return 65535 * kRows; }

// Launches the dQ kernel, then the dK/dV kernel. `raw` is one BwdLongArgs
// block: the tensors as for attention_bwd (attention_bwd.cu), and dsum a
// contiguous [B, H, T] fp32 scratch the wrapper allocates. Returns 0, a
// Refusal, or the first failing launch's cudaError_t.
int attention_bwd_long(const void* raw) {
  BwdLongArgs la;
  memcpy(&la, raw, sizeof la);
  const BwdArgs& a = la.a;
  if (a.B < 1 || a.T < 1 || a.H < 1 || a.D % a.H != 0) return kBadShape;
  if (a.T > attention_bwd_long_max_t() || a.B * a.H > 2147483647LL) return kTooLong;
  const BwdParams p = bwd_params(a);
  float* dsum = ptr<float>(la.dsum);
  cudaStream_t s = ptr<CUstream_st>(a.stream);
  const int B = (int)a.B;
  switch (a.D / a.H) {
    case 8: return (int)launch<8>(p, dsum, B, s);
    case 16: return (int)launch<16>(p, dsum, B, s);
    case 32: return (int)launch<32>(p, dsum, B, s);
    case 64: return (int)launch<64>(p, dsum, B, s);
    default: return kBadHeadWidth;
  }
}

}  // extern "C"
