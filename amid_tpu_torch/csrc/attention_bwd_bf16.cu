// Fused multi-head attention backward in the bf16-operand mode for Hopper
// (sm_90a), one sweep a head: native bf16 products
// (mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32) on 16-bit shared-memory
// tiles. fp32 in and out.
//
// Replaces amid_tpu/ops/pallas_attention.py::_bwd_kernel with mxu_bf16=True
// (pallas_call in _vjp_bwd) on the one-sweep path: the arithmetic of
// attention_bwd.cu (the fp32 one-sweep backward; FlashAttention-2's) with
// the five products on bf16 operands and fp32 sums. With the forward's
// row statistics m_i and 1/l_i and its output O:
//   P   = exp(S - m) / l,  S = bf16(Q) bf16(K)^T / sqrt(dh) + bias
//   D_i = rowsum(dO o O)_i             fp32, from the unrounded dO and O
//   dV  = bf16(Pd)^T bf16(dO),         Pd = P * keep / (1 - rate)
//   dP  = (bf16(dO) bf16(V)^T) * keep / (1 - rate)
//   dS  = P o (dP - D)
//   dK  = bf16(dS)^T bf16(Q) / sqrt(dh),  dQ = bf16(dS) bf16(K) / sqrt(dh)
// the rounding points of ops/attention.py::attention_bwd_plain(mxu_bf16=True)
// and of chip_smoke.py::bf16_attention_bwd_oracle. The dropout mask is the
// forward's counter hash of (seed, row_offset + b, h, i, j), bit for bit.
// No [B, H, T, T] block is stored in device memory.
//
// Design. One block owns one (batch row b, head h):
//   * Staging rounds once. Q, dO and K of the head are read as fp32 (16-byte
//     loads where the rows start on 16 bytes and dh is its template width,
//     else value by value), rounded to bf16 (cvt.rn.bf16x2) and stored 8
//     columns a 16-byte store into [TQ][dh_pad + 8] tiles (TQ: T rounded up
//     to 16; zero rows and columns past T and dh); the 16 bytes of extra
//     pitch put the 8 rows an ldmatrix reads on 8 bank groups. The same
//     pass sums D_i = dO_i . O_i in fp32 from the values it read (a row's
//     8-column chunks on neighbouring lanes, joined by shuffles). Beside
//     them: the dQ accumulator [TQ][dh_pad + 8] in fp32 and the per-row m,
//     1/l (0 on padded rows, so their P is 0), D_i and dropout key.
//   * Each warp owns a 16-row KEY tile at a time. Its K and V A fragments
//     stay in registers, rounded once (K by ldmatrix from its tile, V read
//     from device memory), and so do dK and dV. At dh=128 the held
//     fragments would not fit beside dK and dV: V is staged too, and both
//     are read by ldmatrix at each use (no conversion: the tiles are bf16).
//     The warp walks every query tile: S^T = K Q^T and dP^T = V dO^T as two
//     n8 tiles each, B fragments by ldmatrix.x4 from Q's and dO's rows. The
//     accumulators hold keys in rows and queries in columns: P, Pd and dS
//     element by element, then dV += Pd^T dO and dK += dS^T Q with the
//     accumulators packed as the A fragments (one k16 step over the tile's
//     16 queries, no shuffle), dO's and Q's B fragments by ldmatrix.x4.trans.
//   * dQ of a query tile sums over every key tile, so over warps. No float
//     atomics and no shared-memory round trip of dS: the A fragment of
//     dS (queries in rows) is the packed dS^T accumulator transposed by four
//     movmatrix, K's B fragments come by ldmatrix.x4.trans, and the 16 x dh
//     product is added into the shared dQ rows 16 columns at a time. At step
//     s the warp with key tile kt works on query tile (kt + s) mod NT, so
//     no two warps touch one query tile in one step, and the block syncs
//     between steps. Every sum is taken in an order fixed by the tile
//     numbers, so two calls give the same bits;
//   * each step reads its 16 x 16 bias elements before the products, so the
//     loads (keys along the lanes, queries along the bias's rows) overlap
//     the tensor-core work; at dh=128 the 8 registers they take spilled,
//     and there each element reads its bias where it uses it;
//   * a head of width dh runs at its template width (attention_common.cuh;
//     dh <= 8 at 16 columns), in the instance with PAD set unless dh = DH;
//     no column from dh on is written. Keys and queries past T get P = 0
//     and write nothing.
//   * A tile whose every P is 0 (a causal tile of keys past the queries:
//     scores of -1e9) adds nothing: after S^T and dP^T, the warp skips its
//     dV, dK and dQ products and the dQ update, and an element whose P is 0
//     skips the hash. The results are the same bits; the choice is made on
//     the data, not on the bias's shape (causal B=256, T=150: dh=12 0.2117
//     against 0.2740 ms at rate 0, dh=16 0.1886 against 0.1924; key padding
//     within 1%; NVIDIA H100 80GB HBM3, 700.00 W).
//   * mma.sync, not wgmma: a key tile is 16 rows (a wgmma tile 64: at T=20
//     69% of it idle), and the five products are a small part of the time.
//   * Shared memory: (3 or, at dh=128, 4) * TQ * (dh_pad + 8) * 2 bytes of
//     bf16 tiles, TQ * (dh_pad + 8) * 4 of dQ and 16 TQ of rows: at T=150,
//     dh=16 41.0 KB against the fp32 build's 60.2 KB.
//
// Bound on the H100 (data sheet): at B=256, T=150, D=128, H=8 one call reads
// q, k, v, dO and a causal bias and writes dq, dk, dv: the function's own
// bytes are 137.7 MB, 41 us at 3.35 TB/s; it does 10*B*H*T*T*dh = 7.37
// GFLOP, 7 us at the 989 TFLOP/s bf16 tensor-core peak: bound by bytes. What
// holds this design back: the exp, the hash and the bias read of each of
// B*H*TQ*TQ elements on the CUDA cores (about 0.05 ms at T=150 with dropout
// by the data sheet's issue rates); the S^T and dP^T products of causally
// masked tiles, computed before they are skipped; a block barrier per query
// step.

#include <stdint.h>
#include <string.h>

#include "attention_common.cuh"
#include "hopper.cuh"

namespace {

using namespace amid_attention;
using amid_hopper::smem_u32;

// whether V is staged and K's and V's fragments read at each use (their
// held fragments would not fit beside dK and dV)
__host__ __device__ constexpr bool staged_v(int dh) { return dh > 64; }

// PAD: dh = p.dh, below DH (or, at DH = 128, up to it); else dh = DH.
// vec_rows: the rows of q, k, v, out and dout start on 16 bytes, read 16
// bytes at a time where dh = DH. Launch bounds of one block an SM: ptxas
// then takes what registers it needs (up to 255), where without the bound it
// stopped at 128 and spilled at DH = 32 with PAD.
template <int DH, bool PAD>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
attention_bwd_bf16_kernel(const BwdParams p, const int vec_rows) {
  constexpr int DHP = padded_dh(DH);
  constexpr int SP = bf16_pitch(DH);  // bf16 tiles and the fp32 dQ rows alike
  constexpr int KS = DHP / 16;  // k16 steps over dh
  constexpr int NO = DHP / 8;   // n8 tiles of dV, dK, dQ
  constexpr int CH = DHP / 8;   // 8-column chunks of a staged row
  constexpr bool kStageV = staged_v(DH);
  constexpr bool kPrefetchBias = !kStageV;  // 8 registers more: a spill at dh=128
  const int T = p.T, dh = PAD ? p.dh : DH;
  const bool vec = dh == DH && vec_rows;
  const int NT = tiles16(T);
  const int TQ = NT * 16;
  const int warps = blockDim.x >> 5;

  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* qs = smem;          // [TQ][SP] Q, bf16
  uint16_t* gs = qs + TQ * SP;  // [TQ][SP] dO
  uint16_t* ks = gs + TQ * SP;  // [TQ][SP] K
  uint16_t* vs = ks + TQ * SP;  // [TQ][SP] V, at dh = 128 only
  float* dqs = reinterpret_cast<float*>(vs + (kStageV ? TQ * SP : 0));  // [TQ][SP] dQ
  float* mrow = dqs + TQ * SP;  // [TQ] m_i
  float* lrow = mrow + TQ;      // [TQ] 1/l_i, 0 on padded rows
  float* drow = lrow + TQ;      // [TQ] D_i
  uint32_t* rkey = reinterpret_cast<uint32_t*>(drow + TQ);  // [TQ] dropout key of row i

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const float* qb = p.q + b * p.q_sb + h * dh;
  const float* kb = p.k + b * p.k_sb + h * dh;
  const float* vb = p.v + b * p.v_sb + h * dh;
  const float* gb = p.dout + b * p.g_sb + h * dh;
  const float* ob = p.out + b * p.o_sb + h * dh;
  // TQ * CH is a multiple of 32 (CH >= 2) and CH divides 32: each warp's
  // round is whole, and a row's chunks lie on neighbouring lanes
  for (int idx = threadIdx.x; idx < TQ * CH; idx += blockDim.x) {
    const int t = idx / CH;
    const int c = (idx - t * CH) * 8;
    float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    float d = 0.f;
    uint4 qx = make_uint4(0u, 0u, 0u, 0u), gx = qx, kx = qx, vx = qx;
    if (t < T && c < dh) {
      load8(qb + t * p.q_st, c, dh, vec, f);
      qx = pack8(f);
      load8(kb + t * p.k_st, c, dh, vec, f);
      kx = pack8(f);
      if constexpr (kStageV) {
        load8(vb + t * p.v_st, c, dh, vec, f);
        vx = pack8(f);
      }
      float o[8];
      load8(ob + t * p.o_st, c, dh, vec, o);
      load8(gb + t * p.g_st, c, dh, vec, f);
      gx = pack8(f);
#pragma unroll
      for (int e = 0; e < 8; ++e) d = fmaf(f[e], o[e], d);
    }
#pragma unroll
    for (int w = 1; w < CH; w *= 2) d += __shfl_xor_sync(0xffffffffu, d, w);
    if (idx % CH == 0) drow[t] = d;
    *reinterpret_cast<uint4*>(qs + t * SP + c) = qx;
    *reinterpret_cast<uint4*>(gs + t * SP + c) = gx;
    *reinterpret_cast<uint4*>(ks + t * SP + c) = kx;
    if constexpr (kStageV) *reinterpret_cast<uint4*>(vs + t * SP + c) = vx;
    *reinterpret_cast<float4*>(dqs + t * SP + c) = make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(dqs + t * SP + c + 4) = make_float4(0.f, 0.f, 0.f, 0.f);
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

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const float* bias_b = p.bias + b * p.bias_sb;
  const long long out_base = (long long)b * T * p.D + h * dh;
  // this lane's ldmatrix row offsets (elements): `brow` reads the B
  // fragments of two n8 tiles of rows (rows 0-7 and 8-15 by lane / 16,
  // columns 0-7 and 8-15 by lane / 8 % 2); `arow` an A fragment (rows by
  // lane / 8 % 2, columns by lane / 16) and, with .trans, the B fragments of
  // two n8 tiles of columns
  const int brow = ((lane & 7) + ((lane >> 4) << 3)) * SP + ((lane >> 3) & 1) * 8;
  const int arow = ((lane & 7) + (((lane >> 3) & 1) << 3)) * SP + (lane >> 4) * 8;
  const uint32_t q_base = smem_u32(qs), g_base = smem_u32(gs), k_base = smem_u32(ks),
                 v_base = smem_u32(vs);

  // every warp runs the same number of rounds and steps (block barriers); a
  // warp whose key tile is past the end only keeps the barriers
  const int rounds_end = (NT + warps - 1) / warps * warps;
  for (int kt = warp; kt < rounds_end; kt += warps) {
    const bool active = kt < NT;
    const int j0 = kt * 16;
    const int ja = j0 + g, jb = ja + 8;  // this lane's two keys
    uint32_t ka[kStageV ? 1 : KS][4], va[kStageV ? 1 : KS][4];
    float dk[NO][4], dv[NO][4];
    if (active) {
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.f;
        dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;
      }
      if constexpr (!kStageV) {
        const float* v0 = vb + ja * p.v_st;
        const float* v1 = vb + jb * p.v_st;
        const bool in0 = ja < T, in1 = jb < T;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          ldsm_x4(ka[kk], k_base + (j0 * SP + arow + kk * 16) * 2);
          const int c = kk * 16 + 2 * t4;
          va[kk][0] = load2_bf16(v0, c, dh, in0, vec);
          va[kk][1] = load2_bf16(v1, c, dh, in1, vec);
          va[kk][2] = load2_bf16(v0, c + 8, dh, in0, vec);
          va[kk][3] = load2_bf16(v1, c + 8, dh, in1, vec);
        }
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
            if constexpr (kPrefetchBias) bv[n][e] = bias_b[i * p.bias_si + j];
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
          uint32_t qf[4], gf[4];
          ldsm_x4(qf, q_base + (i0 * SP + brow + kk * 16) * 2);
          ldsm_x4(gf, g_base + (i0 * SP + brow + kk * 16) * 2);
          if constexpr (kStageV) {
            uint32_t kf[4], vf[4];
            ldsm_x4(kf, k_base + (j0 * SP + arow + kk * 16) * 2);
            ldsm_x4(vf, v_base + (j0 * SP + arow + kk * 16) * 2);
            mma_bf16(st[0], kf, qf[0], qf[1]);
            mma_bf16(st[1], kf, qf[2], qf[3]);
            mma_bf16(dp[0], vf, gf[0], gf[1]);
            mma_bf16(dp[1], vf, gf[2], gf[3]);
          } else {
            mma_bf16(st[0], ka[kk], qf[0], qf[1]);
            mma_bf16(st[1], ka[kk], qf[2], qf[3]);
            mma_bf16(dp[0], va[kk], gf[0], gf[1]);
            mma_bf16(dp[1], va[kk], gf[2], gf[3]);
          }
        }
        // element (n, e): key ja (e < 2) or jb, query i0 + 8n + 2*t4 + e % 2
        bool live = false;  // a P of this lane's elements above 0
#pragma unroll
        for (int n = 0; n < 2; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = e < 2 ? ja : jb;
            const int i = i0 + n * 8 + 2 * t4 + (e & 1);
            float pv = 0.f, kf = 1.f;
            if (i < T && j < T) {
              const float bias = kPrefetchBias ? bv[n][e] : bias_b[i * p.bias_si + j];
              pv = expf(st[n][e] * p.scale + bias - mrow[i]) * lrow[i];
              live |= pv != 0.f;
              if (p.dropout && pv != 0.f)
                kf = (mix(rkey[i], (uint32_t)j) >> 8) >= p.keep_threshold ? p.inv_keep : 0.f;
            }
            st[n][e] = pv * kf;                         // Pd
            dp[n][e] = pv * (dp[n][e] * kf - drow[i]);  // dS
          }
        }
        // a tile whose every P is 0 (causally masked) adds nothing to dV, dK
        // and dQ: skipped
        if (__any_sync(0xffffffffu, live)) {
          // dV += Pd^T dO and dK += dS^T Q: one k16 step over the 16 queries
          const uint32_t pa[4] = {
              pack_bf16x2(st[0][0], st[0][1]), pack_bf16x2(st[0][2], st[0][3]),
              pack_bf16x2(st[1][0], st[1][1]), pack_bf16x2(st[1][2], st[1][3])};
          const uint32_t sa[4] = {
              pack_bf16x2(dp[0][0], dp[0][1]), pack_bf16x2(dp[0][2], dp[0][3]),
              pack_bf16x2(dp[1][0], dp[1][1]), pack_bf16x2(dp[1][2], dp[1][3])};
#pragma unroll
          for (int np = 0; np < NO / 2; ++np) {
            uint32_t gf[4], qf[4];
            ldsm_x4_t(gf, g_base + (i0 * SP + arow + np * 16) * 2);
            ldsm_x4_t(qf, q_base + (i0 * SP + arow + np * 16) * 2);
            mma_bf16(dv[2 * np], pa, gf[0], gf[1]);
            mma_bf16(dv[2 * np + 1], pa, gf[2], gf[3]);
            mma_bf16(dk[2 * np], sa, qf[0], qf[1]);
            mma_bf16(dk[2 * np + 1], sa, qf[2], qf[3]);
          }
          // dQ (16 queries x dh) += dS K: dS's A fragment is dS^T's, each
          // 8 x 8 block transposed (blocks: queries 0-7 and 8-15 by the n-tile,
          // keys 0-7 and 8-15 by the accumulator half)
          const uint32_t da[4] = {movm_t(sa[0]), movm_t(sa[2]), movm_t(sa[1]), movm_t(sa[3])};
#pragma unroll
          for (int np = 0; np < NO / 2; ++np) {
            uint32_t kf[4];
            ldsm_x4_t(kf, k_base + (j0 * SP + arow + np * 16) * 2);
            float dq[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
            mma_bf16(dq[0], da, kf[0], kf[1]);
            mma_bf16(dq[1], da, kf[2], kf[3]);
#pragma unroll
            for (int x = 0; x < 2; ++x) {
              const int c = (2 * np + x) * 8 + 2 * t4;
              float2* d0 = reinterpret_cast<float2*>(dqs + (i0 + g) * SP + c);
              float2* d1 = reinterpret_cast<float2*>(dqs + (i0 + g + 8) * SP + c);
              const float2 x0 = *d0, x1 = *d1;
              *d0 = make_float2(x0.x + dq[x][0], x0.y + dq[x][1]);
              *d1 = make_float2(x1.x + dq[x][2], x1.y + dq[x][3]);
            }
          }
        }
      }
      __syncthreads();
    }
    if (active) {
#pragma unroll
      for (int n = 0; n < DH / 8; ++n) {  // the n8 tiles of the template width
        const int col = n * 8 + 2 * t4;
        if (ja < T) {
          const long long row = out_base + (long long)ja * p.D;
          store2<DH>(p.dk + row, col, dh, dk[n][0] * p.scale, dk[n][1] * p.scale);
          store2<DH>(p.dv + row, col, dh, dv[n][0], dv[n][1]);
        }
        if (jb < T) {
          const long long row = out_base + (long long)jb * p.D;
          store2<DH>(p.dk + row, col, dh, dk[n][2] * p.scale, dk[n][3] * p.scale);
          store2<DH>(p.dv + row, col, dh, dv[n][2], dv[n][3]);
        }
      }
    }
  }
  // the last step ended with a block barrier: dQ is complete. Four columns
  // a store where dh = DH (dq's rows start on 16 bytes: h * DH floats)
  if (dh == DH && DH >= 4) {
    for (int idx = threadIdx.x; idx < T * (DH / 4); idx += blockDim.x) {
      const int t = idx / (DH / 4);
      const int c = (idx - t * (DH / 4)) * 4;
      const float4 x = *reinterpret_cast<const float4*>(dqs + t * SP + c);
      *reinterpret_cast<float4*>(p.dq + out_base + (long long)t * p.D + c) =
          make_float4(x.x * p.scale, x.y * p.scale, x.z * p.scale, x.w * p.scale);
    }
  } else {
    for (int idx = threadIdx.x; idx < T * DH; idx += blockDim.x) {
      const int t = idx / DH;
      const int c = idx - t * DH;
      if (c < dh) p.dq[out_base + (long long)t * p.D + c] = dqs[t * SP + c] * p.scale;
    }
  }
}

// at the template width of dh; SIZE_MAX at a width no instance takes
size_t smem_bytes(int T, int dh) {
  const int dt = template_dh(dh);
  if (dt == 0) return SIZE_MAX;
  const size_t tq = (size_t)tiles16(T) * 16;
  const size_t tiles = staged_v(dt) ? 4 : 3;  // Q, dO, K (and V at dh = 128)
  return tiles * tq * bf16_pitch(dt) * sizeof(uint16_t) +
         tq * bf16_pitch(dt) * sizeof(float) + 4 * tq * sizeof(float);
}

template <int DH, bool PAD>
cudaError_t launch_one(const BwdParams& p, int B, int vec, size_t smem, cudaStream_t stream) {
  // every width may take all 227 KB a block can have; asked once, at the first
  // launch (not a stream operation: it stays out of a CUDA graph's capture)
  static const cudaError_t opted_in =
      cudaFuncSetAttribute(attention_bwd_bf16_kernel<DH, PAD>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
  if (opted_in != cudaSuccess) return opted_in;
  attention_bwd_bf16_kernel<DH, PAD>
      <<<B * p.H, warps_for(tiles16(p.T)) * 32, smem, stream>>>(p, vec);
  return cudaGetLastError();
}

// dh = DH: the instance with dh a compile-time constant, below 128; at DH =
// 128 one instance, dh read at run time
template <int DH>
cudaError_t launch(const BwdParams& p, int B, int vec, size_t smem, cudaStream_t stream) {
  if constexpr (DH == 128) {
    return launch_one<DH, true>(p, B, vec, smem, stream);
  } else {
    return p.dh == DH ? launch_one<DH, false>(p, B, vec, smem, stream)
                      : launch_one<DH, true>(p, B, vec, smem, stream);
  }
}

}  // namespace

extern "C" {

// Shared memory one block needs, in bytes: Q, dO, K (and V at dh = 128) of
// one head in bf16 and the fp32 dQ accumulator, T rounded up to 16 rows, a
// row pitch of dh_pad + 8 values (dh_pad: dh's template width, at least 16),
// and four per-row values; SIZE_MAX for dh above 128.
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
  const int vec = rows_on16(a.q, a.q_sb, a.q_st) && rows_on16(a.k, a.k_sb, a.k_st) &&
                  rows_on16(a.v, a.v_sb, a.v_st) && rows_on16(a.out, a.o_sb, a.o_st) &&
                  rows_on16(a.dout, a.g_sb, a.g_st);
  cudaStream_t s = ptr<CUstream_st>(a.stream);
  const int B = (int)a.B;
  switch (template_dh(dh)) {
    case 8: return (int)launch<8>(p, B, vec, smem, s);
    case 16: return (int)launch<16>(p, B, vec, smem, s);
    case 32: return (int)launch<32>(p, B, vec, smem, s);
    case 64: return (int)launch<64>(p, B, vec, smem, s);
    default: return (int)launch<128>(p, B, vec, smem, s);
  }
}

}  // extern "C"
