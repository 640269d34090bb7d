// Fused multi-head attention backward for long sequences, for Hopper
// (sm_90a): fp32 in and out, products on the tensor cores as wgmma in
// 3xTF32. The same function as attention_bwd.cu (the one-sweep kernel), for
// any T up to attention_bwd_long_max_t() and at the lengths where it is the
// faster (ops/attention.py::backward_route).
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
// Design: two kernels on the caller's stream, as FlashAttention-2 splits the
// backward. Each block owns 128 rows of one (b, h) and streams the other
// side through shared memory.
//   * dQ kernel, first: owns 128 queries, writes their D_i to a [B, H, T]
//     scratch, streams K and V. dK/dV kernel, second: owns 128 keys, streams
//     Q, dO, m, 1/l and D_i. S and dP are computed in both (seven products,
//     where the one-sweep kernel has five).
//   * Two warpgroups of 128 threads, 64 owned rows each, share every
//     streamed stage (32 rows at dh=64, else 64): each stage read from L2
//     serves 128 rows. No producer warp: registers are allotted per
//     warpgroup, so a 9th warp would cut every thread's share.
//   * An asynchronous ring of two raw stages. Every thread issues its part
//     of a stage's copies (cp.async, 16 bytes of a row, 4 bytes of a row
//     value, zeros past T) and then one cp.async.mbarrier.arrive on the
//     stage's mbarrier; stage s + 2 is issued as soon as stage s has been
//     split, so it lands while stages s and s + 1 are computed. Raw rows are
//     stored with their 16-byte chunks XOR-swizzled by row, so that the
//     split pass reads them without bank conflicts.
//   * Split once. When a stage lands, all 256 threads write its TF32 halves
//     (hi = tf32(x), lo = tf32(x - hi)) once, in one pass, in the layouts
//     the products read as wgmma's K-major shared-memory B operands (core
//     matrices of 8 rows x 16 bytes, no swizzle): [rows][dh] for S = Q K^T
//     and dP = dO V^T, and [dh][rows] for the products fed from the
//     accumulators (dQ += dS K; dV += Pd^T dO and dK += dS^T Q), whose
//     4-column chunks are strided by 16 dh + 16 bytes so that the transposing
//     stores fall on 32 banks. The owned side is split once a block: into
//     registers as A fragments at dh <= 32, into [128][dh] shared-memory
//     tiles at dh = 64 (registers would not hold them). At dh = 128 the two
//     owned inputs' hi and lo tiles (256 KB) would not fit: there each owned
//     input is one raw fp32 [128][dh] tile (chunks swizzled by row, so that
//     a warp's fragment reads fall on 32 banks), and its A fragments are
//     split again at each k-step of each stage (raw_owned), in two buffers
//     so that one k-step's products run while the next is split; a stage
//     streams 16 rows.
//   * dh = 256 (template width 256, any dh from 129 to 256). Two owned raw
//     tiles of 128 rows would take 256 KB, and the dK and dV accumulators
//     of 64 rows a warpgroup 256 registers a thread (the card allots at most
//     255). So a block owns 64 rows, which both warpgroups share, and a
//     stage streams 8 rows. In the dQ kernel warpgroup 0 computes S and
//     warpgroup 1 dP, each hands its accumulator to the same thread of the
//     other through shared memory, and each sums its half of dQ's columns
//     (64 registers); in the dK/dV kernel (attention_bwd_dkdv_wide_kernel)
//     warpgroup 0 computes S^T, hands it to warpgroup 1 and sums dV,
//     warpgroup 1 computes dP^T and sums dK (128 registers each). S is
//     computed twice (once a kernel, as at every width) and dP twice, each
//     by 32 k-steps of m64n8k8 a stage: small products (PERF.md section 6).
//   * A head of width dh runs at its template width DH (attention_common.cuh):
//     its copies zero the columns from dh on, which then add nothing to S,
//     dP and D_i and leave the gradients zero there; no column from dh on
//     is written. Such a head takes the build with AMID_ATTN_PAD=1 (its own
//     library, dh read at run time); this build takes dh = DH only.
//   * Products: wgmma.mma_async m64nNk8 .f32.tf32.tf32, three a k-step (lo
//     hi, hi lo, hi hi into one fp32 accumulator, as attention_common.cuh's
//     mma3). dS and Pd are re-laid from their accumulator into A fragments
//     in registers with the reduced axis numbered in the accumulator's order
//     (index t is column 2t, t + 4 is 2t + 1: no shuffle), so the [dh][rows]
//     tiles store each group of 8 streamed rows in that order. Those
//     products are issued one k-step (8 streamed rows) at a time, so that
//     the products of one column group run while the next is computed.
//   * Elementwise work per element on the CUDA cores: the exp (ex2 of the
//     pre-scaled exponent, __expf), the bias and the dropout hash, each
//     kernel instantiated for a bias that broadcasts over queries or not and
//     for dropout on or off, so that no element pays for a branch. A
//     broadcast bias (BERT4Rec's key padding [B,1,1,T]) is one row: staged
//     with the keys in the dQ kernel, two values a thread in the dK/dV
//     kernel.
//   * Padded rows (past T) are zeros in the tiles, have m = +inf (P = 0) and
//     write nothing; a staged key past T has bias -inf; a fully masked row
//     (m = -1e9, 1/l = 1/T) gives P = 1/T on every key, as in the one-sweep
//     kernel.
//
// Bound on the H100 (data sheet) at BERT4Rec's shape B=256, H=4, dh=32,
// T=600: 10*B*H*T*T*dh = 118 GFLOP, 0.238 ms at the 495 TFLOP/s TF32
// tensor-core peak, against 550 MB of q, k, v, dO read and dq, dk, dv
// written, 0.164 ms at 3.35 TB/s: bound by operations. This design issues
// 7 products x 3 (3xTF32) = 2.1 times the function's count of TF32 products
// and pads T to the 128-row blocks (640 of 600 rows), about 1.1 ms at the
// peak. What is left (PERF.md section 6): the two warpgroups run the
// split, the products and the elementwise pass of a stage in step, so the
// tensor cores idle while the CUDA cores split and exponentiate (one block
// an SM: the tiles take 100-230 KB); splitting while products run slowed
// those products (both read shared memory); S and dP are computed twice.

#include <string.h>

#include "attention_long.cuh"

namespace {

using namespace amid_long;

// Whether the owned side is kept as raw fp32 tiles, split at each use
// (dh >= 128), rather than split once
template <int DH>
__host__ __device__ constexpr bool raw_owned() {
  return DH >= 128;
}

// dh = 256: a block owns 64 rows, which both warpgroups share
template <int DH>
__host__ __device__ constexpr bool wide() {
  return DH == 256;
}
template <int DH>
__host__ __device__ constexpr int own_rows() {
  return wide<DH>() ? 64 : kOwn;
}

// floats of one owned input: its hi and lo tiles, or its raw tile (none
// where its fragments are held in registers)
template <int DH>
__host__ __device__ constexpr int owned_floats() {
  return raw_owned<DH>() ? own_rows<DH>() * DH : 2 * Plan<DH>::OWN;
}

// floats a wide kernel's warpgroups pass each other a stage (dh = 256): a
// thread's NS / 2 accumulator values of S or dP (dQ kernel: both ways), of
// S^T (dK/dV kernel: warpgroup 0 to 1)
template <int DH>
__host__ __device__ constexpr int exchange_floats(int ways) {
  return wide<DH>() ? ways * 128 * Plan<DH>::NS / 2 : 0;
}

template <int DH>
constexpr size_t dq_smem() {
  using P = Plan<DH>;
  return sizeof(float) * (2 * owned_floats<DH>() + 2 * (2 * P::TILE + P::NS) + 4 * P::TILE +
                          2 * P::TR + P::NS + own_rows<DH>() + exchange_floats<DH>(2)) +
         2 * sizeof(uint64_t);
}

template <int DH>
constexpr size_t dkdv_smem() {
  using P = Plan<DH>;
  return sizeof(float) * (2 * owned_floats<DH>() + 2 * (2 * P::TILE + 3 * P::NS) +
                          4 * P::TILE + 4 * P::TR + 4 * P::NS + exchange_floats<DH>(1)) +
         2 * sizeof(uint64_t);
}

// BCAST: the bias broadcasts over queries (bias_si == 0); DROP: dropout on
template <int DH, bool BCAST, bool DROP>
__global__ void __launch_bounds__(kThreads, 1)
attention_bwd_dq_kernel(const BwdParams p, float* dsum) {
  using P = Plan<DH>;
  constexpr int NS = P::NS, KS = DH / 8, JS = NS / 8;
  constexpr int RAW = 2 * P::TILE + NS;  // a raw stage: K, V, the bias row
  constexpr bool OWN_RAW = raw_owned<DH>(), WIDE = wide<DH>();
  constexpr int OWNR = own_rows<DH>();
  constexpr int DQW = WIDE ? DH / 2 : DH;  // dQ columns a warpgroup sums
  const int T = p.T, dh = kPadBuild ? p.dh : DH;

  extern __shared__ __align__(128) float smem[];
  float* qhi = smem;             // [128][dh] the block's Q, hi and lo (or raw: qhi)
  float* qlo = qhi + P::OWN;
  float* ghi = qhi + owned_floats<DH>();  // [128][dh] the block's dO
  float* glo = ghi + P::OWN;
  float* raw = ghi + owned_floats<DH>();  // two raw stages
  float* khi = raw + 2 * RAW;    // [NS][dh] a stage's K and V
  float* klo = khi + P::TILE;
  float* vhi = klo + P::TILE;
  float* vlo = vhi + P::TILE;
  float* kthi = vlo + P::TILE;   // [dh][NS] a stage's K, transposed
  float* ktlo = kthi + P::TR;
  float* bias_s = ktlo + P::TR;  // [NS] the stage's bias row (a bias broadcast over queries)
  float* drow = bias_s + NS;     // [OWNR] D_i
  float* xchg = drow + OWNR;     // WIDE: [2][128][NS / 2] S (warpgroup 0) and dP (1)
  uint64_t* full = reinterpret_cast<uint64_t*>(xchg + exchange_floats<DH>(2));  // [2] landed

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int q0 = blockIdx.y * OWNR;
  const float* qb = p.q + b * p.q_sb + h * dh;
  const float* kb = p.k + b * p.k_sb + h * dh;
  const float* vb = p.v + b * p.v_sb + h * dh;
  const float* gb = p.dout + b * p.g_sb + h * dh;
  const float* ob = p.out + b * p.o_sb + h * dh;
  const float* bias_b = p.bias + b * p.bias_sb;
  const long long stat = (long long)bh * T;
  const int ns = (T + NS - 1) / NS;

  if (tid == 0) {
    mbar_init(smem_u32(full), kThreads);
    mbar_init(smem_u32(full + 1), kThreads);
    mbar_init_fence();
  }
  __syncthreads();
  auto issue = [&](int s) {  // stage s into raw stage s % 2
    float* r = raw + (s & 1) * RAW;
    copy_rows<DH>(r, kb, p.k_st, s * NS, T, dh, tid);
    copy_rows<DH>(r + P::TILE, vb, p.v_st, s * NS, T, dh, tid);
    if constexpr (BCAST) copy_vals<NS>(r + 2 * P::TILE, bias_b, s * NS, T, tid);
    cp_async_arrive(smem_u32(full + (s & 1)));
  };
  issue(0);
  if (ns > 1) issue(1);
  if constexpr (OWN_RAW) {
    load_owned_raw<DH, OWNR>(qb, p.q_st, q0, T, dh, qhi, tid);
    load_owned_raw<DH, OWNR>(gb, p.g_st, q0, T, dh, ghi, tid);
  } else if constexpr (!P::REG_A) {
    load_owned<DH>(qb, p.q_st, q0, T, dh, qhi, qlo, tid);
    load_owned<DH>(gb, p.g_st, q0, T, dh, ghi, glo, tid);
  }
  // D_i of the block's queries, summed as the one-sweep kernel sums it
  if (tid < OWNR) {
    const int i = q0 + tid;
    float d = 0.f;
    if (i < T) {
      const float* grow = gb + i * p.g_st;
      const float* orow = ob + i * p.o_st;
#pragma unroll
      for (int c = 0; c < DH; ++c)
        if (c < dh) d = fmaf(grow[c], orow[c], d);
      dsum[stat + i] = d;
    }
    drow[tid] = d;
  }
  fence_proxy_async();
  __syncthreads();

  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  // this thread's rows rl, rl + 8 of the block (WIDE: both warpgroups' rows)
  const int rl = (WIDE ? 0 : wg * 64) + warp * 16 + g;
  int i2[2];
  float m2[2], l2[2], d2[2];
  uint32_t key2[2];
  const uint32_t bh_key =
      DROP ? mix(mix(kMixKey0, (uint32_t)*p.seed), (uint32_t)bh + p.bh_offset) : 0u;
#pragma unroll
  for (int x = 0; x < 2; ++x) {  // a row past T has m = inf: P = 0
    const int i = q0 + rl + 8 * x;
    const bool in = i < T;
    i2[x] = in ? i : T - 1;
    m2[x] = in ? p.row_max[stat + i] : INFINITY;
    l2[x] = in ? p.row_inv_sum[stat + i] : 0.f;
    d2[x] = drow[rl + 8 * x];
    key2[x] = DROP ? mix(bh_key, (uint32_t)i) : 0u;
  }
  constexpr int KA = P::REG_A ? KS : 1;
  uint32_t qf_hi[KA][4], qf_lo[KA][4], gf_hi[KA][4], gf_lo[KA][4];
  if constexpr (P::REG_A) {
    owned_frags<DH>(qb, p.q_st, q0 + rl, T, dh, t4, qf_hi, qf_lo);
    owned_frags<DH>(gb, p.g_st, q0 + rl, T, dh, t4, gf_hi, gf_lo);
  }
  const uint64_t qa_hi = tile_desc<DH>(qhi + wg * 64 * DH);
  const uint64_t qa_lo = tile_desc<DH>(qlo + wg * 64 * DH);
  const uint64_t ga_hi = tile_desc<DH>(ghi + wg * 64 * DH);
  const uint64_t ga_lo = tile_desc<DH>(glo + wg * 64 * DH);
  const uint64_t kb_hi = tile_desc<DH>(khi), kb_lo = tile_desc<DH>(klo);
  const uint64_t vb_hi = tile_desc<DH>(vhi), vb_lo = tile_desc<DH>(vlo);
  // WIDE: this warpgroup's columns of K^T, DQW rows of 8 on from wg * DQW
  // (DQW / 8 core matrices of 128 bytes: DQW descriptor units)
  const uint64_t half = WIDE ? (uint64_t)(wg * DQW) : 0;
  const uint64_t kt_hi = tr_desc<DH>(kthi) + half, kt_lo = tr_desc<DH>(ktlo) + half;
  constexpr int kTrStep = 2 * P::TR_LBO / 16;  // a k-step of a [dh][NS] tile, in descriptor units

  float dq[DQW / 2];
#pragma unroll
  for (int x = 0; x < DQW / 2; ++x) dq[x] = 0.f;

  for (int s = 0; s < ns; ++s) {
    const float* r = raw + (s & 1) * RAW;
    const int j0 = s * NS;
    mbar_wait(smem_u32(full + (s & 1)), (s >> 1) & 1);
    split_stage<DH, true, true>(r, khi, klo, kthi, ktlo, tid);
    split_stage<DH, true, false>(r + P::TILE, vhi, vlo, nullptr, nullptr, tid);
    if constexpr (BCAST)  // a key past T gets bias -inf: P = 0
      for (int c = tid; c < NS; c += kThreads)
        bias_s[c] = j0 + c < T ? r[2 * P::TILE + c] : -INFINITY;
    fence_proxy_async();
    __syncthreads();  // the split tiles are written and raw stage s % 2 is free
    if (s + 2 < ns) issue(s + 2);

    // S = Q K^T and dP = dO V^T, 3xTF32 (lo hi, hi lo, hi hi a k-step)
    float sa[NS / 2], pa[NS / 2];
#pragma unroll
    for (int x = 0; x < NS / 2; ++x) sa[x] = pa[x] = 0.f;
    fence_regs(sa);
    fence_regs(pa);
    if constexpr (WIDE) {
      // warpgroup 0 computes S, warpgroup 1 dP, over the same 64 rows; each
      // hands its thread's values to the same thread of the other
      if (wg == 0)
        products_raw<DH, NS, false, 4>(sa, sa, qhi, qhi, rl, t4, kb_hi, kb_lo, kb_hi, kb_lo);
      else
        products_raw<DH, NS, false, 4>(pa, pa, ghi, ghi, rl, t4, vb_hi, vb_lo, vb_hi, vb_lo);
      float* mine = xchg + tid * (NS / 2);
      const float* theirs = xchg + (tid ^ 128) * (NS / 2);
#pragma unroll
      for (int x = 0; x < NS / 2; ++x) mine[x] = wg == 0 ? sa[x] : pa[x];
      __syncthreads();
#pragma unroll
      for (int x = 0; x < NS / 2; ++x) {
        if (wg == 0)
          pa[x] = theirs[x];
        else
          sa[x] = theirs[x];
      }
    } else if constexpr (OWN_RAW) {
      products_raw<DH, NS, true>(sa, pa, qhi, ghi, rl, t4, kb_hi, kb_lo, vb_hi, vb_lo);
    } else {
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < KS; ++k) {
        if constexpr (P::REG_A) {
          mma3_rs<NS>(sa, qf_hi[k], qf_lo[k], kb_hi + 16 * k, kb_lo + 16 * k);
          mma3_rs<NS>(pa, gf_hi[k], gf_lo[k], vb_hi + 16 * k, vb_lo + 16 * k);
        } else {
          mma3_ss<NS>(sa, qa_hi + 16 * k, qa_lo + 16 * k, kb_hi + 16 * k, kb_lo + 16 * k);
          mma3_ss<NS>(pa, ga_hi + 16 * k, ga_lo + 16 * k, vb_hi + 16 * k, vb_lo + 16 * k);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
    }
    fence_regs(sa);
    fence_regs(pa);

    // dS element by element, then dQ += dS K (B: the stage's K as [dh][NS]),
    // one k-step a column group j: element e of group j is query rl + 8 (e / 2),
    // key 8 j + 2 t + e % 2 of the stage. Group j's products run while group
    // j + 1 is computed; its A fragments take turns in two buffers.
    uint32_t ahi[2][4], alo[2][4];
    fence_regs(dq);
#pragma unroll
    for (int j = 0; j < JS; ++j) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = e >> 1;
        const int c = 8 * j + 2 * t4 + (e & 1);
        const int key = j0 + c;
        float pv;
        if constexpr (BCAST) {
          pv = __expf(fmaf(sa[4 * j + e], p.scale, bias_s[c]) - m2[x]) * l2[x];
        } else {
          const float bv = bias_b[i2[x] * p.bias_si + min(key, T - 1)];
          pv = key < T ? __expf(fmaf(sa[4 * j + e], p.scale, bv) - m2[x]) * l2[x] : 0.f;
        }
        float dpv = pa[4 * j + e];
        if constexpr (DROP)
          dpv *= (mix(key2[x], (uint32_t)key) >> 8) >= p.keep_threshold ? p.inv_keep : 0.f;
        ds[e] = pv * (dpv - d2[x]);
      }
      if (j >= 2) wgmma_wait<1>();  // group j - 2 is done: its buffer is free
      fence_regs(ahi[j & 1]);
      fence_regs(alo[j & 1]);
      frag(ds, ahi[j & 1], alo[j & 1]);
      fence_regs(ahi[j & 1]);
      fence_regs(alo[j & 1]);
      wgmma_fence();
      mma3_rs<DQW>(dq, ahi[j & 1], alo[j & 1], kt_hi + j * kTrStep, kt_lo + j * kTrStep);
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs(dq);
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      fence_regs(ahi[x]);
      fence_regs(alo[x]);
    }
    __syncthreads();  // the split tiles are read
  }

  const long long out_base = (long long)b * T * p.D + h * dh;
#pragma unroll
  for (int c = 0; c < DQW / 8; ++c) {
    const int col = (WIDE ? wg * DQW : 0) + c * 8 + 2 * t4;
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int i = q0 + rl + 8 * x;
      if (i < T)
        store2<DH>(p.dq + out_base + (long long)i * p.D, col, dh, dq[4 * c + 2 * x] * p.scale,
                   dq[4 * c + 2 * x + 1] * p.scale);
    }
  }
}

template <int DH, bool BCAST, bool DROP>
__global__ void __launch_bounds__(kThreads, 1)
attention_bwd_dkdv_kernel(const BwdParams p, const float* dsum) {
  using P = Plan<DH>;
  constexpr int NS = P::NS, KS = DH / 8, JS = NS / 8;
  constexpr int RAW = 2 * P::TILE + 3 * NS;  // a raw stage: Q, dO, m, 1/l, D
  constexpr bool OWN_RAW = raw_owned<DH>();
  const int T = p.T, dh = kPadBuild ? p.dh : DH;

  extern __shared__ __align__(128) float smem[];
  float* khi = smem;            // [128][dh] the block's K, hi and lo (or raw: khi)
  float* klo = khi + P::OWN;
  float* vhi = khi + owned_floats<DH>();  // [128][dh] the block's V
  float* vlo = vhi + P::OWN;
  float* raw = vhi + owned_floats<DH>();  // two raw stages
  float* qhi = raw + 2 * RAW;   // [NS][dh] a stage's Q and dO
  float* qlo = qhi + P::TILE;
  float* ghi = qlo + P::TILE;
  float* glo = ghi + P::TILE;
  float* qthi = glo + P::TILE;  // [dh][NS] a stage's Q and dO, transposed
  float* qtlo = qthi + P::TR;
  float* gthi = qtlo + P::TR;
  float* gtlo = gthi + P::TR;
  // [NS] m_i, 1/l_i, D_i and the dropout key (its bits) of the stage's rows
  float4* rows_s = reinterpret_cast<float4*>(gtlo + P::TR);
  uint64_t* full = reinterpret_cast<uint64_t*>(rows_s + NS);  // [2] a raw stage landed

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int k0 = blockIdx.y * kOwn;
  const float* qb = p.q + b * p.q_sb + h * dh;
  const float* kb = p.k + b * p.k_sb + h * dh;
  const float* vb = p.v + b * p.v_sb + h * dh;
  const float* gb = p.dout + b * p.g_sb + h * dh;
  const float* bias_b = p.bias + b * p.bias_sb;
  const long long stat = (long long)bh * T;
  const int ns = (T + NS - 1) / NS;
  const uint32_t bh_key =
      DROP ? mix(mix(kMixKey0, (uint32_t)*p.seed), (uint32_t)bh + p.bh_offset) : 0u;

  if (tid == 0) {
    mbar_init(smem_u32(full), kThreads);
    mbar_init(smem_u32(full + 1), kThreads);
    mbar_init_fence();
  }
  __syncthreads();
  auto issue = [&](int s) {  // stage s into raw stage s % 2
    float* r = raw + (s & 1) * RAW;
    copy_rows<DH>(r, qb, p.q_st, s * NS, T, dh, tid);
    copy_rows<DH>(r + P::TILE, gb, p.g_st, s * NS, T, dh, tid);
    copy_vals<NS>(r + 2 * P::TILE, p.row_max + stat, s * NS, T, tid);
    copy_vals<NS>(r + 2 * P::TILE + NS, p.row_inv_sum + stat, s * NS, T, tid);
    copy_vals<NS>(r + 2 * P::TILE + 2 * NS, dsum + stat, s * NS, T, tid);
    cp_async_arrive(smem_u32(full + (s & 1)));
  };
  issue(0);
  if (ns > 1) issue(1);
  if constexpr (OWN_RAW) {
    load_owned_raw<DH>(kb, p.k_st, k0, T, dh, khi, tid);
    load_owned_raw<DH>(vb, p.v_st, k0, T, dh, vhi, tid);
  } else if constexpr (!P::REG_A) {
    load_owned<DH>(kb, p.k_st, k0, T, dh, khi, klo, tid);
    load_owned<DH>(vb, p.v_st, k0, T, dh, vhi, vlo, tid);
  }
  fence_proxy_async();
  __syncthreads();

  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int rl = wg * 64 + warp * 16 + g;  // this thread's key rows rl, rl + 8 of the block
  int j2[2];
  float bk[2];
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int j = k0 + rl + 8 * x;
    j2[x] = j;
    bk[x] = BCAST ? bias_b[min(j, T - 1)] : 0.f;
  }
  constexpr int KA = P::REG_A ? KS : 1;
  uint32_t kf_hi[KA][4], kf_lo[KA][4], vf_hi[KA][4], vf_lo[KA][4];
  if constexpr (P::REG_A) {
    owned_frags<DH>(kb, p.k_st, k0 + rl, T, dh, t4, kf_hi, kf_lo);
    owned_frags<DH>(vb, p.v_st, k0 + rl, T, dh, t4, vf_hi, vf_lo);
  }
  const uint64_t ka_hi = tile_desc<DH>(khi + wg * 64 * DH);
  const uint64_t ka_lo = tile_desc<DH>(klo + wg * 64 * DH);
  const uint64_t va_hi = tile_desc<DH>(vhi + wg * 64 * DH);
  const uint64_t va_lo = tile_desc<DH>(vlo + wg * 64 * DH);
  const uint64_t qb_hi = tile_desc<DH>(qhi), qb_lo = tile_desc<DH>(qlo);
  const uint64_t gb_hi = tile_desc<DH>(ghi), gb_lo = tile_desc<DH>(glo);
  const uint64_t qt_hi = tr_desc<DH>(qthi), qt_lo = tr_desc<DH>(qtlo);
  const uint64_t gt_hi = tr_desc<DH>(gthi), gt_lo = tr_desc<DH>(gtlo);
  constexpr int kTrStep = 2 * P::TR_LBO / 16;

  float dk[DH / 2], dv[DH / 2];
#pragma unroll
  for (int x = 0; x < DH / 2; ++x) dk[x] = dv[x] = 0.f;

  for (int s = 0; s < ns; ++s) {
    const float* r = raw + (s & 1) * RAW;
    const int s0 = s * NS;
    mbar_wait(smem_u32(full + (s & 1)), (s >> 1) & 1);
    split_stage<DH, true, true>(r, qhi, qlo, qthi, qtlo, tid);
    split_stage<DH, true, true>(r + P::TILE, ghi, glo, gthi, gtlo, tid);
    for (int c = tid; c < NS; c += kThreads)  // a query past T has m = inf: P = 0
      rows_s[c] = make_float4(s0 + c < T ? r[2 * P::TILE + c] : INFINITY,
                              r[2 * P::TILE + NS + c], r[2 * P::TILE + 2 * NS + c],
                              __uint_as_float(DROP ? mix(bh_key, (uint32_t)(s0 + c)) : 0u));
    fence_proxy_async();
    __syncthreads();  // the split tiles are written and raw stage s % 2 is free
    if (s + 2 < ns) issue(s + 2);

    // S^T = K Q^T and dP^T = V dO^T: keys in rows, the stage's queries in columns
    float st[NS / 2], dp[NS / 2];
#pragma unroll
    for (int x = 0; x < NS / 2; ++x) st[x] = dp[x] = 0.f;
    fence_regs(st);
    fence_regs(dp);
    if constexpr (OWN_RAW) {
      products_raw<DH, NS, true>(st, dp, khi, vhi, rl, t4, qb_hi, qb_lo, gb_hi, gb_lo);
    } else {
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < KS; ++k) {
        if constexpr (P::REG_A) {
          mma3_rs<NS>(st, kf_hi[k], kf_lo[k], qb_hi + 16 * k, qb_lo + 16 * k);
          mma3_rs<NS>(dp, vf_hi[k], vf_lo[k], gb_hi + 16 * k, gb_lo + 16 * k);
        } else {
          mma3_ss<NS>(st, ka_hi + 16 * k, ka_lo + 16 * k, qb_hi + 16 * k, qb_lo + 16 * k);
          mma3_ss<NS>(dp, va_hi + 16 * k, va_lo + 16 * k, gb_hi + 16 * k, gb_lo + 16 * k);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
    }
    fence_regs(st);
    fence_regs(dp);

    // Pd and dS element by element, then dV += Pd^T dO and dK += dS^T Q (B:
    // the stage's dO and Q as [dh][NS]), one k-step a column group j:
    // element e of group j is key rl + 8 (e / 2), query 8 j + 2 t + e % 2 of
    // the stage. Group j's products run while group j + 1 is computed.
    uint32_t phi[2][4], plo[2][4], shi[2][4], slo[2][4];
    fence_regs(dk);
    fence_regs(dv);
#pragma unroll
    for (int j = 0; j < JS; ++j) {
      float pd[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = e >> 1;
        const int c = 8 * j + 2 * t4 + (e & 1);
        const int i = s0 + c;
        const int key = j2[x];
        const float4 rv = rows_s[c];  // m, 1/l, D, the row's dropout key
        const float bv = BCAST ? bk[x] : bias_b[min(i, T - 1) * p.bias_si + min(key, T - 1)];
        const float pv = __expf(fmaf(st[4 * j + e], p.scale, bv) - rv.x) * rv.y;
        float kf = 1.f;
        if constexpr (DROP)
          kf = (mix(__float_as_uint(rv.w), (uint32_t)key) >> 8) >= p.keep_threshold ? p.inv_keep
                                                                                    : 0.f;
        pd[e] = DROP ? pv * kf : pv;
        ds[e] = pv * ((DROP ? dp[4 * j + e] * kf : dp[4 * j + e]) - rv.z);
      }
      const int u = j & 1;
      if (j >= 2) wgmma_wait<1>();  // group j - 2 is done: its buffers are free
      fence_regs(phi[u]);
      fence_regs(plo[u]);
      fence_regs(shi[u]);
      fence_regs(slo[u]);
      frag(pd, phi[u], plo[u]);
      frag(ds, shi[u], slo[u]);
      fence_regs(phi[u]);
      fence_regs(plo[u]);
      fence_regs(shi[u]);
      fence_regs(slo[u]);
      wgmma_fence();
      mma3_rs<DH>(dv, phi[u], plo[u], gt_hi + j * kTrStep, gt_lo + j * kTrStep);
      mma3_rs<DH>(dk, shi[u], slo[u], qt_hi + j * kTrStep, qt_lo + j * kTrStep);
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs(dk);
    fence_regs(dv);
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      fence_regs(phi[x]);
      fence_regs(plo[x]);
      fence_regs(shi[x]);
      fence_regs(slo[x]);
    }
    __syncthreads();  // the split tiles are read
  }

  const long long out_base = (long long)b * T * p.D + h * dh;
#pragma unroll
  for (int c = 0; c < DH / 8; ++c) {
    const int col = c * 8 + 2 * t4;
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int j = j2[x];
      if (j < T) {
        const long long row = out_base + (long long)j * p.D;
        store2<DH>(p.dk + row, col, dh, dk[4 * c + 2 * x] * p.scale,
                   dk[4 * c + 2 * x + 1] * p.scale);
        store2<DH>(p.dv + row, col, dh, dv[4 * c + 2 * x], dv[4 * c + 2 * x + 1]);
      }
    }
  }
}

// dh = 256 (wide<DH>()): the block owns 64 keys, both warpgroups share
// them; warpgroup 0 computes S^T = K Q^T, hands it to warpgroup 1 and sums
// dV += Pd^T dO, warpgroup 1 computes dP^T = V dO^T and sums dK += dS^T Q,
// each over all 256 columns (128 accumulators a thread)
template <bool BCAST, bool DROP>
__global__ void __launch_bounds__(kThreads, 1)
attention_bwd_dkdv_wide_kernel(const BwdParams p, const float* dsum) {
  constexpr int DH = 256;
  using P = Plan<DH>;
  constexpr int NS = P::NS, JS = NS / 8, OWNR = own_rows<DH>();
  constexpr int RAW = 2 * P::TILE + 3 * NS;  // a raw stage: Q, dO, m, 1/l, D
  const int T = p.T, dh = kPadBuild ? p.dh : DH;

  extern __shared__ __align__(128) float smem[];
  float* kraw = smem;              // [64][dh] the block's K, raw
  float* vraw = kraw + OWNR * DH;  // [64][dh] the block's V, raw
  float* raw = vraw + OWNR * DH;   // two raw stages
  float* qhi = raw + 2 * RAW;      // [NS][dh] a stage's Q and dO
  float* qlo = qhi + P::TILE;
  float* ghi = qlo + P::TILE;
  float* glo = ghi + P::TILE;
  float* qthi = glo + P::TILE;     // [dh][NS] a stage's Q and dO, transposed
  float* qtlo = qthi + P::TR;
  float* gthi = qtlo + P::TR;
  float* gtlo = gthi + P::TR;
  // [NS] m_i, 1/l_i, D_i and the dropout key (its bits) of the stage's rows
  float4* rows_s = reinterpret_cast<float4*>(gtlo + P::TR);
  float* xchg = reinterpret_cast<float*>(rows_s + NS);  // [128][NS / 2] S^T, warpgroup 0 to 1
  uint64_t* full = reinterpret_cast<uint64_t*>(xchg + exchange_floats<DH>(1));  // [2] landed

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int k0 = blockIdx.y * OWNR;
  const float* qb = p.q + b * p.q_sb + h * dh;
  const float* kb = p.k + b * p.k_sb + h * dh;
  const float* vb = p.v + b * p.v_sb + h * dh;
  const float* gb = p.dout + b * p.g_sb + h * dh;
  const float* bias_b = p.bias + b * p.bias_sb;
  const long long stat = (long long)bh * T;
  const int ns = (T + NS - 1) / NS;
  const uint32_t bh_key =
      DROP ? mix(mix(kMixKey0, (uint32_t)*p.seed), (uint32_t)bh + p.bh_offset) : 0u;

  if (tid == 0) {
    mbar_init(smem_u32(full), kThreads);
    mbar_init(smem_u32(full + 1), kThreads);
    mbar_init_fence();
  }
  __syncthreads();
  auto issue = [&](int s) {  // stage s into raw stage s % 2
    float* r = raw + (s & 1) * RAW;
    copy_rows<DH>(r, qb, p.q_st, s * NS, T, dh, tid);
    copy_rows<DH>(r + P::TILE, gb, p.g_st, s * NS, T, dh, tid);
    copy_vals<NS>(r + 2 * P::TILE, p.row_max + stat, s * NS, T, tid);
    copy_vals<NS>(r + 2 * P::TILE + NS, p.row_inv_sum + stat, s * NS, T, tid);
    copy_vals<NS>(r + 2 * P::TILE + 2 * NS, dsum + stat, s * NS, T, tid);
    cp_async_arrive(smem_u32(full + (s & 1)));
  };
  issue(0);
  if (ns > 1) issue(1);
  load_owned_raw<DH, OWNR>(kb, p.k_st, k0, T, dh, kraw, tid);
  load_owned_raw<DH, OWNR>(vb, p.v_st, k0, T, dh, vraw, tid);
  __syncthreads();

  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int rl = warp * 16 + g;  // this thread's key rows rl, rl + 8 of the block
  const bool sums_dv = wg == 0;  // else dK
  int j2[2];
  float bk[2];
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int j = k0 + rl + 8 * x;
    j2[x] = j;
    bk[x] = BCAST ? bias_b[min(j, T - 1)] : 0.f;
  }
  const uint64_t qb_hi = tile_desc<DH>(qhi), qb_lo = tile_desc<DH>(qlo);
  const uint64_t gb_hi = tile_desc<DH>(ghi), gb_lo = tile_desc<DH>(glo);
  // B of this warpgroup's sum: dO^T for dV, Q^T for dK
  const uint64_t tb_hi = tr_desc<DH>(sums_dv ? gthi : qthi);
  const uint64_t tb_lo = tr_desc<DH>(sums_dv ? gtlo : qtlo);
  constexpr int kTrStep = 2 * P::TR_LBO / 16;

  float acc[DH / 2];  // dV (warpgroup 0) or dK (warpgroup 1)
#pragma unroll
  for (int x = 0; x < DH / 2; ++x) acc[x] = 0.f;

  for (int s = 0; s < ns; ++s) {
    const float* r = raw + (s & 1) * RAW;
    const int s0 = s * NS;
    mbar_wait(smem_u32(full + (s & 1)), (s >> 1) & 1);
    split_stage<DH, true, true>(r, qhi, qlo, qthi, qtlo, tid);
    split_stage<DH, true, true>(r + P::TILE, ghi, glo, gthi, gtlo, tid);
    for (int c = tid; c < NS; c += kThreads)  // a query past T has m = inf: P = 0
      rows_s[c] = make_float4(s0 + c < T ? r[2 * P::TILE + c] : INFINITY,
                              r[2 * P::TILE + NS + c], r[2 * P::TILE + 2 * NS + c],
                              __uint_as_float(DROP ? mix(bh_key, (uint32_t)(s0 + c)) : 0u));
    fence_proxy_async();
    __syncthreads();  // the split tiles are written and raw stage s % 2 is free
    if (s + 2 < ns) issue(s + 2);

    // S^T = K Q^T (warpgroup 0) and dP^T = V dO^T (warpgroup 1): keys in
    // rows, the stage's queries in columns; warpgroup 0 hands S^T over
    float st[NS / 2], dp[NS / 2];
#pragma unroll
    for (int x = 0; x < NS / 2; ++x) st[x] = dp[x] = 0.f;
    fence_regs(st);
    fence_regs(dp);
    if (sums_dv)
      products_raw<DH, NS, false, 4>(st, st, kraw, kraw, rl, t4, qb_hi, qb_lo, qb_hi, qb_lo);
    else
      products_raw<DH, NS, false, 4>(dp, dp, vraw, vraw, rl, t4, gb_hi, gb_lo, gb_hi, gb_lo);
    fence_regs(st);
    fence_regs(dp);
    if (sums_dv) {
#pragma unroll
      for (int x = 0; x < NS / 2; ++x) xchg[tid * (NS / 2) + x] = st[x];
    }
    __syncthreads();
    if (!sums_dv) {
#pragma unroll
      for (int x = 0; x < NS / 2; ++x) st[x] = xchg[(tid - 128) * (NS / 2) + x];
    }

    // Pd (dV) or dS (dK) element by element, then the sum, one k-step a
    // column group j: element e of group j is key rl + 8 (e / 2), query
    // 8 j + 2 t + e % 2 of the stage
    uint32_t ahi[2][4], alo[2][4];
    fence_regs(acc);
#pragma unroll
    for (int j = 0; j < JS; ++j) {
      float av[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = e >> 1;
        const int c = 8 * j + 2 * t4 + (e & 1);
        const int i = s0 + c;
        const int key = j2[x];
        const float4 rv = rows_s[c];  // m, 1/l, D, the row's dropout key
        const float bv = BCAST ? bk[x] : bias_b[min(i, T - 1) * p.bias_si + min(key, T - 1)];
        const float pv = __expf(fmaf(st[4 * j + e], p.scale, bv) - rv.x) * rv.y;
        float kf = 1.f;
        if constexpr (DROP)
          kf = (mix(__float_as_uint(rv.w), (uint32_t)key) >> 8) >= p.keep_threshold ? p.inv_keep
                                                                                    : 0.f;
        av[e] = sums_dv ? (DROP ? pv * kf : pv)
                        : pv * ((DROP ? dp[4 * j + e] * kf : dp[4 * j + e]) - rv.z);
      }
      const int u = j & 1;
      if (j >= 2) wgmma_wait<1>();  // group j - 2 is done: its buffers are free
      fence_regs(ahi[u]);
      fence_regs(alo[u]);
      frag(av, ahi[u], alo[u]);
      fence_regs(ahi[u]);
      fence_regs(alo[u]);
      wgmma_fence();
      mma3_rs<DH>(acc, ahi[u], alo[u], tb_hi + j * kTrStep, tb_lo + j * kTrStep);
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      fence_regs(ahi[x]);
      fence_regs(alo[x]);
    }
    __syncthreads();  // the split tiles are read
  }

  const long long out_base = (long long)b * T * p.D + h * dh;
  float* dst = sums_dv ? p.dv : p.dk;
  const float scale = sums_dv ? 1.f : p.scale;
#pragma unroll
  for (int c = 0; c < DH / 8; ++c) {
    const int col = c * 8 + 2 * t4;
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int j = j2[x];
      if (j < T)
        store2<DH>(dst + out_base + (long long)j * p.D, col, dh, acc[4 * c + 2 * x] * scale,
                   acc[4 * c + 2 * x + 1] * scale);
    }
  }
}

// the dK/dV kernel of a head width
template <int DH, bool BCAST, bool DROP>
constexpr auto dkdv_kernel() {
  if constexpr (wide<DH>())
    return attention_bwd_dkdv_wide_kernel<BCAST, DROP>;
  else
    return attention_bwd_dkdv_kernel<DH, BCAST, DROP>;
}

template <int DH, bool BCAST, bool DROP>
cudaError_t opt_in() {
  cudaError_t e = cudaFuncSetAttribute(attention_bwd_dq_kernel<DH, BCAST, DROP>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)dq_smem<DH>());
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(dkdv_kernel<DH, BCAST, DROP>(),
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dkdv_smem<DH>());
}

template <int DH, bool BCAST, bool DROP>
cudaError_t launch_pair(const BwdParams& p, float* dsum, dim3 grid, cudaStream_t stream) {
  attention_bwd_dq_kernel<DH, BCAST, DROP><<<grid, kThreads, dq_smem<DH>(), stream>>>(p, dsum);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dkdv_kernel<DH, BCAST, DROP>()<<<grid, kThreads, dkdv_smem<DH>(), stream>>>(p, dsum);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch(const BwdParams& p, float* dsum, int B, cudaStream_t stream) {
  static_assert(dq_smem<DH>() <= 232448 && dkdv_smem<DH>() <= 232448, "a block's shared memory");
  // asked once for the four instances, at the first launch at this head
  // width (not a stream operation: it stays out of a CUDA graph's capture)
  static const cudaError_t opted_in = [] {
    cudaError_t e = opt_in<DH, true, false>();
    if (e == cudaSuccess) e = opt_in<DH, true, true>();
    if (e == cudaSuccess) e = opt_in<DH, false, false>();
    if (e == cudaSuccess) e = opt_in<DH, false, true>();
    return e;
  }();
  if (opted_in != cudaSuccess) return opted_in;
  const dim3 grid(B * p.H, (p.T + own_rows<DH>() - 1) / own_rows<DH>());
  if (p.bias_si == 0)
    return p.dropout ? launch_pair<DH, true, true>(p, dsum, grid, stream)
                     : launch_pair<DH, true, false>(p, dsum, grid, stream);
  return p.dropout ? launch_pair<DH, false, true>(p, dsum, grid, stream)
                   : launch_pair<DH, false, false>(p, dsum, grid, stream);
}

// The entry point's argument block: the one-sweep kernel's BwdArgs, then the
// address of the [B, H, T] fp32 scratch that holds D_i between the kernels.
struct BwdLongArgs {
  BwdArgs a;
  long long dsum;
};

}  // namespace

extern "C" {

// Longest T the path takes at dh up to 128: the grid's second dimension
// counts 128-row blocks. Above dh = 128 the blocks own 64 rows: half of it.
int attention_bwd_long_max_t() { return 65535 * kOwn; }

// Launches the dQ kernel, then the dK/dV kernel. `raw` is one BwdLongArgs
// block: the tensors as for attention_bwd (attention_bwd.cu), and dsum a
// contiguous [B, H, T] fp32 scratch the wrapper allocates. Where dh is a
// multiple of 4, q, k, v and dout rows must start on 16 bytes (kMisaligned
// otherwise). Returns 0, a Refusal, or the first failing launch's
// cudaError_t.
int attention_bwd_long(const void* raw) {
  BwdLongArgs la;
  memcpy(&la, raw, sizeof la);
  const BwdArgs& a = la.a;
  if (a.B < 1 || a.T < 1 || a.H < 1 || a.D % a.H != 0) return kBadShape;
  const long long dh = a.D / a.H;
  if (long_template_dh((int)dh) == 0) return kBadHeadWidth;
  if (!kPadBuild && dh != long_template_dh((int)dh)) return kBadHeadWidth;  // the padded build's
  if (a.T > 65535LL * (dh > kMaxHeadDim ? own_rows<256>() : kOwn) || a.B * a.H > 2147483647LL)
    return kTooLong;
  if (!rows_aligned(a.q, a.q_sb, a.q_st, dh) || !rows_aligned(a.k, a.k_sb, a.k_st, dh) ||
      !rows_aligned(a.v, a.v_sb, a.v_st, dh) || !rows_aligned(a.dout, a.g_sb, a.g_st, dh))
    return kMisaligned;
  const BwdParams p = bwd_params(a);
  float* dsum = ptr<float>(la.dsum);
  cudaStream_t s = ptr<CUstream_st>(a.stream);
  const int B = (int)a.B;
  switch (long_template_dh((int)dh)) {
    case 8: return (int)launch<8>(p, dsum, B, s);
    case 16: return (int)launch<16>(p, dsum, B, s);
    case 32: return (int)launch<32>(p, dsum, B, s);
    case 64: return (int)launch<64>(p, dsum, B, s);
    case 128: return (int)launch<128>(p, dsum, B, s);
    default: return (int)launch<256>(p, dsum, B, s);
  }
}

}  // extern "C"
