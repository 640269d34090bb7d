// Fused multi-head attention forward for long sequences, for Hopper
// (sm_90a): fp32 in and out, products on the tensor cores as wgmma in
// 3xTF32. The same function as attention_fwd.cu (the one-head kernel), for
// any T up to attention_fwd_long_max_t() and at the lengths where it is the
// faster (ops/attention.py::forward_route).
//
// Replaces amid_tpu/ops/pallas_attention.py::_fwd_kernel (pallas_call in
// _fused_fwd_impl) beyond the one-head kernel's reach:
//   o = dropout(softmax(Q K^T / sqrt(dh) + bias)) V per head,
// heads packed in D ([B, T, D] in and out), an additive bias of shape
// [1|B, 1, 1|T, T]. The one-head kernel stages one head's whole K and V in
// a block's shared memory, which at dh=32 holds T up to 800; BERT4Rec with
// InnerComp, InterComp and C2DSR attends over T=1,200 on its views (amazon's
// L=150, doubled by the views, by InnerComp and by InterComp).
//
// Arithmetic: an online softmax over the keys in stages of NS, as the
// one-head kernel's over its chunks of 32. For each stage, S = Q K^T scaled
// and biased (keys past T score -inf), the row max m grows to the stage's,
// the running sum l and the output O are rescaled by exp(m_old - m_new),
// then l += rowsum(exp(S - m)) and O += dropout(exp(S - m)) V; at the end
// O / l. When asked (non-null pointers: a gradient will be wanted) it
// writes row_max m_i (the largest score) and row_inv_sum 1 / l_i, each
// [B, H, T] fp32, apart, as the one-head kernel does: the long and the
// one-sweep backward read them. A fully masked row (every score -1e9)
// averages over its T real keys. The dropout keeps element (b, h, i, j)
// by the counter hash of ops/attention.py::dropout_keep_mask at its real
// (i, j), bit for bit. No float atomics; every sum is taken in an order
// fixed by the tile numbers, so two calls give the same bits.
//
// Design (attention_long.cuh, the same ring as attention_bwd_long.cu's dQ
// kernel): a block owns one (b, h) and 128 query rows, two warpgroups of
// 64, so that a grid of B * H * ceil(T / 128) blocks fills the card (5,120
// at BERT4Rec's B=256, H=4, T=600, where the one-head kernel has 1,024).
//   * Q is split into TF32 halves once a block: into registers as A
//     fragments at dh <= 32, into [128][dh] shared-memory tiles from dh = 64.
//   * K, V and (for a bias broadcast over queries, BERT4Rec's key padding)
//     the bias row stream through a ring of two raw stages of NS keys (64,
//     32 at dh = 64, 16 at dh = 128): every thread issues its cp.async part of a stage and
//     one cp.async.mbarrier.arrive; stage s + 2 is issued once stage s is
//     split. A landed stage is split once into hi and lo: K as [NS][dh] (the
//     B operand of S = Q K^T), V as [dh][NS] in the accumulator's order of
//     each 8 keys (the B operand of O += P V). Shared memory does not grow
//     with T: 34 KB at dh = 16, 67 KB at dh = 32, 132 KB at dh = 64, 197 KB
//     at dh = 128.
//   * A head of width dh runs at its template width DH (attention_common.cuh):
//     its copies zero the columns from dh on, which then add nothing to S and
//     leave O zero there, and no output column from dh on is written. Such
//     a head takes the build with AMID_ATTN_PAD=1 (its own library, dh read
//     at run time); this build takes dh = DH only, a compile-time constant.
//   * S = Q K^T: wgmma m64nNSk8, three a k-step (lo hi, hi lo, hi hi). The
//     softmax runs on the accumulator's registers (a row is one quad's);
//     P is re-laid from the accumulator into A fragments without a shuffle
//     and O += P V is issued 8 keys at a time (wgmma m64nDHk8 from
//     registers), so that one group's products run while the next group's
//     exponentials are taken.
//   * Each instance is compiled for a bias that broadcasts over queries or
//     not and for dropout on or off, so that no element pays for a branch.
//     A causal [1, 1, T, T] bias is read from device memory (L2) element by
//     element.
//
// Bound on the H100 (data sheet) at B=256, H=4, dh=32, T=1,200: 4*B*H*T*T*dh
// = 1.89e11 operations, 0.381 ms at the 495 TFLOP/s TF32 tensor-core peak,
// against 630 MB of q, k, v, bias read and o written, 0.188 ms at
// 3.35 TB/s: bound by operations. This design issues 3 TF32 products for
// each (3xTF32), 1.14 ms at the peak, and pads T to its 128-row blocks
// and NS-key stages. What still holds it back: the two warpgroups split,
// multiply and exponentiate a stage in step, so the tensor cores idle
// while the CUDA cores split the stage and take the exp and the hash per
// element; no producer warp and no second consumer pair to overlap them;
// every block reads all keys, also the causally masked ones.

#include <string.h>

#include "attention_long.cuh"

namespace {

using namespace amid_long;

template <int DH>
constexpr size_t fwd_long_smem() {
  using P = Plan<DH>;
  return sizeof(float) * (2 * P::OWN + 2 * (2 * P::TILE + P::NS) + 2 * P::TILE + 2 * P::TR +
                          P::NS) + 2 * sizeof(uint64_t);
}

// BCAST: the bias broadcasts over queries (bias_si == 0); DROP: dropout on
template <int DH, bool BCAST, bool DROP>
__global__ void __launch_bounds__(kThreads, 1)
attention_fwd_long_kernel(const FwdParams p) {
  using P = Plan<DH>;
  constexpr int NS = P::NS, KS = DH / 8, JS = NS / 8;
  constexpr int RAW = 2 * P::TILE + NS;  // a raw stage: K, V, the bias row
  const int T = p.T, dh = kPadBuild ? p.dh : DH;

  extern __shared__ __align__(128) float smem[];
  float* qhi = smem;             // [128][dh] the block's Q, hi and lo (dh >= 64)
  float* qlo = qhi + P::OWN;
  float* raw = qlo + P::OWN;     // two raw stages
  float* khi = raw + 2 * RAW;    // [NS][dh] a stage's K
  float* klo = khi + P::TILE;
  float* vthi = klo + P::TILE;   // [dh][NS] a stage's V, transposed
  float* vtlo = vthi + P::TR;
  float* bias_s = vtlo + P::TR;  // [NS] the stage's bias row (a bias broadcast over queries)
  uint64_t* full = reinterpret_cast<uint64_t*>(bias_s + NS);  // [2] a raw stage landed

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int q0 = blockIdx.y * kOwn;
  const float* qb = p.q + b * p.q_sb + h * dh;
  const float* kb = p.k + b * p.k_sb + h * dh;
  const float* vb = p.v + b * p.v_sb + h * dh;
  const float* bias_b = p.bias + b * p.bias_sb;
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
  if constexpr (!P::REG_A) load_owned<DH>(qb, p.q_st, q0, T, dh, qhi, qlo, tid);
  fence_proxy_async();
  __syncthreads();

  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int rl = wg * 64 + warp * 16 + g;  // this thread's rows rl, rl + 8 of the block
  const float* brow[2];
  uint32_t key2[2];
  const uint32_t bh_key =
      DROP ? mix(mix(kMixKey0, (uint32_t)*p.seed), (uint32_t)bh + p.bh_offset) : 0u;
#pragma unroll
  for (int x = 0; x < 2; ++x) {  // a row past T reads row T - 1's bias and writes nothing
    const int i = q0 + rl + 8 * x;
    brow[x] = bias_b + (long long)min(i, T - 1) * p.bias_si;
    key2[x] = DROP ? mix(bh_key, (uint32_t)i) : 0u;
  }
  constexpr int KA = P::REG_A ? KS : 1;
  uint32_t qf_hi[KA][4], qf_lo[KA][4];
  if constexpr (P::REG_A) owned_frags<DH>(qb, p.q_st, q0 + rl, T, dh, t4, qf_hi, qf_lo);
  const uint64_t qa_hi = tile_desc<DH>(qhi + wg * 64 * DH);
  const uint64_t qa_lo = tile_desc<DH>(qlo + wg * 64 * DH);
  const uint64_t kb_hi = tile_desc<DH>(khi), kb_lo = tile_desc<DH>(klo);
  const uint64_t vt_hi = tr_desc<DH>(vthi), vt_lo = tr_desc<DH>(vtlo);
  constexpr int kTrStep = 2 * P::TR_LBO / 16;  // a k-step of a [dh][NS] tile, in descriptor units

  float o[DH / 2];
#pragma unroll
  for (int x = 0; x < DH / 2; ++x) o[x] = 0.f;
  // row max and this thread's part of the row sum, rows rl and rl + 8
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int s = 0; s < ns; ++s) {
    const float* r = raw + (s & 1) * RAW;
    const int j0 = s * NS;
    mbar_wait(smem_u32(full + (s & 1)), (s >> 1) & 1);
    split_stage<DH, true, false>(r, khi, klo, nullptr, nullptr, tid);
    split_stage<DH, false, true>(r + P::TILE, nullptr, nullptr, vthi, vtlo, tid);
    if constexpr (BCAST)  // a key past T gets bias -inf: P = 0
      for (int c = tid; c < NS; c += kThreads)
        bias_s[c] = j0 + c < T ? r[2 * P::TILE + c] : -INFINITY;
    fence_proxy_async();
    __syncthreads();  // the split tiles are written and raw stage s % 2 is free
    if (s + 2 < ns) issue(s + 2);

    // S = Q K^T, 3xTF32 (lo hi, hi lo, hi hi a k-step)
    float sa[NS / 2];
#pragma unroll
    for (int x = 0; x < NS / 2; ++x) sa[x] = 0.f;
    fence_regs(sa);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < KS; ++k) {
      if constexpr (P::REG_A) {
        mma3_rs<NS>(sa, qf_hi[k], qf_lo[k], kb_hi + 16 * k, kb_lo + 16 * k);
      } else {
        mma3_ss<NS>(sa, qa_hi + 16 * k, qa_lo + 16 * k, kb_hi + 16 * k, kb_lo + 16 * k);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sa);

    // the scores, scaled and biased, and the stage's row max: element e of
    // column group j is row rl + 8 (e / 2), key 8 j + 2 t + e % 2 of the stage
    float cm[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < JS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = e >> 1;
        const int c = 8 * j + 2 * t4 + (e & 1);
        float sv;
        if constexpr (BCAST) {
          sv = fmaf(sa[4 * j + e], p.scale, bias_s[c]);
        } else {
          const int key = j0 + c;
          sv = key < T ? fmaf(sa[4 * j + e], p.scale, brow[x][key]) : -INFINITY;
        }
        sa[4 * j + e] = sv;
        cm[x] = fmaxf(cm[x], sv);
      }
    }
    // every stage holds a real key, so the new maxima are finite
    float al[2];
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const float mn = fmaxf(m[x], quad_max(cm[x]));
      al[x] = __expf(m[x] - mn);
      m[x] = mn;
      l[x] *= al[x];
    }
#pragma unroll
    for (int c = 0; c < DH / 8; ++c) {
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        o[4 * c + 2 * x] *= al[x];
        o[4 * c + 2 * x + 1] *= al[x];
      }
    }

    // P of 8 keys a column group j, then O += P V (B: the stage's V as
    // [dh][NS]); group j's products run while group j + 1 is computed, its A
    // fragments taking turns in two buffers
    uint32_t ahi[2][4], alo[2][4];
    fence_regs(o);
#pragma unroll
    for (int j = 0; j < JS; ++j) {
      float pv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = e >> 1;
        float ev = __expf(sa[4 * j + e] - m[x]);
        l[x] += ev;
        if constexpr (DROP) {
          const uint32_t key = (uint32_t)(j0 + 8 * j + 2 * t4 + (e & 1));
          ev = (mix(key2[x], key) >> 8) >= p.keep_threshold ? ev * p.inv_keep : 0.f;
        }
        pv[e] = ev;
      }
      if (j >= 2) wgmma_wait<1>();  // group j - 2 is done: its buffer is free
      fence_regs(ahi[j & 1]);
      fence_regs(alo[j & 1]);
      frag(pv, ahi[j & 1], alo[j & 1]);
      fence_regs(ahi[j & 1]);
      fence_regs(alo[j & 1]);
      wgmma_fence();
      mma3_rs<DH>(o, ahi[j & 1], alo[j & 1], vt_hi + j * kTrStep, vt_lo + j * kTrStep);
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs(o);
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      fence_regs(ahi[x]);
      fence_regs(alo[x]);
    }
    __syncthreads();  // the split tiles are read
  }

  float inv[2];
#pragma unroll
  for (int x = 0; x < 2; ++x) inv[x] = 1.f / quad_sum(l[x]);
  const long long out_base = (long long)b * T * p.D + h * dh;
#pragma unroll
  for (int c = 0; c < DH / 8; ++c) {
    const int col = c * 8 + 2 * t4;
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int i = q0 + rl + 8 * x;
      if (i < T)
        store2<DH>(p.out + out_base + (long long)i * p.D, col, dh, o[4 * c + 2 * x] * inv[x],
                   o[4 * c + 2 * x + 1] * inv[x]);
    }
  }
  if (p.row_max != nullptr && t4 == 0) {
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int i = q0 + rl + 8 * x;
      if (i < T) {
        p.row_max[(long long)bh * T + i] = m[x];
        p.row_inv_sum[(long long)bh * T + i] = inv[x];
      }
    }
  }
}

template <int DH, bool BCAST, bool DROP>
cudaError_t opt_in() {
  return cudaFuncSetAttribute(attention_fwd_long_kernel<DH, BCAST, DROP>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)fwd_long_smem<DH>());
}

template <int DH, bool BCAST, bool DROP>
cudaError_t launch_one(const FwdParams& p, dim3 grid, cudaStream_t stream) {
  attention_fwd_long_kernel<DH, BCAST, DROP><<<grid, kThreads, fwd_long_smem<DH>(), stream>>>(p);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch(const FwdParams& p, int B, cudaStream_t stream) {
  static_assert(fwd_long_smem<DH>() <= 232448, "a block's shared memory");
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
  const dim3 grid(B * p.H, (p.T + kOwn - 1) / kOwn);
  if (p.bias_si == 0)
    return p.dropout ? launch_one<DH, true, true>(p, grid, stream)
                     : launch_one<DH, true, false>(p, grid, stream);
  return p.dropout ? launch_one<DH, false, true>(p, grid, stream)
                   : launch_one<DH, false, false>(p, grid, stream);
}

}  // namespace

extern "C" {

// Longest T the path takes: the grid's second dimension counts 128-row blocks.
int attention_fwd_long_max_t() { return 65535 * kOwn; }

// Launches the kernel. `raw` is one FwdArgs block (attention_common.cuh),
// the tensors as for attention_fwd (attention_fwd.cu); where dh is a multiple
// of 4, q, k and v rows must start on 16 bytes (kMisaligned otherwise).
// Returns 0, a Refusal, or the launch's cudaError_t.
int attention_fwd_long(const void* raw) {
  FwdArgs a;
  memcpy(&a, raw, sizeof a);
  if (a.B < 1 || a.T < 1 || a.H < 1 || a.D % a.H != 0) return kBadShape;
  const long long dh = a.D / a.H;
  if (template_dh((int)dh) == 0) return kBadHeadWidth;
  if (!kPadBuild && dh != template_dh((int)dh)) return kBadHeadWidth;  // the padded build's
  if (a.T > attention_fwd_long_max_t() || a.B * a.H > 2147483647LL) return kTooLong;
  if (!rows_aligned(a.q, a.q_sb, a.q_st, dh) || !rows_aligned(a.k, a.k_sb, a.k_st, dh) ||
      !rows_aligned(a.v, a.v_sb, a.v_st, dh))
    return kMisaligned;
  const FwdParams p = fwd_params(a);
  cudaStream_t s = ptr<CUstream_st>(a.stream);
  const int B = (int)a.B;
  switch (template_dh((int)dh)) {
    case 8: return (int)launch<8>(p, B, s);
    case 16: return (int)launch<16>(p, B, s);
    case 32: return (int)launch<32>(p, B, s);
    case 64: return (int)launch<64>(p, B, s);
    default: return (int)launch<128>(p, B, s);
  }
}

}  // extern "C"
