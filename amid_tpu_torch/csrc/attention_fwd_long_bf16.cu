// Fused multi-head attention forward for long sequences in the bf16-operand
// mode, for Hopper (sm_90a): native bf16 products (wgmma m64nNk16
// .f32.bf16.bf16) on 16-bit shared-memory tiles. fp32 in and out.
//
// Replaces amid_tpu/ops/pallas_attention.py::_fwd_kernel with mxu_bf16=True
// (pallas_call in _fused_fwd_impl) on the long path: the same function as
// attention_fwd_long.cu (the fp32 long forward) with every product's
// operands rounded to bf16 and fp32 sums:
//   o = dropout(softmax(Q K^T / sqrt(dh) + bias)) V per head,
// heads packed in D ([B, T, D] in and out), an additive bias of shape
// [1|B, 1, 1|T, T]. An online softmax over the keys in stages of
// kStageKeys: per stage, S = bf16(Q) bf16(K)^T (fp32 sums) scaled and
// biased, the row max m grows to the stage's, the running sum l and O are
// rescaled by exp(m_old - m_new), l += rowsum(exp(S - m)) before rounding
// and dropout, and O += bf16(dropout(exp(S - m))) bf16(V); at the end O / l.
// The stage is the rounding point: the unnormalised exp(S - m) is rounded
// once a stage, so the stage's size is part of the function
// (ops/attention.py::LONG_BF16_STAGE_KEYS mirrors it). When asked it writes
// row_max and row_inv_sum ([B, H, T] fp32) for either backward. The dropout
// keeps element (b, h, i, j) by the counter hash of
// ops/attention.py::dropout_keep_mask, bit for bit. No float atomics; every
// sum is taken in an order fixed by the tile numbers, so two calls give the
// same bits.
//
// Design (attention_long_bf16.cuh has the layout and the products):
//   * A block owns 128 queries of one (b, h), two warpgroups of 64; the
//     query blocks of one head are neighbours in a 1-D grid (block x: head
//     x / n_qb, query block x % n_qb), so that the head's K and V stages are
//     read from L2 by every query block after the first. Its Q rows become
//     the K-major owned tile once; K, V and the bias row stream in stages of
//     kStageKeys keys. Where the operands come from depends on the template
//     width (packed_operands):
//       - dh <= 64: a pre-pass (pack_kernel) rounds q, k and v to bf16 once a
//         call into a scratch the wrapper allocates, [B, H, T_pad, dh_pad] in
//         the tile order wgmma reads (T_pad: T rounded up to 128 rows); a bias
//         that broadcasts over queries is padded to T_pad with -inf beside
//         them. The owned Q lands by one bulk copy, and the stages through a
//         ring of stages() slots, each landed by bulk copies on a full
//         mbarrier. Thread 0 issues every copy: it refills the slot of stage
//         s - 1 at the top of stage s, once both warpgroups have arrived on
//         that slot's empty mbarrier, so it seldom waits; no ninth warp
//         (ptxas serialises wgmma with one).
//       - dh = 128 and 256: each block reads its own Q rows as fp32 once and
//         rounds them (cvt.rn.bf16x2, as the pre-pass does; zeros past T and
//         from dh on) into the owned tile, its loads batched eight 16-byte
//         chunks a thread; the pre-pass packs K and V alone, to T rounded up
//         to a stage (a third less pre-pass traffic than q, k and v to 128-row
//         blocks), and they stream through a ring of two stages as above.
//         K and V rounded in the block instead (no pre-pass) measured slower
//         at dh = 128 in both forms tried, fp32 stages landed by cp.async in a
//         ring of two and rounded in shared memory, or loaded into registers a
//         stage ahead (PERF.md section 6); at dh = 256 a stage's K and
//         V as fp32 are 128 registers a thread beside the output's 128, or 128
//         KB of shared memory beside Q's 64 KB and a packed stage's 64 KB.
//     The rounding in the block gives the bits the pre-pass wrote, so every
//     instance computes what the all-packed design computed, bit for bit.
//   * S = Q K^T: wgmma m64n64k16 with both operands in shared memory (K
//     K-major). P leaves the accumulator as k16 A fragments (two column
//     groups a k-step, cvt.rn.bf16x2) and O += P V is issued one k-step (16
//     keys) at a time with V's tile read MN-major (the transpose
//     immediate), so that one k-step's products run while the next one's
//     exponentials and dropout hash are taken.
//   * Two blocks an SM up to dh = 128 (46-97 KB of shared memory a block;
//     at most 128 registers a thread, of which the output takes 64 at dh =
//     128, where ptxas spills 0-180 bytes): one block's products, waits and
//     first loads overlap the other's exponentials; one at dh = 256. The
//     warpgroups of a block pass no turn between them; each releases a stage
//     on its own.
//   * dh = 256 (template width 256, any dh from 129 to 256; the build with
//     AMID_BF16_WIDE=1, ops/_build.py's VARIANTS, which holds these
//     instances alone so that its nvcc runs beside the others): the owned
//     Q is 64 KB and a stage of 64 keys' K and V another 64 KB, so the ring
//     has two stages (193 KB a block, one block an SM); O is one m64n256
//     accumulator, 128 registers a thread beside S's 32, and O += P V one
//     m64n256k16 a k-step. The stage stays 64 keys: it is the rounding point.
//   * A head of width dh runs at its template width (attention_common.cuh):
//     it is packed or rounded to that width with zero columns, and no output
//     column from dh on is written.
//   * Each instance is compiled for a bias that broadcasts over queries or
//     not and for dropout on or off. A causal [1, 1, T, T] bias is read
//     from device memory (L2) element by element, as in the fp32 build.
//
// Bound on the H100 (data sheet) at B=256, H=4, dh=32, T=1,200: 4*B*H*T*T*dh
// = 1.89e11 operations, 0.191 ms at the 989 TFLOP/s bf16 tensor-core peak,
// against 630 MB of q, k, v, bias read and o written, 0.188 ms at
// 3.35 TB/s: bound by operations. What bounds this design: the
// per-element work on the CUDA cores (scale and bias, the running max, one
// exp, the dropout hash and the conversion: 1.5e9 elements at T=1,200), the
// pre-pass's 0.7 GB, and T padded to the 128-row blocks. At configuration
// (a)'s shape (B=256, H=4, dh=128, T=300): 4.7e10 operations, 0.048 ms at
// the bf16 peak, against 629 MB of q, k, v read and o written, 0.188 ms:
// bound by bytes; this design adds the pre-pass's round trip of K and V
// (0.31 GB read, 0.17 GB written) and the kernel's read of the packed 0.17
// GB (the head's three query blocks re-read it from L2). At configuration
// (d)'s shape (B=256, H=4, dh=256, T=300): 9.4e10 operations, 0.095 ms at
// the bf16 peak, against 1.26 GB of q, k, v read and o written, 0.376 ms:
// bound by bytes; the pre-pass adds 0.63 GB read and 0.34 GB written, the
// kernel 0.34 GB read.

#include <string.h>

#include "attention_long_bf16.cuh"

#ifndef AMID_BF16_WIDE
#define AMID_BF16_WIDE 0
#endif

namespace {

using namespace amid_bf16;

constexpr bool kWideBuild = AMID_BF16_WIDE != 0;  // the template width 256 build alone
constexpr int kStageKeys = 64;  // keys a stage: the online softmax's rounding point

// Q read as fp32 by its block and rounded there (template widths 128, 256)
__host__ __device__ constexpr bool q_inblock(int DH) { return DH >= 128; }
// the inputs the pre-pass packs: q, k and v (dh <= 64), k and v (128, 256)
__host__ __device__ constexpr int packed_operands(int DH) { return q_inblock(DH) ? 2 : 3; }
// rows of a packed head: T rounded up to the 128-row blocks where Q is packed
// (a block's rows land by one bulk copy), else to whole stages
inline long long packed_rows(int DH, long long T) {
  return packed_operands(DH) == 3 ? padded_t(T)
                                  : (T + kStageKeys - 1) / kStageKeys * kStageKeys;
}

// slots of the ring: four; two from dh = 128 (two blocks an SM at dh = 128,
// and at dh = 256 a stage's K and V take 64 KB)
template <int DH>
__host__ __device__ constexpr int stages() {
  return DH >= 128 ? 2 : 4;
}

// blocks an SM: two, for one block's products, waits and first loads to
// overlap the other's exponentials (at dh = 128 the output and the scores
// take 96 of the 128 registers a thread; a few bytes spill); one at dh = 256
template <int DH>
__host__ __device__ constexpr int min_blocks() {
  return DH <= 128 ? 2 : 1;
}

// bytes of a packed stage: K, V ([NS][dh_pad] bf16) and the bias row
template <int DH, bool BCAST>
__host__ __device__ constexpr int stage_bytes() {
  return 2 * Tiles<DH, kStageKeys>::TILE + (BCAST ? kStageKeys * 4 : 0);
}

template <int DH, bool BCAST>
__host__ __device__ constexpr size_t fwd_smem() {
  // the barriers (full and empty a slot, the owned rows'), the owned Q, the ring
  return 128 + Tiles<DH, kStageKeys>::OWN + stages<DH>() * stage_bytes<DH, BCAST>();
}

// The packed operands of one call (the scratch the wrapper allocates); null
// where the block reads the input itself.
struct Packed {
  const __nv_bfloat16 *q, *k, *v;
  const float* bias;  // [rows][Tp] (a bias broadcast over queries, packed K and V), else null
  int Tp;             // rows of a packed head
};

// rows [row0, row0 + ROWS) of a head of width dh (row stride st) rounded to
// bf16 into a packed [ROWS][dh_pad] tile (one 16-byte chunk a thread and
// step, consecutive threads on consecutive chunks); zeros past T and from dh
// on. A thread's loads go out G chunks at a time, so that their latencies
// overlap: 16-byte loads where the head is as wide as its template (its rows
// then start on 16 bytes), else value by value.
template <int DHP, int ROWS>
__device__ __forceinline__ void round_rows(unsigned char* tile, const float* head, long long st,
                                           int row0, int T, int dh, int tid) {
  constexpr int CB = DHP / 8, N = ROWS * CB / kThreads, G = N < 8 ? N : 8;
  static_assert(N * kThreads == ROWS * CB && N % G == 0, "whole chunks a thread");
#pragma unroll
  for (int g = 0; g < N; g += G) {
    float f[G][8];
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const int z = tid + (g + u) * kThreads;
      const int i = row0 + ((z >> 3) / CB) * 8 + (z & 7), c = ((z >> 3) % CB) * 8;
#pragma unroll
      for (int e = 0; e < 8; ++e) f[u][e] = 0.f;
      if (i < T) load8(head + (long long)i * st, c, dh, dh == DHP, f[u]);
    }
#pragma unroll
    for (int u = 0; u < G; ++u)
      reinterpret_cast<uint4*>(tile)[tid + (g + u) * kThreads] = pack8(f[u]);
  }
}

// BCAST: the bias broadcasts over queries (bias_si == 0); DROP: dropout on
template <int DH, bool BCAST, bool DROP>
__global__ void __launch_bounds__(kThreads, min_blocks<DH>())
attention_fwd_long_bf16_kernel(const FwdParams p, const Packed pk) {
  using L = Tiles<DH, kStageKeys>;
  constexpr int NS = kStageKeys, DHP = L::DHP, JS = NS / 8;
  constexpr bool QIN = q_inblock(DH);
  constexpr int STAGE = stage_bytes<DH, BCAST>(), kStages = stages<DH>();
  const int T = p.T, dh = p.dh;

  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // [kStages] a stage landed
  uint64_t* empty = full + kStages;                    // [kStages] a stage read
  uint64_t* qbar = empty + kStages;                    // the owned rows landed
  unsigned char* qs = smem + 128;                      // [128][dh_pad] the block's Q
  unsigned char* ring = qs + L::OWN;                   // kStages x (K, V, the bias row)

  const int tid = threadIdx.x;
  const int n_qb = (T + kOwn - 1) / kOwn;
  const int qb = blockIdx.x % n_qb;
  const int bh = blockIdx.x / n_qb;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int q0 = qb * kOwn;
  const size_t head = (size_t)bh * pk.Tp * DHP;
  const __nv_bfloat16* kp = pk.k + head;
  const __nv_bfloat16* vp = pk.v + head;
  const float* bias_row = BCAST ? pk.bias + (size_t)(p.bias_sb ? b : 0) * pk.Tp : nullptr;
  const float* bias_b = p.bias + b * p.bias_sb;
  const int ns = (T + NS - 1) / NS;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(full + s), 1);
      mbar_init(smem_u32(empty + s), kThreads);
    }
    mbar_init(smem_u32(qbar), 1);
    mbar_init_fence();
  }
  __syncthreads();
  auto issue = [&](int s) {  // stage s into slot s % kStages (packed K and V)
    unsigned char* st = ring + (s % kStages) * STAGE;
    const uint32_t bar = smem_u32(full + s % kStages);
    mbar_expect_tx(bar, STAGE);
    bulk_copy(smem_u32(st), kp + (size_t)s * NS * DHP, L::TILE, bar);
    bulk_copy(smem_u32(st + L::TILE), vp + (size_t)s * NS * DHP, L::TILE, bar);
    if constexpr (BCAST) bulk_copy(smem_u32(st + 2 * L::TILE), bias_row + s * NS, NS * 4, bar);
  };
  if (tid == 0) {
    if constexpr (!QIN) {
      mbar_expect_tx(smem_u32(qbar), L::OWN);
      bulk_copy(smem_u32(qs), pk.q + head + (size_t)q0 * DHP, L::OWN, smem_u32(qbar));
    }
    for (int s = 0; s < kStages && s < ns; ++s) issue(s);
  }
  if constexpr (QIN) {  // the owned rows, rounded here
    round_rows<DHP, kOwn>(qs, p.q + b * p.q_sb + h * dh, p.q_st, q0, T, dh, tid);
    fence_proxy_async();
    __syncthreads();
  }

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
  const uint64_t qa = kmajor_desc<DHP>(qs + wg * L::WG_OWN);

  float o[DHP / 2];
#pragma unroll
  for (int x = 0; x < DHP / 2; ++x) o[x] = 0.f;
  // row max and this thread's part of the row sum, rows rl and rl + 8
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  if constexpr (!QIN) mbar_wait(smem_u32(qbar), 0);

  for (int s = 0; s < ns; ++s) {
    if (tid == 0 && s > 0 && s - 1 + kStages < ns) {
      // both warpgroups released stage s - 1: its slot takes stage s - 1 + kStages
      mbar_wait(smem_u32(empty + (s - 1) % kStages), ((s - 1) / kStages) & 1);
      issue(s - 1 + kStages);
    }
    __syncwarp();
    const int slot = s % kStages;
    const unsigned char* st = ring + slot * STAGE;
    const float* bias_s = reinterpret_cast<const float*>(st + 2 * L::TILE);
    const int j0 = s * NS;
    const uint64_t kb = kmajor_desc<DHP>(st);
    const uint64_t vb = mnmajor_desc<DHP>(st + L::TILE);
    mbar_wait(smem_u32(full + slot), (s / kStages) & 1);

    // S = Q K^T, bf16 operands, fp32 sums
    float sa[NS / 2];
#pragma unroll
    for (int x = 0; x < NS / 2; ++x) sa[x] = 0.f;
    fence_regs(sa);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < L::KSTEPS; ++k) mma_ss<NS>(sa, qa + 16 * k, kb + 16 * k);
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
          sv = fmaf(sa[4 * j + e], p.scale, bias_s[c]);  // a key past T: bias -inf
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
    for (int c = 0; c < DHP / 8; ++c) {
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        o[4 * c + 2 * x] *= al[x];
        o[4 * c + 2 * x + 1] *= al[x];
      }
    }

    // P of 16 keys (column groups 2 kk and 2 kk + 1) as one k16 A fragment,
    // then O += P V (B: the stage's V, MN-major); k-step kk's products run
    // while kk + 1 is computed, its fragment taking turns in two buffers
    uint32_t af[2][4];
    fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < L::RSTEPS; ++kk) {
      float pv[8];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = 2 * kk + jj;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = e >> 1;
          float ev = __expf(sa[4 * j + e] - m[x]);
          l[x] += ev;
          if constexpr (DROP) {
            const uint32_t key = (uint32_t)(j0 + 8 * j + 2 * t4 + (e & 1));
            ev = (mix(key2[x], key) >> 8) >= p.keep_threshold ? ev * p.inv_keep : 0.f;
          }
          pv[4 * jj + e] = ev;
        }
      }
      if (kk >= 2) wgmma_wait<1>();  // k-step kk - 2 is done: its buffer is free
      fence_regs(af[kk & 1]);
      a_frag(pv, af[kk & 1]);
      fence_regs(af[kk & 1]);
      wgmma_fence();
      mma_rs_t<DHP>(o, af[kk & 1], vb + kk * L::RSTEP);
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(af[0]);
    fence_regs(af[1]);
    mbar_arrive(smem_u32(empty + slot));  // this thread is done with the stage
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
  return cudaFuncSetAttribute(attention_fwd_long_bf16_kernel<DH, BCAST, DROP>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)fwd_smem<DH, BCAST>());
}

template <int DH, bool BCAST, bool DROP>
cudaError_t launch_one(const FwdParams& p, const Packed& pk, unsigned blocks,
                       cudaStream_t stream) {
  attention_fwd_long_bf16_kernel<DH, BCAST, DROP>
      <<<blocks, kThreads, fwd_smem<DH, BCAST>(), stream>>>(p, pk);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch(const FwdParams& p, const Packed& pk, int B, cudaStream_t stream) {
  static_assert(min_blocks<DH>() * fwd_smem<DH, true>() <= 232448 &&
                    min_blocks<DH>() * fwd_smem<DH, false>() <= 232448,
                "shared memory of the blocks an SM");
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
  const unsigned blocks = (unsigned)((long long)B * p.H * ((p.T + kOwn - 1) / kOwn));
  if (p.bias_si == 0)
    return p.dropout ? launch_one<DH, true, true>(p, pk, blocks, stream)
                     : launch_one<DH, true, false>(p, pk, blocks, stream);
  return p.dropout ? launch_one<DH, false, true>(p, pk, blocks, stream)
                   : launch_one<DH, false, false>(p, pk, blocks, stream);
}

// The entry point's argument block: the fp32 forward's FwdArgs, then the
// address of the scratch the wrapper allocates (ops/attention.py's
// `_long_bf16_forward_scratch`).
struct FwdLongArgs {
  FwdArgs a;
  long long scratch;
};

}  // namespace

extern "C" {

// Launches the pack pre-pass, the bias rows' padding (a bias that broadcasts
// over queries) and the kernel. `raw` is one FwdLongArgs block: the tensors
// as for attention_fwd_long (attention_fwd_long.cu), then the scratch,
// 16-byte aligned, as the template width dh_pad (dh's, at least 16: 256 for
// dh 129 to 256, the widths of the AMID_BF16_WIDE build, which refuses the
// others, as the other build refuses those) asks: at dh_pad <= 64 packed q,
// k and v, 3 * B * H * T_pad * dh_pad bf16 values (T_pad = T rounded up to
// 128), from dh_pad = 128 on packed k and v, 2 * B * H * T_pad * dh_pad
// (T_pad = T rounded up to 64), each followed, when bias_si == 0, by rows *
// T_pad floats (rows = B where bias_sb != 0, else 1). Where dh is a multiple
// of 4, q, k and v rows must start on 16 bytes (kMisaligned otherwise).
// Returns 0, a Refusal, or the first failing launch's cudaError_t.
int attention_fwd_long(const void* raw) {
  FwdLongArgs la;
  memcpy(&la, raw, sizeof la);
  const FwdArgs& a = la.a;
  if (a.B < 1 || a.T < 1 || a.H < 1 || a.D % a.H != 0) return kBadShape;
  const long long dh = a.D / a.H;
  // this build's widths: 1 to 128, or (AMID_BF16_WIDE) 129 to 256
  if (dh > kMaxLongHeadDim || (long_template_dh((int)dh) == 256) != kWideBuild)
    return kBadHeadWidth;
  if (a.T > 65535LL * kOwn || a.B * a.H * ((a.T + kOwn - 1) / kOwn) > 2147483647LL)
    return kTooLong;
  if (!rows_aligned(a.q, a.q_sb, a.q_st, dh) || !rows_aligned(a.k, a.k_sb, a.k_st, dh) ||
      !rows_aligned(a.v, a.v_sb, a.v_st, dh) || la.scratch % 16 != 0)
    return kMisaligned;
  const FwdParams p = fwd_params(a);
  cudaStream_t s = ptr<CUstream_st>(a.stream);
  const int width = long_template_dh((int)dh);
  const int nops = packed_operands(width), first = 3 - nops;  // k and v alone from 128 on
  const int Tp = (int)packed_rows(width, a.T);
  const long long region = a.B * a.H * Tp * (long long)padded_dh(width);
  __nv_bfloat16* packed = ptr<__nv_bfloat16>(la.scratch);
  const float* src[3] = {p.q, p.k, p.v};
  const long long sb[3] = {a.q_sb, a.k_sb, a.v_sb}, st[3] = {a.q_st, a.k_st, a.v_st};
  launch_pack(src + first, sb + first, st + first, nops, packed, a.B, (int)a.T, (int)a.H,
              (int)dh, s, Tp);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  float* bias_rows = reinterpret_cast<float*>(packed + nops * region);
  if (a.bias_si == 0) {
    const int rows = a.bias_sb ? (int)a.B : 1;
    bias_rows_kernel<<<blocks_for((long long)rows * Tp), 256, 0, s>>>(
        p.bias, a.bias_sb, bias_rows, rows, (int)a.T, Tp);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const Packed pk = {nops == 3 ? packed : nullptr, packed + (nops - 2) * region,
                     packed + (nops - 1) * region, a.bias_si == 0 ? bias_rows : nullptr, Tp};
  const int B = (int)a.B;
#if AMID_BF16_WIDE
  return (int)launch<256>(p, pk, B, s);
#else
  switch (template_dh((int)dh)) {
    case 8: return (int)launch<8>(p, pk, B, s);
    case 16: return (int)launch<16>(p, pk, B, s);
    case 32: return (int)launch<32>(p, pk, B, s);
    case 64: return (int)launch<64>(p, pk, B, s);
    default: return (int)launch<128>(p, pk, B, s);
  }
#endif
}

}  // extern "C"
