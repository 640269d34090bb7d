// Fused multi-head attention backward for long sequences in the bf16-operand
// mode, for Hopper (sm_90a): native bf16 products (wgmma m64nNk16
// .f32.bf16.bf16) on 16-bit shared-memory tiles. fp32 in and out.
//
// Replaces amid_tpu/ops/pallas_attention.py::_bwd_kernel with mxu_bf16=True
// (pallas_call in _vjp_bwd) on the long path: the same function as
// attention_bwd_long.cu (the fp32 long backward) with every product's
// operands rounded to bf16 and fp32 sums. From the forward's output O and
// row statistics m_i, 1/l_i:
//   P   = exp(S - m) / l,  S = bf16(Q) bf16(K)^T / sqrt(dh) + bias
//   D_i = rowsum(dO o O)_i  (fp32, from the fp32 dO and O)
//   dP  = (bf16(dO) bf16(V)^T) * keep / (1 - rate),  Pd = P * keep / (1 - rate)
//   dS  = P o (dP - D)
//   dV  = bf16(Pd)^T bf16(dO),  dK = bf16(dS)^T bf16(Q) / sqrt(dh),
//   dQ  = bf16(dS) bf16(K) / sqrt(dh)
// with the dropout mask regenerated from the forward's counter hash of
// (seed, b, h, i, j). No [B, H, T, T] block is stored in device memory, no
// float atomics are used, and every sum is taken in an order fixed by the
// tile numbers, so two calls give the same bits.
//
// Design (attention_long_bf16.cuh has the layout and the products): the
// fp32 long backward's two kernels (FlashAttention-2's split), after a
// pre-pass.
//   * Pre-pass: pack_kernel rounds q, k, v and dO to bf16 once a call into
//     [B, H, T_pad, dh_pad] tiles; rows_kernel writes each query row's
//     (m_i, 1/l_i, D_i, dropout key) as one float4 (+inf, 0, 0 past T: P =
//     0), D_i summed in the one-sweep kernel's order, and pads a bias that
//     broadcasts over queries to T_pad with -inf. The fp32 build re-read
//     and re-split every stage once per owned block, with a transposing
//     store of K, Q and dO.
//   * dQ kernel: owns 128 queries (Q and dO land once by bulk copy), streams
//     K, V (and the bias row) through a ring of kStages stages of dq_rows
//     keys. dK/dV kernel: owns 128 keys (K, V), streams Q, dO and the
//     stage's row float4s, kDkdvRows queries a stage. S and dP are computed in both (seven products).
//   * Two warpgroups of 64 owned rows share each stage; thread 0 issues
//     every bulk copy, refilling the slot of stage s - 1 at the top of stage
//     s once both warpgroups have arrived on its empty mbarrier.
//   * S and dP: wgmma m64nNk16 (N = the stage's rows), both operands in
//     shared memory. dS and Pd
//     leave the accumulators as k16 A fragments without a shuffle, and dQ +=
//     dS K, dV += Pd^T dO, dK += dS^T Q read the streamed tile MN-major (the
//     transpose immediate), one k-step (16 streamed rows) at a time, so that
//     one k-step's products run while the next one's elementwise work is
//     done.
//   * Each instance is compiled for a bias that broadcasts over queries or
//     not and for dropout on or off.
//   * dh = 256 (template width 256, any dh from 129 to 256; the build with
//     AMID_BF16_WIDE=1, ops/_build.py's VARIANTS, which holds these
//     instances alone). The dQ kernel keeps its 128 owned queries (Q and dO:
//     128 KB) and streams stages of 32 keys (32 KB of K and V), three in the
//     ring: 225 KB. In the dK/dV kernel dK and dV of 64 keys a warpgroup
//     would take 256 registers a thread, so a block owns 64 keys, which both
//     warpgroups share (attention_bwd_dkdv_bf16_wide_kernel): warpgroup 0
//     computes S^T = K Q^T, hands P^T to warpgroup 1 through shared memory
//     and sums dV += Pd^T dO; warpgroup 1 computes dP^T = V dO^T and sums
//     dK += dS^T Q; each m64n256, 128 registers a thread. The grid of the
//     dK/dV kernel has twice the blocks a head, so T's limit is half.
//   * A head of width dh runs at its template width (attention_common.cuh):
//     the pre-pass packs it to that width with zero columns, D_i sums its dh
//     columns, and no gradient column from dh on is written.
//
// Bound on the H100 (data sheet) at BERT4Rec's shape B=256, H=4, dh=32,
// T=600: 10*B*H*T*T*dh = 118 GFLOP, 0.119 ms at the 989 TFLOP/s bf16
// tensor-core peak, against 550 MB of q, k, v, dO read and dq, dk, dv
// written, 0.164 ms at 3.35 TB/s: bound by bytes. This design issues seven
// products where the function has five, pads T to the 128-row blocks,
// moves the pre-pass's bytes, and does the per-element exp, hash and
// products' conversion twice (once a kernel). At configuration (d)'s shape
// (B=256, H=4, dh=256, T=300): 2.4e11 operations, 0.239 ms at the bf16
// peak, against 2.2 GB of q, k, v, dO read and dq, dk, dv written, 0.657
// ms: bound by bytes.

#include <string.h>

#include "attention_long_bf16.cuh"

#ifndef AMID_BF16_WIDE
#define AMID_BF16_WIDE 0
#endif

namespace {

using namespace amid_bf16;

constexpr bool kWideBuild = AMID_BF16_WIDE != 0;  // the template width 256 build alone
constexpr int kDkdvRows = 32;  // streamed queries a stage of the dK/dV kernel
constexpr int kStages = 3;     // the ring
constexpr int kWideOwn = 64;   // keys a block of the dh = 256 dK/dV kernel owns

// streamed keys a stage of the dQ kernel: 64, 32 at dh = 256 (three stages
// beside the owned Q and dO)
template <int DH>
__host__ __device__ constexpr int dq_rows() {
  return DH == 256 ? 32 : 64;
}

// blocks an SM: registers (at most 128 a thread for two) against latency
template <int DH>
__host__ __device__ constexpr int min_blocks_dq() {
  return DH <= 32 ? 2 : 1;
}
template <int DH>
__host__ __device__ constexpr int min_blocks_dkdv() {
  return DH <= 32 ? 2 : 1;
}

template <int DH, bool BCAST>
__host__ __device__ constexpr int dq_stage_bytes() {
  return 2 * Tiles<DH, dq_rows<DH>()>::TILE + (BCAST ? dq_rows<DH>() * 4 : 0);
}

template <int DH>
__host__ __device__ constexpr int dkdv_stage_bytes() {
  return 2 * Tiles<DH, kDkdvRows>::TILE + kDkdvRows * 16;
}

template <int DH, bool BCAST>
__host__ __device__ constexpr size_t dq_smem() {
  return 128 + 2 * Tiles<DH, dq_rows<DH>()>::OWN + kStages * dq_stage_bytes<DH, BCAST>();
}

// the dh = 256 kernel: 64 owned keys' K and V, the two P^T buffers, the ring
template <int DH>
__host__ __device__ constexpr size_t dkdv_smem() {
  return DH == 256 ? 128 + 2 * Tiles<DH, kDkdvRows>::WG_OWN + 2 * kDkdvRows / 2 * 128 * 4 +
                         kStages * dkdv_stage_bytes<DH>()
                   : 128 + 2 * Tiles<DH, kDkdvRows>::OWN + kStages * dkdv_stage_bytes<DH>();
}

// The packed operands of one call (the scratch the wrapper allocates).
struct Packed {
  const __nv_bfloat16 *q, *k, *v, *g;
  const float4* rows;  // [B, H, T_pad]: m, 1/l, D, the dropout key's bits
  const float* bias;   // [rows][T_pad] (a bias broadcast over queries), else null
  int Tp;
};

// Each query row's float4 (m_i, 1/l_i, D_i, the row's dropout key
// mix(mix(mix(K0, seed), bh + row_offset * H), i)) for rows i < T_pad of every (b, h); +inf,
// 0, 0 past T. One thread a 16-byte chunk of the row's dO and O (two at
// dh = 256, 128 columns apart): DH / 4 threads a row (32 at dh = 256),
// consecutive along it, so a warp reads whole rows (a chunk from column dh
// on reads zeros; at a dh not a multiple of 4 a chunk is read value by
// value). D_i is each chunk's four products summed in order (a thread's two
// chunks added), then the threads' sums added by a butterfly of shuffles: a
// fixed order, the same bits in every lane.
template <int DH>
__global__ void rows_kernel(const BwdParams p, float4* __restrict__ rows, int Tp, long long n) {
  constexpr int V = DH > 128 ? 2 : 1;  // chunks a thread
  constexpr int C = DH / (4 * V);      // threads a row: at most a warp
  const uint32_t seed_key = p.dropout ? mix(kMixKey0, (uint32_t)*p.seed) : 0u;
  const long long total = n * C, span = (long long)gridDim.x * blockDim.x;
  // the bound is the block's, so every lane of a warp reaches the shuffles
  for (long long base = (long long)blockIdx.x * blockDim.x; base < total; base += span) {
    const long long e = base + threadIdx.x;
    const long long r = e / C;  // the row: bh * T_pad + i
    const int c = (int)(e - r * C);
    const long long bh = r / Tp;
    const int i = (int)(r - bh * Tp);
    const long long b = bh / p.H, h = bh - b * p.H;
    const bool real = e < total && i < p.T;
    float d = 0.f;
#pragma unroll
    for (int w = 0; w < V; ++w) {
      const int col = 4 * (c + w * C);
      if (real && col < p.dh) {
        const float* gp = p.dout + b * p.g_sb + i * p.g_st + h * p.dh + col;
        const float* op = p.out + b * p.o_sb + i * p.o_st + h * p.dh + col;
        float4 g, o;
        if ((p.dh & 3) == 0) {
          g = __ldg(reinterpret_cast<const float4*>(gp));
          o = __ldg(reinterpret_cast<const float4*>(op));
        } else {
          float gv[4], ov[4];
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const bool in = col + x < p.dh;
            gv[x] = in ? __ldg(gp + x) : 0.f;
            ov[x] = in ? __ldg(op + x) : 0.f;
          }
          g = make_float4(gv[0], gv[1], gv[2], gv[3]);
          o = make_float4(ov[0], ov[1], ov[2], ov[3]);
        }
        const float chunk = fmaf(g.w, o.w, fmaf(g.z, o.z, fmaf(g.y, o.y, g.x * o.x)));
        d = w == 0 ? chunk : d + chunk;
      }
    }
#pragma unroll
    for (int w = C / 2; w >= 1; w >>= 1) d += __shfl_xor_sync(0xffffffffu, d, w);
    if (e < total && c == 0) {
      float4 out = make_float4(INFINITY, 0.f, 0.f, 0.f);
      if (real) out = make_float4(p.row_max[bh * p.T + i], p.row_inv_sum[bh * p.T + i], d, 0.f);
      if (p.dropout)
        out.w = __uint_as_float(mix(mix(seed_key, (uint32_t)bh + p.bh_offset), (uint32_t)i));
      rows[r] = out;
    }
  }
}

// BCAST: the bias broadcasts over queries (bias_si == 0); DROP: dropout on
template <int DH, bool BCAST, bool DROP>
__global__ void __launch_bounds__(kThreads, min_blocks_dq<DH>())
attention_bwd_dq_bf16_kernel(const BwdParams p, const Packed pk) {
  constexpr int NS = dq_rows<DH>();
  using L = Tiles<DH, NS>;
  constexpr int DHP = L::DHP;
  constexpr int STAGE = dq_stage_bytes<DH, BCAST>();
  const int T = p.T, dh = p.dh;

  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // [kStages] a stage landed
  uint64_t* empty = full + kStages;                    // [kStages] a stage read
  uint64_t* obar = empty + kStages;                    // the owned rows landed
  unsigned char* qs = smem + 128;                      // [128][dh_pad] the block's Q
  unsigned char* gs = qs + L::OWN;                     // [128][dh_pad] the block's dO
  unsigned char* ring = gs + L::OWN;                   // kStages x (K, V, the bias row)

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int q0 = blockIdx.y * kOwn;
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
    mbar_init(smem_u32(obar), 1);
    mbar_init_fence();
  }
  __syncthreads();
  auto issue = [&](int s) {  // stage s into slot s % kStages
    unsigned char* st = ring + (s % kStages) * STAGE;
    const uint32_t bar = smem_u32(full + s % kStages);
    mbar_expect_tx(bar, STAGE);
    bulk_copy(smem_u32(st), kp + (size_t)s * NS * DHP, L::TILE, bar);
    bulk_copy(smem_u32(st + L::TILE), vp + (size_t)s * NS * DHP, L::TILE, bar);
    if constexpr (BCAST) bulk_copy(smem_u32(st + 2 * L::TILE), bias_row + s * NS, NS * 4, bar);
  };
  if (tid == 0) {
    mbar_expect_tx(smem_u32(obar), 2 * L::OWN);
    bulk_copy(smem_u32(qs), pk.q + head + (size_t)q0 * DHP, L::OWN, smem_u32(obar));
    bulk_copy(smem_u32(gs), pk.g + head + (size_t)q0 * DHP, L::OWN, smem_u32(obar));
    for (int s = 0; s < kStages && s < ns; ++s) issue(s);
  }

  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int rl = wg * 64 + warp * 16 + g;  // this thread's rows rl, rl + 8 of the block
  int i2[2];
  float m2[2], l2[2], d2[2];
  uint32_t key2[2];
#pragma unroll
  for (int x = 0; x < 2; ++x) {  // a row past T has m = inf: P = 0
    const int i = q0 + rl + 8 * x;
    const float4 r = pk.rows[(size_t)bh * pk.Tp + i];
    i2[x] = min(i, T - 1);
    m2[x] = r.x;
    l2[x] = r.y;
    d2[x] = r.z;
    key2[x] = __float_as_uint(r.w);
  }
  const uint64_t qa = kmajor_desc<DHP>(qs + wg * L::WG_OWN);
  const uint64_t ga = kmajor_desc<DHP>(gs + wg * L::WG_OWN);

  float dq[DHP / 2];
#pragma unroll
  for (int x = 0; x < DHP / 2; ++x) dq[x] = 0.f;
  mbar_wait(smem_u32(obar), 0);

  for (int s = 0; s < ns; ++s) {
    if (tid == 0 && s > 0 && s - 1 + kStages < ns) {
      mbar_wait(smem_u32(empty + (s - 1) % kStages), ((s - 1) / kStages) & 1);
      issue(s - 1 + kStages);
    }
    __syncwarp();
    const int slot = s % kStages;
    const unsigned char* st = ring + slot * STAGE;
    const float* bias_s = reinterpret_cast<const float*>(st + 2 * L::TILE);
    const int j0 = s * NS;
    const uint64_t kb = kmajor_desc<DHP>(st);
    const uint64_t vb = kmajor_desc<DHP>(st + L::TILE);
    const uint64_t kt = mnmajor_desc<DHP>(st);
    mbar_wait(smem_u32(full + slot), (s / kStages) & 1);

    // S = Q K^T and dP = dO V^T, bf16 operands, fp32 sums
    float sa[NS / 2], pa[NS / 2];
#pragma unroll
    for (int x = 0; x < NS / 2; ++x) sa[x] = pa[x] = 0.f;
    fence_regs(sa);
    fence_regs(pa);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < L::KSTEPS; ++k) {
      mma_ss<NS>(sa, qa + 16 * k, kb + 16 * k);
      mma_ss<NS>(pa, ga + 16 * k, vb + 16 * k);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sa);
    fence_regs(pa);

    // dS element by element, then dQ += dS K (B: the stage's K, MN-major),
    // one k16 step (column groups 2 kk, 2 kk + 1) at a time: element e of
    // group j is query rl + 8 (e / 2), key 8 j + 2 t + e % 2 of the stage
    uint32_t af[2][4];
    fence_regs(dq);
#pragma unroll
    for (int kk = 0; kk < L::RSTEPS; ++kk) {
      float ds[8];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = 2 * kk + jj;
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
          ds[4 * jj + e] = pv * (dpv - d2[x]);
        }
      }
      if (kk >= 2) wgmma_wait<1>();  // k-step kk - 2 is done: its buffer is free
      fence_regs(af[kk & 1]);
      a_frag(ds, af[kk & 1]);
      fence_regs(af[kk & 1]);
      wgmma_fence();
      mma_rs_t<DHP>(dq, af[kk & 1], kt + kk * L::RSTEP);
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs(dq);
    fence_regs(af[0]);
    fence_regs(af[1]);
    mbar_arrive(smem_u32(empty + slot));
  }

  const long long out_base = (long long)b * T * p.D + h * dh;
#pragma unroll
  for (int c = 0; c < DH / 8; ++c) {
    const int col = c * 8 + 2 * t4;
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
__global__ void __launch_bounds__(kThreads, min_blocks_dkdv<DH>())
attention_bwd_dkdv_bf16_kernel(const BwdParams p, const Packed pk) {
  using L = Tiles<DH, kDkdvRows>;
  constexpr int NS = kDkdvRows, DHP = L::DHP;
  constexpr int STAGE = dkdv_stage_bytes<DH>();
  const int T = p.T, dh = p.dh;

  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kStages;
  uint64_t* obar = empty + kStages;
  unsigned char* ks = smem + 128;     // [128][dh_pad] the block's K
  unsigned char* vs = ks + L::OWN;    // [128][dh_pad] the block's V
  unsigned char* ring = vs + L::OWN;  // kStages x (Q, dO, the rows' float4s)

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int k0 = blockIdx.y * kOwn;
  const size_t head = (size_t)bh * pk.Tp * DHP;
  const __nv_bfloat16* qp = pk.q + head;
  const __nv_bfloat16* gp = pk.g + head;
  const float4* rows = pk.rows + (size_t)bh * pk.Tp;
  const float* bias_b = p.bias + b * p.bias_sb;
  const int ns = (T + NS - 1) / NS;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(full + s), 1);
      mbar_init(smem_u32(empty + s), kThreads);
    }
    mbar_init(smem_u32(obar), 1);
    mbar_init_fence();
  }
  __syncthreads();
  auto issue = [&](int s) {
    unsigned char* st = ring + (s % kStages) * STAGE;
    const uint32_t bar = smem_u32(full + s % kStages);
    mbar_expect_tx(bar, STAGE);
    bulk_copy(smem_u32(st), qp + (size_t)s * NS * DHP, L::TILE, bar);
    bulk_copy(smem_u32(st + L::TILE), gp + (size_t)s * NS * DHP, L::TILE, bar);
    bulk_copy(smem_u32(st + 2 * L::TILE), rows + s * NS, NS * 16, bar);
  };
  if (tid == 0) {
    mbar_expect_tx(smem_u32(obar), 2 * L::OWN);
    bulk_copy(smem_u32(ks), pk.k + head + (size_t)k0 * DHP, L::OWN, smem_u32(obar));
    bulk_copy(smem_u32(vs), pk.v + head + (size_t)k0 * DHP, L::OWN, smem_u32(obar));
    for (int s = 0; s < kStages && s < ns; ++s) issue(s);
  }

  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int rl = wg * 64 + warp * 16 + g;  // this thread's key rows rl, rl + 8 of the block
  int j2[2];
  float bk[2];
#pragma unroll
  for (int x = 0; x < 2; ++x) {  // a key past T gets bias -inf (BCAST) and writes nothing
    const int j = k0 + rl + 8 * x;
    j2[x] = j;
    bk[x] = BCAST ? pk.bias[(size_t)(p.bias_sb ? b : 0) * pk.Tp + j] : 0.f;
  }
  const uint64_t ka = kmajor_desc<DHP>(ks + wg * L::WG_OWN);
  const uint64_t va = kmajor_desc<DHP>(vs + wg * L::WG_OWN);

  float dk[DHP / 2], dv[DHP / 2];
#pragma unroll
  for (int x = 0; x < DHP / 2; ++x) dk[x] = dv[x] = 0.f;
  mbar_wait(smem_u32(obar), 0);

  for (int s = 0; s < ns; ++s) {
    if (tid == 0 && s > 0 && s - 1 + kStages < ns) {
      mbar_wait(smem_u32(empty + (s - 1) % kStages), ((s - 1) / kStages) & 1);
      issue(s - 1 + kStages);
    }
    __syncwarp();
    const int slot = s % kStages;
    const unsigned char* st = ring + slot * STAGE;
    const float4* rows_s = reinterpret_cast<const float4*>(st + 2 * L::TILE);
    const int s0 = s * NS;
    const uint64_t qb = kmajor_desc<DHP>(st);
    const uint64_t gb = kmajor_desc<DHP>(st + L::TILE);
    const uint64_t qt = mnmajor_desc<DHP>(st);
    const uint64_t gt = mnmajor_desc<DHP>(st + L::TILE);
    mbar_wait(smem_u32(full + slot), (s / kStages) & 1);

    // S^T = K Q^T and dP^T = V dO^T: keys in rows, the stage's queries in columns
    float sa[NS / 2], pa[NS / 2];
#pragma unroll
    for (int x = 0; x < NS / 2; ++x) sa[x] = pa[x] = 0.f;
    fence_regs(sa);
    fence_regs(pa);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < L::KSTEPS; ++k) {
      mma_ss<NS>(sa, ka + 16 * k, qb + 16 * k);
      mma_ss<NS>(pa, va + 16 * k, gb + 16 * k);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sa);
    fence_regs(pa);

    // Pd and dS element by element, then dV += Pd^T dO and dK += dS^T Q (B:
    // the stage's dO and Q, MN-major), one k16 step at a time: element e of
    // group j is key rl + 8 (e / 2), query 8 j + 2 t + e % 2 of the stage
    uint32_t pf[2][4], sf[2][4];
    fence_regs(dk);
    fence_regs(dv);
#pragma unroll
    for (int kk = 0; kk < L::RSTEPS; ++kk) {
      float pd[8], ds[8];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = 2 * kk + jj;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = e >> 1;
          const int c = 8 * j + 2 * t4 + (e & 1);
          const int i = s0 + c;
          const int key = j2[x];
          const float4 rv = rows_s[c];  // m, 1/l, D, the row's dropout key
          const float bv =
              BCAST ? bk[x] : bias_b[min(i, T - 1) * p.bias_si + min(key, T - 1)];
          const float pv = __expf(fmaf(sa[4 * j + e], p.scale, bv) - rv.x) * rv.y;
          float kf = 1.f;
          if constexpr (DROP)
            kf = (mix(__float_as_uint(rv.w), (uint32_t)key) >> 8) >= p.keep_threshold
                     ? p.inv_keep
                     : 0.f;
          pd[4 * jj + e] = DROP ? pv * kf : pv;
          ds[4 * jj + e] = pv * ((DROP ? pa[4 * j + e] * kf : pa[4 * j + e]) - rv.z);
        }
      }
      const int u = kk & 1;
      if (kk >= 2) wgmma_wait<1>();  // k-step kk - 2 is done: its buffers are free
      fence_regs(pf[u]);
      fence_regs(sf[u]);
      a_frag(pd, pf[u]);
      a_frag(ds, sf[u]);
      fence_regs(pf[u]);
      fence_regs(sf[u]);
      wgmma_fence();
      mma_rs_t<DHP>(dv, pf[u], gt + kk * L::RSTEP);
      mma_rs_t<DHP>(dk, sf[u], qt + kk * L::RSTEP);
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs(dk);
    fence_regs(dv);
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      fence_regs(pf[x]);
      fence_regs(sf[x]);
    }
    mbar_arrive(smem_u32(empty + slot));
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

// dh = 256 (header, "dh = 256"): the block owns kWideOwn keys, which both
// warpgroups share; warpgroup 0 computes S^T = K Q^T, hands P^T (before the
// dropout) to warpgroup 1 through shared memory and sums dV += Pd^T dO;
// warpgroup 1 computes dP^T = V dO^T and sums dK += dS^T Q, each over all
// 256 columns. The two sides run the same code on their own operands: each
// element's factor is Pd = P (1 kf - 0) on warpgroup 0 and dS = P (dP kf -
// D) on warpgroup 1, the arithmetic of the other widths' kernel.
template <bool BCAST, bool DROP>
__global__ void __launch_bounds__(kThreads, 1)
attention_bwd_dkdv_bf16_wide_kernel(const BwdParams p, const Packed pk) {
  constexpr int DH = 256;
  using L = Tiles<DH, kDkdvRows>;
  constexpr int NS = kDkdvRows, DHP = L::DHP, HALF = NS / 2;
  constexpr int STAGE = dkdv_stage_bytes<DH>();
  const int T = p.T, dh = p.dh;

  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kStages;
  uint64_t* obar = empty + kStages;
  unsigned char* ks = smem + 128;        // [64][dh_pad] the block's K
  unsigned char* vs = ks + L::WG_OWN;    // [64][dh_pad] the block's V
  // [2][HALF][128]: P^T of a stage, warpgroup 0 to 1, in two buffers that
  // take turns (a thread's values 128 floats apart: no bank conflict)
  float* xchg = reinterpret_cast<float*>(vs + L::WG_OWN);
  unsigned char* ring = reinterpret_cast<unsigned char*>(xchg + 2 * HALF * 128);

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int k0 = blockIdx.y * kWideOwn;
  const size_t head = (size_t)bh * pk.Tp * DHP;
  const __nv_bfloat16* qp = pk.q + head;
  const __nv_bfloat16* gp = pk.g + head;
  const float4* rows = pk.rows + (size_t)bh * pk.Tp;
  const float* bias_b = p.bias + b * p.bias_sb;
  const int ns = (T + NS - 1) / NS;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(full + s), 1);
      mbar_init(smem_u32(empty + s), kThreads);
    }
    mbar_init(smem_u32(obar), 1);
    mbar_init_fence();
  }
  __syncthreads();
  auto issue = [&](int s) {
    unsigned char* st = ring + (s % kStages) * STAGE;
    const uint32_t bar = smem_u32(full + s % kStages);
    mbar_expect_tx(bar, STAGE);
    bulk_copy(smem_u32(st), qp + (size_t)s * NS * DHP, L::TILE, bar);
    bulk_copy(smem_u32(st + L::TILE), gp + (size_t)s * NS * DHP, L::TILE, bar);
    bulk_copy(smem_u32(st + 2 * L::TILE), rows + s * NS, NS * 16, bar);
  };
  if (tid == 0) {
    mbar_expect_tx(smem_u32(obar), 2 * L::WG_OWN);
    bulk_copy(smem_u32(ks), pk.k + head + (size_t)k0 * DHP, L::WG_OWN, smem_u32(obar));
    bulk_copy(smem_u32(vs), pk.v + head + (size_t)k0 * DHP, L::WG_OWN, smem_u32(obar));
    for (int s = 0; s < kStages && s < ns; ++s) issue(s);
  }

  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3, wt = tid & 127;
  const int rl = warp * 16 + g;  // this thread's key rows rl, rl + 8 of the block
  const bool sums_dv = wg == 0;  // else dK
  int j2[2];
  float bk[2];
#pragma unroll
  for (int x = 0; x < 2; ++x) {  // a key past T gets bias -inf (BCAST) and writes nothing
    const int j = k0 + rl + 8 * x;
    j2[x] = j;
    bk[x] = BCAST ? pk.bias[(size_t)(p.bias_sb ? b : 0) * pk.Tp + j] : 0.f;
  }
  // A of this warpgroup's scores: K (S^T) or V (dP^T)
  const uint64_t oa = kmajor_desc<DHP>(sums_dv ? ks : vs);

  float acc[DHP / 2];  // dV (warpgroup 0) or dK (warpgroup 1)
#pragma unroll
  for (int x = 0; x < DHP / 2; ++x) acc[x] = 0.f;
  mbar_wait(smem_u32(obar), 0);

  for (int s = 0; s < ns; ++s) {
    if (tid == 0 && s > 0 && s - 1 + kStages < ns) {
      mbar_wait(smem_u32(empty + (s - 1) % kStages), ((s - 1) / kStages) & 1);
      issue(s - 1 + kStages);
    }
    __syncwarp();
    const int slot = s % kStages;
    const unsigned char* st = ring + slot * STAGE;
    const float4* rows_s = reinterpret_cast<const float4*>(st + 2 * L::TILE);
    const int s0 = s * NS;
    // B of the scores: the stage's Q (S^T) or dO (dP^T), K-major; B of the
    // sum: its dO (dV) or Q (dK), MN-major
    const uint64_t sb = kmajor_desc<DHP>(sums_dv ? st : st + L::TILE);
    const uint64_t tb = mnmajor_desc<DHP>(sums_dv ? st + L::TILE : st);
    mbar_wait(smem_u32(full + slot), (s / kStages) & 1);

    // S^T = K Q^T (warpgroup 0) or dP^T = V dO^T (warpgroup 1): keys in
    // rows, the stage's queries in columns
    float sa[HALF];
#pragma unroll
    for (int x = 0; x < HALF; ++x) sa[x] = 0.f;
    fence_regs(sa);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < L::KSTEPS; ++k) mma_ss<NS>(sa, oa + 16 * k, sb + 16 * k);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sa);

    // P^T from warpgroup 0 to the same thread of warpgroup 1: element e of
    // group j is key rl + 8 (e / 2), query 8 j + 2 t + e % 2 of the stage
    float* xb = xchg + (s & 1) * HALF * 128;
    float pt[HALF];
    if (sums_dv) {
#pragma unroll
      for (int j = 0; j < NS / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = e >> 1;
          const int i = s0 + 8 * j + 2 * t4 + (e & 1);
          const int key = j2[x];
          const float4 rv = rows_s[8 * j + 2 * t4 + (e & 1)];
          const float bv =
              BCAST ? bk[x] : bias_b[min(i, T - 1) * p.bias_si + min(key, T - 1)];
          pt[4 * j + e] = __expf(fmaf(sa[4 * j + e], p.scale, bv) - rv.x) * rv.y;
          xb[(4 * j + e) * 128 + wt] = pt[4 * j + e];
        }
      }
    }
    __syncthreads();  // P^T is written (and the buffer's turn before it read)
    if (!sums_dv) {
#pragma unroll
      for (int x = 0; x < HALF; ++x) pt[x] = xb[x * 128 + wt];
    }

    // Pd (warpgroup 0) or dS (1) element by element, then the sum, one k16
    // step (column groups 2 kk, 2 kk + 1) at a time
    uint32_t af[2][4];
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < L::RSTEPS; ++kk) {
      float av[8];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = 2 * kk + jj;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = e >> 1;
          const float4 rv = rows_s[8 * j + 2 * t4 + (e & 1)];
          const float dp = sums_dv ? 1.f : sa[4 * j + e];
          const float dsub = sums_dv ? 0.f : rv.z;
          float kf = 1.f;
          if constexpr (DROP)
            kf = (mix(__float_as_uint(rv.w), (uint32_t)j2[x]) >> 8) >= p.keep_threshold
                     ? p.inv_keep
                     : 0.f;
          av[4 * jj + e] = pt[4 * j + e] * ((DROP ? dp * kf : dp) - dsub);
        }
      }
      const int u = kk & 1;
      if (kk >= 2) wgmma_wait<1>();  // k-step kk - 2 is done: its buffer is free
      fence_regs(af[u]);
      a_frag(av, af[u]);
      fence_regs(af[u]);
      wgmma_fence();
      mma_rs_t<DHP>(acc, af[u], tb + kk * L::RSTEP);
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(af[0]);
    fence_regs(af[1]);
    mbar_arrive(smem_u32(empty + slot));
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

// the dK/dV kernel of a head width, and the keys a block of it owns
template <int DH, bool BCAST, bool DROP>
constexpr auto dkdv_kernel() {
  if constexpr (DH == 256)
    return attention_bwd_dkdv_bf16_wide_kernel<BCAST, DROP>;
  else
    return attention_bwd_dkdv_bf16_kernel<DH, BCAST, DROP>;
}
template <int DH>
constexpr int dkdv_own() {
  return DH == 256 ? kWideOwn : kOwn;
}

template <int DH, bool BCAST, bool DROP>
cudaError_t opt_in() {
  cudaError_t e = cudaFuncSetAttribute(attention_bwd_dq_bf16_kernel<DH, BCAST, DROP>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)dq_smem<DH, BCAST>());
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(dkdv_kernel<DH, BCAST, DROP>(),
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dkdv_smem<DH>());
}

template <int DH, bool BCAST, bool DROP>
cudaError_t launch_pair(const BwdParams& p, const Packed& pk, int bh, cudaStream_t stream) {
  attention_bwd_dq_bf16_kernel<DH, BCAST, DROP>
      <<<dim3(bh, (p.T + kOwn - 1) / kOwn), kThreads, dq_smem<DH, BCAST>(), stream>>>(p, pk);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dkdv_kernel<DH, BCAST, DROP>()<<<dim3(bh, (p.T + dkdv_own<DH>() - 1) / dkdv_own<DH>()),
                                   kThreads, dkdv_smem<DH>(), stream>>>(p, pk);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch(const BwdParams& p, const Packed& pk, int B, cudaStream_t stream) {
  const long long n_rows = (long long)B * p.H * pk.Tp;
  rows_kernel<DH><<<blocks_for(n_rows * (DH > 128 ? 32 : DH / 4)), 256, 0, stream>>>(
      p, const_cast<float4*>(pk.rows), pk.Tp, n_rows);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  static_assert(min_blocks_dq<DH>() * dq_smem<DH, true>() <= 232448 &&
                    min_blocks_dkdv<DH>() * dkdv_smem<DH>() <= 232448,
                "shared memory of the blocks an SM");
  static const cudaError_t opted_in = [] {
    cudaError_t e = opt_in<DH, true, false>();
    if (e == cudaSuccess) e = opt_in<DH, true, true>();
    if (e == cudaSuccess) e = opt_in<DH, false, false>();
    if (e == cudaSuccess) e = opt_in<DH, false, true>();
    return e;
  }();
  if (opted_in != cudaSuccess) return opted_in;
  const int bh = B * p.H;
  if (p.bias_si == 0)
    return p.dropout ? launch_pair<DH, true, true>(p, pk, bh, stream)
                     : launch_pair<DH, true, false>(p, pk, bh, stream);
  return p.dropout ? launch_pair<DH, false, true>(p, pk, bh, stream)
                   : launch_pair<DH, false, false>(p, pk, bh, stream);
}

// The entry point's argument block: the fp32 backward's BwdArgs, then the
// address of the scratch the wrapper allocates.
struct BwdLongArgs {
  BwdArgs a;
  long long scratch;
};

}  // namespace

extern "C" {

// Launches the pre-pass (pack_kernel, rows_kernel and, for a bias that
// broadcasts over queries, its rows' padding), then the dQ kernel and the
// dK/dV kernel. `raw` is one BwdLongArgs block: the tensors as for
// attention_bwd (attention_bwd.cu), then the scratch: 4 * B * H * T_pad *
// dh_pad bf16 values (q, k, v, dout; T_pad = T rounded up to 128, dh_pad =
// dh's template width, at least 16: 256 for dh 129 to 256, the widths of the
// AMID_BF16_WIDE build, which refuses the others, as the other build refuses
// those; there T is at most 65,535 * 64), B * H * T_pad float4s, and, when
// bias_si == 0, rows * T_pad floats (rows = B where bias_sb != 0, else 1),
// 16-byte aligned. Where dh is a multiple of 4, q, k, v, out and dout rows
// must start on 16 bytes (kMisaligned otherwise). Returns 0, a Refusal, or
// the first failing launch's cudaError_t.
int attention_bwd_long(const void* raw) {
  BwdLongArgs la;
  memcpy(&la, raw, sizeof la);
  const BwdArgs& a = la.a;
  if (a.B < 1 || a.T < 1 || a.H < 1 || a.D % a.H != 0) return kBadShape;
  const long long dh = a.D / a.H;
  // this build's widths: 1 to 128, or (AMID_BF16_WIDE) 129 to 256
  if (dh > kMaxLongHeadDim || (long_template_dh((int)dh) == 256) != kWideBuild)
    return kBadHeadWidth;
  if (a.T > 65535LL * (kWideBuild ? kWideOwn : kOwn) || a.B * a.H > 2147483647LL)
    return kTooLong;
  if (!rows_aligned(a.q, a.q_sb, a.q_st, dh) || !rows_aligned(a.k, a.k_sb, a.k_st, dh) ||
      !rows_aligned(a.v, a.v_sb, a.v_st, dh) || !rows_aligned(a.dout, a.g_sb, a.g_st, dh) ||
      !rows_aligned(a.out, a.o_sb, a.o_st, dh) || la.scratch % 16 != 0)
    return kMisaligned;
  const BwdParams p = bwd_params(a);
  cudaStream_t s = ptr<CUstream_st>(a.stream);
  const int Tp = (int)padded_t(a.T);
  const long long region = a.B * a.H * Tp * padded_dh(long_template_dh((int)dh));
  __nv_bfloat16* packed = ptr<__nv_bfloat16>(la.scratch);
  const float* src[4] = {p.q, p.k, p.v, p.dout};
  const long long sb[4] = {a.q_sb, a.k_sb, a.v_sb, a.g_sb};
  const long long st[4] = {a.q_st, a.k_st, a.v_st, a.g_st};
  launch_pack(src, sb, st, 4, packed, a.B, (int)a.T, (int)a.H, (int)dh, s);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  float4* rows = reinterpret_cast<float4*>(packed + 4 * region);  // written by launch<DH>
  float* bias_rows = reinterpret_cast<float*>(rows + a.B * a.H * Tp);
  if (a.bias_si == 0) {
    const int nb = a.bias_sb ? (int)a.B : 1;
    bias_rows_kernel<<<blocks_for((long long)nb * Tp), 256, 0, s>>>(p.bias, a.bias_sb, bias_rows,
                                                                     nb, (int)a.T, Tp);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const Packed pk = {packed, packed + region, packed + 2 * region, packed + 3 * region, rows,
                     a.bias_si == 0 ? bias_rows : nullptr, Tp};
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
