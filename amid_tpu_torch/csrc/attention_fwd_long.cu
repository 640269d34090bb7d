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
// Design: a pre-pass, then a kernel whose stages land by bulk copy.
//   * Pre-pass (split_kv_kernel, one block a (b, h) and stage): K and V are
//     split into TF32 halves (hi = tf32(x), lo = tf32(x - hi)) once a call,
//     into a scratch the wrapper allocates, each stage one contiguous block
//     in the layouts wgmma reads as K-major shared-memory B operands (core
//     matrices of 8 rows x 16 bytes, no swizzle; attention_long.cuh): K hi
//     and lo as [NS][dh] (S = Q K^T), V hi and lo as [dh][NS] in the
//     accumulator's order of each 8 keys (O += P V), zeros past T and from
//     dh on. The bias is packed beside them (bias_pack_kernel): a bias
//     broadcast over queries (BERT4Rec's key padding) as rows padded to
//     whole stages with -inf; any other (SASRec's causal [1, 1, T, T]) as one
//     [128][NS] tile ([64][16] at dh = 256) per query block and stage, -inf
//     past T, in the order the accumulator's threads read it, so that a
//     thread's 4 values of a column group are one conflict-free 16-byte read.
//     So no query block splits a stage again (10 blocks a head at T=1,200),
//     and no block reads a bias element by element from L2.
//   * A block owns 128 queries of one (b, h), two warpgroups of 64; the
//     query blocks of one head are neighbours in the grid, so the head's
//     packed stages are read from L2 by all of them. Q is split once a
//     block: into registers as A fragments at dh <= 16, into [128][dh]
//     shared-memory tiles from dh = 32. K, V and the bias stream through a
//     ring of ring_stages() slots, each stage landed by two bulk copies on a
//     full mbarrier. Thread 0 issues every copy: it refills the slot of stage
//     s - 1 at the top of stage s, once every thread has arrived on that
//     slot's empty mbarrier; no ninth warp (ptxas serialises wgmma with
//     one). The warpgroups pass no turn between them: each waits for a stage
//     and releases it on its own, so one warpgroup's exponentials and
//     dropout hash run while the other's products do; at dh <= 32 two
//     blocks an SM (at most 128 registers a thread; one for the causal
//     dh = 32 instance, whose bias tiles take the room) overlap the same way.
//   * S = Q K^T: wgmma m64nNSk8, three a k-step (lo hi, hi lo, hi hi). The
//     softmax runs on the accumulator's registers (a row is one quad's);
//     P is re-laid from the accumulator into A fragments without a shuffle
//     and O += P V is issued 8 keys at a time (wgmma m64nDHk8 from
//     registers), so that one group's products run while the next group's
//     exponentials are taken.
//   * A head of width dh runs at its template width DH (attention_common.cuh):
//     the pre-pass zeros the columns from dh on, which then add nothing to S
//     and leave O zero there, and no output column from dh on is written.
//     Such a head takes the build with AMID_ATTN_PAD=1 (its own library, dh
//     read at run time); this build takes dh = DH only, a compile-time
//     constant.
//   * dh = 256 (template width 256, any dh from 129 to 256):
//     attention_fwd_long_wide_kernel. The owned Q of 128 rows as TF32 halves
//     would take 256 KB, above a block's 227 KB, and an m64n256 O
//     accumulator alone is 128 registers a thread. So a block owns 64
//     queries and its two warpgroups split the head width: warpgroup w holds
//     columns [128 w, 128 w + 128) of all 64 rows, Q's hi halves as A
//     fragments in registers (64 a thread) and its lo halves in a [64][128]
//     shared-memory tile (32 KB), both split once a block, and O for its 128
//     columns (m64n128, 64 registers). A stage streams 16 keys (66 KB of
//     split K and V, two in the ring). S = Q K^T is each warpgroup's partial
//     product over its 128 columns (16 k-steps of m64n16k8, three a k-step:
//     lo hi from shared memory, hi lo and hi hi from registers), the two
//     partials added through shared memory (one block barrier a stage): the
//     sum of two 48-product chains, each as long as dh = 128's, which keeps
//     dh = 128's precision. Both warpgroups then take the same softmax of the
//     same S (the same bits: the sum is commutative) and each adds P V for its
//     columns (m64n128k8). Shared memory: 64 KB of Q lo, 2 x 70 KB of ring,
//     16 KB of exchanged partials (216 KB, one block an SM).
//   * Each instance is compiled for a bias that broadcasts over queries or
//     not and for dropout on or off, so that no element pays for a branch.
//   * At dh = 128 with one query block a head (T <= 128), or two (T <= 256)
//     and a bias broadcast over queries, the pre-pass's round trip of K and
//     V through device memory costs more than the split it saves: there
//     attention_fwd_long_inblock_kernel streams raw stages and splits them
//     in the block (no scratch).
//
// Bound on the H100 (data sheet) at B=256, H=4, dh=32, T=1,200: 4*B*H*T*T*dh
// = 1.89e11 operations, 0.381 ms at the 495 TFLOP/s TF32 tensor-core peak,
// against 630 MB of q, k, v, bias read and o written, 0.188 ms at
// 3.35 TB/s: bound by operations. This design issues 3 TF32 products for
// each (3xTF32), 1.14 ms at the peak, pads T to its 128-row blocks and
// NS-key stages, and its pre-pass moves 0.94 GB (K and V read, their halves
// written: 0.28 ms at 3.35 TB/s). What is left: the per-element work on the
// CUDA cores (scale and bias, the running max, one exp, the dropout hash,
// the split of P: 1.5e9 elements at T=1,200), as much as the products'; every
// block reads all key stages, also the causally masked ones. At dh = 256
// (B=256, H=4, T=300): 9.4e10 operations, 0.19 ms at the TF32 peak (0.57 ms
// as 3xTF32), against 1.26 GB of q, k, v read and o written, 0.376 ms: bound
// by bytes. The wide kernel's pre-pass moves 1.9 GB (K and V read, their
// halves written) and each stage of a block issues 48 m64n16k8 and 6
// m64n128k8 products a warpgroup, one block an SM (216 KB of shared memory,
// 174-186 registers).

#include <string.h>

#include "attention_long.cuh"

namespace amid_long {

// m64n64k8 with both operands in shared memory: S = Q K^T at dh = 32, whose
// Q lives in shared memory here
template <>
__device__ __forceinline__ void mma_ss<64>(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {" BWL_L32
      "}, %32, %33, p, 1, 1;\n}\n"
      : BWL_O32
      : "l"(a), "l"(b), "r"(1));
}

}  // namespace amid_long

namespace {

using namespace amid_long;

constexpr int kSmallScratch = -5;  // the scratch is below attention_fwd_long_scratch's bytes

// blocks an SM: two where at most 128 registers a thread hold the output,
// the scores and the fragments
template <int DH>
__host__ __device__ constexpr int min_blocks() {
  return DH <= 32 ? 2 : 1;
}
// Q's A fragments in registers (dh <= 16) or Q's halves in shared memory
template <int DH>
__host__ __device__ constexpr bool q_in_regs() {
  return DH <= 16;
}
// floats of Q in shared memory: none, or its hi and lo tiles (dh <= 128);
// at dh = 256 each warpgroup's [64][128] tile of lo halves
template <int DH>
__host__ __device__ constexpr int q_floats() {
  return q_in_regs<DH>() ? 0 : DH == 256 ? 2 * 64 * 128 : 2 * kOwn * DH;
}

// queries a block owns: 128, 64 at dh = 256 (attention_fwd_long_wide_kernel)
template <int DH>
__host__ __device__ constexpr int own_rows() {
  return DH == 256 ? 64 : kOwn;
}
// the threads whose accumulator rows a bias tile is laid out for: both
// warpgroups, or at dh = 256 one (the two hold the same rows)
template <int DH>
__host__ __device__ constexpr int tile_threads() {
  return DH == 256 ? 128 : kThreads;
}

// one stage of the scratch and of the ring, in floats: K hi, K lo ([NS][dh]),
// V hi, V lo ([dh][NS]), then the bias's part; NS keys, Plan's (16 at dh = 256)
template <int DH>
struct Stage {
  using P = Plan<DH>;
  static constexpr int NS = DH == 256 ? 16 : P::NS;
  static constexpr int TILE = NS * DH;   // floats of a [NS][dh] tile
  static constexpr int TR = NS * DH + NS;  // of a [dh][NS] tile (chunk padding)
  static constexpr int KV = 2 * TILE + 2 * TR;
  static constexpr int BIAS_ROW = NS;                    // a bias broadcast over queries
  static constexpr int BIAS_TILE = own_rows<DH>() * NS;  // any other
};

template <int DH, bool BCAST>
__host__ __device__ constexpr int stage_floats() {
  return Stage<DH>::KV + (BCAST ? Stage<DH>::BIAS_ROW : Stage<DH>::BIAS_TILE);
}

template <int DH, bool BCAST>
__host__ __device__ constexpr size_t smem_with(int slots) {
  // the barriers (full and empty a slot), Q's halves, the ring
  return 128 + sizeof(float) * q_floats<DH>() +
         sizeof(float) * (size_t)slots * stage_floats<DH, BCAST>();
}

// the ring's slots: as many as 4 while min_blocks() blocks fit in an SM's
// 228 KB (1 KB a block reserved), else while one block fits in 227 KB
template <int DH, bool BCAST>
__host__ __device__ constexpr int ring_stages() {
  for (int n = 4; n >= 2; --n)
    if (min_blocks<DH>() * (smem_with<DH, BCAST>(n) + 1024) <= 233472) return n;
  for (int n = 4; n >= 2; --n)
    if (smem_with<DH, BCAST>(n) <= 232448) return n;
  return 2;
}

template <int DH, bool BCAST>
__host__ __device__ constexpr size_t fwd_long_smem() {
  return smem_with<DH, BCAST>(ring_stages<DH, BCAST>());
}

// The packed operands of one call (the scratch the wrapper allocates).
struct Packed {
  const float* kv;    // [B * H][ns][Stage::KV]
  const float* bias;  // rows [rows][ns * NS], or tiles [rows][n_qb][ns][128 * NS]
  int n_qb;           // query blocks a head
};

// Thread tid's rows and key columns in an m64nN accumulator of two
// warpgroups: element e of column group j is row rl + 8 (e / 2), column
// 8 j + 2 t + e % 2
__host__ __device__ constexpr int acc_row(int tid) {
  return (tid >> 7) * 64 + ((tid >> 5) & 3) * 16 + ((tid & 31) >> 2);
}

// ---------------------------------------------------------------------------
// the pre-pass
// ---------------------------------------------------------------------------

// inverse of perm8: the streamed row whose column in a [dh][NS] tile is p
__device__ __forceinline__ int unperm8(int p) {
  return (p & ~7) | ((p & 3) << 1) | ((p >> 2) & 1);
}

// One block a (b, h) and stage: K and V rows [s NS, s NS + NS) read once,
// their TF32 halves written in the ring's layout
template <int DH>
__global__ void __launch_bounds__(kThreads)
split_kv_kernel(const FwdParams p, float* __restrict__ out, int ns) {
  using P = Stage<DH>;
  constexpr int NS = P::NS, C = Plan<DH>::C;
  __shared__ __align__(16) float kr[NS * DH];
  __shared__ __align__(16) float vr[NS * DH];
  const int tid = threadIdx.x;
  const int s = blockIdx.x % ns, bh = blockIdx.x / ns;
  const int b = bh / p.H, h = bh - b * p.H;
  const int dh = kPadBuild ? p.dh : DH;
  const float* kb = p.k + b * p.k_sb + h * dh;
  const float* vb = p.v + b * p.v_sb + h * dh;
  for (int item = tid; item < NS * C; item += kThreads) {
    const int r = item / C, c = item - r * C;
    reinterpret_cast<float4*>(kr)[item] = load_chunk(kb, p.k_st, s * NS + r, c, p.T, dh);
    reinterpret_cast<float4*>(vr)[item] = load_chunk(vb, p.v_st, s * NS + r, c, p.T, dh);
  }
  __syncthreads();
  float* st = out + ((size_t)bh * ns + s) * Stage<DH>::KV;
  float4* khi = reinterpret_cast<float4*>(st);
  float4* klo = reinterpret_cast<float4*>(st + P::TILE);
  for (int z = tid; z < NS * C; z += kThreads) {  // z: the 16-byte chunk of tile_at's layout
    const int r = (z / (8 * C)) * 8 + (z & 7), c = (z >> 3) % C;
    float4 hi, lo;
    split4(reinterpret_cast<const float4*>(kr)[r * C + c], hi, lo);
    khi[z] = hi;
    klo[z] = lo;
  }
  float* vthi = st + 2 * P::TILE;
  float* vtlo = vthi + P::TR;
  for (int z = tid; z < (NS / 4) * DH; z += kThreads) {  // columns 4 pg .. 4 pg + 3 of row d
    const int pg = z / DH, d = z - pg * DH;
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = vr[unperm8(4 * pg + e) * DH + d];
    float4 hi, lo;
    split4(make_float4(v[0], v[1], v[2], v[3]), hi, lo);
    const int at = tr_at<DH>(d, 4 * pg);
    *reinterpret_cast<float4*>(vthi + at) = hi;
    *reinterpret_cast<float4*>(vtlo + at) = lo;
  }
}

// The bias beside them: with bcast, each of `rows` rows as ns * NS values,
// -inf past T; else each row's [own][NS] tile of each query block and
// stage in tile order: float4 (j, tid) holds thread tid's 4 values of
// column group j, for `threads` threads. A query row past T reads row T - 1
// (it writes nothing).
__global__ void bias_pack_kernel(const FwdParams p, float* __restrict__ out, int rows, int ns,
                                 int ns_keys, int n_qb, int own, int threads, int bcast) {
  const int T = p.T;
  if (bcast) {
    const long long n = (long long)rows * ns * ns_keys;
    for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n;
         e += (long long)gridDim.x * blockDim.x) {
      const long long r = e / ((long long)ns * ns_keys);
      const int j = (int)(e - r * ns * ns_keys);
      out[e] = j < T ? p.bias[r * p.bias_sb + j] : -INFINITY;
    }
    return;
  }
  const int groups = ns_keys / 8;
  const long long n = (long long)rows * n_qb * ns * groups * threads;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    const int tid = (int)(e % threads);
    long long rest = e / threads;
    const int j = (int)(rest % groups);
    rest /= groups;
    const int s = (int)(rest % ns);
    rest /= ns;
    const int qb = (int)(rest % n_qb);
    const long long r = rest / n_qb;
    const int rl = acc_row(tid), t4 = tid & 3;
    float v[4];
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int i = min(qb * own + rl + 8 * (x >> 1), T - 1);
      const int key = s * ns_keys + 8 * j + 2 * t4 + (x & 1);
      v[x] = key < T ? p.bias[r * p.bias_sb + (long long)i * p.bias_si + key] : -INFINITY;
    }
    reinterpret_cast<float4*>(out)[e] = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

// BCAST: the bias broadcasts over queries (bias_si == 0); DROP: dropout on
template <int DH, bool BCAST, bool DROP>
__global__ void __launch_bounds__(kThreads, min_blocks<DH>())
attention_fwd_long_kernel(const FwdParams p, const Packed pk) {
  static_assert(DH <= 128, "dh = 256 has attention_fwd_long_wide_kernel");
  using P = Plan<DH>;
  using S = Stage<DH>;
  constexpr int NS = P::NS, KS = DH / 8, JS = NS / 8;
  constexpr int SLOTS = ring_stages<DH, BCAST>();
  constexpr int SF = stage_floats<DH, BCAST>();
  constexpr bool QREG = q_in_regs<DH>();
  constexpr uint32_t kKvBytes = S::KV * 4;
  constexpr uint32_t kBiasBytes = (BCAST ? S::BIAS_ROW : S::BIAS_TILE) * 4;
  const int T = p.T, dh = kPadBuild ? p.dh : DH;

  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // [SLOTS] a stage landed
  uint64_t* empty = full + SLOTS;                      // [SLOTS] a stage read
  float* qhi = reinterpret_cast<float*>(smem + 128);   // [128][dh] Q's halves (dh >= 32)
  float* qlo = qhi + (QREG ? 0 : kOwn * DH);
  float* ring = qhi + q_floats<DH>();                  // SLOTS x (K, V, the bias's part)

  const int tid = threadIdx.x;
  const int qb = blockIdx.x % pk.n_qb;
  const int bh = blockIdx.x / pk.n_qb;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int q0 = qb * kOwn;
  const int ns = (T + NS - 1) / NS;
  const float* kv = pk.kv + (size_t)bh * ns * S::KV;
  const float* bias_src =
      BCAST ? pk.bias + (size_t)(p.bias_sb ? b : 0) * ns * NS
            : pk.bias + ((size_t)(p.bias_sb ? b : 0) * pk.n_qb + qb) * ns * S::BIAS_TILE;

  if (tid == 0) {
    for (int s = 0; s < SLOTS; ++s) {
      mbar_init(smem_u32(full + s), 1);
      mbar_init(smem_u32(empty + s), kThreads);
    }
    mbar_init_fence();
  }
  __syncthreads();
  auto issue = [&](int s) {  // stage s into slot s % SLOTS
    float* st = ring + (s % SLOTS) * SF;
    const uint32_t bar = smem_u32(full + s % SLOTS);
    mbar_expect_tx(bar, kKvBytes + kBiasBytes);
    bulk_copy(smem_u32(st), kv + (size_t)s * S::KV, kKvBytes, bar);
    bulk_copy(smem_u32(st + S::KV), bias_src + (size_t)s * (kBiasBytes / 4), kBiasBytes, bar);
  };
  if (tid == 0)
    for (int s = 0; s < SLOTS && s < ns; ++s) issue(s);

  const int wg = tid >> 7, lane = tid & 31;
  const int t4 = lane & 3;
  const int rl = acc_row(tid);  // this thread's rows rl, rl + 8 of the block
  const float* qb_rows = p.q + b * p.q_sb + h * dh;
  uint32_t key2[2];
  const uint32_t bh_key =
      DROP ? mix(mix(kMixKey0, (uint32_t)*p.seed), (uint32_t)bh + p.bh_offset) : 0u;
#pragma unroll
  for (int x = 0; x < 2; ++x) key2[x] = DROP ? mix(bh_key, (uint32_t)(q0 + rl + 8 * x)) : 0u;
  constexpr int KA = QREG ? KS : 1;
  uint32_t qf_hi[KA][4], qf_lo[KA][4];
  if constexpr (QREG) {
    owned_frags<DH>(qb_rows, p.q_st, q0 + rl, T, dh, t4, qf_hi, qf_lo);
  } else {
    load_owned<DH>(qb_rows, p.q_st, q0, T, dh, qhi, qlo, tid);
    fence_proxy_async();
    __syncthreads();
  }
  const uint64_t qa_hi = tile_desc<DH>(qhi + wg * 64 * DH);
  const uint64_t qa_lo = tile_desc<DH>(qlo + wg * 64 * DH);
  constexpr int kTrStep = 2 * P::TR_LBO / 16;  // a k-step of a [dh][NS] tile, in descriptor units

  float o[DH / 2];
#pragma unroll
  for (int x = 0; x < DH / 2; ++x) o[x] = 0.f;
  // row max and this thread's part of the row sum, rows rl and rl + 8
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int s = 0; s < ns; ++s) {
    if (tid == 0 && s > 0 && s - 1 + SLOTS < ns) {
      // every thread released stage s - 1: its slot takes stage s - 1 + SLOTS
      mbar_wait(smem_u32(empty + (s - 1) % SLOTS), ((s - 1) / SLOTS) & 1);
      issue(s - 1 + SLOTS);
    }
    __syncwarp();
    const int slot = s % SLOTS;
    const float* st = ring + slot * SF;
    const float* bias_s = st + S::KV;
    const int j0 = s * NS;
    const uint64_t kb_hi = tile_desc<DH>(st), kb_lo = tile_desc<DH>(st + P::TILE);
    const uint64_t vt_hi = tr_desc<DH>(st + 2 * P::TILE);
    const uint64_t vt_lo = tr_desc<DH>(st + 2 * P::TILE + P::TR);
    mbar_wait(smem_u32(full + slot), (s / SLOTS) & 1);

    // S = Q K^T, 3xTF32 (lo hi, hi lo, hi hi a k-step)
    float sa[NS / 2];
#pragma unroll
    for (int x = 0; x < NS / 2; ++x) sa[x] = 0.f;
    fence_regs(sa);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < KS; ++k) {
      if constexpr (QREG) {
        mma3_rs<NS>(sa, qf_hi[k], qf_lo[k], kb_hi + 16 * k, kb_lo + 16 * k);
      } else {
        mma3_ss<NS>(sa, qa_hi + 16 * k, qa_lo + 16 * k, kb_hi + 16 * k, kb_lo + 16 * k);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sa);

    // the scores, scaled and biased (keys past T: bias -inf), and the
    // stage's row max: element e of column group j is row rl + 8 (e / 2),
    // key 8 j + 2 t + e % 2 of the stage
    float cm[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < JS; ++j) {
      float bv[4];
      if constexpr (BCAST) {
        const float2 r = *reinterpret_cast<const float2*>(bias_s + 8 * j + 2 * t4);
        bv[0] = bv[2] = r.x;
        bv[1] = bv[3] = r.y;
      } else {
        const float4 r = reinterpret_cast<const float4*>(bias_s)[j * kThreads + tid];
        bv[0] = r.x, bv[1] = r.y, bv[2] = r.z, bv[3] = r.w;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float sv = fmaf(sa[4 * j + e], p.scale, bv[e]);
        sa[4 * j + e] = sv;
        cm[e >> 1] = fmaxf(cm[e >> 1], sv);
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

// ---------------------------------------------------------------------------
// dh = 256: a block owns 64 queries, its warpgroups split the head width
// (the design notes at the top)
// ---------------------------------------------------------------------------

constexpr int kWideHalf = 128;  // columns of the head a warpgroup holds at dh = 256

template <bool BCAST>
__host__ __device__ constexpr size_t wide_smem() {
  // the barriers, Q's lo halves, two ring slots, the exchanged partial S of
  // two stages (every thread's NS / 2 values)
  return 128 + sizeof(float) * (q_floats<256>() + 2 * stage_floats<256, BCAST>() +
                                2 * kThreads * Stage<256>::NS / 2);
}

// BCAST: the bias broadcasts over queries (bias_si == 0); DROP: dropout on
template <bool BCAST, bool DROP>
__global__ void __launch_bounds__(kThreads, 1)
attention_fwd_long_wide_kernel(const FwdParams p, const Packed pk) {
  constexpr int DH = 256, HALF = kWideHalf, OWN = own_rows<256>();
  using S = Stage<DH>;
  constexpr int NS = S::NS, KH = HALF / 8, JS = NS / 8, SLOTS = 2;
  constexpr int SF = stage_floats<DH, BCAST>();
  constexpr uint32_t kKvBytes = S::KV * 4;
  constexpr uint32_t kBiasBytes = (BCAST ? S::BIAS_ROW : S::BIAS_TILE) * 4;
  constexpr int kTrStep = 2 * Plan<DH>::TR_LBO / 16;  // a k-step of a [dh][NS] tile
  const int T = p.T, dh = kPadBuild ? p.dh : DH;

  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // [SLOTS] a stage landed
  uint64_t* empty = full + SLOTS;                      // [SLOTS] a stage read
  float* qlo = reinterpret_cast<float*>(smem + 128);   // [2][64][128] each warpgroup's Q lo
  float* ring = qlo + q_floats<DH>();                  // SLOTS x (K, V, the bias's part)
  float4* xs = reinterpret_cast<float4*>(ring + SLOTS * SF);  // [2][NS / 8][256] partial S

  const int tid = threadIdx.x;
  const int qb = blockIdx.x % pk.n_qb;
  const int bh = blockIdx.x / pk.n_qb;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int q0 = qb * OWN;
  const int ns = (T + NS - 1) / NS;
  const float* kv = pk.kv + (size_t)bh * ns * S::KV;
  const float* bias_src =
      BCAST ? pk.bias + (size_t)(p.bias_sb ? b : 0) * ns * NS
            : pk.bias + ((size_t)(p.bias_sb ? b : 0) * pk.n_qb + qb) * ns * S::BIAS_TILE;

  if (tid == 0) {
    for (int s = 0; s < SLOTS; ++s) {
      mbar_init(smem_u32(full + s), 1);
      mbar_init(smem_u32(empty + s), kThreads);
    }
    mbar_init_fence();
  }
  __syncthreads();
  auto issue = [&](int s) {  // stage s into slot s % SLOTS
    float* st = ring + (s % SLOTS) * SF;
    const uint32_t bar = smem_u32(full + s % SLOTS);
    mbar_expect_tx(bar, kKvBytes + kBiasBytes);
    bulk_copy(smem_u32(st), kv + (size_t)s * S::KV, kKvBytes, bar);
    bulk_copy(smem_u32(st + S::KV), bias_src + (size_t)s * (kBiasBytes / 4), kBiasBytes, bar);
  };
  if (tid == 0)
    for (int s = 0; s < SLOTS && s < ns; ++s) issue(s);

  const int wg = tid >> 7, lt = tid & 127, t4 = tid & 3;
  const int rl = acc_row(lt);  // this thread's rows rl, rl + 8 of the block, in either warpgroup
  const int c0 = wg * HALF;    // the first of this warpgroup's columns
  uint32_t key2[2];
  const uint32_t bh_key =
      DROP ? mix(mix(kMixKey0, (uint32_t)*p.seed), (uint32_t)bh + p.bh_offset) : 0u;
#pragma unroll
  for (int x = 0; x < 2; ++x) key2[x] = DROP ? mix(bh_key, (uint32_t)(q0 + rl + 8 * x)) : 0u;

  // Q split once: the hi halves as the A fragments of the warpgroup's 16
  // k-steps (rows rl and rl + 8, columns c0 + 8 k + t and + 4), the lo halves
  // into its [64][128] tile at the same places; rows past T and columns from
  // dh on are zeros
  uint32_t qf[KH][4];
  float* mylo = qlo + wg * OWN * HALF;
  {
    const float* qh = p.q + b * p.q_sb + h * dh;
    const int r0 = q0 + rl;
    const bool in0 = r0 < T, in1 = r0 + 8 < T;
    const float* a0 = qh + (long long)(in0 ? r0 : 0) * p.q_st;
    const float* a1 = qh + (long long)(in1 ? r0 + 8 : 0) * p.q_st;
#pragma unroll
    for (int k = 0; k < KH; ++k) {
      const int c = c0 + 8 * k + t4;
      const bool lo_in = !kPadBuild || c < dh, hi_in = !kPadBuild || c + 4 < dh;
      const float v[4] = {in0 && lo_in ? __ldg(a0 + c) : 0.f, in1 && lo_in ? __ldg(a1 + c) : 0.f,
                          in0 && hi_in ? __ldg(a0 + c + 4) : 0.f,
                          in1 && hi_in ? __ldg(a1 + c + 4) : 0.f};
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const Split sp = split(v[x]);
        qf[k][x] = sp.hi;
        const int col = 8 * k + t4 + 4 * (x >> 1);  // within the warpgroup's half
        mylo[tile_at<HALF>(rl + 8 * (x & 1), col >> 2) + (col & 3)] = __uint_as_float(sp.lo);
      }
    }
  }
  fence_proxy_async();
  __syncthreads();
  const uint64_t qa_lo = tile_desc<HALF>(mylo);

  float o[HALF / 2];
#pragma unroll
  for (int x = 0; x < HALF / 2; ++x) o[x] = 0.f;
  // row max and this thread's part of the row sum, rows rl and rl + 8: the
  // same in both warpgroups
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int s = 0; s < ns; ++s) {
    if (tid == 0 && s > 0 && s - 1 + SLOTS < ns) {
      // every thread released stage s - 1: its slot takes stage s - 1 + SLOTS
      mbar_wait(smem_u32(empty + (s - 1) % SLOTS), ((s - 1) / SLOTS) & 1);
      issue(s - 1 + SLOTS);
    }
    __syncwarp();
    const int slot = s % SLOTS;
    const float* st = ring + slot * SF;
    const float* bias_s = st + S::KV;
    const int j0 = s * NS;
    // this warpgroup's columns of K (k-steps 16 wg on) and of V^T (rows c0 on)
    const uint64_t kb_hi = tile_desc<DH>(st) + 16 * KH * wg;
    const uint64_t kb_lo = tile_desc<DH>(st + S::TILE) + 16 * KH * wg;
    const uint64_t vt_hi = tr_desc<DH>(st + 2 * S::TILE) + c0;  // 16 bytes a column
    const uint64_t vt_lo = tr_desc<DH>(st + 2 * S::TILE + S::TR) + c0;
    mbar_wait(smem_u32(full + slot), (s / SLOTS) & 1);

    // the warpgroup's part of S = Q K^T, 3xTF32 (lo hi, hi lo, hi hi a k-step)
    float sa[NS / 2];
#pragma unroll
    for (int x = 0; x < NS / 2; ++x) sa[x] = 0.f;
    fence_regs(sa);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < KH; ++k) {
      mma_ss<NS>(sa, qa_lo + 16 * k, kb_hi + 16 * k);
      mma_rs<NS>(sa, qf[k], kb_lo + 16 * k);
      mma_rs<NS>(sa, qf[k], kb_hi + 16 * k);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sa);
    // S: the two warpgroups' parts added (the same bits in both), through
    // the exchange buffer of this stage's parity
    float4* xb = xs + (s & 1) * (NS / 8) * kThreads;
#pragma unroll
    for (int c = 0; c < NS / 8; ++c)
      xb[c * kThreads + tid] = make_float4(sa[4 * c], sa[4 * c + 1], sa[4 * c + 2], sa[4 * c + 3]);
    __syncthreads();
#pragma unroll
    for (int c = 0; c < NS / 8; ++c) {
      const float4 r = xb[c * kThreads + (tid ^ 128)];
      sa[4 * c] += r.x;
      sa[4 * c + 1] += r.y;
      sa[4 * c + 2] += r.z;
      sa[4 * c + 3] += r.w;
    }

    // the scores, scaled and biased (keys past T: bias -inf), and the
    // stage's row max: element e of column group j is row rl + 8 (e / 2),
    // key 8 j + 2 t + e % 2 of the stage
    float cm[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < JS; ++j) {
      float bv[4];
      if constexpr (BCAST) {
        const float2 r = *reinterpret_cast<const float2*>(bias_s + 8 * j + 2 * t4);
        bv[0] = bv[2] = r.x;
        bv[1] = bv[3] = r.y;
      } else {
        const float4 r = reinterpret_cast<const float4*>(bias_s)[j * 128 + lt];
        bv[0] = r.x, bv[1] = r.y, bv[2] = r.z, bv[3] = r.w;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float sv = fmaf(sa[4 * j + e], p.scale, bv[e]);
        sa[4 * j + e] = sv;
        cm[e >> 1] = fmaxf(cm[e >> 1], sv);
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
    for (int c = 0; c < HALF / 8; ++c) {
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        o[4 * c + 2 * x] *= al[x];
        o[4 * c + 2 * x + 1] *= al[x];
      }
    }

    // P of 8 keys a column group j, then O += P V for this warpgroup's
    // columns; group j's products run while group j + 1 is computed
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
      mma3_rs<HALF>(o, ahi[j & 1], alo[j & 1], vt_hi + j * kTrStep, vt_lo + j * kTrStep);
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs(o);
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      fence_regs(ahi[x]);
      fence_regs(alo[x]);
    }
    mbar_arrive(smem_u32(empty + slot));  // this thread is done with the stage
  }

  float inv[2];
#pragma unroll
  for (int x = 0; x < 2; ++x) inv[x] = 1.f / quad_sum(l[x]);
  const long long out_base = (long long)b * T * p.D + h * dh;
#pragma unroll
  for (int c = 0; c < HALF / 8; ++c) {
    const int col = c0 + c * 8 + 2 * t4;
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int i = q0 + rl + 8 * x;
      if (i < T)
        store2<DH>(p.out + out_base + (long long)i * p.D, col, dh, o[4 * c + 2 * x] * inv[x],
                   o[4 * c + 2 * x + 1] * inv[x]);
    }
  }
  if (p.row_max != nullptr && t4 == 0 && wg == 0) {
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

// ---------------------------------------------------------------------------
// the in-block path: at dh = 128 with one query block a head, or two where
// the bias broadcasts over queries (key padding), no pre-pass. Each block
// streams raw K, V and bias rows through a ring of two stages (every
// thread's cp.async part and one cp.async.mbarrier.arrive), splits each
// landed stage into TF32 halves once, in the layouts the products read, and
// reads a bias that does not broadcast over queries element by element. A
// stage is split by at most two blocks here, which costs less than the
// pre-pass's round trip of K and V through device memory (0.33 GB at B=256,
// H=4, T=150).
//
// The cut, from both kernels timed on the same inputs at every T (builds
// with the cut moved; device time of a CUDA graph's replay, rate 0, H=4, B=64
// and 256; NVIDIA H100 80GB HBM3, 700.00 W), the in-block kernel's time over
// the pre-pass kernel's:
//   one query block (T = 20, 40, 64, 100, 128): 0.67-0.81, either bias;
//   two, key padding (T = 130, 160, 200, 256): 0.92-0.97 (B=256: 0.97,
//     0.93, 0.95, 0.94);
//   two, causal: B=256 1.03, 1.03, 1.07, 1.10 (B=64 0.99, 0.99, 1.04, 1.06);
//   three (T = 257, 300, 384): 1.06-1.27, either bias.
// With two query blocks a head, a per-query bias read element by element
// costs the in-block kernel more than the pre-pass's round trip.
// ---------------------------------------------------------------------------

constexpr int kInblockMaxQb = 2;      // query blocks a head, a bias broadcast over queries
constexpr int kInblockMaxQbTile = 1;  // and a bias of its own for each query

template <int DH>
constexpr size_t inblock_smem() {
  using P = Plan<DH>;
  return sizeof(float) * (2 * P::OWN + 2 * (2 * P::TILE + P::NS) + 2 * P::TILE + 2 * P::TR +
                          P::NS) + 2 * sizeof(uint64_t);
}

// BCAST: the bias broadcasts over queries (bias_si == 0); DROP: dropout on
template <int DH, bool BCAST, bool DROP>
__global__ void __launch_bounds__(kThreads, 1)
attention_fwd_long_inblock_kernel(const FwdParams p) {
  using P = Plan<DH>;
  constexpr int NS = P::NS, KS = DH / 8, JS = NS / 8;
  constexpr int RAW = 2 * P::TILE + NS;  // a raw stage: K, V, the bias row
  const int T = p.T, dh = kPadBuild ? p.dh : DH;

  extern __shared__ __align__(128) unsigned char smem[];
  float* qhi = reinterpret_cast<float*>(smem);  // [128][dh] the block's Q, hi and lo
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
                              (int)fwd_long_smem<DH, BCAST>());
}

template <int DH, bool BCAST, bool DROP>
cudaError_t launch_one(const FwdParams& p, const Packed& pk, unsigned blocks,
                       cudaStream_t stream) {
  attention_fwd_long_kernel<DH, BCAST, DROP>
      <<<blocks, kThreads, fwd_long_smem<DH, BCAST>(), stream>>>(p, pk);
  return cudaGetLastError();
}

// The scratch of one call: the packed K and V, then the packed bias; none
// on the in-block path.
struct Layout {
  int ns, n_qb, rows, bcast, inblock;
  long long kv_floats, bias_floats;
};

template <int DH>
Layout layout(const FwdArgs& a) {
  Layout L;
  constexpr int NS = Stage<DH>::NS, OWN = own_rows<DH>();
  L.ns = (int)((a.T + NS - 1) / NS);
  L.n_qb = (int)((a.T + OWN - 1) / OWN);
  L.rows = a.bias_sb ? (int)a.B : 1;
  L.bcast = a.bias_si == 0;
  L.inblock = DH == 128 && L.n_qb <= (L.bcast ? kInblockMaxQb : kInblockMaxQbTile);
  L.kv_floats = L.inblock ? 0 : a.B * a.H * L.ns * (long long)Stage<DH>::KV;
  L.bias_floats = L.inblock ? 0
                  : L.bcast ? (long long)L.rows * L.ns * NS
                            : (long long)L.rows * L.n_qb * L.ns * Stage<DH>::BIAS_TILE;
  return L;
}

// grid-stride launch of `n` items, 256 threads a block
inline unsigned blocks_for(long long n) {
  const long long g = (n + 255) / 256;
  return (unsigned)(g < 1 ? 1 : (g < 65535LL * 16 ? g : 65535LL * 16));
}

template <int DH, bool BCAST, bool DROP>
cudaError_t inblock_opt_in() {
  return cudaFuncSetAttribute(attention_fwd_long_inblock_kernel<DH, BCAST, DROP>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)inblock_smem<DH>());
}

template <int DH, bool BCAST, bool DROP>
cudaError_t inblock_one(const FwdParams& p, dim3 grid, cudaStream_t stream) {
  attention_fwd_long_inblock_kernel<DH, BCAST, DROP>
      <<<grid, kThreads, inblock_smem<DH>(), stream>>>(p);
  return cudaGetLastError();
}

// The in-block path (dh = 128, layout()'s cut).
cudaError_t launch_inblock(const FwdParams& p, int B, cudaStream_t stream) {
  static_assert(inblock_smem<128>() <= 232448, "a block's shared memory");
  static const cudaError_t opted_in = [] {
    cudaError_t e = inblock_opt_in<128, true, false>();
    if (e == cudaSuccess) e = inblock_opt_in<128, true, true>();
    if (e == cudaSuccess) e = inblock_opt_in<128, false, false>();
    if (e == cudaSuccess) e = inblock_opt_in<128, false, true>();
    return e;
  }();
  if (opted_in != cudaSuccess) return opted_in;
  const dim3 grid(B * p.H, (p.T + kOwn - 1) / kOwn);
  if (p.bias_si == 0)
    return p.dropout ? inblock_one<128, true, true>(p, grid, stream)
                     : inblock_one<128, true, false>(p, grid, stream);
  return p.dropout ? inblock_one<128, false, true>(p, grid, stream)
                   : inblock_one<128, false, false>(p, grid, stream);
}

template <bool BCAST, bool DROP>
cudaError_t wide_opt_in() {
  return cudaFuncSetAttribute(attention_fwd_long_wide_kernel<BCAST, DROP>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)wide_smem<BCAST>());
}

template <bool BCAST, bool DROP>
cudaError_t wide_one(const FwdParams& p, const Packed& pk, unsigned blocks, cudaStream_t stream) {
  attention_fwd_long_wide_kernel<BCAST, DROP>
      <<<blocks, kThreads, wide_smem<BCAST>(), stream>>>(p, pk);
  return cudaGetLastError();
}

// the kernel of template width DH, its four instances asked once for their
// shared memory at the first launch at that width (not a stream operation:
// it stays out of a CUDA graph's capture)
template <int DH>
cudaError_t launch_kernel(const FwdParams& p, const Packed& pk, unsigned blocks, bool bcast,
                          cudaStream_t stream) {
  if constexpr (DH == 256) {
    static_assert(wide_smem<false>() <= 232448 && wide_smem<true>() <= 232448,
                  "a block's shared memory");
    static const cudaError_t opted_in = [] {
      cudaError_t e = wide_opt_in<true, false>();
      if (e == cudaSuccess) e = wide_opt_in<true, true>();
      if (e == cudaSuccess) e = wide_opt_in<false, false>();
      if (e == cudaSuccess) e = wide_opt_in<false, true>();
      return e;
    }();
    if (opted_in != cudaSuccess) return opted_in;
    if (bcast)
      return p.dropout ? wide_one<true, true>(p, pk, blocks, stream)
                       : wide_one<true, false>(p, pk, blocks, stream);
    return p.dropout ? wide_one<false, true>(p, pk, blocks, stream)
                     : wide_one<false, false>(p, pk, blocks, stream);
  } else {
    static_assert(fwd_long_smem<DH, false>() <= 232448 && fwd_long_smem<DH, true>() <= 232448,
                  "a block's shared memory");
    static const cudaError_t opted_in = [] {
      cudaError_t e = opt_in<DH, true, false>();
      if (e == cudaSuccess) e = opt_in<DH, true, true>();
      if (e == cudaSuccess) e = opt_in<DH, false, false>();
      if (e == cudaSuccess) e = opt_in<DH, false, true>();
      return e;
    }();
    if (opted_in != cudaSuccess) return opted_in;
    if (bcast)
      return p.dropout ? launch_one<DH, true, true>(p, pk, blocks, stream)
                       : launch_one<DH, true, false>(p, pk, blocks, stream);
    return p.dropout ? launch_one<DH, false, true>(p, pk, blocks, stream)
                     : launch_one<DH, false, false>(p, pk, blocks, stream);
  }
}

template <int DH>
cudaError_t launch(const FwdParams& p, const FwdArgs& a, float* scratch, long long bytes,
                   cudaStream_t stream, int& refusal) {
  const Layout L = layout<DH>(a);
  if (L.inblock) return launch_inblock(p, (int)a.B, stream);
  if (bytes < 4 * (L.kv_floats + L.bias_floats)) {
    refusal = kSmallScratch;
    return cudaSuccess;
  }
  split_kv_kernel<DH><<<(unsigned)(a.B * a.H * L.ns), kThreads, 0, stream>>>(p, scratch, L.ns);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  float* bias = scratch + L.kv_floats;
  const long long items = L.bcast ? L.bias_floats : L.bias_floats / 4;
  bias_pack_kernel<<<blocks_for(items), 256, 0, stream>>>(
      p, bias, L.rows, L.ns, Stage<DH>::NS, L.n_qb, own_rows<DH>(), tile_threads<DH>(), L.bcast);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const Packed pk = {scratch, bias, L.n_qb};
  return launch_kernel<DH>(p, pk, (unsigned)(a.B * a.H * L.n_qb), L.bcast, stream);
}

// The entry point's argument block: the forward's FwdArgs, then the scratch
// the wrapper allocates and its bytes.
struct FwdLongArgs {
  FwdArgs a;
  long long scratch, scratch_bytes;
};

int check(const FwdArgs& a) {
  if (a.B < 1 || a.T < 1 || a.H < 1 || a.D % a.H != 0) return kBadShape;
  const long long dh = a.D / a.H;
  if (long_template_dh((int)dh) == 0) return kBadHeadWidth;
  if (!kPadBuild && dh != long_template_dh((int)dh)) return kBadHeadWidth;  // the padded build's
  const int own = long_template_dh((int)dh) == 256 ? own_rows<256>() : kOwn;
  if (a.T > 65535LL * kOwn || a.B * a.H * ((a.T + own - 1) / own) > 2147483647LL)
    return kTooLong;
  return 0;
}

}  // namespace

extern "C" {

// Longest T the path takes.
int attention_fwd_long_max_t() { return 65535 * kOwn; }

// Bytes of scratch a launch with this FwdArgs block needs (the packed K, V
// and bias), or a Refusal.
long long attention_fwd_long_scratch(const void* raw) {
  FwdArgs a;
  memcpy(&a, raw, sizeof a);
  const int refusal = check(a);
  if (refusal) return refusal;
  Layout L;
  switch (long_template_dh((int)(a.D / a.H))) {
    case 8: L = layout<8>(a); break;
    case 16: L = layout<16>(a); break;
    case 32: L = layout<32>(a); break;
    case 64: L = layout<64>(a); break;
    case 128: L = layout<128>(a); break;
    default: L = layout<256>(a); break;
  }
  return 4 * (L.kv_floats + L.bias_floats);
}

// Launches the pre-pass (K, V and the bias packed into the scratch) and the
// kernel. `raw` is one FwdLongArgs block: the tensors as for attention_fwd
// (attention_fwd.cu), then the scratch, attention_fwd_long_scratch(raw)
// bytes, 16-byte aligned. Where dh is a multiple of 4, q, k and v rows must
// start on 16 bytes (kMisaligned otherwise). Returns 0, a Refusal (or
// kSmallScratch), or the first failing launch's cudaError_t.
int attention_fwd_long(const void* raw) {
  FwdLongArgs la;
  memcpy(&la, raw, sizeof la);
  const FwdArgs& a = la.a;
  const int refusal = check(a);
  if (refusal) return refusal;
  const long long dh = a.D / a.H;
  if (!rows_aligned(a.q, a.q_sb, a.q_st, dh) || !rows_aligned(a.k, a.k_sb, a.k_st, dh) ||
      !rows_aligned(a.v, a.v_sb, a.v_st, dh) || la.scratch % 16 != 0)
    return kMisaligned;
  const FwdParams p = fwd_params(a);
  cudaStream_t s = ptr<CUstream_st>(a.stream);
  float* scratch = ptr<float>(la.scratch);
  int small = 0;
  cudaError_t e;
  switch (long_template_dh((int)dh)) {
    case 8: e = launch<8>(p, a, scratch, la.scratch_bytes, s, small); break;
    case 16: e = launch<16>(p, a, scratch, la.scratch_bytes, s, small); break;
    case 32: e = launch<32>(p, a, scratch, la.scratch_bytes, s, small); break;
    case 64: e = launch<64>(p, a, scratch, la.scratch_bytes, s, small); break;
    case 128: e = launch<128>(p, a, scratch, la.scratch_bytes, s, small); break;
    default: e = launch<256>(p, a, scratch, la.scratch_bytes, s, small); break;
  }
  return small ? small : (int)e;
}

}  // extern "C"
