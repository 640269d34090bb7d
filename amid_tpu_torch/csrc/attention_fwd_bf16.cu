// Fused multi-head attention forward in the bf16-operand mode for Hopper
// (sm_90a), one head a block: native bf16 products
// (mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32) on 16-bit shared-memory
// tiles. fp32 in and out.
//
// Replaces amid_tpu/ops/pallas_attention.py::_fwd_kernel with mxu_bf16=True
// (pallas_call in _fused_fwd_impl) on the one-head path: the function of
// attention_fwd.cu (the fp32 one-head forward) with every product's
// operands rounded to bf16 and fp32 sums:
//   o = dropout(softmax(Q K^T / sqrt(dh) + bias)) V per head,
// heads packed in D ([B, T, D] in and out), an additive bias of shape
// [1|B, 1, 1|T, T]. S = bf16(Q) bf16(K)^T in fp32 sums, then times the
// scale and plus the bias in fp32 (the scale is not folded into Q before
// it is rounded). An online softmax over chunks of kChunk keys: the row
// max m grows to the chunk's, the running sum l and O are rescaled by
// exp(m_old - m_new), l += exp(S - m) before rounding and dropout, and
// O += bf16(dropout(exp(S - m))) bf16(V), the kept values times the fp32
// 1 / (1 - rate); at the end O / l. The chunk is the rounding point: the
// unnormalised exp(S - m) is rounded once a chunk, so its size is part of
// the function (chip_smoke.py::key_chunk reads it). When asked it writes
// row_max m_i and row_inv_sum 1 / l_i ([B, H, T] fp32) for either
// backward. The dropout keeps element (b, h, i, j) when
//   mix(mix(mix(mix(K0, seed), (row_offset + b)*H + h), i), j) >> 8 >= threshold,
// the mask of ops/attention.py::dropout_keep_mask, bit for bit. No float
// atomics: two calls give the same bits.
//
// Design. One block owns one (batch row b, head h), as many warps as it has
// 16-row query tiles, at most 8 (T=150: 10 tiles -> 5 warps of 2 tiles):
//   * Staging rounds once. The block reads K and V of the head as fp32
//     (16-byte loads where the rows start on 16 bytes and dh is its
//     template width, else value by value), rounds them to bf16 with
//     cvt.rn.bf16x2 and stores 8 columns a 16-byte store into [TK][dh_pad
//     + 8] tiles (TK: T rounded up to the chunk; rows past T and columns
//     from dh on zero). The 16 extra bytes of pitch put the 8 rows an
//     ldmatrix reads on 8 different 16-byte bank groups. No pre-pass: one
//     block holds the whole head, so each element is read once anyway.
//   * Each warp holds its 16 query rows' Q as bf16 A fragments, read from
//     device memory and rounded once: dh_pad / 4 registers, 32 at dh=128
//     (the fp32 build re-read and re-split Q each chunk there).
//   * Per chunk: S = Q K^T as 4 n8 tiles, B from ldmatrix.x4 on K's rows;
//     the scale, the bias (from device memory, L2), the running max by
//     quad shuffles, the exps and the dropout hash element by element; then
//     O += P V with P's accumulators packed as the A fragments (two n8
//     tiles, one k16 step, no shuffle) and V's B fragments from
//     ldmatrix.x4.trans.
//   * A head of width dh runs at its template width (attention_common.cuh;
//     dh <= 8 at 16 columns, a k16 step's), in the instance with PAD set
//     unless dh = DH; output columns from dh on are not written. Keys past
//     T score -inf (P = 0); query rows past T write nothing.
//   * A chunk whose every exp(S - m) underflows to 0 for the warp's 16 rows
//     (a causal chunk past them: scores of -1e9) leaves m, l and O as they
//     are, bit for bit, and is skipped after its scores: no exps, no hash,
//     no P.V. A choice made on the data, not on the bias's shape (causal
//     B=256, T=150, dh=16: 0.1036 against 0.1263 ms at rate 0.5, dh=12
//     0.1050 against 0.1225 at rate 0; key padding within 1%; NVIDIA H100
//     80GB HBM3, 700.00 W).
//   * One head a block at every T. Several (b, h) heads a block at T <= 64
//     (2 or 4 heads, up to 8 warps) won nothing: B=256, h=8, causal, T=20
//     0.00872 ms with one head against 0.00886 (2) and 0.00898 (4), T=37
//     0.01388 against 0.01412 and 0.01418, T=64 0.02707 against 0.02679
//     and 0.02682 (rate 0; NVIDIA H100 80GB HBM3, 700.00 W): an SM holds
//     as many warps either way (registers limit them), and at T=20 the
//     2,048 blocks of 2 warps take under two waves.
//   * mma.sync, not wgmma: a wgmma tile is 64 query rows, 69% of it idle at
//     T=20, and a block of T=150 would hold 3 of them for 10 16-row tiles;
//     the products are a small part of the time (below).
//   * Shared memory: 2 * TK * (dh_pad + 8) * 2 bytes (T=150, dh=16: 15.4 KB
//     against the fp32 build's 24.3 KB; dh=16 holds T up to 2,400, dh=128
//     up to 416).
//
// Bound on the H100 (data sheet): at B=256, T=150, D=128, H=8 one call reads
// q, k, v and a causal bias and writes o, about 78.7 MB (23.5 us at
// 3.35 TB/s), and does 4*B*H*T*T*dh = 2.95 GFLOP (3 us at the 989 TFLOP/s
// bf16 tensor-core peak): bound by bytes. What holds this design back: the
// per-element work on the CUDA cores (an exp, the hash's ten integer
// operations and a bias read for each of B*H*T*TK elements, about 0.035 ms
// at T=150 with dropout by the data sheet's issue rates); the scores of
// causally masked chunks are computed before they are skipped.

#include <stdint.h>
#include <string.h>

#include "attention_common.cuh"
#include "hopper.cuh"

namespace {

using namespace amid_attention;
using amid_hopper::smem_u32;

constexpr int kChunk = 32;  // keys per online-softmax step: the rounding point
// exp(x) is 0 in fp32 below about -104: a chunk whose scores all lie this far
// below their row's maximum adds nothing
constexpr float kUnderflow = 128.f;

// PAD: dh = p.dh, below DH (or, at DH = 128, up to it); else dh = DH.
// vec_rows: the rows of q, k and v start on 16 bytes, read 16 bytes at a
// time where dh = DH. Launch bounds of one block an SM: ptxas then takes
// what registers it needs (up to 255), where without the bound it stopped
// at 128 and spilled at DH = 64 with PAD.
template <int DH, bool PAD>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
attention_fwd_bf16_kernel(const FwdParams p, const int vec_rows) {
  constexpr int DHP = padded_dh(DH);
  constexpr int SP = bf16_pitch(DH);
  constexpr int KS = DHP / 16;  // k16 steps of Q.K^T
  constexpr int NO = DHP / 8;   // n8 tiles of P.V
  constexpr int CH = DHP / 8;   // 8-column chunks of a staged row
  const int T = p.T, dh = PAD ? p.dh : DH;
  const bool vec = dh == DH && vec_rows;
  const int TK = (T + kChunk - 1) / kChunk * kChunk;

  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* ks = smem;
  uint16_t* vs = ks + TK * SP;

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const float* qb = p.q + b * p.q_sb + h * dh;
  const float* kb = p.k + b * p.k_sb + h * dh;
  const float* vb = p.v + b * p.v_sb + h * dh;
  for (int idx = threadIdx.x; idx < TK * CH; idx += blockDim.x) {
    const int t = idx / CH;
    const int c = (idx - t * CH) * 8;
    uint4 kx = make_uint4(0u, 0u, 0u, 0u), vx = kx;
    if (t < T && c < dh) {
      float x[8];
      load8(kb + t * p.k_st, c, dh, vec, x);
      kx = pack8(x);
      load8(vb + t * p.v_st, c, dh, vec, x);
      vx = pack8(x);
    }
    *reinterpret_cast<uint4*>(ks + t * SP + c) = kx;
    *reinterpret_cast<uint4*>(vs + t * SP + c) = vx;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int warps = blockDim.x >> 5;
  const float* bias_b = p.bias + b * p.bias_sb;
  const uint32_t bh_key =
      p.dropout ? mix(mix(kMixKey0, (uint32_t)*p.seed), (uint32_t)bh + p.bh_offset) : 0u;
  float* out_b = p.out + (long long)b * T * p.D + h * dh;
  // this lane's ldmatrix row addresses: K (blocks: keys 0-7 and 8-15 by
  // lane / 16, columns 0-7 and 8-15 by lane / 8 % 2) and V transposed
  // (keys by lane / 8 % 2, columns by lane / 16)
  const uint32_t k_addr =
      smem_u32(ks + ((lane & 7) + ((lane >> 4) << 3)) * SP + ((lane >> 3) & 1) * 8);
  const uint32_t v_addr =
      smem_u32(vs + ((lane & 7) + (((lane >> 3) & 1) << 3)) * SP + (lane >> 4) * 8);

  for (int qt = threadIdx.x >> 5; qt < tiles16(T); qt += warps) {
    const int r0 = qt * 16 + g, r1 = r0 + 8;  // this lane's two query rows
    const bool in0 = r0 < T, in1 = r1 < T;
    uint32_t qa[KS][4];
    {
      const float* q0 = qb + r0 * p.q_st;
      const float* q1 = qb + r1 * p.q_st;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const int c = kk * 16 + 2 * t4;
        qa[kk][0] = load2_bf16(q0, c, dh, in0, vec);
        qa[kk][1] = load2_bf16(q1, c, dh, in1, vec);
        qa[kk][2] = load2_bf16(q0, c + 8, dh, in0, vec);
        qa[kk][3] = load2_bf16(q1, c + 8, dh, in1, vec);
      }
    }
    // padded rows read row 0 of the bias; their results are never written
    const float* brow0 = bias_b + (in0 ? r0 : 0) * p.bias_si;
    const float* brow1 = bias_b + (in1 ? r1 : 0) * p.bias_si;
    const uint32_t key0 = p.dropout ? mix(bh_key, (uint32_t)r0) : 0u;
    const uint32_t key1 = p.dropout ? mix(bh_key, (uint32_t)r1) : 0u;

    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    float o[NO][4];
#pragma unroll
    for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

    for (int j0 = 0; j0 < T; j0 += kChunk) {
      float s[kChunk / 8][4];
#pragma unroll
      for (int nt = 0; nt < kChunk / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int np = 0; np < kChunk / 16; ++np) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          uint32_t kf[4];
          ldsm_x4(kf, k_addr + ((j0 + np * 16) * SP + kk * 16) * 2);
          mma_bf16(s[2 * np], qa[kk], kf[0], kf[1]);
          mma_bf16(s[2 * np + 1], qa[kk], kf[2], kf[3]);
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
      // a chunk whose every exp(S - m) is 0 (a causal chunk past the warp's
      // rows) leaves m, l and O as they are: skipped
      if (__all_sync(0xffffffffu, cm0 < mn0 - kUnderflow && cm1 < mn1 - kUnderflow)) continue;
      const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      l0 *= al0;
      l1 *= al1;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
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
      for (int kk = 0; kk < kChunk / 16; ++kk) {
        const uint32_t pa[4] = {
            pack_bf16x2(s[2 * kk][0], s[2 * kk][1]), pack_bf16x2(s[2 * kk][2], s[2 * kk][3]),
            pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
            pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int np = 0; np < NO / 2; ++np) {
          uint32_t vf[4];
          ldsm_x4_t(vf, v_addr + ((j0 + kk * 16) * SP + np * 16) * 2);
          mma_bf16(o[2 * np], pa, vf[0], vf[1]);
          mma_bf16(o[2 * np + 1], pa, vf[2], vf[3]);
        }
      }
    }
    const float inv0 = 1.f / quad_sum(l0), inv1 = 1.f / quad_sum(l1);
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {  // the n8 tiles of the template width
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
  const size_t tk = (size_t)(T + kChunk - 1) / kChunk * kChunk;
  return 2 * sizeof(uint16_t) * tk * bf16_pitch(dt);
}

template <int DH, bool PAD>
cudaError_t launch_one(const FwdParams& p, int B, int vec, size_t smem, cudaStream_t stream) {
  // every width may take all 227 KB a block can have; asked once, at the first
  // launch (not a stream operation: it stays out of a CUDA graph's capture)
  static const cudaError_t opted_in =
      cudaFuncSetAttribute(attention_fwd_bf16_kernel<DH, PAD>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
  if (opted_in != cudaSuccess) return opted_in;
  attention_fwd_bf16_kernel<DH, PAD>
      <<<B * p.H, warps_for(tiles16(p.T)) * 32, smem, stream>>>(p, vec);
  return cudaGetLastError();
}

// dh = DH: the instance with dh a compile-time constant, below 128; at DH =
// 128 one instance, dh read at run time
template <int DH>
cudaError_t launch(const FwdParams& p, int B, int vec, size_t smem, cudaStream_t stream) {
  if constexpr (DH == 128) {
    return launch_one<DH, true>(p, B, vec, smem, stream);
  } else {
    return p.dh == DH ? launch_one<DH, false>(p, B, vec, smem, stream)
                      : launch_one<DH, true>(p, B, vec, smem, stream);
  }
}

}  // namespace

extern "C" {

// Shared memory one block needs, in bytes: K and V of one head in bf16, T
// rounded up to the chunk of 32 keys, a row pitch of dh_pad + 8 values
// (dh_pad: dh's template width, at least 16); SIZE_MAX for dh above 128.
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
  // a head's rows start on 16 bytes where the tensors' do and dh = DH (a
  // multiple of 8): h * dh floats
  const int vec = rows_on16(a.q, a.q_sb, a.q_st) && rows_on16(a.k, a.k_sb, a.k_st) &&
                  rows_on16(a.v, a.v_sb, a.v_st);
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
