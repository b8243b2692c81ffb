// Flash-attention prefill (kernel K1 of the port) for Hopper, sm_90a.
//
// Replaces the TPU Pallas kernel src/repro/kernels/attention/flash.py::
// flash_attention (body _kernel): causal prefill attention with an optional
// sliding window and GQA (query head h reads kv head h / (H/K)), an online
// softmax with float32 (m, l, acc), scale hd^-0.5, masked logits set to the
// finite -1e30 and the final max(l, 1e-30) guard, so a row whose keys are all
// masked comes out as the reference's does.
//
// What bounds it on this card.  The function moves q, k, v and o once
// (4*B*S*H*hd elements for MHA) and does 4*hd*H*B*S(S+1)/2 flops, about S/4
// flops per byte in bf16.  Against the tensor cores (989 TFLOP/s) and HBM
// (3.35 TB/s) that is bound by bytes up to S of about 1200, which covers the
// serving prompts.  On the CUDA cores' float32 FMA (67 TFLOP/s) the same work
// would be bound by operations from S of about 80 up, so the bf16 kernel
// multiplies on the tensor cores and then has to stream its tiles.
//
// bf16 (the serving path), flash_fwd_mma, in the FlashAttention-2 shape:
//  * one CTA per (64-row query tile, head, batch row), 4 warps, each warp
//    owning 16 query rows; the Pallas sequential KV grid axis becomes a loop
//    inside the CTA, and KV tiles that causality or the window mask out for
//    every row of the query tile are never loaded.  The longest causal rows
//    are scheduled first;
//  * q, k and v tiles are copied into shared memory as bf16 with 16-byte
//    cp.async, k and v into a 2-stage ring so that tile t+1 loads while tile
//    t computes.  Rows past a ragged S are zero-filled by the copy (source
//    size 0), so no padded copy is made.  Rows are padded by 16 bytes, which
//    makes every ldmatrix read free of bank conflicts;
//  * S = Q K^T and O += P V run on the tensor cores as mma.sync m16n8k16
//    (bf16 operands, float32 accumulators); q is held in registers as A
//    fragments for the whole sweep, k is read with ldmatrix and v with
//    ldmatrix.trans;
//  * the per-element causal/window/ragged mask is applied only to tiles that
//    need it (for causal prefill, the diagonal tile of each query tile);
//  * the online softmax stays in registers (a row's scores lie in the four
//    threads of a quad: two shuffles for its max, its sum kept per thread
//    until the end), in base-2 units; P is rounded to bf16 in registers and
//    used directly as the A operand of PV, so the score tile never touches
//    shared memory;
//  * the output is staged in the warp's own rows of the q tile and written
//    with 16-byte stores.
//  About 85 KB of shared memory per CTA at hd=128: two CTAs per SM.
//
// float32 (no serving path takes it; the tests hold the kernel to 1e-4 in
// float32, which TF32 tensor cores would miss): flash_fwd, a simple kernel on
// the CUDA cores.
//  * one CTA per (64-row query tile, head, batch row), causal and window
//    tile skipping as above, (m, l) in shared memory and acc in registers;
//  * K and then V of a tile share one shared-memory buffer (about 82 KB for
//    hd=128);
//  * each thread owns a 4x8 block of the score tile and a 4x(hd/8) block of
//    the output, so each shared-memory operand read feeds several FMAs.
//    Rows of q and k/v in shared memory are padded by one float, so the
//    threads of a warp that read different rows hit different banks.
// The entry point picks the kernel by dtype.

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using repro::cp_async16;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::ldsm_x4;
using repro::ldsm_x4_trans;
using repro::mma_bf16;
using repro::NEG;
using repro::pack_bf16;
using repro::store;
using repro::to_f32;
using bf16 = __nv_bfloat16;

constexpr int BQ = 64;        // query rows per CTA
constexpr int BK = 64;        // keys per KV tile
constexpr int NT = 128;       // threads per CTA
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int HD>
constexpr size_t smem_bytes() {
  // q tile, shared k/v tile, score tile, and m, l, alpha per row
  return sizeof(float) * (BQ * (HD + 1) + BK * (HD + 1) + BQ * (BK + 1) + 3 * BQ);
}

// ---------------------------------------------------------------------------
// float32: the CUDA cores
// ---------------------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          T* __restrict__ o, float* __restrict__ lse, int S, int H, int KH, int window,
          float scale) {
  constexpr int LD = HD + 1;
  constexpr int CW = HD / 8;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                 // [BQ][LD]
  float* KV = Qs + BQ * LD;         // [BK][LD], K then V of the current tile
  float* Ps = KV + BK * LD;         // [BQ][BK+1], scores then probabilities
  float* m_s = Ps + BQ * (BK + 1);  // running max per row
  float* l_s = m_s + BQ;            // running sum per row
  float* a_s = l_s + BQ;            // this tile's rescale factor per row

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / KH);
  const int tid = threadIdx.x;
  const int rg = tid / 8;  // rows rg*4 .. rg*4+3
  const int cg = tid % 8;  // score columns cg + 8j, output columns cg + 8j

  const long long q_stride = (long long)H * HD;   // between positions
  const long long kv_stride = (long long)KH * HD;
  const T* qb = q + (long long)b * S * q_stride + (long long)h * HD;
  const T* kb = k + (long long)b * S * kv_stride + (long long)kh * HD;
  const T* vb = v + (long long)b * S * kv_stride + (long long)kh * HD;
  T* ob = o + (long long)b * S * q_stride + (long long)h * HD;

  for (int i = tid; i < BQ * HD; i += NT) {
    const int r = i / HD, d = i % HD, p = q0 + r;
    Qs[r * LD + d] = p < S ? to_f32(qb[p * q_stride + d]) : 0.f;
  }
  for (int r = tid; r < BQ; r += NT) {
    m_s[r] = NEG;
    l_s[r] = 0.f;
  }

  float acc[4][CW];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CW; ++j) acc[i][j] = 0.f;

  // KV tiles that hold a key some row of this query tile may attend to
  const int q_last = min(q0 + BQ - 1, S - 1);
  const int k_first = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_end = q_last / BK;

  for (int t = k_first / BK; t <= t_end; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's PV reads of KV and Ps are done
    for (int i = tid; i < BK * HD; i += NT) {
      const int r = i / HD, d = i % HD, p = k0 + r;
      KV[r * LD + d] = p < S ? to_f32(kb[p * kv_stride + d]) : 0.f;
    }
    __syncthreads();

    // scores for rows rg*4+i, keys cg+8j
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(rg * 4 + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = KV[(cg + 8 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rg * 4 + i, qp = q0 + r;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = cg + 8 * j, kp = k0 + c;
        const bool ok = kp <= qp && kp < S && (window <= 0 || qp - kp < window);
        Ps[r * (BK + 1) + c] = ok ? s[i][j] * scale : NEG;
      }
    }
    __syncthreads();

    // online softmax: two threads per row, 32 keys each
    {
      const int r = tid / 2, half = tid % 2;
      float* row = Ps + r * (BK + 1) + half * 32;
      float mx = NEG;
      for (int c = 0; c < 32; ++c) mx = fmaxf(mx, row[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = 0; c < 32; ++c) {
        const float p = expf(row[c] - m_new);
        row[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      if (half == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();  // every score read of KV is done: load V over K
    for (int i = tid; i < BK * HD; i += NT) {
      const int r = i / HD, d = i % HD, p = k0 + r;
      KV[r * LD + d] = p < S ? to_f32(vb[p * kv_stride + d]) : 0.f;
    }
    __syncthreads();

    // acc = acc * alpha + P V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = a_s[rg * 4 + i];
#pragma unroll
      for (int j = 0; j < CW; ++j) acc[i][j] *= alpha;
    }
#pragma unroll 2
    for (int c = 0; c < BK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(rg * 4 + i) * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < CW; ++j) {
        const float vv = KV[c * LD + cg + 8 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = rg * 4 + i, p = q0 + r;
    if (p < S) {
      const float l = fmaxf(l_s[r], 1e-30f);
#pragma unroll
      for (int j = 0; j < CW; ++j) store(&ob[p * q_stride + cg + 8 * j], acc[i][j] / l);
      if (lse != nullptr && cg == 0) lse[((long long)b * H + h) * S + p] = m_s[r] + logf(l);
    }
  }
}


// ---------------------------------------------------------------------------
// bf16: tensor cores and a cp.async ring
// ---------------------------------------------------------------------------

constexpr int PAD = 8;   // bf16 elements (16 bytes) of padding per shared row

template <int HD>
constexpr size_t mma_smem_bytes() {
  // the q tile, and two stages of the k and v tiles
  return sizeof(bf16) * (BQ + 4 * BK) * (HD + PAD);
}

template <int HD>
__global__ void __launch_bounds__(NT, 2)
flash_fwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
              int S, int H, int KH, int window, float scale_log2) {
  constexpr int LD = HD + PAD;
  constexpr int CH = HD / 8;    // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);   // [BQ][LD]; then each warp's O rows
  bf16* Ks = Qs + BQ * LD;                         // [2][BK][LD]
  bf16* Vs = Ks + 2 * BK * LD;                     // [2][BK][LD]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tg = lane & 3;   // fragment row and column pair
  const int mi = lane >> 3, mr = lane & 7;   // ldmatrix: this lane's matrix and row

  const long long q_stride = (long long)H * HD;   // between positions
  const long long kv_stride = (long long)KH * HD;
  const bf16* qb = q + (long long)b * S * q_stride + (long long)h * HD;
  const bf16* kb = k + (long long)b * S * kv_stride + (long long)kh * HD;
  const bf16* vb = v + (long long)b * S * kv_stride + (long long)kh * HD;
  bf16* ob = o + (long long)b * S * q_stride + (long long)h * HD;

  // 64 rows from position p0 of src into dst, rows past S zero-filled
  auto load_tile = [&](bf16* dst, const bf16* src, long long stride, int p0) {
    for (int c = tid; c < 64 * CH; c += NT) {
      const int r = c / CH, cc = c % CH, p = p0 + r;
      const bool in = p < S;
      cp_async16(dst + r * LD + cc * 8, in ? src + p * stride + cc * 8 : src, in ? 16 : 0);
    }
  };

  // KV tiles that hold a key some row of this query tile may attend to
  const int q_last = min(q0 + BQ - 1, S - 1);
  const int k_first = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_begin = k_first / BK, t_end = q_last / BK;

  load_tile(Qs, qb, q_stride, q0);
  load_tile(Ks, kb, kv_stride, t_begin * BK);
  load_tile(Vs, vb, kv_stride, t_begin * BK);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  uint32_t qf[HD / 16][4];   // this warp's 16 query rows as A fragments
#pragma unroll
  for (int kc = 0; kc < HD / 16; ++kc)
    ldsm_x4(qf[kc], Qs + (warp * 16 + mr + (mi & 1) * 8) * LD + kc * 16 + (mi >> 1) * 8);

  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m_r[2] = {NEG, NEG};   // rows gr and gr+8 of the warp, base-2 units
  float l_r[2] = {0.f, 0.f};   // this thread's share of each row's sum
  const int qp0 = q0 + warp * 16 + gr;

  for (int t = t_begin; t <= t_end; ++t) {
    const int st = (t - t_begin) & 1;
    if (t < t_end) {   // the next tile streams in while this one computes
      load_tile(Ks + (st ^ 1) * BK * LD, kb, kv_stride, (t + 1) * BK);
      load_tile(Vs + (st ^ 1) * BK * LD, vb, kv_stride, (t + 1) * BK);
    }
    cp_async_commit();
    cp_async_wait<1>();   // all but the newest group: tile t has landed
    __syncthreads();
    const bf16* Kt = Ks + st * BK * LD;
    const bf16* Vt = Vs + st * BK * LD;

    // S = Q K^T: 16 rows x 64 keys per warp, 8 accumulator tiles
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < HD / 16; ++kc) {
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        uint32_t kf[4];   // B fragments of key tiles 2np and 2np+1
        ldsm_x4(kf, Kt + (np * 16 + mr + (mi >> 1) * 8) * LD + kc * 16 + (mi & 1) * 8);
        mma_bf16(s[2 * np], qf[kc], kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], qf[kc], kf[2], kf[3]);
      }
    }

    // scale into base-2 units; causal, window and past-S keys get NEG.  A
    // tile wholly below the warp's first row, inside S and inside the window
    // of its last row needs no mask (all but the diagonal tiles, causally).
    const int k0 = t * BK, qw = q0 + warp * 16;
    if (k0 + BK - 1 <= qw && k0 + BK <= S && (window <= 0 || qw + 15 - k0 < window)) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= scale_log2;
    } else {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qp = qp0 + (e >> 1) * 8, kp = k0 + j * 8 + tg * 2 + (e & 1);
          const bool ok = kp <= qp && kp < S && (window <= 0 || qp - kp < window);
          s[j][e] = ok ? s[j][e] * scale_log2 : NEG;
        }
    }

    // online softmax: a row's 64 scores lie in the four threads of a quad
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_r[r], mx);
      alpha[r] = exp2f(m_r[r] - m_new);
      m_r[r] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f(s[j][2 * r + e] - m_new);
          s[j][2 * r + e] = p;
          sum += p;
        }
      l_r[r] = l_r[r] * alpha[r] + sum;
    }
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += P V, P rounded to bf16 in registers as the A operand
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      const uint32_t pf[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                              pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                              pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                              pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        uint32_t vf[4];   // B fragments of output column tiles 2dp and 2dp+1
        ldsm_x4_trans(vf, Vt + (kc * 16 + mr + (mi & 1) * 8) * LD + dp * 16 + (mi >> 1) * 8);
        mma_bf16(acc[2 * dp], pf, vf[0], vf[1]);
        mma_bf16(acc[2 * dp + 1], pf, vf[2], vf[3]);
      }
    }
    __syncthreads();   // every warp is done with stage st before it is refilled
  }

  // O / max(l, 1e-30), staged in the warp's own rows of the q tile, then
  // written to device memory with 16-byte stores
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = 1.f / fmaxf(l, 1e-30f);
    const int p = qp0 + r * 8;
    if (lse != nullptr && tg == 0 && p < S)   // natural-log units, for the backward
      lse[((long long)b * H + h) * S + p] = (m_r[r] + log2f(fmaxf(l, 1e-30f))) * LN2;
  }
  bf16* Os = Qs + warp * 16 * LD;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    *reinterpret_cast<uint32_t*>(Os + gr * LD + n * 8 + tg * 2) =
        pack_bf16(acc[n][0] * inv[0], acc[n][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(Os + (gr + 8) * LD + n * 8 + tg * 2) =
        pack_bf16(acc[n][2] * inv[1], acc[n][3] * inv[1]);
  }
  __syncwarp();
  for (int c = lane; c < 16 * CH; c += 32) {
    const int r = c / CH, cc = c % CH, p = q0 + warp * 16 + r;
    if (p < S)
      *reinterpret_cast<uint4*>(ob + p * q_stride + cc * 8) =
          *reinterpret_cast<const uint4*>(Os + r * LD + cc * 8);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int HD>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                       int S, int H, int KH, int window, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd<float, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd<float, HD><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, S, H, KH, window, scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                        int S, int H, int KH, int window, float scale, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_mma<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd_mma<HD><<<grid, NT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), lse, S, H, KH, window, scale * LOG2E);
  return cudaGetLastError();
}

cudaError_t launch_hd(bool bf16, const void* q, const void* k, const void* v, void* o,
                      float* lse, int B, int S, int H, int KH, int hd, int window, float scale,
                      cudaStream_t stream) {
  switch (hd) {
    case 32:
      return bf16 ? launch_bf16<32>(q, k, v, o, lse, B, S, H, KH, window, scale, stream)
                  : launch_f32<32>(q, k, v, o, lse, B, S, H, KH, window, scale, stream);
    case 64:
      return bf16 ? launch_bf16<64>(q, k, v, o, lse, B, S, H, KH, window, scale, stream)
                  : launch_f32<64>(q, k, v, o, lse, B, S, H, KH, window, scale, stream);
    case 128:
      return bf16 ? launch_bf16<128>(q, k, v, o, lse, B, S, H, KH, window, scale, stream)
                  : launch_f32<128>(q, k, v, o, lse, B, S, H, KH, window, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o: (B,S,H,hd) contiguous; k, v: (B,S,KH,hd) contiguous; H % KH == 0.
// dtype 0 = float32, 1 = bfloat16 (pointers 16-byte aligned); hd in
// {32, 64, 128}.  lse, when not null, receives each row's float32
// log-sum-exp of its scaled, masked logits, (B,H,S): what the backward
// (flash_attention_bwd.cu) rebuilds the probabilities from.  Every serving
// call passes null.  Launches on `stream` and returns the launch's
// cudaError_t (0 on success).
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* o,
                                     float* lse, int B, int S, int H, int KH, int hd,
                                     int window, float scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  return (int)launch_hd(dtype == 1, q, k, v, o, lse, B, S, H, KH, hd, window, scale, st);
}
