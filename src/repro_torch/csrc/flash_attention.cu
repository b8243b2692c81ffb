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
// serving prompts.  This first version multiplies with float32 FMA on the
// CUDA cores (67 TFLOP/s), so the kernel itself is bound by FMA issue and by
// shared-memory operand reads from S of about 80 up: it is a simple, correct
// version, and mma.sync / wgmma with TMA staging are later work.
//
// What the design does about it:
//  * one CTA per (64-row query tile, head, batch row).  The Pallas sequential
//    KV grid axis becomes a loop inside the CTA; (m, l) live in shared
//    memory and acc in registers, so only q, k, v and o touch device memory;
//  * KV tiles that causality or the window mask out for every row of the
//    query tile are never loaded (the Pallas grid visits every (qi, ki));
//  * a ragged S is masked in the loads and the stores, with no padded copy;
//  * K and then V of a tile share one shared-memory buffer, which keeps a
//    CTA at about 82 KB for hd=128, so two CTAs fit on an SM;
//  * each thread owns a 4x8 block of the score tile and a 4x(hd/8) block of
//    the output, so each shared-memory operand read feeds several FMAs.
//    Rows of q and k/v in shared memory are padded by one float, so the
//    threads of a warp that read different rows hit different banks.

#include <math.h>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;        // query rows per CTA
constexpr int BK = 64;        // keys per KV tile
constexpr int NT = 128;       // threads per CTA: 16 row groups x 8 column lanes
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <int HD>
constexpr size_t smem_bytes() {
  // q tile, shared k/v tile, score tile, and m, l, alpha per row
  return sizeof(float) * (BQ * (HD + 1) + BK * (HD + 1) + BQ * (BK + 1) + 3 * BQ);
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          T* __restrict__ o, int S, int H, int KH, int window, float scale) {
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
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int S,
                   int H, int KH, int window, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd<T, HD><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, H, KH, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(const void* q, const void* k, const void* v, void* o, int B, int S,
                      int H, int KH, int hd, int window, float scale, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32>(q, k, v, o, B, S, H, KH, window, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, S, H, KH, window, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, S, H, KH, window, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o: (B,S,H,hd) contiguous; k, v: (B,S,KH,hd) contiguous; H % KH == 0.
// dtype 0 = float32, 1 = bfloat16; hd in {32, 64, 128}.  Launches on `stream`
// and returns the launch's cudaError_t (0 on success).
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* o,
                                     int B, int S, int H, int KH, int hd, int window,
                                     float scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_hd<float>(q, k, v, o, B, S, H, KH, hd, window, scale, st);
  if (dtype == 1)
    return (int)launch_hd<__nv_bfloat16>(q, k, v, o, B, S, H, KH, hd, window, scale, st);
  return (int)cudaErrorInvalidValue;
}
