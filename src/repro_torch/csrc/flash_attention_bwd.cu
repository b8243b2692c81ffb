// Flash-attention backward (kernel K1-bwd of the port) for Hopper, sm_90a.
//
// No TPU kernel stands behind it: the JAX package never differentiates its
// Pallas flash attention (pallas_call has no reverse-mode rule there), so
// its training differentiates the plain layers.sdpa through XLA.  This is
// the gradient of that same function, the causal (+window) GQA attention
// of K1 (flash_attention.cu), computed on the card from K1's output and the
// per-row log-sum-exp that K1 writes when asked:
//     P  = exp(scale q k^T - lse), masked to 0
//     dV = P^T dO            D = rowsum(dO o O)
//     dS = P o (dO V^T - D)
//     dQ = scale dS K        dK = scale dS^T Q
// dK and dV of a kv head sum over the query heads of its group.
//
// What bounds it on this card.  The function reads q, k, v, o, dO and lse
// once and writes dq, dk and dv once (8 tensors of B*S*H*hd for MHA), and
// does 5 products of B*H*S(S+1)/2*hd multiply-adds over the causal pairs
// (QK^T, dO V^T, P^T dO, dS K, dS^T Q).  At the training shape of
// deepseek-7b, (4,512,32,128) bf16, that is about 134 MB (0.040 ms at
// 3.35 TB/s) against 21 GFLOP (0.022 ms at the bf16 tensor-core peak).
//
// Design: a simple kernel that is right, on the CUDA cores in float32 for
// both storage types (tensor-core tiles are for a later change):
//  * three launches: bwd_dot (D, one warp per row), then bwd_dkdv and
//    bwd_dq, two deterministic passes with no atomics, so two runs give
//    bit-equal gradients;
//  * bwd_dkdv: one CTA per (64-key tile, kv head, batch row).  K and V stay
//    in shared memory while the CTA walks every query head of the kv
//    head's group and every 64-row query tile that causality and the window
//    let see its keys; dK and dV accumulate in registers and are written
//    once, which is the GQA sum;
//  * bwd_dq: one CTA per (64-row query tile, head, batch row), walking the
//    key tiles the forward walks;
//  * 256 threads; a thread owns rows ty + 16a and columns tx + 16c of each
//    64 x 64 score tile and of each accumulator tile, so that the threads of
//    a warp read shared memory in distinct banks or by broadcast.  Rows of
//    the tiles in shared memory are padded by one float.
// Shared memory: four 64-row tiles of hd + 1 floats and two 64 x 65 score
// tiles, about 162 KB at hd 128: one CTA per SM.

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using repro::store;
using repro::to_f32;
using bf16 = __nv_bfloat16;

constexpr int BQ = 64;    // query rows per tile
constexpr int BK = 64;    // keys per tile
constexpr int NT = 256;   // threads per CTA: a 16 x 16 grid (tx, ty)
constexpr int LDS = BK + 1;

template <int HD>
constexpr size_t smem_bytes() {
  // four (64, hd + 1) tiles, two (64, 65) score tiles, lse and D of 64 rows
  return sizeof(float) * (4 * 64 * (HD + 1) + 2 * BQ * LDS + 2 * BQ);
}

// 64 rows of hd values from row p0 of src (row stride `stride`) into dst as
// float32, rows past S zero-filled
template <typename T, int HD>
__device__ __forceinline__ void load_rows(float* dst, const T* src, long long stride, int p0,
                                          int S) {
  for (int x = threadIdx.x; x < 64 * HD; x += NT) {
    const int r = x / HD, d = x % HD, p = p0 + r;
    dst[r * (HD + 1) + d] = p < S ? to_f32(src[p * stride + d]) : 0.f;
  }
}

__device__ __forceinline__ bool visible(int qp, int kp, int S, int window) {
  return kp <= qp && qp < S && kp < S && (window <= 0 || qp - kp < window);
}

// D[b,h,p] = sum_d dO[b,p,h,d] O[b,p,h,d]: one warp per (b, p, h) row
template <typename T, int HD>
__global__ void bwd_dot(const T* __restrict__ o, const T* __restrict__ dout,
                        float* __restrict__ D, int S, int H, long long rows) {
  const long long row = (long long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;   // the whole warp leaves together
  const T* orow = o + row * HD;
  const T* drow = dout + row * HD;
  float acc = 0.f;
  for (int d = lane; d < HD; d += 32) acc = fmaf(to_f32(orow[d]), to_f32(drow[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const long long b = row / ((long long)S * H);
    const int p = (int)((row / H) % S), h = (int)(row % H);
    D[(b * H + h) * S + p] = acc;
  }
}

// Scores of a 64 x 64 tile: s = Q K^T and dp = dO V^T for rows ty + 16a of
// Qs/dOs and keys tx + 16c of Ks/Vs.
template <int HD>
__device__ __forceinline__ void tile_products(const float* Qs, const float* dOs,
                                              const float* Ks, const float* Vs,
                                              float (&s)[4][4], float (&dp)[4][4]) {
  constexpr int LD = HD + 1;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[a][c] = dp[a][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float qv[4], gv[4], kv[4], vv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      qv[a] = Qs[(ty + 16 * a) * LD + d];
      gv[a] = dOs[(ty + 16 * a) * LD + d];
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      kv[c] = Ks[(tx + 16 * c) * LD + d];
      vv[c] = Vs[(tx + 16 * c) * LD + d];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[a][c] = fmaf(qv[a], kv[c], s[a][c]);
        dp[a][c] = fmaf(gv[a], vv[c], dp[a][c]);
      }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
         const T* __restrict__ dout, const float* __restrict__ lse,
         const float* __restrict__ D, T* __restrict__ dk, T* __restrict__ dv, int S, int H,
         int KH, int window, float scale) {
  constexpr int LD = HD + 1;
  constexpr int CW = HD / 16;   // accumulator columns per thread
  extern __shared__ float smem[];
  float* Ks = smem;             // [BK][LD]
  float* Vs = Ks + BK * LD;
  float* Qs = Vs + BK * LD;     // [BQ][LD]
  float* dOs = Qs + BQ * LD;
  float* Ps = dOs + BQ * LD;    // [BQ][LDS]
  float* dSs = Ps + BQ * LDS;
  float* Ls = dSs + BQ * LDS;   // [BQ] lse of the tile's rows
  float* Dsh = Ls + BQ;         // [BQ] D of the tile's rows

  const int k0 = blockIdx.x * BK, kh = blockIdx.y, b = blockIdx.z;
  const int G = H / KH;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long long q_stride = (long long)H * HD, kv_stride = (long long)KH * HD;
  const long long kv_base = (long long)b * S * kv_stride + (long long)kh * HD;

  load_rows<T, HD>(Ks, k + kv_base, kv_stride, k0, S);
  load_rows<T, HD>(Vs, v + kv_base, kv_stride, k0, S);

  float accK[4][CW], accV[4][CW];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < CW; ++c) accK[a][c] = accV[a][c] = 0.f;

  // query tiles with a row that sees a key of this tile
  const int k_last = min(k0 + BK - 1, S - 1);
  const int q_last = window > 0 ? min(S - 1, k_last + window - 1) : S - 1;
  for (int hh = 0; hh < G; ++hh) {
    const int h = kh * G + hh;
    const long long q_base = (long long)b * S * q_stride + (long long)h * HD;
    const float* lrow = lse + ((long long)b * H + h) * S;
    const float* drow = D + ((long long)b * H + h) * S;
    for (int t = k0 / BQ; t <= q_last / BQ; ++t) {
      const int q0 = t * BQ;
      __syncthreads();   // the last tile's reads of Qs, dOs, Ps, dSs are done
      load_rows<T, HD>(Qs, q + q_base, q_stride, q0, S);
      load_rows<T, HD>(dOs, dout + q_base, q_stride, q0, S);
      for (int r = tid; r < BQ; r += NT) {
        Ls[r] = q0 + r < S ? lrow[q0 + r] : 0.f;
        Dsh[r] = q0 + r < S ? drow[q0 + r] : 0.f;
      }
      __syncthreads();

      float s[4][4], dp[4][4];
      tile_products<HD>(Qs, dOs, Ks, Vs, s, dp);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int r = ty + 16 * a;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = tx + 16 * c;
          const float p = visible(q0 + r, k0 + col, S, window)
                              ? expf(fmaf(s[a][c], scale, -Ls[r])) : 0.f;
          Ps[r * LDS + col] = p;
          dSs[r * LDS + col] = p * (dp[a][c] - Dsh[r]);
        }
      }
      __syncthreads();

      // dV += P^T dO and dK += dS^T Q for keys ty + 16a, columns tx + 16c
#pragma unroll 2
      for (int i = 0; i < BQ; ++i) {
        float pv[4], sv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          pv[a] = Ps[i * LDS + ty + 16 * a];
          sv[a] = dSs[i * LDS + ty + 16 * a];
        }
#pragma unroll
        for (int c = 0; c < CW; ++c) {
          const float gv = dOs[i * LD + tx + 16 * c];
          const float qv = Qs[i * LD + tx + 16 * c];
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            accV[a][c] = fmaf(pv[a], gv, accV[a][c]);
            accK[a][c] = fmaf(sv[a], qv, accK[a][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int p = k0 + ty + 16 * a;
    if (p < S) {
#pragma unroll
      for (int c = 0; c < CW; ++c) {
        const long long at = kv_base + p * kv_stride + tx + 16 * c;
        store(&dk[at], accK[a][c] * scale);
        store(&dv[at], accV[a][c]);
      }
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
       const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ D,
       T* __restrict__ dq, int S, int H, int KH, int window, float scale) {
  constexpr int LD = HD + 1;
  constexpr int CW = HD / 16;
  extern __shared__ float smem[];
  float* Qs = smem;             // [BQ][LD]
  float* dOs = Qs + BQ * LD;
  float* Ks = dOs + BQ * LD;    // [BK][LD]
  float* Vs = Ks + BK * LD;
  float* dSs = Vs + BK * LD;    // [BQ][LDS]
  float* Ls = dSs + 2 * BQ * LDS;
  float* Dsh = Ls + BQ;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long long q_stride = (long long)H * HD, kv_stride = (long long)KH * HD;
  const long long q_base = (long long)b * S * q_stride + (long long)h * HD;
  const long long kv_base = (long long)b * S * kv_stride + (long long)kh * HD;

  load_rows<T, HD>(Qs, q + q_base, q_stride, q0, S);
  load_rows<T, HD>(dOs, dout + q_base, q_stride, q0, S);
  for (int r = tid; r < BQ; r += NT) {
    const long long at = ((long long)b * H + h) * S + q0 + r;
    Ls[r] = q0 + r < S ? lse[at] : 0.f;
    Dsh[r] = q0 + r < S ? D[at] : 0.f;
  }

  float acc[4][CW];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[a][c] = 0.f;

  // key tiles that hold a key some row of this query tile sees
  const int q_last = min(q0 + BQ - 1, S - 1);
  const int k_first = window > 0 ? max(0, q0 - window + 1) : 0;
  for (int t = k_first / BK; t <= q_last / BK; ++t) {
    const int k0 = t * BK;
    __syncthreads();   // the last tile's reads of Ks and dSs are done
    load_rows<T, HD>(Ks, k + kv_base, kv_stride, k0, S);
    load_rows<T, HD>(Vs, v + kv_base, kv_stride, k0, S);
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_products<HD>(Qs, dOs, Ks, Vs, s, dp);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = ty + 16 * a;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = tx + 16 * c;
        const float p = visible(q0 + r, k0 + col, S, window)
                            ? expf(fmaf(s[a][c], scale, -Ls[r])) : 0.f;
        dSs[r * LDS + col] = p * (dp[a][c] - Dsh[r]);
      }
    }
    __syncthreads();

    // dQ += dS K for rows ty + 16a, columns tx + 16c
#pragma unroll 2
    for (int j = 0; j < BK; ++j) {
      float sv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) sv[a] = dSs[(ty + 16 * a) * LDS + j];
#pragma unroll
      for (int c = 0; c < CW; ++c) {
        const float kv = Ks[j * LD + tx + 16 * c];
#pragma unroll
        for (int a = 0; a < 4; ++a) acc[a][c] = fmaf(sv[a], kv, acc[a][c]);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int p = q0 + ty + 16 * a;
    if (p < S) {
#pragma unroll
      for (int c = 0; c < CW; ++c)
        store(&dq[q_base + p * q_stride + tx + 16 * c], acc[a][c] * scale);
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const float* lse, float* D, void* dq, void* dk, void* dv,
                   int B, int S, int H, int KH, int window, float scale, cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(dout);
  const long long rows = (long long)B * S * H;
  bwd_dot<T, HD><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(static_cast<const T*>(o), gt,
                                                                  D, S, H, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = smem_bytes<HD>();
  err = cudaFuncSetAttribute(bwd_dkdv<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  bwd_dkdv<T, HD><<<dim3((S + BK - 1) / BK, KH, B), NT, smem, stream>>>(
      qt, kt, vt, gt, lse, D, static_cast<T*>(dk), static_cast<T*>(dv), S, H, KH, window,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(bwd_dq<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  bwd_dq<T, HD><<<dim3((S + BQ - 1) / BQ, H, B), NT, smem, stream>>>(
      qt, kt, vt, gt, lse, D, static_cast<T*>(dq), S, H, KH, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(int hd, const void* q, const void* k, const void* v, const void* o,
                      const void* dout, const float* lse, float* D, void* dq, void* dk,
                      void* dv, int B, int S, int H, int KH, int window, float scale,
                      cudaStream_t st) {
  switch (hd) {
    case 32: return launch<T, 32>(q, k, v, o, dout, lse, D, dq, dk, dv, B, S, H, KH, window, scale, st);
    case 64: return launch<T, 64>(q, k, v, o, dout, lse, D, dq, dk, dv, B, S, H, KH, window, scale, st);
    case 128: return launch<T, 128>(q, k, v, o, dout, lse, D, dq, dk, dv, B, S, H, KH, window, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o, dout, dq: (B,S,H,hd) contiguous; k, v, dk, dv: (B,S,KH,hd)
// contiguous; H % KH == 0; lse: (B,H,S) float32 from the forward; D: a
// (B,H,S) float32 scratch buffer.  dtype 0 = float32, 1 = bfloat16; hd in
// {32, 64, 128}.  Launches three kernels on `stream` and returns the first
// failing launch's cudaError_t (0 on success).
extern "C" int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* o, const void* dout, const float* lse,
                                         float* D, void* dq, void* dk, void* dv, int B, int S,
                                         int H, int KH, int hd, int window, float scale,
                                         int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_hd<float>(hd, q, k, v, o, dout, lse, D, dq, dk, dv, B, S, H, KH,
                                 window, scale, st);
  if (dtype == 1)
    return (int)launch_hd<bf16>(hd, q, k, v, o, dout, lse, D, dq, dk, dv, B, S, H, KH,
                                window, scale, st);
  return (int)cudaErrorInvalidValue;
}
