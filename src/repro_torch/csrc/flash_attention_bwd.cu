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
// 3.35 TB/s) against 21.5 GFLOP (0.022 ms at the bf16 tensor-core peak):
// bound by bytes, so the products have to run on the tensor cores.
//
// Three launches, deterministic: bwd_dot (D, 16-byte loads), then a
// dK/dV pass and a dQ pass with no atomics, so two runs give bit-equal
// gradients.  The dQ pass recomputes S and dP, so seven products run.
//
// bf16 (the training path), bwd_dkdv_mma and bwd_dq_mma, in the
// FlashAttention-2 shape, from the parts of K1's forward (common.cuh:
// ldmatrix, mma.sync m16n8k16 with float32 accumulators, 16-byte cp.async
// into rows padded by 16 bytes):
//  * bwd_dkdv_mma: one CTA per (64-key tile, kv head, batch row), 4 warps,
//    each owning 16 keys, keys as the M dimension.  It walks every query
//    head of the kv head's group and every query tile that causality and
//    the window let see its keys (64 rows each), so the GQA sum stays in
//    registers.  The tile's q, dO, lse and D come in by cp.async through a
//    2-stage ring, the next tile's while this one computes.  Per tile:
//    S^T = K Q^T and dP^T = V dO^T on the tensor cores (K and V read as A
//    fragments from shared memory, Q and dO as B fragments); then
//    P^T = exp(scale S^T - lse) and dS^T = P^T o (dP^T - D) in registers,
//    rounded to bf16 there and used directly as the A operands of
//    dV += P^T dO and dK += dS^T Q (dO and Q by ldmatrix.trans).  No score
//    tile goes through shared memory.  At hd 128 a warp's dK and dV hold
//    128 float32 registers a lane, so K and V stay in shared memory rather
//    than in registers: the score tiles fit beside dK and dV in 255
//    registers with no spill;
//  * bwd_dq_mma: one CTA per (64-row query tile, head, batch row), the
//    longest causal rows first, queries as M.  Q and dO stay in shared
//    memory, K and V tiles stream through a 2-stage ring; S = Q K^T and
//    dP = dO V^T, dS in registers rounded to bf16 as the A operand of
//    dQ += dS K (K by ldmatrix.trans);
//  * the causal, window and ragged-S mask is applied per element only on
//    the tiles that need it; tiles masked for every pair are never loaded;
//    rows past S are zero-filled by the copies' source size;
//  * dK, dV and dQ are staged in the warp's own rows of a tile in shared
//    memory and written with 16-byte stores.
//  About 104 KB of shared memory a CTA at hd 128: two CTAs per SM.
//
// On an H100 80GB HBM3 at 700 W, 0.22 ms at deepseek-7b's training shape,
// 1.6 times the library's backward (PERF.md).  What it leaves on the
// table: mma.sync issues from each warp with its
// operands through ldmatrix, which reaches about two thirds of the card's
// tensor-core rate at best; the dQ pass recomputes S and dP (7 products for
// 5); and rounding P and dS to bf16 costs about 2^-9 relative per element.
// The next step is wgmma with TMA loads from a producer warp.
//
// float32 (the float32 gradient gate's path and nothing else's; TF32 would
// miss its 1e-4 bar): bwd_dkdv and bwd_dq, simple kernels on the CUDA
// cores in the same three launches:
//  * bwd_dkdv: one CTA per (64-key tile, kv head, batch row); K and V stay
//    in shared memory while the CTA walks the group's query heads and the
//    visible query tiles; dK and dV accumulate in registers;
//  * bwd_dq: one CTA per (64-row query tile, head, batch row);
//  * 256 threads; a thread owns rows ty + 16a and columns tx + 16c of each
//    64 x 64 score tile and of each accumulator tile.  Rows of the tiles in
//    shared memory are padded by one float.  About 162 KB of shared memory
//    at hd 128: one CTA per SM.

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using repro::cp_async16;
using repro::cp_async4;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::ldsm_x4;
using repro::ldsm_x4_trans;
using repro::mma_bf16;
using repro::pack_bf16;
using repro::store;
using repro::to_f32;
using bf16 = __nv_bfloat16;

constexpr int BQ = 64;    // query rows per tile
constexpr int BK = 64;    // keys per tile
constexpr int NT = 256;   // threads of a float32 CTA: a 16 x 16 grid (tx, ty)
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

// D[b,h,p] = sum_d dO[b,p,h,d] O[b,p,h,d]: each (b, p, h) row read by hd / V
// neighbouring lanes, 16 bytes (V values) of o and of dO each
template <typename T, int HD>
__global__ void bwd_dot(const T* __restrict__ o, const T* __restrict__ dout,
                        float* __restrict__ D, int S, int H, long long rows) {
  constexpr int V = 16 / sizeof(T), L = HD / V;   // lanes per row
  const long long x = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long row = x / L;
  const int part = (int)(x % L);
  float acc = 0.f;
  if (row < rows) {
    const uint4 a = *reinterpret_cast<const uint4*>(o + row * HD + part * V);
    const uint4 g = *reinterpret_cast<const uint4*>(dout + row * HD + part * V);
    const T* av = reinterpret_cast<const T*>(&a);
    const T* gv = reinterpret_cast<const T*>(&g);
#pragma unroll
    for (int e = 0; e < V; ++e) acc = fmaf(to_f32(av[e]), to_f32(gv[e]), acc);
  }
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < rows && part == 0) {
    const long long b = row / ((long long)S * H);
    const int p = (int)((row / H) % S), h = (int)(row % H);
    D[(b * H + h) * S + p] = acc;
  }
}

// ---------------------------------------------------------------------------
// float32: the CUDA cores
// ---------------------------------------------------------------------------

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


// ---------------------------------------------------------------------------
// bf16: tensor cores and a cp.async ring
// ---------------------------------------------------------------------------

constexpr int MT = 128;      // threads of a bf16 CTA: 4 warps of 16 rows each
constexpr int PAD = 8;       // bf16 elements (16 bytes) of padding per shared row
constexpr float LOG2E = 1.4426950408889634f;

template <int HD>
constexpr size_t dkdv_smem_bytes() {
  // K and V of the CTA's keys, two stages of the q and dO tiles, and lse
  // and D of each stage's rows
  return sizeof(bf16) * (2 * BK + 4 * BQ) * (HD + PAD) + sizeof(float) * 4 * BQ;
}

template <int HD>
constexpr size_t dq_smem_bytes() {
  // the q and dO tiles, and two stages of the k and v tiles
  return sizeof(bf16) * (2 * BQ + 4 * BK) * (HD + PAD);
}

// ROWS rows from position p0 of src (row stride `stride`) into dst by
// 16-byte cp.async, rows past S zero-filled
template <int HD, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long long stride, int p0,
                                          int S) {
  constexpr int CH = HD / 8;
  for (int c = threadIdx.x; c < ROWS * CH; c += MT) {
    const int r = c / CH, cc = c % CH, p = p0 + r;
    const bool in = p < S;
    cp_async16(dst + r * (HD + PAD) + cc * 8, in ? src + p * stride + cc * 8 : src, in ? 16 : 0);
  }
}

// N floats from src[p0..] into dst by 4-byte cp.async, past S zero-filled
template <int N>
__device__ __forceinline__ void load_vec(float* dst, const float* src, int p0, int S) {
  for (int r = threadIdx.x; r < N; r += MT) {
    const bool in = p0 + r < S;
    cp_async4(dst + r, in ? src + p0 + r : src, in ? 4 : 0);
  }
}

// A warp's 16 rows of acc (scaled) as bf16 into its rows dst of a shared
// tile, then to device memory with 16-byte stores: positions p0 .. p0+15
// of out (row stride `stride`), those below S
template <int HD>
__device__ __forceinline__ void store_rows(bf16* dst, const float (&acc)[HD / 8][4], float scale,
                                           bf16* out, long long stride, int p0, int S) {
  constexpr int LD = HD + PAD, CH = HD / 8;
  const int lane = threadIdx.x & 31, gr = lane >> 2, tg = lane & 3;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    *reinterpret_cast<uint32_t*>(dst + gr * LD + n * 8 + tg * 2) =
        pack_bf16(acc[n][0] * scale, acc[n][1] * scale);
    *reinterpret_cast<uint32_t*>(dst + (gr + 8) * LD + n * 8 + tg * 2) =
        pack_bf16(acc[n][2] * scale, acc[n][3] * scale);
  }
  __syncwarp();
  for (int c = lane; c < 16 * CH; c += 32) {
    const int r = c / CH, cc = c % CH, p = p0 + r;
    if (p < S)
      *reinterpret_cast<uint4*>(out + p * stride + cc * 8) =
          *reinterpret_cast<const uint4*>(dst + r * LD + cc * 8);
  }
}

// dK and dV of 64 keys: keys as M, each warp 16 of them, against query
// tiles of QT rows (tiles of 32, which take fewer registers at hd 128, were
// slower on the card).  Lane l holds, of each 16 x 8 score tile, keys l/4
// and l/4+8 at queries 2(l%4) and +1.
template <int HD>
__global__ void __launch_bounds__(MT, 2)
bwd_dkdv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
             const bf16* __restrict__ dout, const float* __restrict__ lse,
             const float* __restrict__ D, bf16* __restrict__ dk, bf16* __restrict__ dv, int S,
             int H, int KH, int window, float scale_log2, float scale) {
  constexpr int LD = HD + PAD, QT = BQ;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);   // [BK][LD]; then each warp's dK rows
  bf16* Vs = Ks + BK * LD;                         // [BK][LD]; then each warp's dV rows
  bf16* Qs = Vs + BK * LD;                         // [2][QT][LD]
  bf16* dOs = Qs + 2 * QT * LD;                    // [2][QT][LD]
  float* Ls = reinterpret_cast<float*>(dOs + 2 * QT * LD);   // [2][QT] lse of the rows
  float* Ds = Ls + 2 * QT;                                   // [2][QT] D of the rows

  const int k0 = blockIdx.x * BK, kh = blockIdx.y, b = blockIdx.z;
  const int G = H / KH;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tg = lane & 3;   // fragment row and column pair
  const int mi = lane >> 3, mr = lane & 7;   // ldmatrix: this lane's matrix and row
  const long long q_stride = (long long)H * HD, kv_stride = (long long)KH * HD;
  const long long kv_base = (long long)b * S * kv_stride + (long long)kh * HD;

  // the jobs: each query head of the group times each query tile with a row
  // that sees a key of this tile
  const int k_last = min(k0 + BK - 1, S - 1);
  const int q_last = window > 0 ? min(S - 1, k_last + window - 1) : S - 1;
  const int t_begin = k0 / QT, nt = q_last / QT - t_begin + 1, jobs = G * nt;
  auto load_job = [&](int j, int st) {
    const int h = kh * G + j / nt, q0 = (t_begin + j % nt) * QT;
    const long long q_base = (long long)b * S * q_stride + (long long)h * HD;
    const long long row = ((long long)b * H + h) * S;
    load_tile<HD, QT>(Qs + st * QT * LD, q + q_base, q_stride, q0, S);
    load_tile<HD, QT>(dOs + st * QT * LD, dout + q_base, q_stride, q0, S);
    load_vec<QT>(Ls + st * QT, lse + row, q0, S);
    load_vec<QT>(Ds + st * QT, D + row, q0, S);
  };

  load_tile<HD, BK>(Ks, k + kv_base, kv_stride, k0, S);
  load_tile<HD, BK>(Vs, v + kv_base, kv_stride, k0, S);
  load_job(0, 0);
  cp_async_commit();

  float accK[HD / 8][4], accV[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) accK[n][e] = accV[n][e] = 0.f;
  const int kw = k0 + warp * 16;   // the warp's first key
  const int a_off = (warp * 16 + mr + (mi & 1) * 8) * LD + (mi >> 1) * 8;   // its A fragments

  for (int j = 0; j < jobs; ++j) {
    const int st = j & 1;
    if (j + 1 < jobs) load_job(j + 1, st ^ 1);   // streams in while this job computes
    cp_async_commit();
    cp_async_wait<1>();   // all but the newest group: job j has landed
    __syncthreads();
    const bf16* Qt = Qs + st * QT * LD;
    const bf16* Gt = dOs + st * QT * LD;
    const float* Lt = Ls + st * QT;
    const float* Dt = Ds + st * QT;
    const int q0 = (t_begin + j % nt) * QT;

    // S^T = K Q^T and dP^T = V dO^T: 16 keys x QT queries per warp
    float s[QT / 8][4], dp[QT / 8][4];
#pragma unroll
    for (int n = 0; n < QT / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < HD / 16; ++kc) {
      uint32_t kf[4], vf[4];
      ldsm_x4(kf, Ks + a_off + kc * 16);
      ldsm_x4(vf, Vs + a_off + kc * 16);
#pragma unroll
      for (int np = 0; np < QT / 16; ++np) {
        uint32_t qb[4], gb[4];   // B fragments of query tiles 2np and 2np+1
        const int off = (np * 16 + mr + (mi >> 1) * 8) * LD + kc * 16 + (mi & 1) * 8;
        ldsm_x4(qb, Qt + off);
        ldsm_x4(gb, Gt + off);
        mma_bf16(s[2 * np], kf, qb[0], qb[1]);
        mma_bf16(s[2 * np + 1], kf, qb[2], qb[3]);
        mma_bf16(dp[2 * np], vf, gb[0], gb[1]);
        mma_bf16(dp[2 * np + 1], vf, gb[2], gb[3]);
      }
    }

    // P^T = exp(scale S^T - lse) and dS^T = P^T o (dP^T - D), in base-2
    // units.  A tile whose keys all lie at or below its first query, inside
    // S and inside the window of its last query needs no mask.
    const bool full =
        kw + 15 <= q0 && q0 + QT <= S && (window <= 0 || q0 + QT - 1 - kw < window);
#pragma unroll
    for (int n = 0; n < QT / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + tg * 2 + (e & 1);
        float p = exp2f(fmaf(s[n][e], scale_log2, -Lt[col] * LOG2E));
        if (!full && !visible(q0 + col, kw + gr + (e >> 1) * 8, S, window)) p = 0.f;
        s[n][e] = p;
        dp[n][e] = p * (dp[n][e] - Dt[col]);
      }

    // dV += P^T dO and dK += dS^T Q: P^T and dS^T rounded to bf16 in
    // registers as the A operands, dO and Q as B by ldmatrix.trans
#pragma unroll
    for (int kc = 0; kc < QT / 16; ++kc) {
      const uint32_t pf[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                              pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                              pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                              pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
      const uint32_t sf[4] = {pack_bf16(dp[2 * kc][0], dp[2 * kc][1]),
                              pack_bf16(dp[2 * kc][2], dp[2 * kc][3]),
                              pack_bf16(dp[2 * kc + 1][0], dp[2 * kc + 1][1]),
                              pack_bf16(dp[2 * kc + 1][2], dp[2 * kc + 1][3])};
#pragma unroll
      for (int d = 0; d < HD / 16; ++d) {
        uint32_t gb[4], qb[4];   // B fragments of output column tiles 2d and 2d+1
        const int off = (kc * 16 + mr + (mi & 1) * 8) * LD + d * 16 + (mi >> 1) * 8;
        ldsm_x4_trans(gb, Gt + off);
        ldsm_x4_trans(qb, Qt + off);
        mma_bf16(accV[2 * d], pf, gb[0], gb[1]);
        mma_bf16(accV[2 * d + 1], pf, gb[2], gb[3]);
        mma_bf16(accK[2 * d], sf, qb[0], qb[1]);
        mma_bf16(accK[2 * d + 1], sf, qb[2], qb[3]);
      }
    }
    __syncthreads();   // every warp is done with stage st before it is refilled
  }

  // a warp read only its own rows of Ks and Vs: they take its dK and dV
  store_rows<HD>(Ks + warp * 16 * LD, accK, scale, dk + kv_base, kv_stride, kw, S);
  store_rows<HD>(Vs + warp * 16 * LD, accV, 1.f, dv + kv_base, kv_stride, kw, S);
}

// dQ of 64 query rows: queries as M, each warp 16 of them, the longest
// causal rows first
template <int HD>
__global__ void __launch_bounds__(MT, 2)
bwd_dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
           const bf16* __restrict__ dout, const float* __restrict__ lse,
           const float* __restrict__ D, bf16* __restrict__ dq, int S, int H, int KH, int window,
           float scale_log2, float scale) {
  constexpr int LD = HD + PAD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);   // [BQ][LD]; then each warp's dQ rows
  bf16* dOs = Qs + BQ * LD;                        // [BQ][LD]
  bf16* Ks = dOs + BQ * LD;                        // [2][BK][LD]
  bf16* Vs = Ks + 2 * BK * LD;                     // [2][BK][LD]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tg = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;
  const long long q_stride = (long long)H * HD, kv_stride = (long long)KH * HD;
  const long long q_base = (long long)b * S * q_stride + (long long)h * HD;
  const long long kv_base = (long long)b * S * kv_stride + (long long)kh * HD;

  // key tiles that hold a key some row of this query tile sees
  const int q_last = min(q0 + BQ - 1, S - 1);
  const int k_first = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_begin = k_first / BK, t_end = q_last / BK;

  load_tile<HD, BQ>(Qs, q + q_base, q_stride, q0, S);
  load_tile<HD, BQ>(dOs, dout + q_base, q_stride, q0, S);
  load_tile<HD, BK>(Ks, k + kv_base, kv_stride, t_begin * BK, S);
  load_tile<HD, BK>(Vs, v + kv_base, kv_stride, t_begin * BK, S);
  cp_async_commit();

  // lse (base 2) and D of the warp's rows gr and gr+8
  const int qw = q0 + warp * 16;
  float lr[2], dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int p = qw + gr + 8 * r;
    const long long at = ((long long)b * H + h) * S + p;
    lr[r] = p < S ? lse[at] * LOG2E : 0.f;
    dr[r] = p < S ? D[at] : 0.f;
  }

  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const int a_off = (warp * 16 + mr + (mi & 1) * 8) * LD + (mi >> 1) * 8;

  for (int t = t_begin; t <= t_end; ++t) {
    const int st = (t - t_begin) & 1;
    if (t < t_end) {   // the next tile streams in while this one computes
      load_tile<HD, BK>(Ks + (st ^ 1) * BK * LD, k + kv_base, kv_stride, (t + 1) * BK, S);
      load_tile<HD, BK>(Vs + (st ^ 1) * BK * LD, v + kv_base, kv_stride, (t + 1) * BK, S);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* Kt = Ks + st * BK * LD;
    const bf16* Vt = Vs + st * BK * LD;

    // S = Q K^T and dP = dO V^T: 16 rows x 64 keys per warp
    float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < HD / 16; ++kc) {
      uint32_t qf[4], gf[4];
      ldsm_x4(qf, Qs + a_off + kc * 16);
      ldsm_x4(gf, dOs + a_off + kc * 16);
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        uint32_t kf[4], vf[4];   // B fragments of key tiles 2np and 2np+1
        const int off = (np * 16 + mr + (mi >> 1) * 8) * LD + kc * 16 + (mi & 1) * 8;
        ldsm_x4(kf, Kt + off);
        ldsm_x4(vf, Vt + off);
        mma_bf16(s[2 * np], qf, kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], qf, kf[2], kf[3]);
        mma_bf16(dp[2 * np], gf, vf[0], vf[1]);
        mma_bf16(dp[2 * np + 1], gf, vf[2], vf[3]);
      }
    }

    // dS = P o (dP - D), P = exp(scale S - lse); the mask as in K1's forward
    const int k0 = t * BK;
    const bool full =
        k0 + BK - 1 <= qw && k0 + BK <= S && (window <= 0 || qw + 15 - k0 < window);
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float p = exp2f(fmaf(s[n][e], scale_log2, -lr[r]));
        if (!full && !visible(qw + gr + 8 * r, k0 + n * 8 + tg * 2 + (e & 1), S, window))
          p = 0.f;
        dp[n][e] = p * (dp[n][e] - dr[r]);
      }

    // dQ += dS K: dS rounded to bf16 in registers as the A operand, K as B
    // by ldmatrix.trans
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      const uint32_t sf[4] = {pack_bf16(dp[2 * kc][0], dp[2 * kc][1]),
                              pack_bf16(dp[2 * kc][2], dp[2 * kc][3]),
                              pack_bf16(dp[2 * kc + 1][0], dp[2 * kc + 1][1]),
                              pack_bf16(dp[2 * kc + 1][2], dp[2 * kc + 1][3])};
#pragma unroll
      for (int d = 0; d < HD / 16; ++d) {
        uint32_t kb[4];
        ldsm_x4_trans(kb, Kt + (kc * 16 + mr + (mi & 1) * 8) * LD + d * 16 + (mi >> 1) * 8);
        mma_bf16(acc[2 * d], sf, kb[0], kb[1]);
        mma_bf16(acc[2 * d + 1], sf, kb[2], kb[3]);
      }
    }
    __syncthreads();   // every warp is done with stage st before it is refilled
  }

  // a warp read only its own rows of Qs: they take its dQ
  store_rows<HD>(Qs + warp * 16 * LD, acc, scale, dq + q_base, q_stride, qw, S);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int HD>
cudaError_t launch_f32(const float* q, const float* k, const float* v, const float* dout,
                       const float* lse, const float* D, float* dq, float* dk, float* dv, int B,
                       int S, int H, int KH, int window, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dkdv<float, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  bwd_dkdv<float, HD><<<dim3((S + BK - 1) / BK, KH, B), NT, smem, stream>>>(
      q, k, v, dout, lse, D, dk, dv, S, H, KH, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(bwd_dq<float, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  bwd_dq<float, HD><<<dim3((S + BQ - 1) / BQ, H, B), NT, smem, stream>>>(
      q, k, v, dout, lse, D, dq, S, H, KH, window, scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_bf16(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
                        const float* lse, const float* D, bf16* dq, bf16* dk, bf16* dv, int B,
                        int S, int H, int KH, int window, float scale, cudaStream_t stream) {
  const size_t s1 = dkdv_smem_bytes<HD>(), s2 = dq_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dkdv_mma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s1);
  if (err != cudaSuccess) return err;
  bwd_dkdv_mma<HD><<<dim3((S + BK - 1) / BK, KH, B), MT, s1, stream>>>(
      q, k, v, dout, lse, D, dk, dv, S, H, KH, window, scale * LOG2E, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(bwd_dq_mma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)s2);
  if (err != cudaSuccess) return err;
  bwd_dq_mma<HD><<<dim3((S + BQ - 1) / BQ, H, B), MT, s2, stream>>>(
      q, k, v, dout, lse, D, dq, S, H, KH, window, scale * LOG2E, scale);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const float* lse, float* D, void* dq, void* dk, void* dv,
                   int B, int S, int H, int KH, int window, float scale, cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(dout);
  const long long rows = (long long)B * S * H, lanes = rows * (HD * sizeof(T) / 16);
  bwd_dot<T, HD><<<(unsigned)((lanes + 255) / 256), 256, 0, stream>>>(static_cast<const T*>(o),
                                                                      gt, D, S, H, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if constexpr (sizeof(T) == sizeof(float))
    return launch_f32<HD>(qt, kt, vt, gt, lse, D, static_cast<T*>(dq), static_cast<T*>(dk),
                          static_cast<T*>(dv), B, S, H, KH, window, scale, stream);
  else
    return launch_bf16<HD>(qt, kt, vt, gt, lse, D, static_cast<T*>(dq), static_cast<T*>(dk),
                           static_cast<T*>(dv), B, S, H, KH, window, scale, stream);
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
