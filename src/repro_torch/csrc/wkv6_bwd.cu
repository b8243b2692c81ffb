// WKV-6 backward (kernel K3-bwd of the port) for Hopper, sm_90a.
//
// No TPU kernel stands behind it: the JAX package never differentiates its
// Pallas WKV kernel (pallas_call has no reverse-mode rule there), so its
// training differentiates the plain models/ssm.py::wkv_ref through XLA.
// This is the gradient of that same recurrence (K3, wkv6.cu), per batch row
// b and head h, with S_t the state after step t (S_-1 = s0) and dS the
// running gradient of S_t, starting at dS_T, the gradient of the final
// state, and going back over t:
//     dr_t[i] = sum_j dO_t[j] (S_{t-1}[i,j] + u[i] k_t[i] v_t[j])
//     dk_t[i] = u[i] r_t[i] (dO_t . v_t) + sum_j dS[i,j] v_t[j]
//     dv_t[j] = (sum_i r_t[i] u[i] k_t[i]) dO_t[j] + sum_i dS[i,j] k_t[i]
//     dw_t[i] = sum_j dS[i,j] S_{t-1}[i,j]
//     du[i]  += r_t[i] k_t[i] (dO_t . v_t)
//     dS      = diag(w_t) dS + r_t dO_t^T          (now the gradient of S_{t-1})
// and ds0 is the last dS.  du sums over B and T.
//
// What bounds it on this card.  Every input is read and every output
// written once: r, k, v, w, dO, dr, dk, dv, dw of B*T*H*hd floats, and s0,
// dS_T and ds0 of B*H*hd*hd.  At rwkv6-1.6b's training shape (4,512,32,64)
// that is about 151 MB, 0.045 ms at 3.35 TB/s; the operations, about 9 per
// (i, j) and step, take less at the 67 TFLOP/s float32 peak.
//
// Design: a simple kernel that is right.  The sweep goes back over t and
// needs each S_{t-1}, which the forward did not keep; running the
// recurrence backwards would divide by w_t, which may be near 0.  So:
//  * one CTA per (b, h); a thread holds a 4-row block of S and of dS in
//    registers (4 columns, 8 at hd 128);
//  * a first sweep forward from s0 keeps the state at the start of every
//    16-step chunk in a scratch buffer (ckpt);
//  * the backward sweep takes the chunks last to first: it rebuilds the
//    chunk's 16 states from its checkpoint into a second scratch buffer
//    (hist, 16 states per CTA, small enough to stay in L2), then walks the
//    chunk's steps backwards.  Each thread writes its share of the row sums
//    (dr, dk, dw) and column sums (dv) to shared memory, and hd threads add
//    them up in a fixed order and store a step's outputs: no atomics, so
//    two runs give bit-equal gradients.  A chunk's r, k, v, w and dO are
//    staged in shared memory once;
//  * du is summed per (b, h) in registers and over b by a second kernel.
// The sweep is a dependent loop over t with two barriers a step; the kernel
// is held by that latency, not by bytes (PERF.md has its time).

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int ROWS = 4;   // state rows per thread
constexpr int C = 16;     // steps per chunk

template <int HD>
struct Plan {
  static constexpr int COLS = HD == 128 ? 8 : 4;   // state columns per thread
  static constexpr int RT = HD / ROWS;              // row groups
  static constexpr int CT = HD / COLS;              // column groups
  static constexpr int NT = RT * CT;                // threads per CTA
  static constexpr int E = ROWS * COLS;             // state elements per thread
  // a chunk's r, k, v, w, dO; the row partials of dr, dk, dw; the column
  // partials of dv; u
  static constexpr size_t smem = sizeof(float) * (5 * C * HD + 3 * CT * HD + RT * HD + HD);
};

template <int HD>
__global__ void __launch_bounds__(Plan<HD>::NT)
wkv6_bwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, const float* __restrict__ s0,
                const float* __restrict__ dout, const float* __restrict__ dsT,
                float* __restrict__ dr, float* __restrict__ dk, float* __restrict__ dv,
                float* __restrict__ dw, float* __restrict__ du_part, float* __restrict__ ds0,
                float* __restrict__ ckpt, float* __restrict__ hist, int T, int H) {
  using P = Plan<HD>;
  constexpr int COLS = P::COLS, RT = P::RT, CT = P::CT, NT = P::NT, E = P::E;
  extern __shared__ __align__(16) float sm[];
  float* in = sm;                   // [5][C][HD]: r, k, v, w, dO of a chunk's steps
  float* part_r = in + 5 * C * HD;  // [3][CT][HD]: row partials of dr, dk, dw
  float* part_c = part_r + 3 * CT * HD;   // [RT][HD]: column partials of dv
  float* us = part_c + RT * HD;     // [HD]: u of this head

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, rg = tid % RT, cg = tid / RT;
  const int i0 = rg * ROWS, j0 = cg * COLS;
  const long long xs = (long long)H * HD;                           // between steps
  const long long x0 = (long long)b * T * xs + (long long)h * HD;   // step 0 of (b, h)
  const long long st0 = (long long)bh * HD * HD;                    // this head's state
  const int nch = (T + C - 1) / C;
  float* ck = ckpt + (long long)bh * nch * E * NT;
  float* hs = hist + (long long)bh * C * E * NT;

  for (int i = tid; i < HD; i += NT) us[i] = u[h * HD + i];

  // steps t0 .. t0+n-1 of the arrays whose bit is set in `mask` (r, k, v, w,
  // dO = bits 0..4) into `in`; steps past n zero-filled
  auto stage = [&](int t0, int n, int mask) {
    __syncthreads();   // every read of the last chunk is done
    for (int x = tid; x < 5 * C * HD; x += NT) {
      const int a = x / (C * HD), s = (x / HD) % C, i = x % HD;
      if (!((mask >> a) & 1)) continue;
      const float* src = a == 0 ? r : a == 1 ? k : a == 2 ? v : a == 3 ? w : dout;
      in[x] = s < n ? src[x0 + (t0 + s) * xs + i] : 0.f;
    }
    __syncthreads();
  };
  auto IN = [&](int a, int s, int i) -> float { return in[(a * C + s) * HD + i]; };
  // S <- diag(w_s) S + k_s v_s^T, step s of the staged chunk
  auto advance = [&](float (&S)[ROWS][COLS], int s) {
#pragma unroll
    for (int a = 0; a < ROWS; ++a) {
      const float kk = IN(1, s, i0 + a), ww = IN(3, s, i0 + a);
#pragma unroll
      for (int c = 0; c < COLS; ++c) S[a][c] = ww * S[a][c] + kk * IN(2, s, j0 + c);
    }
  };

  float S[ROWS][COLS];
#pragma unroll
  for (int a = 0; a < ROWS; ++a)
#pragma unroll
    for (int c = 0; c < COLS; ++c) S[a][c] = s0[st0 + (i0 + a) * HD + j0 + c];

  // sweep 1: the state at the start of every chunk
  for (int ch = 0; ch < nch; ++ch) {
#pragma unroll
    for (int a = 0; a < ROWS; ++a)
#pragma unroll
      for (int c = 0; c < COLS; ++c) ck[(ch * E + a * COLS + c) * NT + tid] = S[a][c];
    if (ch == nch - 1) break;
    stage(ch * C, C, 0b01110);
    for (int s = 0; s < C; ++s) advance(S, s);
  }

  // sweep 2, backwards, a chunk at a time
  float dS[ROWS][COLS];
#pragma unroll
  for (int a = 0; a < ROWS; ++a)
#pragma unroll
    for (int c = 0; c < COLS; ++c) dS[a][c] = dsT[st0 + (i0 + a) * HD + j0 + c];
  float du_acc = 0.f;   // row tid's share of du, for tid < HD

  for (int ch = nch - 1; ch >= 0; --ch) {
    const int t0 = ch * C, n = min(C, T - t0);
    stage(t0, n, 0b11111);
    // the chunk's states: hs[s] = S_{t0+s-1}, the state before step t0+s
#pragma unroll
    for (int a = 0; a < ROWS; ++a)
#pragma unroll
      for (int c = 0; c < COLS; ++c) S[a][c] = ck[(ch * E + a * COLS + c) * NT + tid];
    for (int s = 0; s < n; ++s) {
#pragma unroll
      for (int a = 0; a < ROWS; ++a)
#pragma unroll
        for (int c = 0; c < COLS; ++c) hs[(s * E + a * COLS + c) * NT + tid] = S[a][c];
      if (s + 1 < n) advance(S, s);
    }

    for (int s = n - 1; s >= 0; --s) {
      float Sp[ROWS][COLS];
#pragma unroll
      for (int a = 0; a < ROWS; ++a)
#pragma unroll
        for (int c = 0; c < COLS; ++c) Sp[a][c] = hs[(s * E + a * COLS + c) * NT + tid];
      float pc[COLS];
#pragma unroll
      for (int c = 0; c < COLS; ++c) pc[c] = 0.f;
#pragma unroll
      for (int a = 0; a < ROWS; ++a) {
        const int i = i0 + a;
        const float kk = IN(1, s, i);
        float pr = 0.f, pk = 0.f, pw = 0.f;
#pragma unroll
        for (int c = 0; c < COLS; ++c) {
          const int j = j0 + c;
          pr = fmaf(IN(4, s, j), Sp[a][c], pr);
          pk = fmaf(dS[a][c], IN(2, s, j), pk);
          pw = fmaf(dS[a][c], Sp[a][c], pw);
          pc[c] = fmaf(dS[a][c], kk, pc[c]);
        }
        part_r[(0 * CT + cg) * HD + i] = pr;
        part_r[(1 * CT + cg) * HD + i] = pk;
        part_r[(2 * CT + cg) * HD + i] = pw;
      }
#pragma unroll
      for (int c = 0; c < COLS; ++c) part_c[rg * HD + j0 + c] = pc[c];
      // dS <- diag(w) dS + r dO^T: now the gradient of the state before step s
#pragma unroll
      for (int a = 0; a < ROWS; ++a) {
        const float ww = IN(3, s, i0 + a), rr = IN(0, s, i0 + a);
#pragma unroll
        for (int c = 0; c < COLS; ++c) dS[a][c] = ww * dS[a][c] + rr * IN(4, s, j0 + c);
      }
      __syncthreads();
      if (tid < HD) {
        const int i = tid;
        float dov = 0.f, ruk = 0.f;
        for (int x = 0; x < HD; ++x) {
          dov = fmaf(IN(4, s, x), IN(2, s, x), dov);
          ruk = fmaf(IN(0, s, x) * us[x], IN(1, s, x), ruk);
        }
        float a_r = 0.f, a_k = 0.f, a_w = 0.f, a_v = 0.f;
        for (int g = 0; g < CT; ++g) {
          a_r += part_r[(0 * CT + g) * HD + i];
          a_k += part_r[(1 * CT + g) * HD + i];
          a_w += part_r[(2 * CT + g) * HD + i];
        }
        for (int g = 0; g < RT; ++g) a_v += part_c[g * HD + i];
        const float ri = IN(0, s, i), ki = IN(1, s, i), ui = us[i];
        const long long at = x0 + (t0 + s) * xs + i;
        dr[at] = a_r + ui * ki * dov;
        dk[at] = a_k + ui * ri * dov;
        dw[at] = a_w;
        dv[at] = a_v + ruk * IN(4, s, i);
        du_acc = fmaf(ri * ki, dov, du_acc);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int a = 0; a < ROWS; ++a)
#pragma unroll
    for (int c = 0; c < COLS; ++c) ds0[st0 + (i0 + a) * HD + j0 + c] = dS[a][c];
  if (tid < HD) du_part[(long long)bh * HD + tid] = du_acc;
}

// du[h, i] = sum over b of du_part[b, h, i], in order of b
__global__ void du_sum(const float* __restrict__ du_part, float* __restrict__ du, int B,
                       int n) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= n) return;
  float acc = 0.f;
  for (int b = 0; b < B; ++b) acc += du_part[(long long)b * n + x];
  du[x] = acc;
}

template <int HD>
cudaError_t launch(const float* r, const float* k, const float* v, const float* w,
                   const float* u, const float* s0, const float* dout, const float* dsT,
                   float* dr, float* dk, float* dv, float* dw, float* du, float* ds0,
                   float* du_part, float* ckpt, float* hist, int B, int T, int H,
                   cudaStream_t stream) {
  using P = Plan<HD>;
  cudaError_t err = cudaFuncSetAttribute(wkv6_bwd_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)P::smem);
  if (err != cudaSuccess) return err;
  wkv6_bwd_kernel<HD><<<B * H, P::NT, P::smem, stream>>>(
      r, k, v, w, u, s0, dout, dsT, dr, dk, dv, dw, du_part, ds0, ckpt, hist, T, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = H * HD;
  du_sum<<<(n + 255) / 256, 256, 0, stream>>>(du_part, du, B, n);
  return cudaGetLastError();
}

}  // namespace

// r, k, v, w, dout, dr, dk, dv, dw: (B,T,H,hd); u, du: (H,hd); s0, dsT, ds0:
// (B,H,hd,hd); scratch: du_part (B,H,hd), ckpt B*H*ceil(T/16)*hd*hd floats
// and hist B*H*16*hd*hd floats; all float32, contiguous.  hd in
// {16, 32, 64, 128}.  Launches on `stream` and returns the first failing
// launch's cudaError_t (0 on success).
extern "C" int repro_wkv6_bwd(const float* r, const float* k, const float* v, const float* w,
                              const float* u, const float* s0, const float* dout,
                              const float* dsT, float* dr, float* dk, float* dv, float* dw,
                              float* du, float* ds0, float* du_part, float* ckpt,
                              float* hist, int B, int T, int H, int hd, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return (int)launch<16>(r, k, v, w, u, s0, dout, dsT, dr, dk, dv, dw, du, ds0, du_part, ckpt, hist, B, T, H, st);
    case 32: return (int)launch<32>(r, k, v, w, u, s0, dout, dsT, dr, dk, dv, dw, du, ds0, du_part, ckpt, hist, B, T, H, st);
    case 64: return (int)launch<64>(r, k, v, w, u, s0, dout, dsT, dr, dk, dv, dw, du, ds0, du_part, ckpt, hist, B, T, H, st);
    case 128: return (int)launch<128>(r, k, v, w, u, s0, dout, dsT, dr, dk, dv, dw, du, ds0, du_part, ckpt, hist, B, T, H, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
