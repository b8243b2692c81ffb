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
// that is about 151 MB, 0.045 ms at 3.35 TB/s; the operations, about 14
// per (i, j) and step (the state rebuilt, the four sums and the dS update),
// take 0.056 ms at the 67 TFLOP/s float32 peak: bound by operations.
//
// Design.  Columns j of S and of dS evolve independently in both
// directions (S[:, j] needs only v[j]; dS[:, j] = diag(w) dS[:, j] +
// r dO[j]), and dv[j] and column j of ds0 are sums over rows alone:
//  * a head is split by column over a thread-block cluster of P CTAs of 32
//    columns each, or one CTA where the head is narrower (the host's
//    kernels/rwkv/wkv_bwd.py::split_plan; 256 CTAs of 128 threads at the
//    training shape; 16-column CTAs, more of them, were slower on the
//    card).  A thread holds a 4 x 4 block of S and of dS in registers
//    (rows 4 rg .. +3, columns 4 cg .. +3); the column groups of a row
//    group are neighbouring lanes, so a warp holds every column of the CTA;
//  * the states are kept every 16 steps (a chunk): a first sweep forward
//    from s0 writes each chunk's starting state to a scratch buffer (ckpt),
//    since the recurrence run backwards would divide by decays near 0;
//  * the backward sweep takes the chunks last to first.  A chunk's r, k, w
//    (whole rows), v and dO (the CTA's columns) and its starting state
//    arrive by 16-byte cp.async in a 2-stage ring, the next chunk's while
//    this one computes.  The chunk is walked forwards from its starting
//    state through its first 12 steps, keeping the states before steps 4,
//    8 and 12 in shared memory; then backwards, four steps at a time, each
//    group's four states rebuilt in registers from the kept one, carrying
//    only dS (dr's state part, sum_j dO[j] S_{t-1}[i,j], needs no dS);
//  * per step, a thread's row partials of dr, dk and dw are summed over the
//    warp's lanes by a shuffle reduce-scatter and stored once per row in
//    shared memory; its column partials of dv likewise over the warp's rows,
//    then per warp.  The per-step scalars dO.v and r.u.k do not depend on
//    the state: each chunk's are computed when it has landed, a warp each;
//  * once a chunk: one cluster barrier, then each CTA sums a share of the
//    chunk's (step, row) pairs over the cluster's CTAs through distributed
//    shared memory, in rank order, adds the u terms and stores dr, dk, dw;
//    and sums its own warps' dv.  Fixed orders and no atomics, so two runs
//    give bit-equal gradients; no barrier inside a chunk's step loop.
//    The last chunk's steps past T are staged as w = 1 and zeros, which
//    leave S and dS exactly as they are, and their outputs are dropped;
//  * du is summed per thread (a fixed row) in registers, then over threads
//    and B by a second kernel in a fixed order.
// Shared memory at hd 64 and 32 columns: about 104 KB, two CTAs per SM.
//
// On an H100 80GB HBM3 at 700 W, 0.31 ms at rwkv6-1.6b's training shape
// (PERF.md).  What still holds it back: a thread's 4 x 4 block is the
// whole problem's parallelism (B*H*hd*hd/16 threads, about 8 warps an SM
// at the training shape), so the sweep is held by the latency of each
// warp's dependent steps, not by bytes or by the issue rate; every state is
// advanced about 2.5 times (the first sweep, the chunk's forward walk, the
// rebuild of each group); the checkpoints, B*H*T/16*hd*hd floats, cross
// device memory twice.  K3's forward could write them (it runs just
// before) and save the first sweep.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;
using repro::cp_async16;
using repro::cp_async_commit;
using repro::cp_async_wait;

constexpr int ROWS = 4;   // state rows per thread
constexpr int COLS = 4;   // state columns per thread
constexpr int C = 16;     // steps per chunk, between kept states
constexpr int GS = 4;     // steps per group: states rebuilt in registers

template <int HD, int CC>
struct Plan {
  static constexpr int P = HD / CC;                 // CTAs per head: the cluster
  static constexpr int CG = CC / COLS;              // column groups: neighbouring lanes
  static constexpr int NT = CG * (HD / ROWS);       // threads
  static constexpr int WL = NT < 32 ? NT : 32;      // lanes of a warp in use
  static constexpr int RL = WL / CG;                // row groups of a warp
  static constexpr int W = (NT + 31) / 32;          // warps
  static constexpr unsigned MASK = NT < 32 ? (1u << NT) - 1 : 0xffffffffu;
  // shared memory, in floats
  static constexpr int IN = 3 * HD + 2 * CC;        // a step: r, k, w rows; v, dO of the CTA's columns
  static constexpr int RING = 2 * C * IN;
  static constexpr int SLOTS = 2 + C / GS - 1;      // two chunk starts, the states before steps 4, 8, 12
  static constexpr int STASH = SLOTS * NT * ROWS * COLS;
  static constexpr int PART = C * 3 * HD + C;       // a chunk's row partials of dr, dk, dw; its dO.v
  static constexpr int DVP = C * W * CC;            // a chunk's column partials of dv, per warp
  static constexpr int FLOATS = RING + STASH + 2 * PART + DVP + C + HD;
};

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Sums v[0..N) over the L lanes whose lane index differs from this one's in
// the bits STRIDE * {1, 2, .., L/2} (sub: this lane's index among them).
// While more than one value is left, each level keeps half and sends half,
// so on return v[0 .. max(N/L, 1)) hold the sums of elements
// rs_first<N, L>(sub) onwards; a level with one value left adds its pair's.
template <int N, int O, int STRIDE, unsigned MASK>
__device__ __forceinline__ void reduce_scatter(float* v, int sub) {
  if constexpr (O >= 1) {
    if constexpr (N >= 2) {
      const bool up = sub & O;
#pragma unroll
      for (int x = 0; x < N / 2; ++x) {
        const float send = up ? v[x] : v[x + N / 2];
        const float keep = up ? v[x + N / 2] : v[x];
        v[x] = keep + __shfl_xor_sync(MASK, send, O * STRIDE);
      }
      reduce_scatter<N / 2, O / 2, STRIDE, MASK>(v, sub);
    } else {
      v[0] += __shfl_xor_sync(MASK, v[0], O * STRIDE);
      reduce_scatter<1, O / 2, STRIDE, MASK>(v, sub);
    }
  }
}
// the first element whose sum v[0] holds after reduce_scatter<N, L/2, ..>
template <int N, int L>
__device__ __forceinline__ int rs_first(int sub) {
  int first = 0, n = N;
#pragma unroll
  for (int o = L / 2; o >= 1; o /= 2)
    if (n >= 2) {
      n /= 2;
      if (sub & o) first += n;
    }
  return first;
}
// whether this lane holds the sum alone among the lanes that hold the same
// elements (those are its pairs at the levels with one value left)
template <int N, int L>
__device__ __forceinline__ bool rs_primary(int sub) {
  return N >= L || (sub & (L / N - 1)) == 0;
}

template <int HD, int CC>
__global__ void __launch_bounds__(Plan<HD, CC>::NT)
wkv6_bwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, const float* __restrict__ s0,
                const float* __restrict__ dout, const float* __restrict__ dsT,
                float* __restrict__ dr, float* __restrict__ dk, float* __restrict__ dv,
                float* __restrict__ dw, float* __restrict__ du_part, float* __restrict__ ds0,
                float* __restrict__ ckpt, int T, int H) {
  using PL = Plan<HD, CC>;
  constexpr int P = PL::P, CG = PL::CG, NT = PL::NT, RL = PL::RL, W = PL::W, IN = PL::IN;
  constexpr unsigned MASK = PL::MASK;
  extern __shared__ __align__(16) float sm[];
  float* ring = sm;                          // [2][C][IN]
  float* stash = ring + PL::RING;            // [SLOTS][4][NT] float4: a thread's 4 x 4 blocks
  float* part = stash + PL::STASH;           // [2][PART], by chunk parity; read by the cluster
  float* dvp = part + 2 * PL::PART;          // [C][W][CC]
  float* ruk = dvp + PL::DVP;                // [C]: r.u.k of a chunk's steps
  float* us = ruk + C;                       // [HD]: u of this head

  cg::cluster_group cluster = cg::this_cluster();
  const int p = (int)cluster.block_rank();
  const int bh = blockIdx.x / P, b = bh / H, h = bh % H;
  const int j0 = p * CC;                     // the CTA's first column
  const int tid = threadIdx.x, cgi = tid % CG, rg = tid / CG;
  const int i0 = rg * ROWS, c0 = cgi * COLS;
  const int warp = tid / 32, lane = tid % 32, rsub = lane / CG;   // row group within the warp
  const long long xs = (long long)H * HD;                            // between steps
  const long long x0 = (long long)b * T * xs + (long long)h * HD;    // step 0 of (b, h)
  const long long sbase = (long long)bh * HD * HD + (long long)i0 * HD + j0 + c0;
  const int nch = (T + C - 1) / C;
  float* ck = ckpt + (long long)blockIdx.x * nch * NT * ROWS * COLS;   // [nch][4][NT] float4

  for (int i = tid; i < HD; i += NT) us[i] = u[h * HD + i];

  // chunk ch's steps into ring stage st: r, k, w (whole rows) and v, dO
  // (the CTA's columns); steps past T as w = 1, the rest 0, which leave S
  // and dS exactly as they are
  auto stage = [&](int ch, int st) {
    constexpr int RW = HD / 4, CW = CC / 4, WORDS = 3 * RW + 2 * CW;
    const int t0 = ch * C, n = min(C, T - t0);
    float* dst = ring + st * C * IN;
    for (int x = tid; x < C * WORDS; x += NT) {
      const int s = x / WORDS, y = x % WORDS;
      const int a = y < 3 * RW ? y / RW : 3 + (y - 3 * RW) / CW;   // r, k, w, v, dO
      const int off = a < 3 ? a * HD + 4 * (y % RW) : 3 * HD + (a - 3) * CC + 4 * ((y - 3 * RW) % CW);
      const int col = a < 3 ? 4 * (y % RW) : j0 + 4 * ((y - 3 * RW) % CW);
      float* d = dst + s * IN + off;
      if (s < n) {
        const float* src = a == 0 ? r : a == 1 ? k : a == 2 ? w : a == 3 ? v : dout;
        cp_async16(d, src + x0 + (long long)(t0 + s) * xs + col, 16);
      } else {
        const float f = a == 2 ? 1.f : 0.f;
        *reinterpret_cast<float4*>(d) = make_float4(f, f, f, f);
      }
    }
  };
  auto slot = [&](int sl, int a) { return stash + ((sl * ROWS + a) * NT + tid) * 4; };
  auto put = [&](float* p4, const float (&x)[COLS]) {
    *reinterpret_cast<float4*>(p4) = make_float4(x[0], x[1], x[2], x[3]);
  };
  auto get = [&](float (&x)[COLS], const float* p4) {
    const float4 y = lds4(p4);
    x[0] = y.x, x[1] = y.y, x[2] = y.z, x[3] = y.w;
  };
  // X <- diag(w_s) X + k_s v_s^T, from a staged step's rows of k, w and v
  auto advance = [&](float (&X)[ROWS][COLS], const float* kr, const float* wr, const float* vr) {
    const float4 k4 = lds4(kr + i0), w4 = lds4(wr + i0), v4 = lds4(vr + c0);
    const float kk[ROWS] = {k4.x, k4.y, k4.z, k4.w}, ww[ROWS] = {w4.x, w4.y, w4.z, w4.w};
    const float vv[COLS] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
    for (int a = 0; a < ROWS; ++a)
#pragma unroll
      for (int c = 0; c < COLS; ++c) X[a][c] = fmaf(ww[a], X[a][c], kk[a] * vv[c]);
  };

  float S[ROWS][COLS], dS[ROWS][COLS];
#pragma unroll
  for (int a = 0; a < ROWS; ++a) {
    const float4 y = *reinterpret_cast<const float4*>(s0 + sbase + (long long)a * HD);
    const float4 z = *reinterpret_cast<const float4*>(dsT + sbase + (long long)a * HD);
    S[a][0] = y.x, S[a][1] = y.y, S[a][2] = y.z, S[a][3] = y.w;
    dS[a][0] = z.x, dS[a][1] = z.y, dS[a][2] = z.z, dS[a][3] = z.w;
  }

  // sweep 1: the state at the start of every chunk but the last, to ckpt.
  // It needs k, w and v alone, so the ring holds three of its chunks (SW
  // floats a step): two stream in while one computes
  constexpr int SW = 2 * HD + CC;
  static_assert(3 * C * SW <= PL::RING, "sweep 1's ring");
  auto stage1 = [&](int ch, int st) {
    constexpr int RW = HD / 4, CW = CC / 4, WORDS = 2 * RW + CW;
    float* dst = ring + st * C * SW;
    for (int x = tid; x < C * WORDS; x += NT) {
      const int s = x / WORDS, y = x % WORDS;
      const float* src = y < RW ? k : y < 2 * RW ? w : v;
      const int col = y < 2 * RW ? 4 * (y % RW) : j0 + 4 * (y - 2 * RW);
      cp_async16(dst + s * SW + 4 * y, src + x0 + (long long)(ch * C + s) * xs + col, 16);
    }
  };
  for (int c = 0; c < 2; ++c) {
    if (c < nch - 1) stage1(c, c);
    cp_async_commit();
  }
  for (int ch = 0; ch + 1 < nch; ++ch) {
    cp_async_wait<1>();
    __syncthreads();   // chunk ch has landed, and the stage of chunk ch - 1 is free
    if (ch + 3 < nch) stage1(ch + 2, (ch + 2) % 3);
    cp_async_commit();
#pragma unroll
    for (int a = 0; a < ROWS; ++a) put(ck + ((ch * ROWS + a) * NT + tid) * 4, S[a]);
    const float* base = ring + (ch % 3) * C * SW;
#pragma unroll 4
    for (int s = 0; s < C; ++s)
      advance(S, base + s * SW, base + s * SW + HD, base + s * SW + 2 * HD);
  }
  // the last chunk starts from S: its slot, read by this thread alone
#pragma unroll
  for (int a = 0; a < ROWS; ++a) put(slot((nch - 1) & 1, a), S[a]);
  cp_async_wait<0>();
  __syncthreads();   // every stage of sweep 1 is free
  stage(nch - 1, 0);   // the backward sweep's first chunk
  cp_async_commit();

  float du_acc = 0.f;   // du of row (p * NT + tid) % HD, for the pairs this thread sums
  // the outputs of chunk chr (ring stage st), after every CTA's partials of
  // it are complete: this CTA's share of the (step, row) pairs summed over
  // the cluster in rank order (every load first: the partials of steps
  // past T are read and dropped), and the dv of its columns summed over its
  // warps in order
  auto reduce = [&](int chr, int st) {
    constexpr int PAIRS = C * HD / (P * NT), DPAIRS = C * CC / NT;   // per thread
    const int t0 = chr * C, n = min(C, T - t0);
    const float* base = ring + st * C * IN;
    const float* mine = part + (chr & 1) * PL::PART;
    float a_r[PAIRS], a_k[PAIRS], a_w[PAIRS], dov[PAIRS];
#pragma unroll
    for (int m = 0; m < PAIRS; ++m) a_r[m] = a_k[m] = a_w[m] = dov[m] = 0.f;
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const float* pq = cluster.map_shared_rank(mine, q);
#pragma unroll
      for (int m = 0; m < PAIRS; ++m) {
        const int x = p * NT + tid + m * P * NT, s = x / HD, i = x % HD;
        a_r[m] += pq[(s * 3 + 0) * HD + i];
        a_k[m] += pq[(s * 3 + 1) * HD + i];
        a_w[m] += pq[(s * 3 + 2) * HD + i];
        dov[m] += pq[C * 3 * HD + s];
      }
    }
#pragma unroll
    for (int m = 0; m < PAIRS; ++m) {
      const int x = p * NT + tid + m * P * NT, s = x / HD, i = x % HD;
      if (s < n) {
        const float* in = base + s * IN;
        const float ri = in[i], ki = in[HD + i], ui = us[i];
        const long long at = x0 + (long long)(t0 + s) * xs + i;
        dr[at] = a_r[m] + ui * ki * dov[m];
        dk[at] = a_k[m] + ui * ri * dov[m];
        dw[at] = a_w[m];
        du_acc = fmaf(ri * ki, dov[m], du_acc);
      }
    }
#pragma unroll
    for (int m = 0; m < DPAIRS; ++m) {
      const int x = tid + m * NT, s = x / CC, j = x % CC;
      if (s < n) {
        float a_v = 0.f;
#pragma unroll
        for (int wi = 0; wi < W; ++wi) a_v += dvp[(s * W + wi) * CC + j];
        dv[x0 + (long long)(t0 + s) * xs + j0 + j] = a_v + ruk[s] * base[s * IN + 3 * HD + CC + j];
      }
    }
  };

  int job = 0;   // the backward sweep's chunks in order: job & 1 is the ring stage
  for (int ch = nch - 1; ch >= 0; --ch, ++job) {
    const int st = job & 1;
    float* mine = part + (ch & 1) * PL::PART;
    cp_async_wait<0>();
    // chunk ch and its starting state have landed for every thread; every
    // CTA of the cluster has its partials of chunk ch + 1 complete, and is
    // done reading this CTA's partials of chunk ch + 2 (the same buffer)
    cluster.sync();
    if (ch + 1 < nch) reduce(ch + 1, st ^ 1);
    __syncthreads();   // ring stage st^1, dvp and ruk are free again
    if (ch > 0) {
      stage(ch - 1, st ^ 1);
#pragma unroll
      for (int a = 0; a < ROWS; ++a)
        cp_async16(slot((ch - 1) & 1, a), ck + (((ch - 1) * ROWS + a) * NT + tid) * 4, 16);
    }
    cp_async_commit();
    const float* base = ring + st * C * IN;

    // the chunk's state-free scalars, NT / C neighbouring threads a step:
    // this CTA's share of dO.v, and r.u.k
    {
      constexpr int L = NT / C;
      const int s = tid / L, q = tid % L;
      const float* in = base + s * IN;
      float dov = 0.f, rk = 0.f;
#pragma unroll
      for (int j = q; j < CC; j += L) dov = fmaf(in[3 * HD + CC + j], in[3 * HD + j], dov);
#pragma unroll
      for (int i = q; i < HD; i += L) rk = fmaf(in[i] * us[i], in[HD + i], rk);
#pragma unroll
      for (int o = L / 2; o >= 1; o /= 2) {
        dov += __shfl_xor_sync(MASK, dov, o);
        rk += __shfl_xor_sync(MASK, rk, o);
      }
      if (q == 0) {
        mine[C * 3 * HD + s] = dov;
        ruk[s] = rk;
      }
    }

    // forwards through the chunk's first C - GS steps: the states before
    // steps 4, 8 and 12 kept
    float X[ROWS][COLS];
#pragma unroll
    for (int a = 0; a < ROWS; ++a) get(X[a], slot(ch & 1, a));
#pragma unroll
    for (int s = 0; s < C - GS; ++s) {
      advance(X, base + s * IN + HD, base + s * IN + 2 * HD, base + s * IN + 3 * HD);
      if ((s + 1) % GS == 0) {
#pragma unroll
        for (int a = 0; a < ROWS; ++a) put(slot(1 + (s + 1) / GS, a), X[a]);
      }
    }

    // backwards, a group of GS steps at a time, its states rebuilt in
    // registers from the kept one
#pragma unroll
    for (int g = C / GS - 1; g >= 0; --g) {
      float Xs[GS][ROWS][COLS];
#pragma unroll
      for (int a = 0; a < ROWS; ++a) get(Xs[0][a], slot(g == 0 ? ch & 1 : 1 + g, a));
#pragma unroll
      for (int e = 1; e < GS; ++e) {
#pragma unroll
        for (int a = 0; a < ROWS; ++a)
#pragma unroll
          for (int c = 0; c < COLS; ++c) Xs[e][a][c] = Xs[e - 1][a][c];
        const float* in = base + (g * GS + e - 1) * IN;
        advance(Xs[e], in + HD, in + 2 * HD, in + 3 * HD);
      }
#pragma unroll
      for (int e = GS - 1; e >= 0; --e) {
        const int s = g * GS + e;
        const float* in = base + s * IN;
        const float4 r4 = lds4(in + i0), k4 = lds4(in + HD + i0), w4 = lds4(in + 2 * HD + i0),
                     v4 = lds4(in + 3 * HD + c0), g4 = lds4(in + 3 * HD + CC + c0);
        const float rr[ROWS] = {r4.x, r4.y, r4.z, r4.w}, kk[ROWS] = {k4.x, k4.y, k4.z, k4.w},
                    ww[ROWS] = {w4.x, w4.y, w4.z, w4.w}, vv[COLS] = {v4.x, v4.y, v4.z, v4.w},
                    gg[COLS] = {g4.x, g4.y, g4.z, g4.w};
        // rows: dr's state part; dk's, then dw's; columns: dv's
        float pr[ROWS], rp[2 * ROWS], pc[COLS];
#pragma unroll
        for (int x = 0; x < 2 * ROWS; ++x) rp[x] = 0.f;
#pragma unroll
        for (int c = 0; c < COLS; ++c) pc[c] = 0.f;
#pragma unroll
        for (int a = 0; a < ROWS; ++a) {
          pr[a] = 0.f;
#pragma unroll
          for (int c = 0; c < COLS; ++c) pr[a] = fmaf(gg[c], Xs[e][a][c], pr[a]);
        }
#pragma unroll
        for (int a = 0; a < ROWS; ++a)
#pragma unroll
          for (int c = 0; c < COLS; ++c) {
            rp[a] = fmaf(dS[a][c], vv[c], rp[a]);
            rp[ROWS + a] = fmaf(dS[a][c], Xs[e][a][c], rp[ROWS + a]);
            pc[c] = fmaf(dS[a][c], kk[a], pc[c]);
            dS[a][c] = fmaf(ww[a], dS[a][c], rr[a] * gg[c]);
          }
        reduce_scatter<ROWS, CG / 2, 1, MASK>(pr, cgi);
        if (rs_primary<ROWS, CG>(cgi)) mine[(s * 3) * HD + i0 + rs_first<ROWS, CG>(cgi)] = pr[0];
        reduce_scatter<2 * ROWS, CG / 2, 1, MASK>(rp, cgi);
        if (rs_primary<2 * ROWS, CG>(cgi)) {
          const int first = rs_first<2 * ROWS, CG>(cgi);
#pragma unroll
          for (int x = 0; x < (2 * ROWS >= CG ? 2 * ROWS / CG : 1); ++x) {
            const int el = first + x;   // dk of row i0 + el, or dw of row i0 + el - ROWS
            mine[(s * 3 + 1 + el / ROWS) * HD + i0 + el % ROWS] = rp[x];
          }
        }
        reduce_scatter<COLS, RL / 2, CG, MASK>(pc, rsub);
        if (rs_primary<COLS, RL>(rsub))
          dvp[(s * W + warp) * CC + c0 + rs_first<COLS, RL>(rsub)] = pc[0];
      }
    }
  }

  cp_async_wait<0>();
  cluster.sync();   // every CTA's partials of chunk 0 are complete
  reduce(0, (job - 1) & 1);
#pragma unroll
  for (int a = 0; a < ROWS; ++a)
    *reinterpret_cast<float4*>(ds0 + sbase + (long long)a * HD) =
        make_float4(dS[a][0], dS[a][1], dS[a][2], dS[a][3]);
  du_part[(long long)blockIdx.x * NT + tid] = du_acc;
  cluster.sync();   // no CTA leaves while another reads its shared memory
}

// du[h, i] = the sum of du_part over b, then over the threads of (b, h)'s
// CTAs that summed row i (index i + m * hd of its hd * hd / 16), in order
__global__ void du_sum(const float* __restrict__ du_part, float* __restrict__ du, int B, int H,
                       int hd) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= H * hd) return;
  const int h = x / hd, i = x % hd, per = hd * hd / (ROWS * COLS);
  float acc = 0.f;
  for (int b = 0; b < B; ++b)
    for (int m = 0; m < per / hd; ++m) acc += du_part[((long long)b * H + h) * per + i + m * hd];
  du[x] = acc;
}

template <int HD, int CC>
cudaError_t launch(const float* r, const float* k, const float* v, const float* w,
                   const float* u, const float* s0, const float* dout, const float* dsT,
                   float* dr, float* dk, float* dv, float* dw, float* du, float* ds0,
                   float* du_part, float* ckpt, int B, int T, int H, cudaStream_t stream) {
  using PL = Plan<HD, CC>;
  const size_t smem = sizeof(float) * PL::FLOATS;
  cudaError_t err = cudaFuncSetAttribute(wkv6_bwd_kernel<HD, CC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * H * PL::P);
  cfg.blockDim = dim3(PL::NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = PL::P;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, wkv6_bwd_kernel<HD, CC>, r, k, v, w, u, s0, dout, dsT, dr, dk,
                           dv, dw, du_part, ds0, ckpt, T, H);
  if (err != cudaSuccess) return err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = H * HD;
  du_sum<<<(n + 255) / 256, 256, 0, stream>>>(du_part, du, B, H, HD);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_cols(int cols, const float* r, const float* k, const float* v,
                        const float* w, const float* u, const float* s0, const float* dout,
                        const float* dsT, float* dr, float* dk, float* dv, float* dw, float* du,
                        float* ds0, float* du_part, float* ckpt, int B, int T, int H,
                        cudaStream_t st) {
  constexpr int CC = HD < 32 ? HD : 32;
  if (cols != CC) return cudaErrorInvalidValue;
  return launch<HD, CC>(r, k, v, w, u, s0, dout, dsT, dr, dk, dv, dw, du, ds0, du_part, ckpt, B, T, H, st);
}

}  // namespace

// r, k, v, w, dout, dr, dk, dv, dw: (B,T,H,hd); u, du: (H,hd); s0, dsT, ds0:
// (B,H,hd,hd); all float32, contiguous, 16-byte aligned.  hd in {16, 32,
// 64, 128}; the split plan: ctas_per_head CTAs of cols = min(hd, 32)
// columns.  Scratch: ckpt
// B*H*ceil(T/16)*hd*hd floats and du_part B*H*hd*hd/16.  Launches on
// `stream` and returns the first failing launch's cudaError_t (0 on
// success).
extern "C" int repro_wkv6_bwd(const float* r, const float* k, const float* v, const float* w,
                              const float* u, const float* s0, const float* dout,
                              const float* dsT, float* dr, float* dk, float* dv, float* dw,
                              float* du, float* ds0, float* du_part, float* ckpt, int B, int T,
                              int H, int hd, int ctas_per_head, int cols, void* stream) {
  if (B < 1 || T < 1 || H < 1 || cols * ctas_per_head != hd) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return (int)launch_cols<16>(cols, r, k, v, w, u, s0, dout, dsT, dr, dk, dv, dw, du, ds0, du_part, ckpt, B, T, H, st);
    case 32: return (int)launch_cols<32>(cols, r, k, v, w, u, s0, dout, dsT, dr, dk, dv, dw, du, ds0, du_part, ckpt, B, T, H, st);
    case 64: return (int)launch_cols<64>(cols, r, k, v, w, u, s0, dout, dsT, dr, dk, dv, dw, du, ds0, du_part, ckpt, B, T, H, st);
    case 128: return (int)launch_cols<128>(cols, r, k, v, w, u, s0, dout, dsT, dr, dk, dv, dw, du, ds0, du_part, ckpt, B, T, H, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
