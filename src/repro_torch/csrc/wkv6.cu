// WKV-6 recurrence (kernel K3 of the port) for Hopper, sm_90a.
//
// Replaces the TPU Pallas kernel src/repro/kernels/rwkv/wkv.py::wkv6 (body
// _kernel) and its padding wrapper kernels/rwkv/ops.py::wkv6.  Per batch row
// b and head h, over t = 0..T-1, with kv = k_t (outer) v_t:
//     o_t[j] = sum_i r_t[i] * (S[i][j] + u[i] * kv[i][j])
//     S[i][j] = w_t[i] * S[i][j] + kv[i][j]
// in float32 throughout.  Returns every o_t and the final S.
//
// The Pallas kernel keeps the (hd, hd) state in VMEM scratch across a
// sequential chunk axis of its grid and pads T to a multiple of 64 with w=1,
// k=0.  Hopper has no sequential grid axis: here each CTA loops over t, so
// its part of the state stays in registers for the whole sweep, and any
// T >= 1 runs unpadded (the engine's decode calls it with T=1).
//
// What bounds it on this card.  Every input is read and every output written
// once: r, k, v, w, o of B*T*H*hd floats and the state of B*H*hd*hd floats in
// and out.  The work is three float32 operations per (i, j) and step (below).
// At the engine's prefill (4,100,32,64) the bytes take about 6 us at 3.35
// TB/s and the operations about 4 us at the 67 TFLOP/s float32 peak, so the
// design has to come near both at once.  At the decode shape (T=1) the state
// is all the bytes.
//
// Design:
//  * The columns j of S evolve independently, so a head is split over
//    ctas_per_head CTAs of cols columns (the host's split_plan in
//    kernels/rwkv/wkv.py: 128 threads where the head is wide enough, so 2
//    CTAs per head at hd 64, 256 CTAs of 4 warps at the engine's prefill).
//    A thread holds a 4 x 4 block of S (rows 4 lane .. +3, columns 4 grp ..
//    +3) in registers; neighbouring threads hold neighbouring column groups,
//    so the state is read before the sweep and written after it in whole
//    128-byte row segments of 16-byte accesses.  A CTA reads and writes only
//    its own block, so the final state may be written in place over s0
//    (sout == s0): the engine's decode uses this as the counterpart of the
//    reference's donated cache.
//  * r, k, w (whole head rows) and v (the CTA's columns) are staged in
//    shared memory tc = min(16, T) steps at a time by 16-byte cp.async in a
//    2-stage ring: chunk c+1 loads while chunk c is swept, and no global load
//    sits on a step's critical path.  A thread reads a step's r, k, w of its
//    rows and v of its columns as four 16-byte shared loads.
//  * The bonus term factors: sum_i r_i u_i k_i v_j = v_j * sum_i r_i u_i k_i.
//    A thread adds its rows' share of the dot product, times v_j, to its
//    partial sums of o, so a step costs 3 operations per (i, j) (r*S into
//    the sum, k*v, w*S + kv) and a few per row.  This changes the order of
//    the float32 sums against the plain version.
//  * A thread's partial sums of o for its 4 columns go to shared memory, one
//    16-byte store a step, double-buffered by chunk.  After the chunk,
//    neighbouring threads sum the hd/4 partials of neighbouring columns and
//    store o coalesced.  So one __syncthreads per chunk replaces one per
//    step, and nothing crosses lanes inside the sweep.
//
// What it leaves on the table: the sweep is a dependent loop over t, and
// one head alone takes two thirds of the time of 128 heads at once: the
// kernel is held by the latency and issue rate of a step, not by bytes.
// Each CTA of a head stages the whole r, k, w rows (ctas_per_head times the
// bytes from L2, once from device memory).

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using repro::cp_async16;
using repro::cp_async_commit;
using repro::cp_async_wait;

constexpr int COLS = 4;          // state columns per thread (one 16-byte word)
constexpr int ROWS = 4;          // state rows per thread (one 16-byte word of r, k, w)
constexpr int THREADS = 128;     // threads of the widest CTA (4 warps)
constexpr int TC = 16;           // steps per chunk
constexpr int NS = 2;            // chunks in the ring

template <int HD>
struct Shape {
  static constexpr int LANES = HD / ROWS;                       // lanes per column
  static constexpr int CMAX = HD < COLS * THREADS / LANES ? HD : COLS * THREADS / LANES;
  static constexpr int RV = HD / 4;                             // 16-byte words per row
};

// Shared memory of a CTA of `cols` columns and chunks of tc = min(TC, T)
// steps, in floats: the ring of r, k, w (NS stages of tc steps, whole head
// rows), the ring of v (the CTA's columns, row stride cols), and each
// lane's partial sums of o for two chunks ([step][lane][column], row stride
// cols + 4, so that the rows of a 16-byte store start in distinct banks)
template <int HD>
constexpr int smem_floats(int cols, int tc) {
  return NS * 3 * tc * HD + NS * tc * cols + 2 * tc * Shape<HD>::LANES * (cols + 4);
}

__device__ __forceinline__ long long row_of(int b, int t, int h, int T, int H) {
  return ((long long)b * T + t) * H + h;
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <int HD>
__global__ void __launch_bounds__(Shape<HD>::CMAX / COLS * Shape<HD>::LANES)
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* s0, float* __restrict__ o,
            float* sout, int T, int H, int cols) {
  using S = Shape<HD>;
  constexpr int L = S::LANES, RV = S::RV;
  extern __shared__ __align__(16) float smem[];

  const int P = HD / cols;                 // CTAs per head
  const int nthr = cols / COLS * L;        // == blockDim.x
  const int cv = cols / 4;                 // 16-byte words of the CTA's columns
  const int cp = cols + 4;                 // row stride of part
  const int lc = __ffs(cols) - 1;          // log2(cols)
  const int tid = threadIdx.x;
  // a thread holds columns j0 + 4 grp .. + 3 of rows 4 lane .. + 3 of S; the
  // column groups of a row are neighbouring threads, so a warp reads and
  // writes whole 128-byte row segments of the state
  const int grp = tid % (cols / COLS), lane = tid / (cols / COLS);
  const int bh = blockIdx.x / P;
  const int j0 = (blockIdx.x % P) * cols;
  const int b = bh / H, h = bh % H;
  const int tc = min(TC, T);                         // steps per chunk of this launch
  const int nc = (T + tc - 1) / tc;
  float* const ring = smem;                          // [NS][3][tc][HD]
  float* const vring = ring + NS * 3 * tc * HD;      // [NS][tc][cols]
  float* const part = vring + NS * tc * cols;        // [2][tc][L][cp]

  // the n = min(tc, T - t0) steps of chunk c into ring stage c % NS
  auto load_chunk = [&](int c) {
    const int t0 = c * tc, n = min(tc, T - t0), s = c % NS;
    const float* src[3] = {r, k, w};
#pragma unroll
    for (int a = 0; a < 3; ++a)
      for (int x = tid; x < n * RV; x += nthr)
        cp_async16(ring + ((s * 3 + a) * tc + x / RV) * HD + 4 * (x % RV),
                   src[a] + row_of(b, t0 + x / RV, h, T, H) * HD + 4 * (x % RV), 16);
    for (int x = tid; x < n * cv; x += nthr)
      cp_async16(vring + (s * tc + x / cv) * cols + 4 * (x % cv),
                 v + row_of(b, t0 + x / cv, h, T, H) * HD + j0 + 4 * (x % cv), 16);
  };

  // o_t[j] of chunk c: the sum of its L lanes' partials, stored by
  // neighbouring threads to neighbouring columns
  auto reduce = [&](int c) {
    const int n = min(tc, T - c * tc);
    const float* pt = part + (c & 1) * tc * L * cp;
#pragma unroll 4
    for (int x = tid; x < n * cols; x += nthr) {
      const int tt = x >> lc, j = x & (cols - 1);
      float a = 0.f;
#pragma unroll
      for (int l = 0; l < L; ++l) a += pt[(tt * L + l) * cp + j];
      o[row_of(b, c * tc + tt, h, T, H) * HD + j0 + j] = a;
    }
  };

  // prologue: chunks 0 .. NS-2 in flight, one group each; meanwhile the
  // thread's block of the state, st[e][cc] = S[4 lane + e][j0 + 4 grp + cc],
  // and u of its rows come straight into registers by 16-byte loads
  for (int c = 0; c < NS - 1; ++c) {
    if (c < nc) load_chunk(c);
    cp_async_commit();
  }
  const long long sbase = (long long)bh * HD * HD + j0 + 4 * grp;
  const int row0 = ROWS * lane;
  float st[ROWS][COLS];
  const float4 uv = *reinterpret_cast<const float4*>(u + h * HD + row0);
  const float ur[ROWS] = {uv.x, uv.y, uv.z, uv.w};
#pragma unroll
  for (int e = 0; e < ROWS; ++e) {
    const float4 y = *reinterpret_cast<const float4*>(s0 + sbase + (long long)(row0 + e) * HD);
    st[e][0] = y.x, st[e][1] = y.y, st[e][2] = y.z, st[e][3] = y.w;
  }

  // one barrier a chunk: after it chunk c has landed, the partials of chunk
  // c-1 are complete, and the ring stage of chunk c-1 is free for chunk
  // c+NS-1 (the sweep alone reads a stage); part[c & 1] was last read by the
  // reduction of chunk c-2, before the barrier
  for (int c = 0; c < nc; ++c) {
    const int s = c % NS;
    const int n = min(tc, T - c * tc);
    cp_async_wait<NS - 2>();
    __syncthreads();
    if (c + NS - 1 < nc) load_chunk(c + NS - 1);
    cp_async_commit();
    if (c > 0) reduce(c - 1);

    // the sweep, in registers; unrolled so that the shared loads of later
    // steps are issued while earlier steps compute
    float* pt = part + ((c & 1) * tc * L + lane) * cp + 4 * grp;
    const float* rs = ring + s * 3 * tc * HD + row0;   // r; k and w follow tc*HD apart
    const float* vs = vring + s * tc * cols + 4 * grp;
#pragma unroll 4
    for (int tt = 0; tt < n; ++tt) {
      const float* q = rs + tt * HD;
      const float4 r4 = lds4(q), k4 = lds4(q + tc * HD), w4 = lds4(q + 2 * tc * HD),
                   v4 = lds4(vs + tt * cols);
      const float ri[ROWS] = {r4.x, r4.y, r4.z, r4.w}, ki[ROWS] = {k4.x, k4.y, k4.z, k4.w},
                  wi[ROWS] = {w4.x, w4.y, w4.z, w4.w}, vc[COLS] = {v4.x, v4.y, v4.z, v4.w};
      float acc[COLS] = {0.f, 0.f, 0.f, 0.f};
      float bon = 0.f;   // this lane's share of sum_i r_i u_i k_i
#pragma unroll
      for (int e = 0; e < ROWS; ++e) {
        bon = fmaf(ri[e] * ki[e], ur[e], bon);
#pragma unroll
        for (int cc = 0; cc < COLS; ++cc) {
          acc[cc] = fmaf(ri[e], st[e][cc], acc[cc]);
          st[e][cc] = fmaf(wi[e], st[e][cc], ki[e] * vc[cc]);
        }
      }
      *reinterpret_cast<float4*>(pt + tt * L * cp) =
          make_float4(fmaf(bon, vc[0], acc[0]), fmaf(bon, vc[1], acc[1]),
                      fmaf(bon, vc[2], acc[2]), fmaf(bon, vc[3], acc[3]));
    }
  }
  __syncthreads();
  reduce(nc - 1);

  // the final state: 16-byte stores of the thread's own block
#pragma unroll
  for (int e = 0; e < ROWS; ++e)
    *reinterpret_cast<float4*>(sout + sbase + (long long)(row0 + e) * HD) =
        make_float4(st[e][0], st[e][1], st[e][2], st[e][3]);
}

template <int HD>
cudaError_t launch(const float* r, const float* k, const float* v, const float* w,
                   const float* u, const float* s0, float* o, float* sout, int B, int T,
                   int H, int ctas_per_head, int cols, int lanes, cudaStream_t stream) {
  using S = Shape<HD>;
  const bool pow2 = cols > 0 && (cols & (cols - 1)) == 0;
  const int threads = cols / COLS * lanes;
  if (lanes != S::LANES || !pow2 || cols < COLS || cols > S::CMAX ||
      cols * ctas_per_head != HD || threads < 8 || (threads > 32 && threads % 32))
    return cudaErrorInvalidValue;
  static const cudaError_t set =
      cudaFuncSetAttribute(wkv6_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           sizeof(float) * smem_floats<HD>(S::CMAX, TC));
  if (set != cudaSuccess) return set;
  wkv6_kernel<HD><<<B * H * ctas_per_head, threads,
                    sizeof(float) * smem_floats<HD>(cols, T < TC ? T : TC),
                    stream>>>(r, k, v, w, u, s0, o, sout, T, H, cols);
  return cudaGetLastError();
}

}  // namespace

// r, k, v, w, o: (B,T,H,hd) float32 contiguous; u: (H,hd); s0, sout:
// (B,H,hd,hd), which may be the same buffer; every pointer 16-byte aligned.
// hd in {16, 32, 64, 128}, T >= 1.  The split plan: ctas_per_head CTAs of
// cols columns each (a power of two, at least 4, cols * ctas_per_head = hd,
// at most 128 threads) and lanes = hd/4 lanes per column.  Returns the
// cudaError_t of the launch.
extern "C" int repro_wkv6(const void* r, const void* k, const void* v, const void* w,
                          const void* u, const void* s0, void* o, void* sout, int B,
                          int T, int H, int hd, int ctas_per_head, int cols, int lanes,
                          void* stream) {
  if (B < 1 || T < 1 || H < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *rp = static_cast<const float*>(r), *kp = static_cast<const float*>(k),
              *vp = static_cast<const float*>(v), *wp = static_cast<const float*>(w),
              *up = static_cast<const float*>(u), *sp = static_cast<const float*>(s0);
  float *op = static_cast<float*>(o), *so = static_cast<float*>(sout);
  switch (hd) {
    case 16: return (int)launch<16>(rp, kp, vp, wp, up, sp, op, so, B, T, H,
                                    ctas_per_head, cols, lanes, st);
    case 32: return (int)launch<32>(rp, kp, vp, wp, up, sp, op, so, B, T, H,
                                    ctas_per_head, cols, lanes, st);
    case 64: return (int)launch<64>(rp, kp, vp, wp, up, sp, op, so, B, T, H,
                                    ctas_per_head, cols, lanes, st);
    case 128: return (int)launch<128>(rp, kp, vp, wp, up, sp, op, so, B, T, H,
                                      ctas_per_head, cols, lanes, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
