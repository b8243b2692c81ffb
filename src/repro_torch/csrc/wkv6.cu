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
// k=0.  Hopper has no sequential grid axis: here one CTA per (b, h) loops
// over t inside the block, so the state stays on chip for the whole sweep
// and any T >= 1 runs unpadded (the engine's decode calls it with T=1).
//
// Design (a simple, correct first version):
//  * hd threads per CTA; thread j holds column j of S (hd floats) in
//    registers for the whole sweep.  The columns evolve independently, so
//    nothing crosses threads but r_t, k_t and w_t, which each step stages in
//    shared memory.  The staging is double-buffered, so one __syncthreads
//    per step suffices: a buffer is rewritten two steps later, after every
//    thread has passed the next step's barrier.
//  * the next step's r, k, w, v are loaded into registers before the
//    current step's arithmetic, so their latency overlaps it;
//  * o_t[j] is summed over i in four partial sums to shorten the chain of
//    dependent adds.
//  * the final state may be written in place over s0 (sout == s0): each
//    thread reads its whole column before the sweep and writes only that
//    column after it, so aliasing is safe.  The engine's decode uses this
//    as the counterpart of the reference's donated cache.
//
// What bounds it on this card: device-memory bytes.  Every input is read and
// every output written once (r, k, v, w, o of B*T*H*hd floats, the state of
// B*H*hd*hd floats in and out) for about 7*hd flops per element of o, far
// below the 67 TFLOP/s float32 rate at 3.35 TB/s.  This first version does
// not reach that bound: at batch 4 and 32 heads only 128 CTAs of 64 threads
// are in flight, and each step is a dependent chain.  Later work: split the
// columns j of one (b, h) across CTAs for occupancy, and vectorised loads.

#include <cuda_runtime.h>

namespace {

template <int HD>
__global__ void __launch_bounds__(HD)
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* s0, float* __restrict__ o,
            float* sout, int T, int H) {
  __shared__ float rs[2][HD], ks[2][HD], ws[2][HD], us[HD];
  const int j = threadIdx.x;
  const int bh = blockIdx.x;  // b * H + h
  const int h = bh % H, b = bh / H;
  const long long row = (long long)H * HD;  // stride of t in (B,T,H,hd)
  const long long base = (long long)b * T * row + (long long)h * HD + j;

  float S[HD];
  const float* sp = s0 + (long long)bh * HD * HD + j;
#pragma unroll
  for (int i = 0; i < HD; ++i) S[i] = sp[(long long)i * HD];
  us[j] = u[h * HD + j];

  float rn = r[base], kn = k[base], wn = w[base], vn = v[base];
  for (int t = 0; t < T; ++t) {
    const int buf = t & 1;
    rs[buf][j] = rn;
    ks[buf][j] = kn;
    ws[buf][j] = wn;
    const float vt = vn;
    __syncthreads();
    if (t + 1 < T) {
      const long long nx = base + (long long)(t + 1) * row;
      rn = r[nx];
      kn = k[nx];
      wn = w[nx];
      vn = v[nx];
    }
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < HD; ++i) {
      const float kv = ks[buf][i] * vt;
      acc[i & 3] = fmaf(rs[buf][i], S[i] + us[i] * kv, acc[i & 3]);
      S[i] = fmaf(ws[buf][i], S[i], kv);
    }
    o[base + (long long)t * row] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
  }
  float* op = sout + (long long)bh * HD * HD + j;
#pragma unroll
  for (int i = 0; i < HD; ++i) op[(long long)i * HD] = S[i];
}

template <int HD>
cudaError_t launch(const float* r, const float* k, const float* v, const float* w,
                   const float* u, const float* s0, float* o, float* sout, int B, int T,
                   int H, cudaStream_t stream) {
  wkv6_kernel<HD><<<B * H, HD, 0, stream>>>(r, k, v, w, u, s0, o, sout, T, H);
  return cudaGetLastError();
}

}  // namespace

// r, k, v, w, o: (B,T,H,hd) float32 contiguous; u: (H,hd); s0, sout:
// (B,H,hd,hd), which may be the same buffer.  hd in {16, 32, 64, 128},
// T >= 1.  Returns the cudaError_t of the launch.
extern "C" int repro_wkv6(const void* r, const void* k, const void* v, const void* w,
                          const void* u, const void* s0, void* o, void* sout, int B,
                          int T, int H, int hd, void* stream) {
  if (B < 1 || T < 1 || H < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *rp = static_cast<const float*>(r), *kp = static_cast<const float*>(k),
              *vp = static_cast<const float*>(v), *wp = static_cast<const float*>(w),
              *up = static_cast<const float*>(u), *sp = static_cast<const float*>(s0);
  float *op = static_cast<float*>(o), *so = static_cast<float*>(sout);
  switch (hd) {
    case 16: return (int)launch<16>(rp, kp, vp, wp, up, sp, op, so, B, T, H, st);
    case 32: return (int)launch<32>(rp, kp, vp, wp, up, sp, op, so, B, T, H, st);
    case 64: return (int)launch<64>(rp, kp, vp, wp, up, sp, op, so, B, T, H, st);
    case 128: return (int)launch<128>(rp, kp, vp, wp, up, sp, op, so, B, T, H, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
