// Flash-decode (kernel K2 of the port) for Hopper, sm_90a.
//
// Replaces the TPU Pallas kernel src/repro/kernels/decode/flash_decode.py::
// flash_decode (body _kernel): one new query per row against a (B,S,K,hd) KV
// cache, masked by a validity vector, with an online softmax in float32,
// scale hd^-0.5, masked logits set to the finite -1e30 and the final
// max(l, 1e-30) guard.  The reference takes one (S,) validity vector for the
// whole batch; this kernel takes a (B,S) uint8 mask with a batch stride that
// may be 0, so stride 0 is the reference's (S,) form (the engine's decode)
// and stride S serves per-row positions (the continuous server), which the
// reference sends around its kernel.
//
// What bounds it on this card: bytes.  Each cached key and value is read
// once for 2*hd flops per query head (4*g flops per cached element for g
// query heads per kv head), far below the 295 flops per byte at which the
// tensor cores would become the limit, so the least time is the bytes of the
// valid cache positions over 3.35 TB/s.  So the design reads as few bytes as
// the mask allows, in wide loads, with many of them in flight, and needs no
// tensor cores and no shared-memory staging (nothing is reused across
// threads: for MHA each cache row feeds one query head).
//
// What the design does about it:
//  * split-KV: the grid is (split of S, kv head x head chunk, batch row),
//    with the number of splits chosen by the caller so that the CTAs fill
//    the 132 SMs even at small batch; each CTA writes its partial (m, l, acc)
//    to scratch and a second small kernel combines the splits;
//  * a group of LP lanes reads one cache row with 16-byte loads (at hd=128
//    bf16, 16 lanes: one warp load covers two positions), and each lane
//    unrolls over U positions, so 2U loads of K and V are in flight per lane;
//  * the q.k dot is reduced by shuffles within a group; the online softmax
//    (m, l) runs per warp and per query head in registers, in base-2 units;
//    each lane keeps its slice of the PV accumulator in registers, and the
//    warps merge once, through shared memory, at the end;
//  * the g = H/K query heads of a kv head (up to 8 per CTA) share each cache
//    row read, so a row is read once for all of them;
//  * masked positions are not read.  A warp skips a step of positions none of
//    which is valid, and does not load the K and V rows of masked positions
//    in a step it runs.  That is exact: in the reference a masked logit
//    (-1e30) contributes exp(-1e30 - m) = 0 once the row's max m is that of a
//    valid position.  The one exception is a row with no valid position at
//    all: the reference then weighs every position equally and returns the
//    mean of V.  So each CTA first checks whether its row has a valid
//    position (its own range, then the rest of the row only if its range has
//    none), and for a row without one it reads every position as the
//    reference does;
//  * positions past S are neither loaded nor counted (-inf, weight 0).
//
// On request the combine also writes each row's log-sum-exp of its logits
// (natural log, float32, (B,H)), from the (M, L) it holds anyway: the
// weight that lets partial softmaxes over chunks of a sequence-sharded
// cache be combined across ranks.  It is -inf for a row with no valid
// position (whose output is still the mean of V), so such a chunk weighs 0.
// Writing it changes nothing else: o is the same with and without it.

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using repro::NEG;
using repro::store;
using bf16 = __nv_bfloat16;

constexpr int BKD = 64;   // cache positions per tile: the unit of a split
constexpr int NT = 128;   // threads per CTA
constexpr int NW = NT / 32;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// the VEC float32 values of one 16-byte load
__device__ __forceinline__ void unpack(const uint4& r, float (&f)[4]) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void unpack(const uint4& r, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// LP lanes per cache row, NV 16-byte vectors per lane and row, up to GC
// query heads per CTA.  Lane `sub` of a group holds the row's vectors
// sub + i*LP (i < NV) that lie below hd.
template <typename T, int LP, int NV, int GC>
__global__ void __launch_bounds__(NT)
decode_split(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const uint8_t* __restrict__ valid, long long valid_bstride,
             float* __restrict__ part_m, float* __restrict__ part_l,
             float* __restrict__ part_acc, int S, int H, int KH, int hd,
             long long cache_bstride, long long cache_sstride, int tiles_per_split,
             float scale_log2) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PPW = 32 / LP;                          // rows per warp load
  constexpr int U = (NV == 2 || GC >= 8) ? 4 : 8;       // rows per lane and step
  constexpr int SP = PPW * U;                           // rows per warp step
  constexpr int DW = LP * NV * VEC;                     // dims a warp can hold
  __shared__ float red_m[NW][GC], red_l[NW][GC];
  __shared__ float red_acc[NW][GC][DW];

  const int g = H / KH;
  const int nchunk = (g + GC - 1) / GC;
  const int split = blockIdx.x, kh = blockIdx.y / nchunk, chunk = blockIdx.y % nchunk;
  const int b = blockIdx.z, nsplit = gridDim.x;
  const int h0 = kh * g + chunk * GC;                   // first query head of this CTA
  const int gc = min(GC, g - chunk * GC);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gi = lane / LP, sub = lane % LP;
  const int nvec = hd / VEC;

  // this lane's slice of each query head, pre-scaled into base-2 logits
  float qv[GC][NV][VEC];
#pragma unroll
  for (int hh = 0; hh < GC; ++hh)
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int vi = sub + i * LP;
      float f[VEC];
      if (hh < gc && vi < nvec) {
        unpack(*reinterpret_cast<const uint4*>(q + ((long long)b * H + h0 + hh) * hd + vi * VEC),
               f);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) f[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) qv[hh][i][e] = f[e] * scale_log2;
    }

  const T* kb = k + b * cache_bstride + (long long)kh * hd;
  const T* vb = v + b * cache_bstride + (long long)kh * hd;
  const uint8_t* vm = valid + b * valid_bstride;
  const int p_begin = split * tiles_per_split * BKD;
  const int p_end = min(p_begin + tiles_per_split * BKD, S);

  // does the row have a valid position?  This split's range first, the rest
  // of the row only if the range has none.
  int any = 0;
  for (int p = p_begin + tid; p < p_end; p += NT) any |= vm[p];
  bool row_any = __syncthreads_or(any) != 0;
  if (!row_any) {
    for (int p = tid; p < S; p += NT) any |= vm[p];
    row_any = __syncthreads_or(any) != 0;
  }

  float acc[GC][NV][VEC], m[GC], l[GC];
#pragma unroll
  for (int hh = 0; hh < GC; ++hh) {
    m[hh] = NEG;   // the same in every lane of the warp
    l[hh] = 0.f;   // this lane group's share
#pragma unroll
    for (int i = 0; i < NV; ++i)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[hh][i][e] = 0.f;
  }

  const int nsteps = (p_end - p_begin + SP - 1) / SP;
  for (int st = warp; st < nsteps; st += NW) {
    const int base = p_begin + st * SP + gi;
    bool ok[U], live[U], any_live = false;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = base + u * PPW;
      ok[u] = p < p_end && vm[p];
      live[u] = p < p_end && (ok[u] || !row_any);   // read: valid, or a row without any
      any_live |= live[u];
    }
    if (!__any_sync(0xffffffffu, any_live)) continue;

    uint4 kr[U][NV], vr[U][NV];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long off = (long long)(base + u * PPW) * cache_sstride;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int vi = sub + i * LP;
        if (live[u] && vi < nvec) {
          kr[u][i] = *reinterpret_cast<const uint4*>(kb + off + vi * VEC);
          vr[u][i] = *reinterpret_cast<const uint4*>(vb + off + vi * VEC);
        } else {
          kr[u][i] = make_uint4(0u, 0u, 0u, 0u);
          vr[u][i] = make_uint4(0u, 0u, 0u, 0u);
        }
      }
    }

    // logits, base 2: valid -> q.k, masked -> NEG (read only for a row with
    // no valid position), not read or past S -> -inf
    float s[GC][U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[NV][VEC];
#pragma unroll
      for (int i = 0; i < NV; ++i) unpack(kr[u][i], kf[i]);
#pragma unroll
      for (int hh = 0; hh < GC; ++hh) {
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < NV; ++i)
#pragma unroll
          for (int e = 0; e < VEC; ++e) dot = fmaf(qv[hh][i][e], kf[i][e], dot);
#pragma unroll
        for (int o = LP / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
        s[hh][u] = !live[u] ? -INFINITY : (ok[u] ? dot : NEG);
      }
    }

#pragma unroll
    for (int hh = 0; hh < GC; ++hh) {
      float mx = s[hh][0];
#pragma unroll
      for (int u = 1; u < U; ++u) mx = fmaxf(mx, s[hh][u]);
#pragma unroll
      for (int o = LP; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[hh], mx);
      const float alpha = exp2f(m[hh] - m_new);
      m[hh] = m_new;
      l[hh] *= alpha;
#pragma unroll
      for (int i = 0; i < NV; ++i)
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[hh][i][e] *= alpha;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vf[NV][VEC];
#pragma unroll
      for (int i = 0; i < NV; ++i) unpack(vr[u][i], vf[i]);
#pragma unroll
      for (int hh = 0; hh < GC; ++hh) {
        const float p = exp2f(s[hh][u] - m[hh]);   // 0 for -inf
        l[hh] += p;
#pragma unroll
        for (int i = 0; i < NV; ++i)
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[hh][i][e] = fmaf(p, vf[i][e], acc[hh][i][e]);
      }
    }
  }

  // merge the lane groups of the warp (they share m), then the warps
#pragma unroll
  for (int hh = 0; hh < GC; ++hh) {
#pragma unroll
    for (int o = LP; o < 32; o <<= 1) {
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], o);
#pragma unroll
      for (int i = 0; i < NV; ++i)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          acc[hh][i][e] += __shfl_xor_sync(0xffffffffu, acc[hh][i][e], o);
    }
    if (lane == 0) {
      red_m[warp][hh] = m[hh];
      red_l[warp][hh] = l[hh];
    }
    if (gi == 0) {
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int vi = sub + i * LP;
        if (vi < nvec) {
#pragma unroll
          for (int e = 0; e < VEC; ++e) red_acc[warp][hh][vi * VEC + e] = acc[hh][i][e];
        }
      }
    }
  }
  __syncthreads();
  const long long row0 = (long long)b * H + h0;   // first head of this CTA
  for (int idx = tid; idx < gc * hd; idx += NT) {
    const int hh = idx / hd, d = idx - hh * hd;
    float M = red_m[0][hh];
#pragma unroll
    for (int w = 1; w < NW; ++w) M = fmaxf(M, red_m[w][hh]);
    float L = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float c = exp2f(red_m[w][hh] - M);
      L += c * red_l[w][hh];
      a += c * red_acc[w][hh][d];
    }
    const long long prow = (row0 + hh) * nsplit + split;
    part_acc[prow * hd + d] = a;
    if (d == 0) {
      part_m[prow] = M;
      part_l[prow] = L;
    }
  }
}

// One CTA per (batch row, head): weight each split by 2^(m_i - M).  With
// lse (not null), also the row's natural log-sum-exp: M is the largest
// base-2 logit and L the sum of 2^(s - M), so it is (M + log2 L) ln 2; a row
// with no valid position has only masked logits (NEG) and gets -inf.
template <typename T>
__global__ void __launch_bounds__(NT)
decode_combine(const float* __restrict__ part_m, const float* __restrict__ part_l,
               const float* __restrict__ part_acc, T* __restrict__ o, float* __restrict__ lse,
               int nsplit, int hd) {
  const long long row = blockIdx.x;  // b*H + h; o is (B,1,H,hd) contiguous
  const float* pm = part_m + row * nsplit;
  const float* pl = part_l + row * nsplit;
  float M = pm[0];
  for (int i = 1; i < nsplit; ++i) M = fmaxf(M, pm[i]);
  float L = 0.f;
  for (int i = 0; i < nsplit; ++i) L += exp2f(pm[i] - M) * pl[i];
  if (lse != nullptr && threadIdx.x == 0)
    lse[row] = M <= 0.5f * NEG ? -INFINITY : (M + log2f(L)) * LN2;
  L = fmaxf(L, 1e-30f);
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    float a = 0.f;
    for (int i = 0; i < nsplit; ++i) a += exp2f(pm[i] - M) * part_acc[(row * nsplit + i) * hd + d];
    store(&o[row * hd + d], a / L);
  }
}

struct Args {
  const void *q, *k, *v, *valid;
  long long valid_bstride;
  void *o, *lse, *part_m, *part_l, *part_acc;
  int B, S, H, KH, hd;
  long long cache_bstride, cache_sstride;
  int nsplit, tiles_per_split;
  float scale_log2;
  cudaStream_t stream;
};

template <typename T, int LP, int NV, int GC>
cudaError_t launch(const Args& a) {
  const int nchunk = (a.H / a.KH + GC - 1) / GC;
  decode_split<T, LP, NV, GC><<<dim3(a.nsplit, a.KH * nchunk, a.B), NT, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const uint8_t*>(a.valid), a.valid_bstride, static_cast<float*>(a.part_m),
      static_cast<float*>(a.part_l), static_cast<float*>(a.part_acc), a.S, a.H, a.KH, a.hd,
      a.cache_bstride, a.cache_sstride, a.tiles_per_split, a.scale_log2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine<T><<<a.B * a.H, NT, 0, a.stream>>>(
      static_cast<const float*>(a.part_m), static_cast<const float*>(a.part_l),
      static_cast<const float*>(a.part_acc), static_cast<T*>(a.o), static_cast<float*>(a.lse),
      a.nsplit, a.hd);
  return cudaGetLastError();
}

// heads per CTA: 1 (MHA), 4 (g of 2 to 4) or 8 (g of 5 and more, in chunks)
template <typename T, int LP, int NV>
cudaError_t launch_gc(const Args& a) {
  const int g = a.H / a.KH;
  if (g == 1) return launch<T, LP, NV, 1>(a);
  if (g <= 4) return launch<T, LP, NV, 4>(a);
  return launch<T, LP, NV, 8>(a);
}

// lanes per row: the 16-byte vectors of a row, rounded up to 8, 16 or 32
template <typename T>
cudaError_t launch_t(const Args& a) {
  constexpr int VEC = 16 / sizeof(T);
  const int nvec = a.hd / VEC;
  if (a.hd % VEC || a.hd < VEC || a.hd > 256) return cudaErrorInvalidValue;
  if constexpr (VEC == 4) {
    if (nvec > 32) return launch_gc<T, 32, 2>(a);
  }
  if (nvec > 16) return launch_gc<T, 32, 1>(a);
  if (nvec > 8) return launch_gc<T, 16, 1>(a);
  return launch_gc<T, 8, 1>(a);
}

}  // namespace

// q, o: (B,1,H,hd) contiguous.  k, v: (B,S,KH,hd) with the last two dims
// contiguous and element strides cache_bstride (batch) and cache_sstride
// (position).  valid: uint8, element (b, p) at b*valid_bstride + p.
// lse: null, or (B,H) float32, each row's natural log-sum-exp (-inf for a
// row with no valid position).
// part_m, part_l: (B,H,nsplit) float32 scratch; part_acc: (B,H,nsplit,hd).
// Split i covers tiles [i*tiles_per_split, (i+1)*tiles_per_split) of 64
// positions.  dtype 0 = float32, 1 = bfloat16.  hd is a multiple of 16
// bytes, at most 256; q, k, v and the cache strides are 16-byte aligned.
// Returns the cudaError_t.
extern "C" int repro_flash_decode(const void* q, const void* k, const void* v,
                                  const void* valid, long long valid_bstride, void* o,
                                  void* lse, void* part_m, void* part_l, void* part_acc,
                                  int B, int S, int H, int KH, int hd, long long cache_bstride,
                                  long long cache_sstride, int nsplit, int tiles_per_split,
                                  float scale, int dtype, void* stream) {
  const Args a{q, k, v, valid, valid_bstride, o, lse, part_m, part_l, part_acc, B, S, H, KH, hd,
               cache_bstride, cache_sstride, nsplit, tiles_per_split, scale * LOG2E,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return (int)launch_t<float>(a);
  if (dtype == 1) return (int)launch_t<bf16>(a);
  return (int)cudaErrorInvalidValue;
}
