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
// tensor cores would become the limit, so the least time is the cache bytes
// over 3.35 TB/s.  This version reads the whole padded cache, masked
// positions included: skipping tiles past the longest valid position is
// later work.
//
// What the design does about it:
//  * split-KV: the grid is (split of S, kv head, batch row), with the number
//    of splits chosen by the caller so that B*K*splits fills the 132 SMs even
//    at small batch; each CTA writes its partial (m, l, acc) to scratch and
//    a second small kernel combines the splits;
//  * each CTA holds the g = H/K query heads of its kv head and reads every
//    K/V tile once for all of them (the Pallas grid (b, h, nk) reads each
//    tile g times);
//  * tiles are loaded with consecutive threads on consecutive elements of
//    a position, so the reads from device memory coalesce;
//  * a ragged S is handled by bounds checks: positions past S are neither
//    loaded nor counted.

#include <math.h>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BKD = 64;   // cache positions per tile
constexpr int NT = 128;   // threads per CTA
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

size_t split_smem_bytes(int g, int hd) {
  // q heads, shared k/v tile, scores, acc, and m, l, alpha per head
  return sizeof(float) * ((size_t)g * hd + (size_t)BKD * (hd + 1) + (size_t)g * BKD +
                          (size_t)g * hd + 3 * (size_t)g);
}

template <typename T>
__global__ void __launch_bounds__(NT)
decode_split(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const uint8_t* __restrict__ valid, long long valid_bstride,
             float* __restrict__ part_m, float* __restrict__ part_l,
             float* __restrict__ part_acc, int S, int H, int KH, int hd,
             long long cache_bstride, long long cache_sstride, int tiles_per_split,
             float scale) {
  extern __shared__ float smem[];
  const int g = H / KH;
  const int ld = hd + 1;
  float* Qs = smem;               // [g][hd]
  float* KV = Qs + g * hd;        // [BKD][ld], K then V of the current tile
  float* Ss = KV + BKD * ld;      // [g][BKD], scores then probabilities
  float* Acc = Ss + g * BKD;      // [g][hd]
  float* m_s = Acc + g * hd;      // [g]
  float* l_s = m_s + g;           // [g]
  float* a_s = l_s + g;           // [g]

  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int nsplit = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const T* qb = q + ((long long)b * H + (long long)kh * g) * hd;
  for (int i = tid; i < g * hd; i += NT) {
    Qs[i] = to_f32(qb[i]);
    Acc[i] = 0.f;
  }
  for (int i = tid; i < g; i += NT) {
    m_s[i] = NEG;
    l_s[i] = 0.f;
  }
  const T* kb = k + b * cache_bstride + (long long)kh * hd;
  const T* vb = v + b * cache_bstride + (long long)kh * hd;
  const uint8_t* vm = valid + b * valid_bstride;

  const int ntiles = (S + BKD - 1) / BKD;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(t_begin + tiles_per_split, ntiles);
  for (int t = t_begin; t < t_end; ++t) {
    const int p0 = t * BKD;
    __syncthreads();  // the previous tile's PV reads of KV and Ss are done
    for (int i = tid; i < BKD * hd; i += NT) {
      const int j = i / hd, d = i - j * hd, p = p0 + j;
      KV[j * ld + d] = p < S ? to_f32(kb[p * cache_sstride + d]) : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < g * BKD; i += NT) {
      const int hh = i / BKD, j = i % BKD, p = p0 + j;
      float s = -INFINITY;  // past S: not a position at all
      if (p < S) {
        const float* qr = Qs + hh * hd;
        const float* kr = KV + j * ld;
        float dot = 0.f;
        for (int d = 0; d < hd; ++d) dot = fmaf(qr[d], kr[d], dot);
        s = vm[p] ? dot * scale : NEG;
      }
      Ss[i] = s;
    }
    __syncthreads();
    for (int hh = warp; hh < g; hh += NT / 32) {
      float* row = Ss + hh * BKD;
      const float s0 = row[lane], s1 = row[lane + 32];
      const float m_prev = m_s[hh];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(s0, s1)));
      const float p0v = s0 == -INFINITY ? 0.f : expf(s0 - m_new);
      const float p1v = s1 == -INFINITY ? 0.f : expf(s1 - m_new);
      row[lane] = p0v;
      row[lane + 32] = p1v;
      const float sum = warp_sum(p0v + p1v);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[hh] = alpha;
        l_s[hh] = l_s[hh] * alpha + sum;
        m_s[hh] = m_new;
      }
    }
    __syncthreads();  // every score read of KV is done: load V over K
    for (int i = tid; i < BKD * hd; i += NT) {
      const int j = i / hd, d = i - j * hd, p = p0 + j;
      KV[j * ld + d] = p < S ? to_f32(vb[p * cache_sstride + d]) : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < g * hd; i += NT) {
      const int hh = i / hd, d = i - hh * hd;
      const float* pr = Ss + hh * BKD;
      float a = Acc[i] * a_s[hh];
      for (int j = 0; j < BKD; ++j) a = fmaf(pr[j], KV[j * ld + d], a);
      Acc[i] = a;
    }
  }
  __syncthreads();
  const long long row0 = (long long)b * H + (long long)kh * g;  // first head of this CTA
  for (int i = tid; i < g * hd; i += NT) {
    const int hh = i / hd, d = i - hh * hd;
    part_acc[((row0 + hh) * nsplit + split) * hd + d] = Acc[i];
  }
  for (int hh = tid; hh < g; hh += NT) {
    part_m[(row0 + hh) * nsplit + split] = m_s[hh];
    part_l[(row0 + hh) * nsplit + split] = l_s[hh];
  }
}

// One CTA per (batch row, head): weight each split by exp(m_i - M).
template <typename T>
__global__ void __launch_bounds__(NT)
decode_combine(const float* __restrict__ part_m, const float* __restrict__ part_l,
               const float* __restrict__ part_acc, T* __restrict__ o, int nsplit, int hd) {
  const long long row = blockIdx.x;  // b*H + h; o is (B,1,H,hd) contiguous
  const float* pm = part_m + row * nsplit;
  const float* pl = part_l + row * nsplit;
  float M = pm[0];
  for (int i = 1; i < nsplit; ++i) M = fmaxf(M, pm[i]);
  float L = 0.f;
  for (int i = 0; i < nsplit; ++i) L += expf(pm[i] - M) * pl[i];
  L = fmaxf(L, 1e-30f);
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    float a = 0.f;
    for (int i = 0; i < nsplit; ++i) a += expf(pm[i] - M) * part_acc[(row * nsplit + i) * hd + d];
    store(&o[row * hd + d], a / L);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* valid,
                   long long valid_bstride, void* o, void* part_m, void* part_l,
                   void* part_acc, int B, int S, int H, int KH, int hd,
                   long long cache_bstride, long long cache_sstride, int nsplit,
                   int tiles_per_split, float scale, cudaStream_t stream) {
  const size_t smem = split_smem_bytes(H / KH, hd);
  cudaError_t err = cudaFuncSetAttribute(decode_split<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  decode_split<T><<<dim3(nsplit, KH, B), NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(valid), valid_bstride, static_cast<float*>(part_m),
      static_cast<float*>(part_l), static_cast<float*>(part_acc), S, H, KH, hd,
      cache_bstride, cache_sstride, tiles_per_split, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine<T><<<B * H, NT, 0, stream>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_l),
      static_cast<const float*>(part_acc), static_cast<T*>(o), nsplit, hd);
  return cudaGetLastError();
}

}  // namespace

// q, o: (B,1,H,hd) contiguous.  k, v: (B,S,KH,hd) with the last two dims
// contiguous and element strides cache_bstride (batch) and cache_sstride
// (position).  valid: uint8, element (b, p) at b*valid_bstride + p.
// part_m, part_l: (B,H,nsplit) float32 scratch; part_acc: (B,H,nsplit,hd).
// Split i covers tiles [i*tiles_per_split, (i+1)*tiles_per_split) of 64
// positions.  dtype 0 = float32, 1 = bfloat16.  Returns the cudaError_t.
extern "C" int repro_flash_decode(const void* q, const void* k, const void* v,
                                  const void* valid, long long valid_bstride, void* o,
                                  void* part_m, void* part_l, void* part_acc, int B, int S,
                                  int H, int KH, int hd, long long cache_bstride,
                                  long long cache_sstride, int nsplit, int tiles_per_split,
                                  float scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(q, k, v, valid, valid_bstride, o, part_m, part_l, part_acc, B,
                              S, H, KH, hd, cache_bstride, cache_sstride, nsplit,
                              tiles_per_split, scale, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k, v, valid, valid_bstride, o, part_m, part_l,
                                      part_acc, B, S, H, KH, hd, cache_bstride,
                                      cache_sstride, nsplit, tiles_per_split, scale, st);
  return (int)cudaErrorInvalidValue;
}
