// K4 grad_sumsq and K5 adamw_update: AdamW's global gradient norm and its
// elementwise update, each in one pass over the leaves.
//
// No Pallas kernel stands behind either.  The reference jits its train step
// (src/repro/train/loop.py:37), so XLA fuses AdamW's update and its global
// norm (src/repro/train/optimizer.py:30-33, :53-81) into a few passes over
// the leaves; these two kernels are the port's counterpart of that fusion.
//   K4: ss = the float32 sum over every gradient leaf of its squares (the
//       reference's global_norm before the sqrt), written to a device scalar.
//   K5: per element, with the clip scale, lr, b1c and b2c read from device
//       memory and the reference's arithmetic in its order:
//         g = g * scale;  mu = b1 mu + (1 - b1) g;  nu = b2 nu + (1 - b2) g g
//         delta = (mu / b1c) / (sqrt(nu / b2c) + eps) + wd p
//         p = p - lr delta, rounded to the param's type (nearest even)
//
// Both are bound by memory: K4 reads each gradient once (2 bytes a bf16
// element); K5 reads p, g, mu, nu and writes p, mu, nu once (22 bytes a bf16
// param with float32 moments).  A thread moves 8 elements at a time, in
// 16-byte loads and stores.
//
// What held K5 back, and its design (measured on an H100 at deepseek-7b's
// 20-layer leaves by tools/k5_probe.py; PERF.md): each thread loaded a
// vector, ran its arithmetic (three IEEE divisions and a square root an
// element) and stored it, in turn, so no load of its was in flight while it
// computed.  The same tiles with the arithmetic taken out ran near the HBM
// rate, the kernel at half of it.  So each thread now issues its next
// vector's loads before the arithmetic of the current one (a register double
// buffer), as streaming loads and stores (ld/st.global.cs: every byte is
// touched once), at more registers and so fewer threads than before; and a
// zero operand skips the divisions' slow path (div_rn).  Persistent blocks
// fed by a ring of bulk copies (cp.async.bulk into shared memory and
// mbarriers), and a persistent grid with this register double buffer, were
// tried and ran slower, the ring even with the arithmetic taken out.
//
// The leaves travel as a kernel parameter, a table of pointers and sizes of
// at most 4 KB passed by value (__grid_constant__, read in place from the
// parameter space), one launch a group of leaves.  So a launch reads no
// pointer table from device memory, and can be captured into a CUDA graph
// where the gradients were allocated inside the capture (a table copied from
// host memory would be a pageable copy, which capture refuses).  A block
// takes one tile of one leaf, found by a binary search of the table.
//
// K4 sums in a fixed order, with no atomics: each thread its elements of a
// tile in float32, each block its threads in double by a fixed tree, one
// partial a tile, then one block sums every partial in double in a fixed
// order.  Two runs give the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 8;                            // elements a thread moves at a time
constexpr int SUMSQ_TILE = THREADS * VEC * 8;     // elements a K4 block sums
constexpr int UPDATE_TILE = THREADS * VEC * 4;    // elements a K5 block updates
constexpr int SUMSQ_LEAVES = 128;                 // leaves a K4 table holds
constexpr int UPDATE_LEAVES = 64;                 // leaves a K5 table holds
constexpr int FINAL_THREADS = 1024;

// the tables: the wrapper (kernels/optim/adamw.py) fills the same layout
// with ctypes; "first" is the leaf's first block within its launch
struct SumsqLeaf {
  const void* x;
  long long n;
  int first;
  int bf16;
};
struct SumsqTable {
  SumsqLeaf leaf[SUMSQ_LEAVES];
  int count;
  int base;     // this launch's first partial
  int blocks;   // this launch's blocks: every tile of its leaves
};

constexpr int P_BF16 = 1, G_BF16 = 2;   // UpdateLeaf.flags
struct UpdateLeaf {
  void* p;
  const void* g;
  float* mu;
  float* nu;
  long long n;
  int first;
  int flags;
};
struct UpdateTable {
  UpdateLeaf leaf[UPDATE_LEAVES];
  int count;
  int blocks;
};
struct Hyper {
  float b1, omb1, b2, omb2, eps, wd;   // omb1 = 1 - b1, omb2 = 1 - b2, rounded from double
};

static_assert(sizeof(SumsqTable) + sizeof(void*) <= 4096, "K4's parameters exceed 4 KB");
static_assert(sizeof(UpdateTable) + sizeof(void*) + sizeof(Hyper) <= 4096,
              "K5's parameters exceed 4 KB");

// the leaf whose tiles hold block b: the last with first <= b
template <class Table>
__device__ __forceinline__ int find_leaf(const Table& t, int b) {
  int lo = 0, hi = t.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.leaf[mid].first <= b) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

// 8 bf16 or float32 values from a 16-byte-aligned address, as float32
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&f)[VEC]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < VEC / 2; ++j) {
    const float2 x = __bfloat1622float2(h[j]);
    f[2 * j] = x.x;
    f[2 * j + 1] = x.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float (&f)[VEC]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&f)[VEC]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < VEC / 2; ++j) h[j] = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
  __stcs(reinterpret_cast<uint4*>(p), u);
}
__device__ __forceinline__ void store8(float* p, const float (&f)[VEC]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(f[0], f[1], f[2], f[3]));
  __stcs(reinterpret_cast<float4*>(p) + 1, make_float4(f[4], f[5], f[6], f[7]));
}
__device__ __forceinline__ float load1(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }

// the sum of v over the block's NT threads, by a fixed tree; every thread
// gets it
template <int NT>
__device__ __forceinline__ double block_sum(double v) {
  __shared__ double warp_sum[NT / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) warp_sum[warp] = v;
  __syncthreads();
  v = lane < NT / 32 ? warp_sum[lane] : 0.0;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// one thread's float32 sum of squares over its elements of [start, end)
template <class T>
__device__ __forceinline__ float tile_sumsq(const T* x, long long start, long long end) {
  float acc = 0.f;
  const long long vend = start + (end - start) / VEC * VEC;
  for (long long i = start + (long long)threadIdx.x * VEC; i < vend; i += THREADS * VEC) {
    float f[VEC];
    load8(x + i, f);
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc = fmaf(f[j], f[j], acc);
  }
  for (long long i = vend + threadIdx.x; i < end; i += THREADS) {
    const float f = load1(x + i);
    acc = fmaf(f, f, acc);
  }
  return acc;
}

__global__ void __launch_bounds__(THREADS)
    sumsq_tiles(const __grid_constant__ SumsqTable t, double* __restrict__ partials) {
  const SumsqLeaf& L = t.leaf[find_leaf(t, blockIdx.x)];
  const long long start = (long long)(blockIdx.x - L.first) * SUMSQ_TILE;
  const long long end = start + SUMSQ_TILE < L.n ? start + SUMSQ_TILE : L.n;
  const float acc = L.bf16 ? tile_sumsq(static_cast<const __nv_bfloat16*>(L.x), start, end)
                           : tile_sumsq(static_cast<const float*>(L.x), start, end);
  const double s = block_sum<THREADS>((double)acc);
  if (threadIdx.x == 0) partials[t.base + blockIdx.x] = s;
}

__global__ void __launch_bounds__(FINAL_THREADS)
    sumsq_final(const double* __restrict__ partials, int n, float* __restrict__ out) {
  double acc = 0.0;
  for (int i = threadIdx.x; i < n; i += FINAL_THREADS) acc += partials[i];
  const double s = block_sum<FINAL_THREADS>(acc);
  if (threadIdx.x == 0) *out = (float)s;
}

// 8 values of type T as they lie in memory, loaded and not yet converted,
// so that their loads stay in flight while other values are computed
template <class T>
struct Raw8 {
  uint4 u[sizeof(T) / 2];
};
template <class T>
__device__ __forceinline__ void load_raw8(const T* p, Raw8<T>& r) {
#pragma unroll
  for (int i = 0; i < (int)(sizeof(T) / 2); ++i)
    r.u[i] = __ldcs(reinterpret_cast<const uint4*>(p) + i);
}
__device__ __forceinline__ void unpack8(const Raw8<__nv_bfloat16>& r, float (&f)[VEC]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r.u[0]);
#pragma unroll
  for (int j = 0; j < VEC / 2; ++j) {
    const float2 x = __bfloat1622float2(h[j]);
    f[2 * j] = x.x;
    f[2 * j + 1] = x.y;
  }
}
__device__ __forceinline__ void unpack8(const Raw8<float>& r, float (&f)[VEC]) {
  const float* x = reinterpret_cast<const float*>(&r.u[0]);
#pragma unroll
  for (int j = 0; j < VEC; ++j) f[j] = x[j];
}

// x / y and sqrt(x), rounded to nearest.  A zero x gives x itself (its sign
// kept; over a positive y), which is what the division and the square root
// round to, without the slow path the card takes for a zero operand: an
// embedding row that no token of a step touched has a zero gradient, and
// zero moments from then on (tools/k5_probe.py times K5 without this)
__device__ __forceinline__ float div_rn(float x, float y) {
  return x == 0.f && y > 0.f ? x : __fdiv_rn(x, y);
}
__device__ __forceinline__ float sqrt_rn(float x) { return x == 0.f ? x : __fsqrt_rn(x); }

// the reference's update of one element, in its order (optimizer.py:62-73),
// every product and sum rounded on its own (no fused multiply-add), as the
// plain version's PyTorch operations round them: so the two agree bit for
// bit, and a param whose update nearly cancels it rounds alike on both
__device__ __forceinline__ void adamw1(float& p, float g, float& mu, float& nu, const Hyper& h,
                                       float scale, float lr, float b1c, float b2c) {
  g = __fmul_rn(g, scale);
  mu = __fadd_rn(__fmul_rn(mu, h.b1), __fmul_rn(g, h.omb1));
  nu = __fadd_rn(__fmul_rn(nu, h.b2), __fmul_rn(__fmul_rn(g, h.omb2), g));
  float delta = div_rn(div_rn(mu, b1c), __fadd_rn(sqrt_rn(div_rn(nu, b2c)), h.eps));
  delta = __fadd_rn(delta, __fmul_rn(p, h.wd));
  p = __fsub_rn(p, __fmul_rn(delta, lr));
}

template <class P, class G>
__device__ __forceinline__ void update_tile(const UpdateLeaf& L, long long start, long long end,
                                            const Hyper& h, float scale, float lr, float b1c,
                                            float b2c) {
  P* p = static_cast<P*>(L.p);
  const G* g = static_cast<const G*>(L.g);
  const long long vend = start + (end - start) / VEC * VEC;
  long long i = start + (long long)threadIdx.x * VEC;
  Raw8<P> rp;
  Raw8<G> rg;
  Raw8<float> rm, rn;
  if (i < vend) {
    load_raw8(p + i, rp);
    load_raw8(g + i, rg);
    load_raw8(L.mu + i, rm);
    load_raw8(L.nu + i, rn);
  }
  for (; i < vend; i += THREADS * VEC) {
    float pf[VEC], gf[VEC], mf[VEC], nf[VEC];
    unpack8(rp, pf);
    unpack8(rg, gf);
    unpack8(rm, mf);
    unpack8(rn, nf);
    const long long next = i + THREADS * VEC;
    if (next < vend) {         // in flight during the arithmetic below
      load_raw8(p + next, rp);
      load_raw8(g + next, rg);
      load_raw8(L.mu + next, rm);
      load_raw8(L.nu + next, rn);
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) adamw1(pf[j], gf[j], mf[j], nf[j], h, scale, lr, b1c, b2c);
    store8(p + i, pf);
    store8(L.mu + i, mf);
    store8(L.nu + i, nf);
  }
  for (long long i = vend + threadIdx.x; i < end; i += THREADS) {
    float pf = load1(p + i), mf = L.mu[i], nf = L.nu[i];
    adamw1(pf, load1(g + i), mf, nf, h, scale, lr, b1c, b2c);
    store1(p + i, pf);
    L.mu[i] = mf;
    L.nu[i] = nf;
  }
}

// scalars: the clip scale, lr, b1c, b2c (float32, on the device)
__global__ void __launch_bounds__(THREADS)
    adamw_update(const __grid_constant__ UpdateTable t, const float* __restrict__ scalars,
                 const Hyper h) {
  const UpdateLeaf& L = t.leaf[find_leaf(t, blockIdx.x)];
  const long long start = (long long)(blockIdx.x - L.first) * UPDATE_TILE;
  const long long end = start + UPDATE_TILE < L.n ? start + UPDATE_TILE : L.n;
  const float scale = scalars[0], lr = scalars[1], b1c = scalars[2], b2c = scalars[3];
  switch (L.flags) {
    case P_BF16 | G_BF16:
      update_tile<__nv_bfloat16, __nv_bfloat16>(L, start, end, h, scale, lr, b1c, b2c);
      break;
    case P_BF16:
      update_tile<__nv_bfloat16, float>(L, start, end, h, scale, lr, b1c, b2c);
      break;
    case G_BF16:
      update_tile<float, __nv_bfloat16>(L, start, end, h, scale, lr, b1c, b2c);
      break;
    default:
      update_tile<float, float>(L, start, end, h, scale, lr, b1c, b2c);
  }
}

}  // namespace

extern "C" {

// groups: n_groups K4 tables (each leaf non-empty, 16-byte aligned, bf16 or
// float32); partials: n_partials doubles, the sum of the tables' blocks;
// out: one float.  -> a CUDA error code, 0 on success.
// (The tables come as void pointers: a function whose signature names the
// anonymous namespace's types would not be exported.)
int repro_grad_sumsq(const void* tables, int n_groups, double* partials,
                                int n_partials, float* out, void* stream) {
  if (n_groups < 1 || n_partials < 1) return (int)cudaErrorInvalidValue;
  const SumsqTable* groups = static_cast<const SumsqTable*>(tables);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int i = 0; i < n_groups; ++i) {
    const SumsqTable& t = groups[i];
    if (t.count < 1 || t.count > SUMSQ_LEAVES || t.blocks < 1 || t.base + t.blocks > n_partials)
      return (int)cudaErrorInvalidValue;
    sumsq_tiles<<<t.blocks, THREADS, 0, st>>>(t, partials);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  sumsq_final<<<1, FINAL_THREADS, 0, st>>>(partials, n_partials, out);
  return (int)cudaGetLastError();
}

// groups: n_groups K5 tables (p bf16 or float32, g bf16 or float32, mu and
// nu float32, each leaf non-empty and every pointer 16-byte aligned);
// scalars: 4 floats on the device.  -> a CUDA error code, 0 on success.
int repro_adamw_update(const void* tables, int n_groups, const float* scalars,
                                  float b1, float omb1, float b2, float omb2, float eps,
                                  float wd, void* stream) {
  if (n_groups < 1) return (int)cudaErrorInvalidValue;
  const UpdateTable* groups = static_cast<const UpdateTable*>(tables);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Hyper h = {b1, omb1, b2, omb2, eps, wd};
  for (int i = 0; i < n_groups; ++i) {
    const UpdateTable& t = groups[i];
    if (t.count < 1 || t.count > UPDATE_LEAVES || t.blocks < 1) return (int)cudaErrorInvalidValue;
    adamw_update<<<t.blocks, THREADS, 0, st>>>(t, scalars, h);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // the C interface
