// Helpers shared by the attention kernels (K1 flash_attention.cu, K2
// flash_decode.cu): the reference's finite mask value and float32 <-> storage
// type conversions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

// Masked logits: the reference's finite -1e30, so that a row whose keys are
// all masked averages them instead of dividing 0 by 0.
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

}  // namespace repro
