// Shared helpers of the port's CUDA kernels (plain C interface, no torch
// headers: the library builds with nvcc alone and loads through ctypes).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

#define ST_EXPORT extern "C" __attribute__((visibility("default")))

// ConvBNAct tail: folded BatchNorm and SiLU in float32, one bf16 rounding
// (round to nearest even, as jnp.astype / torch.to do).
__device__ __forceinline__ bf16 st_act(float acc, float scale, float bias) {
  float y = acc * scale + bias;
  float s = 1.0f / (1.0f + expf(-y));
  return __float2bfloat16_rn(y * s);
}

__device__ __forceinline__ float st_f(bf16 v) { return __bfloat162float(v); }
