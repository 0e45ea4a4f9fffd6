// Helpers shared by the attention and recurrence kernels: conversion between
// the storage type (float or __nv_bfloat16) and float, 16-byte loads of
// float, stores of four outputs, and the segment that holds a position.
//
// Every kernel computes in float and rounds to the storage type once, on
// the way out; __float2bfloat16_rn rounds to nearest even, as PyTorch's
// float -> bfloat16 cast does.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace kern {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Vec<T>::N elements of T fill 16 bytes; load() converts them to float.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
};

// Four consecutive outputs, rounded to T.
__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b,
                                       float c, float d) {
  __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(p);
  q[0] = __floats2bfloat162_rn(a, b);
  q[1] = __floats2bfloat162_rn(c, d);
}

// The segment [lo, hi) of the offsets seg[0] = 0 < ... <= seg[n] that
// holds pos (0 <= pos < seg[n]): the last i with seg[i] <= pos, so an empty
// segment is passed over.
__device__ __forceinline__ void seg_bounds(const int* seg, int n, int pos,
                                           int& lo, int& hi) {
  int a = 0, b = n;
  while (b - a > 1) {
    const int m = (a + b) >> 1;
    if (seg[m] <= pos) a = m; else b = m;
  }
  lo = seg[a];
  hi = seg[b];
}

}  // namespace kern
