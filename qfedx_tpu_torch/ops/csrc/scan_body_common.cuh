// Shared by both instances of the scan-body kernel (scan_body.cu): the
// slab geometry, the int32 descriptor layout the wrapper writes
// (ops/scan_body.py::_layout), the op kind codes (_KIND_CODE there) and
// the element types (f32 and bf16) the instances read and write in
// global memory.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace qfx {

constexpr int LANES = 128;
constexpr int LANE_BITS = 7;
constexpr int DESC_W = 8;

// Descriptor fields.
constexpr int D_KIND = 0;    // op kind code (below)
constexpr int D_Q0 = 1;      // first qubit (control for glane/growmat/cnot)
constexpr int D_Q1 = 2;      // second qubit (rowpair q2, cnot target)
constexpr int D_RE = 3;      // offset of the re coefficients (floats)
constexpr int D_IM = 4;      // offset of the im coefficients, -1 = real
constexpr int D_GROUPS = 5;  // coefficient groups G (G divides tb)
constexpr int D_GSIZE = 6;   // floats per (layer, group) gate
constexpr int D_STATIC = 7;  // offset into the int32 statics (rowperm)

enum Kind {
  K_LANE = 0,
  K_ROWMAT = 1,
  K_MASK = 2,
  K_GLANE = 3,
  K_GROWMAT = 4,
  K_ROWPERM = 5,
  K_ROWPAIR = 6,
  K_CNOT = 7,
};

// The element type of a launch's state, boundaries and coefficients in
// global memory. Arithmetic is f32 in both instances; the bf16 one rounds
// each op's result to bf16 (rnd) where the reference's Pallas _emit
// rounds, and keeps the rounded values as f32 in shared memory.
using bf16 = __nv_bfloat16;
template <class T>
constexpr bool IS_BF16 = sizeof(T) == 2;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <class T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// A read-only (non-coherent cache) load, as f32.
__device__ __forceinline__ float ldg_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg_f32(const bf16* p) {
  return __bfloat162float(__ldg(p));
}

// x rounded to T's precision, as an f32 value (the identity for f32).
template <class T>
__device__ __forceinline__ float rnd(float x) {
  return to_f32(from_f32<T>(x));
}

// Four consecutive elements (16 bytes in f32, 8 in bf16, aligned so) as
// f32, and back.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const __nv_bfloat162* pair = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 lo = __bfloat1622float2(pair[0]);
  const float2 hi = __bfloat1622float2(pair[1]);
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(bf16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<const unsigned*>(&lo);
  raw.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

// The complex product of the bf16 instance at the reference's rounding
// points: each of the four real products (accumulated in f32) rounds to
// bf16, then re = rr - ii and im = ir + ri round as bf16 arithmetic does.
template <class T>
__device__ __forceinline__ float cre_of(float rr, float ii) {
  return rnd<T>(rnd<T>(rr) - rnd<T>(ii));
}
template <class T>
__device__ __forceinline__ float cim_of(float ir, float ri) {
  return rnd<T>(rnd<T>(ir) + rnd<T>(ri));
}

}  // namespace qfx
