// SplitMix32 direction chain as __device__ functions in native uint32.
//
// Port of repro/kernels/common.py (splitmix32 ... tile_from_state), bit
// for bit: uint32 arithmetic wraps mod 2^32 exactly as the reference's.
// The chain is kept in its factored form: the seed rounds and the row
// rounds are hoisted (row_state, once per (seed, row)), leaving one
// mixer round per element (value_from_state).
//
// Float ops use the _rn intrinsics, and the kernels are built with
// -fmad=false, so nothing is contracted into an FMA.  Gaussian uses
// the precise logf/cosf/sqrtf (never --use_fast_math); they may differ
// from the reference's by an ulp, which the tests allow for.
#pragma once
#include <cuda_bf16.h>
#include <stdint.h>

namespace fs {

// Leaf element types the FedScalar and QSGD kernels take (the wrappers'
// dtype code): the TPU kernels read x.astype(float32) and write
// o_ref.dtype, so a bf16 leaf is widened exactly on load and the float32
// result is rounded to nearest-even once on store, as astype does.
enum DType : int { F32 = 0, BF16 = 1 };

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_rn(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_rn(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// 16-byte vector accesses: element j of a uint4 holding V = 16 / sizeof(T)
// leaf elements, widened exactly (bf16 is the high half of a float32), and
// V float32 values rounded once to T and packed back (j compile-time
// after unrolling, so nothing leaves the registers).
template <typename T> struct VecOf { static constexpr int V = 16 / (int)sizeof(T); };

__device__ __forceinline__ uint32_t vec_word(const uint4& w, int i) {
  return i == 0 ? w.x : (i == 1 ? w.y : (i == 2 ? w.z : w.w));
}
template <typename T>
__device__ __forceinline__ float vec_f32(const uint4& w, int j);
template <>
__device__ __forceinline__ float vec_f32<float>(const uint4& w, int j) {
  return __uint_as_float(vec_word(w, j));
}
template <>
__device__ __forceinline__ float vec_f32<__nv_bfloat16>(const uint4& w, int j) {
  const uint32_t word = vec_word(w, j >> 1);
  return __uint_as_float((j & 1) ? (word & 0xFFFF0000u) : (word << 16));
}
template <typename T>
__device__ __forceinline__ uint4 vec_pack(const float (&v)[VecOf<T>::V]);
template <>
__device__ __forceinline__ uint4 vec_pack<float>(const float (&v)[4]) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                    __float_as_uint(v[2]), __float_as_uint(v[3]));
}
template <>
__device__ __forceinline__ uint4 vec_pack<__nv_bfloat16>(const float (&v)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i]))
           | ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i + 1])) << 16);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// x rounded to T and widened back: the value a T leaf would store.
__device__ __forceinline__ float round_as(float x, const float*) { return x; }
__device__ __forceinline__ float round_as(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

enum Dist : int { RADEMACHER = 0, GAUSSIAN = 1, SPARSE_RADEMACHER = 2, HADAMARD = 3 };

constexpr uint32_t TAG_U1 = 0x9E3779B9u;
constexpr uint32_t TAG_U2 = 0x85EBCA6Bu;
constexpr uint32_t TAG_HAD_MR = 0xC2B2AE35u;
constexpr uint32_t TAG_HAD_MC = 0x27D4EB2Fu;
constexpr uint32_t TAG_HAD_TR = 0x165667B1u;
constexpr uint32_t TAG_HAD_TC = 0x9E3779F9u;
constexpr uint32_t HAD_MASK_FALLBACK = 0x9E3779B9u;
constexpr uint32_t PROJ_SALT = 0xA511E9B3u;
constexpr uint32_t SPARSE_S = 4u;
constexpr float TWO_PI_F = 6.28318548202514648f;   // float32(2*pi)
constexpr float TWO_POW_M32 = 2.3283064365386963e-10f;  // 2^-32

__device__ __forceinline__ uint32_t splitmix32(uint32_t x) {
  x += 0x9E3779B9u;
  x ^= x >> 16;
  x *= 0x21F0AAADu;
  x ^= x >> 15;
  x *= 0x735A2D97u;
  x ^= x >> 15;
  return x;
}

__device__ __forceinline__ uint32_t parity32(uint32_t x) {
  x ^= x >> 16;
  x ^= x >> 8;
  x ^= x >> 4;
  x ^= x >> 2;
  x ^= x >> 1;
  return x & 1u;
}

// splitmix32(seed ^ splitmix32(leaf_tag))
__device__ __forceinline__ uint32_t fold_seed(uint32_t seed, uint32_t leaf_tag) {
  return splitmix32(seed ^ splitmix32(leaf_tag));
}

// Per-block, leaf-folded seed: fold_seed(splitmix32(seed ^ (PROJ_SALT + b)), tag).
__device__ __forceinline__ uint32_t block_leaf_seed(uint32_t seed, uint32_t b,
                                                    uint32_t leaf_tag) {
  return fold_seed(splitmix32(seed ^ (PROJ_SALT + b)), leaf_tag);
}

__device__ __forceinline__ float uniform01(uint32_t bits) {
  return __fmul_rn(__fadd_rn(__uint2float_rn(bits), 1.0f), TWO_POW_M32);
}

struct RowState {
  uint32_t a, b, c;
};

// Hoisted rounds of the chain for one (leaf-folded seed, row).
template <int DIST>
__device__ __forceinline__ RowState row_state(uint32_t s, uint32_t row) {
  RowState st{0u, 0u, 0u};
  if (DIST == RADEMACHER || DIST == SPARSE_RADEMACHER) {
    st.a = splitmix32(splitmix32(s ^ TAG_U1) ^ row);
  } else if (DIST == GAUSSIAN) {
    st.a = splitmix32(splitmix32(s ^ TAG_U1) ^ row);
    st.b = splitmix32(splitmix32(s ^ TAG_U2) ^ row);
  } else {  // HADAMARD: (row parity, column mask, column translation)
    uint32_t m_r = splitmix32(s ^ TAG_HAD_MR);
    m_r = m_r == 0u ? HAD_MASK_FALLBACK : m_r;
    uint32_t m_c = splitmix32(s ^ TAG_HAD_MC);
    m_c = m_c == 0u ? HAD_MASK_FALLBACK : m_c;
    uint32_t t_r = splitmix32(s ^ TAG_HAD_TR);
    uint32_t t_c = splitmix32(s ^ TAG_HAD_TC);
    st.a = parity32((row ^ t_r) & m_r);
    st.b = m_c;
    st.c = t_c;
  }
  return st;
}

// The per-element round and the family's value map.
template <int DIST>
__device__ __forceinline__ float value_from_state(const RowState& st, uint32_t col) {
  if (DIST == RADEMACHER) {
    uint32_t bits = splitmix32(st.a ^ col);
    return ((bits >> 8) & 1u) ? 1.0f : -1.0f;
  } else if (DIST == GAUSSIAN) {
    float u1 = uniform01(splitmix32(st.a ^ col));
    float u2 = uniform01(splitmix32(st.b ^ col));
    float r = sqrtf(__fmul_rn(-2.0f, logf(u1)));
    return __fmul_rn(r, cosf(__fmul_rn(TWO_PI_F, u2)));
  } else if (DIST == SPARSE_RADEMACHER) {
    uint32_t bits = splitmix32(st.a ^ col);
    if ((bits & (SPARSE_S - 1u)) != 0u) return 0.0f;
    return ((bits >> 8) & 1u) ? 2.0f : -2.0f;   // ±sqrt(SPARSE_S)
  } else {
    uint32_t bit = st.a ^ parity32((col ^ st.c) & st.b);
    return bit == 0u ? 1.0f : -1.0f;
  }
}

}  // namespace fs
