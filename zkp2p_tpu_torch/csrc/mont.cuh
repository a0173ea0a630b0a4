// BN254 field arithmetic for one thread: 256-bit values as 8 x 32-bit
// words, Montgomery form with R = 2^256.  Shared by mont_mul.cu (K1) and
// point_ops.cu (K2-K4).
//
// At the boundary of every kernel an element is 16 little-endian 16-bit
// limbs held in int32 (the layout of the reference's JAX field layer);
// inside, limbs pack two to a word.  Every operation returns exactly the
// limbs the reference computes: the Montgomery product keeps the low 256
// bits of (a*b + m*N) / 2^256 and subtracts N once, add drops the carry
// out of bit 256 before its conditional subtract, and sub adds N back
// (mod 2^256) on a borrow.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

struct FieldConst {
  uint32_t n[8];    // modulus N
  uint32_t one[8];  // Montgomery one, 2^256 mod N
  uint32_t n0;      // -N^-1 mod 2^32
};

struct Fe {
  uint32_t w[8];
};

__device__ __forceinline__ Fe fe_load(const int32_t* __restrict__ p) {
  const int4* q = reinterpret_cast<const int4*>(p);
  Fe r;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    int4 v = __ldg(q + k);
    r.w[2 * k] = (uint32_t)v.x | ((uint32_t)v.y << 16);
    r.w[2 * k + 1] = (uint32_t)v.z | ((uint32_t)v.w << 16);
  }
  return r;
}

__device__ __forceinline__ void fe_store(int32_t* __restrict__ p, const Fe& a) {
  int4* q = reinterpret_cast<int4*>(p);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    q[k] = make_int4((int)(a.w[2 * k] & 0xFFFFu), (int)(a.w[2 * k] >> 16),
                     (int)(a.w[2 * k + 1] & 0xFFFFu), (int)(a.w[2 * k + 1] >> 16));
  }
}

// d = a - b mod 2^256; returns the borrow (1 where a < b).
__device__ __forceinline__ uint32_t fe_sub_raw(Fe& d, const Fe& a, const uint32_t* b) {
  uint32_t br = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    uint64_t x = (uint64_t)a.w[k] - b[k] - br;
    d.w[k] = (uint32_t)x;
    br = (uint32_t)(x >> 32) & 1u;
  }
  return br;
}

// a mod N for a < 2N (one conditional subtract).
__device__ __forceinline__ Fe fe_csub(const Fe& a, const FieldConst& c) {
  Fe d;
  uint32_t br = fe_sub_raw(d, a, c.n);
  return br ? a : d;
}

__device__ __forceinline__ Fe fe_add(const Fe& a, const Fe& b, const FieldConst& c) {
  Fe s;
  uint64_t cy = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    cy += (uint64_t)a.w[k] + b.w[k];
    s.w[k] = (uint32_t)cy;
    cy >>= 32;
  }
  return fe_csub(s, c);
}

__device__ __forceinline__ Fe fe_sub(const Fe& a, const Fe& b, const FieldConst& c) {
  Fe d;
  uint32_t br = fe_sub_raw(d, a, b.w);
  if (br) {
    uint64_t cy = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      cy += (uint64_t)d.w[k] + c.n[k];
      d.w[k] = (uint32_t)cy;
      cy >>= 32;
    }
  }
  return d;
}

// CIOS Montgomery product a*b*2^-256 mod N: 8 outer steps, each adding
// a*b[i] and then m*N with m = t[0]*n0 mod 2^32, shifting one word.
// 64 + 64 32x32->64 multiply-adds and 8 low multiplies.
__device__ __forceinline__ Fe fe_mul(const Fe& a, const Fe& b, const FieldConst& c) {
  uint32_t t[10];
#pragma unroll
  for (int j = 0; j < 10; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t cy = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint64_t p = (uint64_t)a.w[j] * b.w[i] + t[j] + cy;
      t[j] = (uint32_t)p;
      cy = p >> 32;
    }
    uint64_t s = (uint64_t)t[8] + cy;
    t[8] = (uint32_t)s;
    t[9] = (uint32_t)(s >> 32);
    uint32_t m = t[0] * c.n0;
    uint64_t p = (uint64_t)m * c.n[0] + t[0];
    cy = p >> 32;
#pragma unroll
    for (int j = 1; j < 8; ++j) {
      p = (uint64_t)m * c.n[j] + t[j] + cy;
      t[j - 1] = (uint32_t)p;
      cy = p >> 32;
    }
    s = (uint64_t)t[8] + cy;
    t[7] = (uint32_t)s;
    t[8] = t[9] + (uint32_t)(s >> 32);
  }
  Fe r;
#pragma unroll
  for (int j = 0; j < 8; ++j) r.w[j] = t[j];
  return fe_csub(r, c);
}

__device__ __forceinline__ bool fe_is_zero(const Fe& a) {
  uint32_t o = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) o |= a.w[k];
  return o == 0;
}

__device__ __forceinline__ Fe fe_zero() {
  Fe r;
#pragma unroll
  for (int k = 0; k < 8; ++k) r.w[k] = 0;
  return r;
}

__device__ __forceinline__ Fe fe_one(const FieldConst& c) {
  Fe r;
#pragma unroll
  for (int k = 0; k < 8; ++k) r.w[k] = c.one[k];
  return r;
}
