// The Montgomery product of mont.cuh (a*b*2^-256 mod N over 8 x 32-bit
// words) written in PTX carry chains, for the kernels that are bound by
// their integer multiplies or by the dependent chain of them: K17
// (fixed_base.cu) and K18 (lane_tree.cu).  The other kernels keep
// mont.cuh's fe_mul.
//
// The same CIOS schedule as fe_mul: 8 outer steps, each adding a*b[i] and
// then m*N with m = t[0]*n0 mod 2^32, shifting one word.  Where fe_mul
// carries through 64-bit temporaries (about four instructions a word), a
// step here is four chains of one instruction a word: the low halves of
// a*b[i] (mad.lo.cc/madc.lo.cc) into t[0..7] with the carry into t[8],
// the high halves one word up (mad.hi.cc/madc.hi.cc), then the same for
// m*N.  Bounds: with t < 2N < 2^255 at a step's start, t + a*b[i] <
// 2^287 and t + a*b[i] + m*N < 2^288, so no chain carries out of t[8],
// and the shifted t < 2N again.  The result is reduced once, so for
// canonical inputs it is canonical and equal to fe_mul's limb for limb.
#pragma once

#include "mont.cuh"

// t[0..8] += a * b (a step's first half), in two chains
__device__ __forceinline__ void cc_mad_row(uint32_t (&t)[9], const Fe& a, uint32_t b) {
  asm("mad.lo.cc.u32 %0, %9, %17, %0;\n\t"
      "madc.lo.cc.u32 %1, %10, %17, %1;\n\t"
      "madc.lo.cc.u32 %2, %11, %17, %2;\n\t"
      "madc.lo.cc.u32 %3, %12, %17, %3;\n\t"
      "madc.lo.cc.u32 %4, %13, %17, %4;\n\t"
      "madc.lo.cc.u32 %5, %14, %17, %5;\n\t"
      "madc.lo.cc.u32 %6, %15, %17, %6;\n\t"
      "madc.lo.cc.u32 %7, %16, %17, %7;\n\t"
      "addc.u32 %8, %8, 0;\n\t"
      "mad.hi.cc.u32 %1, %9, %17, %1;\n\t"
      "madc.hi.cc.u32 %2, %10, %17, %2;\n\t"
      "madc.hi.cc.u32 %3, %11, %17, %3;\n\t"
      "madc.hi.cc.u32 %4, %12, %17, %4;\n\t"
      "madc.hi.cc.u32 %5, %13, %17, %5;\n\t"
      "madc.hi.cc.u32 %6, %14, %17, %6;\n\t"
      "madc.hi.cc.u32 %7, %15, %17, %7;\n\t"
      "madc.hi.u32 %8, %16, %17, %8;"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]), "+r"(t[7]),
        "+r"(t[8])
      : "r"(a.w[0]), "r"(a.w[1]), "r"(a.w[2]), "r"(a.w[3]), "r"(a.w[4]), "r"(a.w[5]), "r"(a.w[6]), "r"(a.w[7]),
        "r"(b));
}

// t[0..8] += m * N with m = t[0] * n0 (the step's second half); t[0]
// becomes 0
__device__ __forceinline__ void cc_reduce_row(uint32_t (&t)[9], const FieldConst& c) {
  asm("{\n\t"
      ".reg .u32 m;\n\t"
      "mul.lo.u32 m, %0, %17;\n\t"
      "mad.lo.cc.u32 %0, m, %9, %0;\n\t"
      "madc.lo.cc.u32 %1, m, %10, %1;\n\t"
      "madc.lo.cc.u32 %2, m, %11, %2;\n\t"
      "madc.lo.cc.u32 %3, m, %12, %3;\n\t"
      "madc.lo.cc.u32 %4, m, %13, %4;\n\t"
      "madc.lo.cc.u32 %5, m, %14, %5;\n\t"
      "madc.lo.cc.u32 %6, m, %15, %6;\n\t"
      "madc.lo.cc.u32 %7, m, %16, %7;\n\t"
      "addc.u32 %8, %8, 0;\n\t"
      "mad.hi.cc.u32 %1, m, %9, %1;\n\t"
      "madc.hi.cc.u32 %2, m, %10, %2;\n\t"
      "madc.hi.cc.u32 %3, m, %11, %3;\n\t"
      "madc.hi.cc.u32 %4, m, %12, %4;\n\t"
      "madc.hi.cc.u32 %5, m, %13, %5;\n\t"
      "madc.hi.cc.u32 %6, m, %14, %6;\n\t"
      "madc.hi.cc.u32 %7, m, %15, %7;\n\t"
      "madc.hi.u32 %8, m, %16, %8;\n\t"
      "}"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]), "+r"(t[7]),
        "+r"(t[8])
      : "r"(c.n[0]), "r"(c.n[1]), "r"(c.n[2]), "r"(c.n[3]), "r"(c.n[4]), "r"(c.n[5]), "r"(c.n[6]), "r"(c.n[7]),
        "r"(c.n0));
}

// a mod N for a < 2N: a - N in one borrow chain, kept where it did not
// borrow
__device__ __forceinline__ Fe cc_csub(const Fe& a, const FieldConst& c) {
  Fe d;
  uint32_t br;
  asm("sub.cc.u32 %0, %9, %17;\n\t"
      "subc.cc.u32 %1, %10, %18;\n\t"
      "subc.cc.u32 %2, %11, %19;\n\t"
      "subc.cc.u32 %3, %12, %20;\n\t"
      "subc.cc.u32 %4, %13, %21;\n\t"
      "subc.cc.u32 %5, %14, %22;\n\t"
      "subc.cc.u32 %6, %15, %23;\n\t"
      "subc.cc.u32 %7, %16, %24;\n\t"
      "subc.u32 %8, 0, 0;"
      : "=&r"(d.w[0]), "=&r"(d.w[1]), "=&r"(d.w[2]), "=&r"(d.w[3]), "=&r"(d.w[4]), "=&r"(d.w[5]),
        "=&r"(d.w[6]), "=&r"(d.w[7]), "=&r"(br)
      : "r"(a.w[0]), "r"(a.w[1]), "r"(a.w[2]), "r"(a.w[3]), "r"(a.w[4]), "r"(a.w[5]), "r"(a.w[6]), "r"(a.w[7]),
        "r"(c.n[0]), "r"(c.n[1]), "r"(c.n[2]), "r"(c.n[3]), "r"(c.n[4]), "r"(c.n[5]), "r"(c.n[6]), "r"(c.n[7]));
  return br ? a : d;
}

__device__ __forceinline__ Fe fe_mul_cc(const Fe& a, const Fe& b, const FieldConst& c) {
  uint32_t t[9];
#pragma unroll
  for (int j = 0; j < 9; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    cc_mad_row(t, a, b.w[i]);
    cc_reduce_row(t, c);
#pragma unroll
    for (int j = 0; j < 8; ++j) t[j] = t[j + 1];
    t[8] = 0;
  }
  Fe r;
#pragma unroll
  for (int j = 0; j < 8; ++j) r.w[j] = t[j];
  return cc_csub(r, c);
}

// point.cuh's formulas over this product: pt_add<MulCC>(p, q, c)
struct MulCC {
  __device__ __forceinline__ static Fe mul(const Fe& a, const Fe& b, const FieldConst& c) { return fe_mul_cc(a, b, c); }
};
