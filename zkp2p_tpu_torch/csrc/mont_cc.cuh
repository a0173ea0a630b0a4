// The Montgomery product of mont.cuh (a*b*2^-256 mod N over 8 x 32-bit
// words) written in PTX carry chains, for the kernels that are bound by
// their integer multiplies or by the dependent chain of them: K17
// (fixed_base.cu), K18 (lane_tree.cu) and K19 (scale.cu), which also
// takes the Montgomery square below.  The other kernels keep mont.cuh's
// fe_mul.
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

// t[0..15] = a * a (512 bits) in one asm: the 28 cross products a[i]*a[j]
// (i < j) row by row, each row a low-half chain with its carry into the
// row's top word and a high-half chain one word up (no carry leaves the
// top: after row i the sum is below 2^(32(i+9))), then the sum doubled in
// one carry chain and the 8 squares a[i]^2 added on the diagonal: 72
// multiplies against a product's 128.
__device__ __forceinline__ void cc_sqr_wide(uint32_t (&t)[16], const Fe& a) {
  asm("{\n\t"
      ".reg .u32 z;\n\t"
      "mov.u32 z, 0;\n\t"
      "mul.lo.u32 %1, %16, %17;\n\t"
      "mul.lo.u32 %2, %16, %18;\n\t"
      "mul.lo.u32 %3, %16, %19;\n\t"
      "mul.lo.u32 %4, %16, %20;\n\t"
      "mul.lo.u32 %5, %16, %21;\n\t"
      "mul.lo.u32 %6, %16, %22;\n\t"
      "mul.lo.u32 %7, %16, %23;\n\t"
      "mad.hi.cc.u32 %2, %16, %17, %2;\n\t"
      "madc.hi.cc.u32 %3, %16, %18, %3;\n\t"
      "madc.hi.cc.u32 %4, %16, %19, %4;\n\t"
      "madc.hi.cc.u32 %5, %16, %20, %5;\n\t"
      "madc.hi.cc.u32 %6, %16, %21, %6;\n\t"
      "madc.hi.cc.u32 %7, %16, %22, %7;\n\t"
      "madc.hi.u32 %8, %16, %23, z;\n\t"
      "mad.lo.cc.u32 %3, %17, %18, %3;\n\t"
      "madc.lo.cc.u32 %4, %17, %19, %4;\n\t"
      "madc.lo.cc.u32 %5, %17, %20, %5;\n\t"
      "madc.lo.cc.u32 %6, %17, %21, %6;\n\t"
      "madc.lo.cc.u32 %7, %17, %22, %7;\n\t"
      "madc.lo.cc.u32 %8, %17, %23, %8;\n\t"
      "addc.u32 %9, z, z;\n\t"
      "mad.hi.cc.u32 %4, %17, %18, %4;\n\t"
      "madc.hi.cc.u32 %5, %17, %19, %5;\n\t"
      "madc.hi.cc.u32 %6, %17, %20, %6;\n\t"
      "madc.hi.cc.u32 %7, %17, %21, %7;\n\t"
      "madc.hi.cc.u32 %8, %17, %22, %8;\n\t"
      "madc.hi.u32 %9, %17, %23, %9;\n\t"
      "mad.lo.cc.u32 %5, %18, %19, %5;\n\t"
      "madc.lo.cc.u32 %6, %18, %20, %6;\n\t"
      "madc.lo.cc.u32 %7, %18, %21, %7;\n\t"
      "madc.lo.cc.u32 %8, %18, %22, %8;\n\t"
      "madc.lo.cc.u32 %9, %18, %23, %9;\n\t"
      "addc.u32 %10, z, z;\n\t"
      "mad.hi.cc.u32 %6, %18, %19, %6;\n\t"
      "madc.hi.cc.u32 %7, %18, %20, %7;\n\t"
      "madc.hi.cc.u32 %8, %18, %21, %8;\n\t"
      "madc.hi.cc.u32 %9, %18, %22, %9;\n\t"
      "madc.hi.u32 %10, %18, %23, %10;\n\t"
      "mad.lo.cc.u32 %7, %19, %20, %7;\n\t"
      "madc.lo.cc.u32 %8, %19, %21, %8;\n\t"
      "madc.lo.cc.u32 %9, %19, %22, %9;\n\t"
      "madc.lo.cc.u32 %10, %19, %23, %10;\n\t"
      "addc.u32 %11, z, z;\n\t"
      "mad.hi.cc.u32 %8, %19, %20, %8;\n\t"
      "madc.hi.cc.u32 %9, %19, %21, %9;\n\t"
      "madc.hi.cc.u32 %10, %19, %22, %10;\n\t"
      "madc.hi.u32 %11, %19, %23, %11;\n\t"
      "mad.lo.cc.u32 %9, %20, %21, %9;\n\t"
      "madc.lo.cc.u32 %10, %20, %22, %10;\n\t"
      "madc.lo.cc.u32 %11, %20, %23, %11;\n\t"
      "addc.u32 %12, z, z;\n\t"
      "mad.hi.cc.u32 %10, %20, %21, %10;\n\t"
      "madc.hi.cc.u32 %11, %20, %22, %11;\n\t"
      "madc.hi.u32 %12, %20, %23, %12;\n\t"
      "mad.lo.cc.u32 %11, %21, %22, %11;\n\t"
      "madc.lo.cc.u32 %12, %21, %23, %12;\n\t"
      "addc.u32 %13, z, z;\n\t"
      "mad.hi.cc.u32 %12, %21, %22, %12;\n\t"
      "madc.hi.u32 %13, %21, %23, %13;\n\t"
      "mad.lo.cc.u32 %13, %22, %23, %13;\n\t"
      "addc.u32 %14, z, z;\n\t"
      "mad.hi.u32 %14, %22, %23, %14;\n\t"
      "add.cc.u32 %1, %1, %1;\n\t"
      "addc.cc.u32 %2, %2, %2;\n\t"
      "addc.cc.u32 %3, %3, %3;\n\t"
      "addc.cc.u32 %4, %4, %4;\n\t"
      "addc.cc.u32 %5, %5, %5;\n\t"
      "addc.cc.u32 %6, %6, %6;\n\t"
      "addc.cc.u32 %7, %7, %7;\n\t"
      "addc.cc.u32 %8, %8, %8;\n\t"
      "addc.cc.u32 %9, %9, %9;\n\t"
      "addc.cc.u32 %10, %10, %10;\n\t"
      "addc.cc.u32 %11, %11, %11;\n\t"
      "addc.cc.u32 %12, %12, %12;\n\t"
      "addc.cc.u32 %13, %13, %13;\n\t"
      "addc.cc.u32 %14, %14, %14;\n\t"
      "addc.u32 %15, z, z;\n\t"
      "mul.lo.u32 %0, %16, %16;\n\t"
      "mad.hi.cc.u32 %1, %16, %16, %1;\n\t"
      "madc.lo.cc.u32 %2, %17, %17, %2;\n\t"
      "madc.hi.cc.u32 %3, %17, %17, %3;\n\t"
      "madc.lo.cc.u32 %4, %18, %18, %4;\n\t"
      "madc.hi.cc.u32 %5, %18, %18, %5;\n\t"
      "madc.lo.cc.u32 %6, %19, %19, %6;\n\t"
      "madc.hi.cc.u32 %7, %19, %19, %7;\n\t"
      "madc.lo.cc.u32 %8, %20, %20, %8;\n\t"
      "madc.hi.cc.u32 %9, %20, %20, %9;\n\t"
      "madc.lo.cc.u32 %10, %21, %21, %10;\n\t"
      "madc.hi.cc.u32 %11, %21, %21, %11;\n\t"
      "madc.lo.cc.u32 %12, %22, %22, %12;\n\t"
      "madc.hi.cc.u32 %13, %22, %22, %13;\n\t"
      "madc.lo.cc.u32 %14, %23, %23, %14;\n\t"
      "madc.hi.u32 %15, %23, %23, %15;\n\t"
      "}"
      : "=&r"(t[0]), "=&r"(t[1]), "=&r"(t[2]), "=&r"(t[3]), "=&r"(t[4]), "=&r"(t[5]), "=&r"(t[6]), "=&r"(t[7]),
        "=&r"(t[8]), "=&r"(t[9]), "=&r"(t[10]), "=&r"(t[11]), "=&r"(t[12]), "=&r"(t[13]), "=&r"(t[14]),
        "=&r"(t[15])
      : "r"(a.w[0]), "r"(a.w[1]), "r"(a.w[2]), "r"(a.w[3]), "r"(a.w[4]), "r"(a.w[5]), "r"(a.w[6]), "r"(a.w[7]));
}

// a*a*2^-256 mod N: the 512-bit square, then the Montgomery reduction of
// its low half alone (8 cc_reduce_row steps over a 9-word window: t' =
// (lo + m*N) / 2^256 <= N) plus its high half (below N^2 / 2^256 < N/4),
// so the sum is below 2N and one conditional subtract makes it canonical:
// the same limbs as fe_mul_cc(a, a, c) for a canonical a, at 72 + 136 =
// 208 multiplies against 264.
__device__ __forceinline__ Fe fe_sqr_cc(const Fe& a, const FieldConst& c) {
  uint32_t w[16];
  cc_sqr_wide(w, a);
  uint32_t t[9];
#pragma unroll
  for (int j = 0; j < 8; ++j) t[j] = w[j];
  t[8] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    cc_reduce_row(t, c);
#pragma unroll
    for (int j = 0; j < 8; ++j) t[j] = t[j + 1];
    t[8] = 0;
  }
  Fe r;
  asm("add.cc.u32 %0, %8, %16;\n\t"
      "addc.cc.u32 %1, %9, %17;\n\t"
      "addc.cc.u32 %2, %10, %18;\n\t"
      "addc.cc.u32 %3, %11, %19;\n\t"
      "addc.cc.u32 %4, %12, %20;\n\t"
      "addc.cc.u32 %5, %13, %21;\n\t"
      "addc.cc.u32 %6, %14, %22;\n\t"
      "addc.u32 %7, %15, %23;"
      : "=&r"(r.w[0]), "=&r"(r.w[1]), "=&r"(r.w[2]), "=&r"(r.w[3]), "=&r"(r.w[4]), "=&r"(r.w[5]),
        "=&r"(r.w[6]), "=&r"(r.w[7])
      : "r"(t[0]), "r"(t[1]), "r"(t[2]), "r"(t[3]), "r"(t[4]), "r"(t[5]), "r"(t[6]), "r"(t[7]), "r"(w[8]),
        "r"(w[9]), "r"(w[10]), "r"(w[11]), "r"(w[12]), "r"(w[13]), "r"(w[14]), "r"(w[15]));
  return cc_csub(r, c);
}

// point.cuh's formulas over this product: pt_add<MulCC>(p, q, c); a
// square is a product of an element with itself, so K17 and K18 run the
// products and limbs they always ran
struct MulCC {
  __device__ __forceinline__ static Fe mul(const Fe& a, const Fe& b, const FieldConst& c) { return fe_mul_cc(a, b, c); }
  __device__ __forceinline__ static Fe sqr(const Fe& a, const FieldConst& c) { return fe_mul_cc(a, a, c); }
};
