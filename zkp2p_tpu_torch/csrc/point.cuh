// BN254 Jacobian point math for one thread, written once over the field
// type (Fe = Fq, Fe2 = Fq2) and shared by point_ops.cu (K2-K4),
// msm_window.cu (K6-K9) and msm_fold.cu (K10/K11, which spreads the same
// formulas over three threads), so that every kernel runs literally the
// same formulas and case selects and its output limbs equal the
// reference's.
//
// The addend q of pt_add / pt_add_core (and the affine addend of
// pt_add_mixed_q) is read through its accessors qx(), qy(), qz() at each
// use: Jac<E> returns the coordinates it holds, and a kernel may pass an
// addend that reads them from device memory where the formula needs them
// instead of holding 3 coordinates in registers across the add (K8, K9).
//
// The formulas (dbl-2009-l, add-2007-bl and its mixed form), the order of
// the case selects (q at infinity -> p, p at infinity -> q, same x and same
// y -> double, same x only -> (0, 0, 0)) and the encodings (Jacobian
// infinity Z = 0, affine infinity (0, 0), Montgomery one (R, 0) in Fq2)
// are the reference's (zkp2p_tpu/ops/pallas_curve.py: _add_math,
// _add_mixed_math, _add_core_math, _double_math over _FqOps / _Fq2Ops).
// The selects are branches: the doubling runs only in lanes that need it,
// which changes no output.
//
// The Montgomery product is a template parameter M of the formulas (a type
// with a static mul, and a static sqr that the formulas call where an
// element is squared): MulC, mont.cuh's fe_mul, by default, so that a
// kernel that names none runs fe_mul; MulCC (mont_cc.cuh), the same
// product in PTX carry chains, where K17 and K18 name it; K19's MulCallCC
// (scale.cu), that product and mont_cc.cuh's Montgomery square as called
// functions.  Every value is canonical, so they all give the same limbs.
#pragma once

#include "mont.cuh"

struct Fe2 {
  Fe c0, c1;
};

struct MulC {
  __device__ __forceinline__ static Fe mul(const Fe& a, const Fe& b, const FieldConst& c) { return fe_mul(a, b, c); }
  __device__ __forceinline__ static Fe sqr(const Fe& a, const FieldConst& c) { return fe_mul(a, a, c); }
};

template <class M = MulC>
__device__ __forceinline__ Fe f_mul(const Fe& a, const Fe& b, const FieldConst& c) { return M::mul(a, b, c); }
template <class M = MulC>
__device__ __forceinline__ Fe f_sqr(const Fe& a, const FieldConst& c) { return M::sqr(a, c); }
__device__ __forceinline__ Fe f_add(const Fe& a, const Fe& b, const FieldConst& c) { return fe_add(a, b, c); }
__device__ __forceinline__ Fe f_sub(const Fe& a, const Fe& b, const FieldConst& c) { return fe_sub(a, b, c); }
__device__ __forceinline__ bool f_is_zero(const Fe& a) { return fe_is_zero(a); }
__device__ __forceinline__ Fe f_zero(const Fe&) { return fe_zero(); }
__device__ __forceinline__ Fe f_one(const Fe&, const FieldConst& c) { return fe_one(c); }
__device__ __forceinline__ Fe f_load(const Fe*, const int32_t* p, long long i) { return fe_load(p + i * 16); }
__device__ __forceinline__ void f_store(int32_t* p, long long i, const Fe& a) { fe_store(p + i * 16, a); }

// Fq2 = Fq[u]/(u^2 + 1); Karatsuba: c0 = v0 - v1, c1 = (a0+a1)(b0+b1) - (v0+v1).
template <class M = MulC>
__device__ __forceinline__ Fe2 f_mul(const Fe2& a, const Fe2& b, const FieldConst& c) {
  Fe v0 = M::mul(a.c0, b.c0, c);
  Fe v1 = M::mul(a.c1, b.c1, c);
  Fe2 r;
  r.c0 = fe_sub(v0, v1, c);
  r.c1 = fe_sub(M::mul(fe_add(a.c0, a.c1, c), fe_add(b.c0, b.c1, c), c), fe_add(v0, v1, c), c);
  return r;
}
template <class M = MulC>
__device__ __forceinline__ Fe2 f_sqr(const Fe2& a, const FieldConst& c) { return f_mul<M>(a, a, c); }
__device__ __forceinline__ Fe2 f_add(const Fe2& a, const Fe2& b, const FieldConst& c) {
  return Fe2{fe_add(a.c0, b.c0, c), fe_add(a.c1, b.c1, c)};
}
__device__ __forceinline__ Fe2 f_sub(const Fe2& a, const Fe2& b, const FieldConst& c) {
  return Fe2{fe_sub(a.c0, b.c0, c), fe_sub(a.c1, b.c1, c)};
}
__device__ __forceinline__ bool f_is_zero(const Fe2& a) { return fe_is_zero(a.c0) && fe_is_zero(a.c1); }
__device__ __forceinline__ Fe2 f_zero(const Fe2&) { return Fe2{fe_zero(), fe_zero()}; }
__device__ __forceinline__ Fe2 f_one(const Fe2&, const FieldConst& c) { return Fe2{fe_one(c), fe_zero()}; }
__device__ __forceinline__ Fe2 f_load(const Fe2*, const int32_t* p, long long i) {
  return Fe2{fe_load(p + i * 32), fe_load(p + i * 32 + 16)};
}
__device__ __forceinline__ void f_store(int32_t* p, long long i, const Fe2& a) {
  fe_store(p + i * 32, a.c0);
  fe_store(p + i * 32 + 16, a.c1);
}

// One element read from device memory at each call.  The asm is volatile
// so that the compiler neither merges two reads of an element nor keeps a
// read value live between its uses: an addend read through accessors
// that use it comes from L1 where the formula needs it, not from
// registers.
__device__ __forceinline__ Fe fe_load_each(const int32_t* p) {
  Fe r;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    int a, b, c, d;
    asm volatile("ld.global.nc.v4.s32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(a), "=r"(b), "=r"(c), "=r"(d)
                 : "l"(p + 4 * k));
    r.w[2 * k] = (uint32_t)a | ((uint32_t)b << 16);
    r.w[2 * k + 1] = (uint32_t)c | ((uint32_t)d << 16);
  }
  return r;
}

__device__ __forceinline__ Fe2 fe2_load_each(const int32_t* p) { return Fe2{fe_load_each(p), fe_load_each(p + 16)}; }

__device__ __forceinline__ Fe f_load_each(const Fe*, const int32_t* p) { return fe_load_each(p); }
__device__ __forceinline__ Fe2 f_load_each(const Fe2*, const int32_t* p) { return fe2_load_each(p); }

template <class E>
struct Jac {
  E x, y, z;
  __device__ __forceinline__ E qx() const { return x; }
  __device__ __forceinline__ E qy() const { return y; }
  __device__ __forceinline__ E qz() const { return z; }
};

template <class M = MulC, class E>
__device__ __forceinline__ Jac<E> pt_double(const Jac<E>& p, const FieldConst& c) {
  E A = f_sqr<M>(p.x, c);
  E B = f_sqr<M>(p.y, c);
  E C = f_sqr<M>(B, c);
  E XB = f_add(p.x, B, c);
  E XB2 = f_sqr<M>(XB, c);
  E YZ = f_mul<M>(p.y, p.z, c);
  E t = f_sub(f_sub(XB2, A, c), C, c);
  E D = f_add(t, t, c);
  E Ev = f_add(f_add(A, A, c), A, c);
  E Fv = f_sqr<M>(Ev, c);
  Jac<E> r;
  r.x = f_sub(Fv, f_add(D, D, c), c);
  E C8 = f_add(C, C, c);
  C8 = f_add(C8, C8, c);
  C8 = f_add(C8, C8, c);
  r.y = f_sub(f_mul<M>(Ev, f_sub(D, r.x, c), c), C8, c);
  r.z = f_add(YZ, YZ, c);
  return r;
}

template <class M = MulC, class E, class Q>
__device__ __forceinline__ Jac<E> pt_add_core(const Jac<E>& p, const Q& q, const E& U1, const E& U2,
                                              const E& S1, const E& S2, const E& Z1Z2, const FieldConst& c) {
  E H = f_sub(U2, U1, c);
  E Rr = f_sub(S2, S1, c);
  Jac<E> res;
  const bool same_x = f_is_zero(H);
  const bool same_y = f_is_zero(Rr);
  if (f_is_zero(q.qz())) {
    res = p;
  } else if (f_is_zero(p.z)) {
    res = Jac<E>{q.qx(), q.qy(), q.qz()};
  } else if (same_x && same_y) {
    res = pt_double<M>(p, c);
  } else if (same_x) {
    E zero = f_zero(H);
    res.x = zero;
    res.y = zero;
    res.z = zero;
  } else {
    E HH = f_sqr<M>(H, c);
    E R2 = f_sqr<M>(Rr, c);
    E HHH = f_mul<M>(H, HH, c);
    E V = f_mul<M>(U1, HH, c);
    res.x = f_sub(f_sub(R2, HHH, c), f_add(V, V, c), c);
    res.y = f_sub(f_mul<M>(Rr, f_sub(V, res.x, c), c), f_mul<M>(S1, HHH, c), c);
    res.z = f_mul<M>(Z1Z2, H, c);
  }
  return res;
}

template <class M = MulC, class E, class Q>
__device__ __forceinline__ Jac<E> pt_add(const Jac<E>& p, const Q& q, const FieldConst& c) {
  E Z1Z1 = f_sqr<M>(p.z, c);
  E Z2Z2 = f_sqr<M>(q.qz(), c);
  E U1 = f_mul<M>(p.x, Z2Z2, c);
  E U2 = f_mul<M>(q.qx(), Z1Z1, c);
  E S1 = f_mul<M>(f_mul<M>(p.y, q.qz(), c), Z2Z2, c);
  E S2 = f_mul<M>(f_mul<M>(q.qy(), p.z, c), Z1Z1, c);
  E Z1Z2 = f_mul<M>(p.z, q.qz(), c);
  return pt_add_core<M>(p, q, U1, U2, S1, S2, Z1Z2, c);
}

template <class M = MulC, class E>
__device__ __forceinline__ Jac<E> pt_add_mixed(const Jac<E>& p, const E& x2, const E& y2, const FieldConst& c) {
  E Z1Z1 = f_sqr<M>(p.z, c);
  E U2 = f_mul<M>(x2, Z1Z1, c);
  E S2 = f_mul<M>(y2, f_mul<M>(p.z, Z1Z1, c), c);
  Jac<E> q;
  q.x = x2;
  q.y = y2;
  q.z = (f_is_zero(x2) && f_is_zero(y2)) ? f_zero(x2) : f_one(x2, c);
  return pt_add_core<M>(p, q, p.x, U2, p.y, S2, p.z, c);
}

// pt_add_mixed for an affine addend read through its accessors: qx(),
// qy() its coordinates and qz() the Z of from_affine, 0 for (0, 0) and
// one otherwise.
template <class M = MulC, class E, class A>
__device__ __forceinline__ Jac<E> pt_add_mixed_q(const Jac<E>& p, const A& a, const FieldConst& c) {
  E Z1Z1 = f_sqr<M>(p.z, c);
  E U2 = f_mul<M>(a.qx(), Z1Z1, c);
  E S2 = f_mul<M>(a.qy(), f_mul<M>(p.z, Z1Z1, c), c);
  return pt_add_core<M>(p, a, p.x, U2, p.y, S2, p.z, c);
}

// p + (x2, y2) for an affine addend that is not (0, 0), for a kernel whose
// loop holds the one doubling it runs (K19: one copy of each formula in
// its code): pt_add_mixed's formulas and case selects in the same order,
// except that where they double p this leaves p as it is and returns
// false, for the caller to double it.
template <class M = MulC>
__device__ __forceinline__ bool pt_add_mixed_or_double(Jac<Fe>& p, const Fe& x2, const Fe& y2, const FieldConst& c) {
  if (f_is_zero(p.z)) {
    p = Jac<Fe>{x2, y2, fe_one(c)};
    return true;
  }
  Fe Z1Z1 = f_sqr<M>(p.z, c);
  Fe U2 = f_mul<M>(x2, Z1Z1, c);
  Fe S2 = f_mul<M>(y2, f_mul<M>(p.z, Z1Z1, c), c);
  Fe H = f_sub(U2, p.x, c);
  Fe Rr = f_sub(S2, p.y, c);
  if (f_is_zero(H)) {
    if (f_is_zero(Rr)) return false;
    p = Jac<Fe>{fe_zero(), fe_zero(), fe_zero()};
    return true;
  }
  Fe HH = f_sqr<M>(H, c);
  Fe R2 = f_sqr<M>(Rr, c);
  Fe HHH = f_mul<M>(H, HH, c);
  Fe V = f_mul<M>(p.x, HH, c);
  Jac<Fe> res;
  res.x = f_sub(f_sub(R2, HHH, c), f_add(V, V, c), c);
  res.y = f_sub(f_mul<M>(Rr, f_sub(V, res.x, c), c), f_mul<M>(p.y, HHH, c), c);
  res.z = f_mul<M>(p.z, H, c);
  p = res;
  return true;
}
