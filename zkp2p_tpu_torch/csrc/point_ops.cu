// K2-K4: BN254 Jacobian point operations, one thread per lane, written
// once over the field type and instantiated for G1 (Fq) and G2 (Fq2):
//   K2 add        complete Jacobian + Jacobian (add-2007-bl)
//   K3 add_mixed  Jacobian + affine, (0, 0) lifted to Z = 0
//   K4 double     dbl-2009-l; infinity maps to infinity
//
// Replaces the Pallas kernels g1_add, g1_add_mixed, g1_double, g2_add,
// g2_add_mixed, g2_double of the reference (zkp2p_tpu/ops/pallas_curve.py:
// _add_math, _add_mixed_math, _add_core_math, _double_math over _FqOps /
// _Fq2Ops), which keep a whole point operation in VMEM.  Here a thread
// reads its operands once, keeps every intermediate in registers and
// writes the result once.  The formulas, the order of the case selects
// (same x and same y -> double, same x only -> (0, 0, 0), p at infinity ->
// q, q at infinity -> p) and the encodings (Jacobian infinity Z = 0,
// affine infinity (0, 0), Montgomery one (R, 0) in Fq2) are the
// reference's, so the output limbs equal it bit for bit.  The selects are
// branches: the doubling runs only in lanes that need it, which changes no
// output.
//
// What bounds it on an H100: integer multiply throughput (a G1 add is 16
// Montgomery products; an Fq2 product is 3), not bytes.  The G2
// instantiation holds six Fq2 coordinates plus temporaries per thread and
// spills registers (the build log, ptxas -v, shows how much).  Cooperative
// multi-thread field products and wgmma/TMA-style layouts are later work.
#include "mont.cuh"

struct Fe2 {
  Fe c0, c1;
};

__device__ __forceinline__ Fe f_mul(const Fe& a, const Fe& b, const FieldConst& c) { return fe_mul(a, b, c); }
__device__ __forceinline__ Fe f_add(const Fe& a, const Fe& b, const FieldConst& c) { return fe_add(a, b, c); }
__device__ __forceinline__ Fe f_sub(const Fe& a, const Fe& b, const FieldConst& c) { return fe_sub(a, b, c); }
__device__ __forceinline__ bool f_is_zero(const Fe& a) { return fe_is_zero(a); }
__device__ __forceinline__ Fe f_zero(const Fe&) { return fe_zero(); }
__device__ __forceinline__ Fe f_one(const Fe&, const FieldConst& c) { return fe_one(c); }
__device__ __forceinline__ Fe f_load(const Fe*, const int32_t* p, long long i) { return fe_load(p + i * 16); }
__device__ __forceinline__ void f_store(int32_t* p, long long i, const Fe& a) { fe_store(p + i * 16, a); }

// Fq2 = Fq[u]/(u^2 + 1); Karatsuba: c0 = v0 - v1, c1 = (a0+a1)(b0+b1) - (v0+v1).
__device__ __forceinline__ Fe2 f_mul(const Fe2& a, const Fe2& b, const FieldConst& c) {
  Fe v0 = fe_mul(a.c0, b.c0, c);
  Fe v1 = fe_mul(a.c1, b.c1, c);
  Fe2 r;
  r.c0 = fe_sub(v0, v1, c);
  r.c1 = fe_sub(fe_mul(fe_add(a.c0, a.c1, c), fe_add(b.c0, b.c1, c), c), fe_add(v0, v1, c), c);
  return r;
}
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

template <class E>
struct Jac {
  E x, y, z;
};

template <class E>
__device__ __forceinline__ Jac<E> pt_double(const Jac<E>& p, const FieldConst& c) {
  E A = f_mul(p.x, p.x, c);
  E B = f_mul(p.y, p.y, c);
  E C = f_mul(B, B, c);
  E XB = f_add(p.x, B, c);
  E XB2 = f_mul(XB, XB, c);
  E YZ = f_mul(p.y, p.z, c);
  E t = f_sub(f_sub(XB2, A, c), C, c);
  E D = f_add(t, t, c);
  E Ev = f_add(f_add(A, A, c), A, c);
  E Fv = f_mul(Ev, Ev, c);
  Jac<E> r;
  r.x = f_sub(Fv, f_add(D, D, c), c);
  E C8 = f_add(C, C, c);
  C8 = f_add(C8, C8, c);
  C8 = f_add(C8, C8, c);
  r.y = f_sub(f_mul(Ev, f_sub(D, r.x, c), c), C8, c);
  r.z = f_add(YZ, YZ, c);
  return r;
}

template <class E>
__device__ __forceinline__ Jac<E> pt_add_core(const Jac<E>& p, const Jac<E>& q, const E& U1, const E& U2,
                                              const E& S1, const E& S2, const E& Z1Z2, const FieldConst& c) {
  E H = f_sub(U2, U1, c);
  E Rr = f_sub(S2, S1, c);
  Jac<E> res;
  const bool same_x = f_is_zero(H);
  const bool same_y = f_is_zero(Rr);
  if (f_is_zero(q.z)) {
    res = p;
  } else if (f_is_zero(p.z)) {
    res = q;
  } else if (same_x && same_y) {
    res = pt_double(p, c);
  } else if (same_x) {
    E zero = f_zero(H);
    res.x = zero;
    res.y = zero;
    res.z = zero;
  } else {
    E HH = f_mul(H, H, c);
    E R2 = f_mul(Rr, Rr, c);
    E HHH = f_mul(H, HH, c);
    E V = f_mul(U1, HH, c);
    res.x = f_sub(f_sub(R2, HHH, c), f_add(V, V, c), c);
    res.y = f_sub(f_mul(Rr, f_sub(V, res.x, c), c), f_mul(S1, HHH, c), c);
    res.z = f_mul(Z1Z2, H, c);
  }
  return res;
}

template <class E>
__device__ __forceinline__ Jac<E> pt_add(const Jac<E>& p, const Jac<E>& q, const FieldConst& c) {
  E Z1Z1 = f_mul(p.z, p.z, c);
  E Z2Z2 = f_mul(q.z, q.z, c);
  E U1 = f_mul(p.x, Z2Z2, c);
  E U2 = f_mul(q.x, Z1Z1, c);
  E S1 = f_mul(f_mul(p.y, q.z, c), Z2Z2, c);
  E S2 = f_mul(f_mul(q.y, p.z, c), Z1Z1, c);
  E Z1Z2 = f_mul(p.z, q.z, c);
  return pt_add_core(p, q, U1, U2, S1, S2, Z1Z2, c);
}

template <class E>
__device__ __forceinline__ Jac<E> pt_add_mixed(const Jac<E>& p, const E& x2, const E& y2, const FieldConst& c) {
  E Z1Z1 = f_mul(p.z, p.z, c);
  E U2 = f_mul(x2, Z1Z1, c);
  E S2 = f_mul(y2, f_mul(p.z, Z1Z1, c), c);
  Jac<E> q;
  q.x = x2;
  q.y = y2;
  q.z = (f_is_zero(x2) && f_is_zero(y2)) ? f_zero(x2) : f_one(x2, c);
  return pt_add_core(p, q, p.x, U2, p.y, S2, p.z, c);
}

template <class E>
__global__ void __launch_bounds__(128)
k_add(const int32_t* __restrict__ x1, const int32_t* __restrict__ y1, const int32_t* __restrict__ z1,
      const int32_t* __restrict__ x2, const int32_t* __restrict__ y2, const int32_t* __restrict__ z2,
      int32_t* __restrict__ ox, int32_t* __restrict__ oy, int32_t* __restrict__ oz, long long n, FieldConst c) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const E* tag = nullptr;
  Jac<E> p{f_load(tag, x1, i), f_load(tag, y1, i), f_load(tag, z1, i)};
  Jac<E> q{f_load(tag, x2, i), f_load(tag, y2, i), f_load(tag, z2, i)};
  Jac<E> r = pt_add(p, q, c);
  f_store(ox, i, r.x);
  f_store(oy, i, r.y);
  f_store(oz, i, r.z);
}

template <class E>
__global__ void __launch_bounds__(128)
k_add_mixed(const int32_t* __restrict__ x1, const int32_t* __restrict__ y1, const int32_t* __restrict__ z1,
            const int32_t* __restrict__ x2, const int32_t* __restrict__ y2,
            int32_t* __restrict__ ox, int32_t* __restrict__ oy, int32_t* __restrict__ oz, long long n,
            FieldConst c) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const E* tag = nullptr;
  Jac<E> p{f_load(tag, x1, i), f_load(tag, y1, i), f_load(tag, z1, i)};
  Jac<E> r = pt_add_mixed(p, f_load(tag, x2, i), f_load(tag, y2, i), c);
  f_store(ox, i, r.x);
  f_store(oy, i, r.y);
  f_store(oz, i, r.z);
}

template <class E>
__global__ void __launch_bounds__(128)
k_double(const int32_t* __restrict__ x1, const int32_t* __restrict__ y1, const int32_t* __restrict__ z1,
         int32_t* __restrict__ ox, int32_t* __restrict__ oy, int32_t* __restrict__ oz, long long n, FieldConst c) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const E* tag = nullptr;
  Jac<E> p{f_load(tag, x1, i), f_load(tag, y1, i), f_load(tag, z1, i)};
  Jac<E> r = pt_double(p, c);
  f_store(ox, i, r.x);
  f_store(oy, i, r.y);
  f_store(oz, i, r.z);
}

static inline unsigned grid_for(long long n) { return (unsigned)((n + 127) / 128); }

#define I const int32_t*
#define O int32_t*

template <class E>
static int launch_add(const void* const* in, void* const* out, long long n, const void* consts, void* stream) {
  if (n <= 0) return 0;
  FieldConst c = *reinterpret_cast<const FieldConst*>(consts);
  k_add<E><<<grid_for(n), 128, 0, (cudaStream_t)stream>>>((I)in[0], (I)in[1], (I)in[2], (I)in[3], (I)in[4],
                                                         (I)in[5], (O)out[0], (O)out[1], (O)out[2], n, c);
  return (int)cudaGetLastError();
}

template <class E>
static int launch_add_mixed(const void* const* in, void* const* out, long long n, const void* consts, void* stream) {
  if (n <= 0) return 0;
  FieldConst c = *reinterpret_cast<const FieldConst*>(consts);
  k_add_mixed<E><<<grid_for(n), 128, 0, (cudaStream_t)stream>>>((I)in[0], (I)in[1], (I)in[2], (I)in[3],
                                                               (I)in[4], (O)out[0], (O)out[1], (O)out[2], n, c);
  return (int)cudaGetLastError();
}

template <class E>
static int launch_double(const void* const* in, void* const* out, long long n, const void* consts, void* stream) {
  if (n <= 0) return 0;
  FieldConst c = *reinterpret_cast<const FieldConst*>(consts);
  k_double<E><<<grid_for(n), 128, 0, (cudaStream_t)stream>>>((I)in[0], (I)in[1], (I)in[2], (O)out[0],
                                                            (O)out[1], (O)out[2], n, c);
  return (int)cudaGetLastError();
}

#undef I
#undef O

extern "C" {

int zk_g1_add(const void* x1, const void* y1, const void* z1, const void* x2, const void* y2, const void* z2,
              void* ox, void* oy, void* oz, long long n, const void* consts, void* stream) {
  const void* in[6] = {x1, y1, z1, x2, y2, z2};
  void* out[3] = {ox, oy, oz};
  return launch_add<Fe>(in, out, n, consts, stream);
}

int zk_g1_add_mixed(const void* x1, const void* y1, const void* z1, const void* x2, const void* y2,
                    void* ox, void* oy, void* oz, long long n, const void* consts, void* stream) {
  const void* in[5] = {x1, y1, z1, x2, y2};
  void* out[3] = {ox, oy, oz};
  return launch_add_mixed<Fe>(in, out, n, consts, stream);
}

int zk_g1_double(const void* x1, const void* y1, const void* z1, void* ox, void* oy, void* oz, long long n,
                 const void* consts, void* stream) {
  const void* in[3] = {x1, y1, z1};
  void* out[3] = {ox, oy, oz};
  return launch_double<Fe>(in, out, n, consts, stream);
}

int zk_g2_add(const void* x1, const void* y1, const void* z1, const void* x2, const void* y2, const void* z2,
              void* ox, void* oy, void* oz, long long n, const void* consts, void* stream) {
  const void* in[6] = {x1, y1, z1, x2, y2, z2};
  void* out[3] = {ox, oy, oz};
  return launch_add<Fe2>(in, out, n, consts, stream);
}

int zk_g2_add_mixed(const void* x1, const void* y1, const void* z1, const void* x2, const void* y2,
                    void* ox, void* oy, void* oz, long long n, const void* consts, void* stream) {
  const void* in[5] = {x1, y1, z1, x2, y2};
  void* out[3] = {ox, oy, oz};
  return launch_add_mixed<Fe2>(in, out, n, consts, stream);
}

int zk_g2_double(const void* x1, const void* y1, const void* z1, void* ox, void* oy, void* oz, long long n,
                 const void* consts, void* stream) {
  const void* in[3] = {x1, y1, z1};
  void* out[3] = {ox, oy, oz};
  return launch_double<Fe2>(in, out, n, consts, stream);
}

}  // extern "C"
