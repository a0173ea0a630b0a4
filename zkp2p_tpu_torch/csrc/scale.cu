// K19: n affine G1 points scaled by one shared scalar, out[i] = k * P[i]:
// the phase-2 ceremony's rescale of every C and H query point by 1/delta'.
//
// No Pallas counterpart: the reference runs it in its native C++ library
// (csrc/zkp2p_native.cpp: g1_scale_batch), else one Python g1_mul a point
// (snark/ceremony.py: _scale_points); both run the group law through P
// over the whole k, without reducing it mod r.  This kernel computes the
// same function by two ladders, chosen a point:
//
// - a point on the curve (y^2 = x^3 + 3, tested in Montgomery form with
//   three products; BN254's G1 has cofactor 1, so it lies in G1) takes
//   the GLV ladder: k mod r = k1 + k2 * lambda with |k1|, |k2| < 2^128
//   (ops/cuda_scale.py: glv_ops, the reference's glv_decompose), and k*P
//   = k1*P + k2*phi(P) with phi(x, y) = (beta*x, y) (one product): one
//   doubling a digit position of the two half-scalars' width-2 NAFs, about
//   127 against 253, and at a nonzero digit a mixed add of (x, +-y) or
//   (beta*x, +-y);
// - a point off the curve (a corrupt key: k1*P + k2*phi(P) is not k*P
//   there) takes the full-scalar NAF ladder over k, the native rule: its
//   point lies on y^2 = x^3 + (y0^2 - x0^3), whose group law the same
//   formulas compute, so it gets k*P exactly as the reference does.
//
// Both ladders are one op stream a point, computed once on the host and
// passed by value (ScaleOps): 0 a doubling, +-1 a mixed add of (x, +-y),
// +-2 of (beta*x, +-y), from the point at infinity.  The stream is the
// same for every thread of a ladder, so a warp diverges only where its
// points take different ladders or an add meets its doubling case.
//
// The code is kept small: the loop holds one copy of the doubling and one
// of the mixed add (point.cuh's pt_add_mixed_or_double hands the add's
// doubling case to the loop's doubling), and each of their products calls
// one of two functions, mont_cc.cuh's PTX product and Montgomery square,
// with the modulus in constant memory.  Inlined, the loop's 18 products
// came to 12,464 SASS instructions (about 200 KB, beyond what the SM's
// instruction cache holds) and the kernel ran 1.35x slower on an H100;
// the NAF-only design inlined 25 in 15,896.  With the calls, 4 blocks of
// 256 threads an SM (64 registers, a spill to local memory) ran faster
// than 2 or 3 blocks without one.
//
// The formulas are point.cuh's (complete: P, -P, phi(P) and their sums
// all occur).  A
// (0, 0) hole, or k = 0, gives the Jacobian (0, 0, 0); ops/cuda_scale.py's
// g1_scale_plain runs the same test, streams and formulas, so the
// Jacobian limbs equal it bit for bit, and K15's jac_to_affine makes them
// the key's unique affine limbs.
//
// What bounds it: 32-bit multiplies.  A live point on the curve costs
// about 127 doublings (5 squares and 2 products) and 86 mixed adds (3
// squares and 8 products), a square 208 multiplies and a product 264:
// about 432,000 multiplies against the NAF ladder's 714,000; the bytes
// (128 in, 192 out a point) are three orders of magnitude below.
//
// zk_g1_scale_naf keeps the former NAF-only kernel (the full-scalar NAF
// ladder over every point, the add's doubling inlined, products only) as
// the comparator that chip_smoke.py times beside this one; no path of
// the program launches it.
#include "mont_cc.cuh"
#include "point.cuh"

constexpr int SCALE_THREADS = 256;
constexpr int SCALE_MIN_BLOCKS = 4;  // 64 registers a thread at most: 32 warps an SM
constexpr int SCALE_MAX_OPS = 768;   // a GLV stream has at most ~260 ops, a 256-bit NAF stream 385
constexpr int SCALE_MAX_DIGITS = 264;  // a 256-bit scalar's NAF has at most 257 digits

// the field constants of zk_g1_scale's launch, for the called products
__constant__ FieldConst scale_field;

__device__ __noinline__ Fe scale_mul(const Fe a, const Fe b) { return fe_mul_cc(a, b, scale_field); }
__device__ __noinline__ Fe scale_sqr(const Fe a) { return fe_sqr_cc(a, scale_field); }

// point.cuh's product policy over the two called functions
struct MulCallCC {
  __device__ __forceinline__ static Fe mul(const Fe& a, const Fe& b, const FieldConst&) { return scale_mul(a, b); }
  __device__ __forceinline__ static Fe sqr(const Fe& a, const FieldConst&) { return scale_sqr(a); }
};

struct ScaleOps {
  uint32_t beta[8];               // GLV_BETA in Montgomery form
  int n_glv;                      // the GLV stream: ops[0, n_glv)
  int n_naf;                      // the full-scalar NAF stream: ops[n_glv, n_glv + n_naf)
  signed char op[SCALE_MAX_OPS];  // 0 double, +-1 add (x, +-y), +-2 add (beta*x, +-y)
};

__global__ void __launch_bounds__(SCALE_THREADS, SCALE_MIN_BLOCKS)
k_g1_scale(const int32_t* __restrict__ px, const int32_t* __restrict__ py, int32_t* __restrict__ ox,
           int32_t* __restrict__ oy, int32_t* __restrict__ oz, long long n, ScaleOps k, FieldConst c) {
  const long long i = (long long)blockIdx.x * SCALE_THREADS + threadIdx.x;
  if (i >= n) return;
  const Fe x = fe_load(px + i * 16);
  const Fe y = fe_load(py + i * 16);
  const Fe zero = fe_zero();
  Jac<Fe> acc{zero, zero, zero};
  if (!(fe_is_zero(x) && fe_is_zero(y))) {
    const Fe one = fe_one(c);
    const Fe rhs = fe_add(f_mul<MulCallCC>(f_sqr<MulCallCC>(x, c), x, c), fe_add(fe_add(one, one, c), one, c), c);
    const Fe lhs = f_sqr<MulCallCC>(y, c);
    bool on = true;
#pragma unroll
    for (int w = 0; w < 8; ++w) on = on && lhs.w[w] == rhs.w[w];
    Fe beta;
#pragma unroll
    for (int w = 0; w < 8; ++w) beta.w[w] = k.beta[w];
    const Fe phix = on ? f_mul<MulCallCC>(beta, x, c) : x;
    const int base = on ? 0 : k.n_glv;
    const int end = on ? k.n_glv : k.n_glv + k.n_naf;
#pragma unroll 1
    for (int s = base; s < end; ++s) {
      const int op = k.op[s];
      bool dbl = op == 0;
      if (!dbl) {
        Fe ax;  // word by word: a select of the whole struct goes through local memory
#pragma unroll
        for (int w = 0; w < 8; ++w) ax.w[w] = (op & 1) ? x.w[w] : phix.w[w];
        dbl = !pt_add_mixed_or_double<MulCallCC>(acc, ax, op > 0 ? y : fe_sub(zero, y, c), c);
      }
      if (dbl) acc = pt_double<MulCallCC>(acc, c);
    }
  }
  fe_store(ox + i * 16, acc.x);
  fe_store(oy + i * 16, acc.y);
  fe_store(oz + i * 16, acc.z);
}

// The comparator: the former NAF-only kernel as it was.
struct ScaleDigits {
  int n;                              // digits; the top one is 1 (none for the scalar 0)
  signed char d[SCALE_MAX_DIGITS];    // least significant first, each -1, 0 or 1
};

__global__ void __launch_bounds__(SCALE_THREADS)
k_g1_scale_naf(const int32_t* __restrict__ px, const int32_t* __restrict__ py, int32_t* __restrict__ ox,
               int32_t* __restrict__ oy, int32_t* __restrict__ oz, long long n, ScaleDigits k, FieldConst c) {
  const long long i = (long long)blockIdx.x * SCALE_THREADS + threadIdx.x;
  if (i >= n) return;
  const Fe x = fe_load(px + i * 16);
  const Fe y = fe_load(py + i * 16);
  const Fe zero = fe_zero();
  Jac<Fe> acc{zero, zero, zero};
  if (k.n > 0 && !(fe_is_zero(x) && fe_is_zero(y))) {
    acc = Jac<Fe>{x, y, fe_one(c)};
#pragma unroll 1
    for (int b = k.n - 2; b >= 0; --b) {
      acc = pt_double<MulCC>(acc, c);
      const int d = k.d[b];
      if (d) acc = pt_add_mixed<MulCC>(acc, x, d > 0 ? y : fe_sub(zero, y, c), c);
    }
  }
  fe_store(ox + i * 16, acc.x);
  fe_store(oy + i * 16, acc.y);
  fe_store(oz + i * 16, acc.z);
}

extern "C" {

// points x/y (n, 16), out x/y/z (n, 16), n, op streams (host ScaleOps),
// field consts (host), stream
int zk_g1_scale(const void* px, const void* py, void* ox, void* oy, void* oz, long long n, const void* ops,
                const void* consts, void* stream) {
  if (n <= 0) return 0;
  const ScaleOps k = *reinterpret_cast<const ScaleOps*>(ops);
  if (k.n_glv < 0 || k.n_naf < 0 || k.n_glv + k.n_naf > SCALE_MAX_OPS) return (int)cudaErrorInvalidValue;
  const FieldConst c = *reinterpret_cast<const FieldConst*>(consts);
  const cudaError_t err = cudaMemcpyToSymbolAsync(scale_field, &c, sizeof(c), 0, cudaMemcpyHostToDevice,
                                                  (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  k_g1_scale<<<(unsigned)((n + SCALE_THREADS - 1) / SCALE_THREADS), SCALE_THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)px, (const int32_t*)py, (int32_t*)ox, (int32_t*)oy, (int32_t*)oz, n, k, c);
  return (int)cudaGetLastError();
}

// the comparator: as zk_g1_scale with the NAF digits (host ScaleDigits)
int zk_g1_scale_naf(const void* px, const void* py, void* ox, void* oy, void* oz, long long n, const void* digits,
                    const void* consts, void* stream) {
  if (n <= 0) return 0;
  const ScaleDigits k = *reinterpret_cast<const ScaleDigits*>(digits);
  if (k.n < 0 || k.n > SCALE_MAX_DIGITS) return (int)cudaErrorInvalidValue;
  const FieldConst c = *reinterpret_cast<const FieldConst*>(consts);
  k_g1_scale_naf<<<(unsigned)((n + SCALE_THREADS - 1) / SCALE_THREADS), SCALE_THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)px, (const int32_t*)py, (int32_t*)ox, (int32_t*)oy, (int32_t*)oz, n, k, c);
  return (int)cudaGetLastError();
}

}  // extern "C"
