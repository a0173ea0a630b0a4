// K19: n affine G1 points scaled by one shared scalar, out[i] = k * P[i]:
// the phase-2 ceremony's rescale of every C and H query point by 1/delta'.
//
// No Pallas counterpart: the reference runs it in its native C++ library
// (csrc/zkp2p_native.cpp: g1_scale_batch), else one Python g1_mul a point
// (snark/ceremony.py: _scale_points).  As the native code, the scalar's
// width-2 NAF (digits -1, 0, 1, least significant first) is computed once
// on the host (ops/cuda_scale.py: naf_digits, the native rule) and passed
// by value as a kernel argument; each thread walks it from the top over
// one point: acc = P at the top digit (always 1), then for each lower
// digit a doubling and, for a nonzero digit, a mixed addition of P or -P
// (y negated as 0 - y).  The formulas are point.cuh's (the K3 / K4
// formulas: complete, so an accumulator that reaches infinity, for a
// scalar at or above r, goes on exactly) over mont_cc.cuh's PTX product.
// A (0, 0) hole, or the scalar 0, gives the Jacobian (0, 0, 0).  The
// output is Jacobian; K15's jac_to_affine normalises it to the key's
// affine limbs, which are unique, so they equal the reference's.
// ops/cuda_scale.py's g1_scale_plain runs the same digits with the same
// formulas, so the Jacobian limbs equal it bit for bit.
//
// What bounds it: 32-bit multiplies.  A 254-bit scalar costs about 253
// doublings (7 Montgomery products) and 85 mixed additions (11), about
// 2,700 products of 264 multiplies a point; the bytes (128 in, 192 out a
// point) are three orders of magnitude below.  The design for that: every
// product in PTX carry chains; the digits shared by every thread, so a
// warp never diverges but in the rare doubling branch of an addition; one
// thread a point, SCALE_THREADS a block.
#include "mont_cc.cuh"
#include "point.cuh"

constexpr int SCALE_THREADS = 256;
constexpr int SCALE_MAX_DIGITS = 264;  // a 256-bit scalar's NAF has at most 257 digits

struct ScaleDigits {
  int n;                              // digits; the top one is 1 (none for the scalar 0)
  signed char d[SCALE_MAX_DIGITS];    // least significant first, each -1, 0 or 1
};

__global__ void __launch_bounds__(SCALE_THREADS)
k_g1_scale(const int32_t* __restrict__ px, const int32_t* __restrict__ py, int32_t* __restrict__ ox,
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

// points x/y (n, 16), out x/y/z (n, 16), n, digits (host ScaleDigits),
// field consts (host), stream
int zk_g1_scale(const void* px, const void* py, void* ox, void* oy, void* oz, long long n, const void* digits,
                const void* consts, void* stream) {
  if (n <= 0) return 0;
  const ScaleDigits k = *reinterpret_cast<const ScaleDigits*>(digits);
  if (k.n < 0 || k.n > SCALE_MAX_DIGITS) return (int)cudaErrorInvalidValue;
  const FieldConst c = *reinterpret_cast<const FieldConst*>(consts);
  k_g1_scale<<<(unsigned)((n + SCALE_THREADS - 1) / SCALE_THREADS), SCALE_THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)px, (const int32_t*)py, (int32_t*)ox, (int32_t*)oy, (int32_t*)oz, n, k, c);
  return (int)cudaGetLastError();
}

}  // extern "C"
