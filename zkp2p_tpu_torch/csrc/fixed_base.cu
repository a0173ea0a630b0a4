// K17: a batch of fixed-base scalar multiplications k_i * G, one thread
// per scalar, written once over the field type and instantiated for G1
// (Fq) and G2 (Fq2).
//
// Replaces the reference's native C++ fixed-base batches
// (csrc/zkp2p_native.cpp: g1_fixed_base_batch_mont,
// g2_fixed_base_batch_mont), which its trusted setup runs for every query
// point of the key.  Same comb: the scalar's standard form cut into 32
// unsigned 8-bit windows, read straight from its 16-bit limbs, and one
// mixed addition of the table entry 2^(8w) * d * G for each nonzero digit
// d of window w.  The table holds the 32 x 255 affine multiples in
// Montgomery form (row w * 255 + d - 1; 522 KB for G1, 1 MB for G2, so it
// stays in L2) and is built once per base on the host.  The additions are
// point.cuh's pt_add_mixed, which handles P + P, P + (-P) and an
// accumulator at infinity, so every scalar in [0, r) is exact.
//
// The output is Jacobian (Z = 0 for the scalar 0); K15's jac_to_affine
// normalises it to the key's affine limbs.  The point is unique, so the
// limbs equal the reference's whatever the order of the additions.
//
// What bounds it: integer multiplies, 11 Montgomery products (Fq2: 3
// each) an addition, up to 32 additions a scalar.  Signed digits, tables
// in shared memory and several scalars a thread are later work.
#include "point.cuh"

constexpr int FB_WINDOWS = 32;
constexpr int FB_DIGITS = 255;

template <class E>
__global__ void __launch_bounds__(128)
k_fixed_base(const int32_t* __restrict__ tx, const int32_t* __restrict__ ty, const int32_t* __restrict__ scalars,
             int32_t* __restrict__ ox, int32_t* __restrict__ oy, int32_t* __restrict__ oz, long long n,
             FieldConst c) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const E* tag = nullptr;
  const Fe k = fe_load(scalars + i * 16);  // 8 words of the standard form
  const E zero = f_zero(E{});
  Jac<E> acc{zero, zero, zero};
#pragma unroll 1
  for (int w = 0; w < FB_WINDOWS; ++w) {
    const int d = (int)((k.w[w >> 2] >> ((w & 3) * 8)) & 0xFFu);
    if (d == 0) continue;
    const long long e = (long long)w * FB_DIGITS + (d - 1);
    acc = pt_add_mixed(acc, f_load(tag, tx, e), f_load(tag, ty, e), c);
  }
  f_store(ox, i, acc.x);
  f_store(oy, i, acc.y);
  f_store(oz, i, acc.z);
}

template <class E>
static int launch_fixed_base(const void* tx, const void* ty, const void* scalars, void* ox, void* oy, void* oz,
                             long long n, const void* consts, void* stream) {
  if (n <= 0) return 0;
  FieldConst c = *reinterpret_cast<const FieldConst*>(consts);
  k_fixed_base<E><<<(unsigned)((n + 127) / 128), 128, 0, (cudaStream_t)stream>>>(
      (const int32_t*)tx, (const int32_t*)ty, (const int32_t*)scalars, (int32_t*)ox, (int32_t*)oy, (int32_t*)oz,
      n, c);
  return (int)cudaGetLastError();
}

extern "C" {

int zk_g1_fixed_base(const void* tx, const void* ty, const void* scalars, void* ox, void* oy, void* oz,
                     long long n, const void* consts, void* stream) {
  return launch_fixed_base<Fe>(tx, ty, scalars, ox, oy, oz, n, consts, stream);
}

int zk_g2_fixed_base(const void* tx, const void* ty, const void* scalars, void* ox, void* oy, void* oz,
                     long long n, const void* consts, void* stream) {
  return launch_fixed_base<Fe2>(tx, ty, scalars, ox, oy, oz, n, consts, stream);
}

}  // extern "C"
