// K5: batched Montgomery power out[i] = a[i]^e (Montgomery in and out).
//
// Replaces the Pallas kernel mont_pow of the reference
// (zkp2p_tpu/ops/pallas_mont.py: entry mont_pow, body _pow_kernel), which
// runs the whole square-and-multiply ladder of one fixed exponent inside
// one kernel with all state in VMEM, so that a Fermat inversion
// (e = N - 2) is one launch instead of two products a bit.  Here one
// thread runs the ladder of one element in registers, LSB first as the
// reference does: acc = one; for each bit, acc = acc * base where the bit
// is set, then base = base * base (the reference also squares after the
// last bit, which changes nothing).  Every product is K1's (mont.cuh), so
// the limbs are the reference's, 0 -> 0 included.  The exponent comes in
// at run time (eight 32-bit words and its bit length), so one kernel
// serves any e >= 1 on Fr and Fq.
//
// What bounds it on an H100: on the prover's path K5 inverts the product
// of all denominators of one batch inversion, a batch of ONE element, so
// it is one thread running a dependent chain of 253 squarings, with 110
// multiplies beside it (363 products for e = p - 2 on Fq): latency, not
// throughput.  At a large batch it is bound by 32-bit multiplies, as K1
// is.  A faster design (a sliding-window ladder with fewer multiplies, or
// several threads sharing one element's product) is later work.
#include "mont.cuh"

struct Exponent {
  uint32_t w[8];  // e, little-endian 32-bit words
};

__global__ void __launch_bounds__(256)
k_mont_pow(const int32_t* __restrict__ a, int32_t* __restrict__ out, long long n,
           Exponent e, int nbits, FieldConst c) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Fe base = fe_load(a + i * 16);
  Fe acc = fe_one(c);
  for (int k = 0; k < nbits; ++k) {
    // the bit is the same in every thread: no divergence
    if ((e.w[k >> 5] >> (k & 31)) & 1u) acc = fe_mul(acc, base, c);
    if (k + 1 < nbits) base = fe_mul(base, base, c);
  }
  fe_store(out + i * 16, acc);
}

extern "C" int zk_mont_pow(const void* a, void* out, long long n, const void* exponent,
                           int nbits, const void* consts, void* stream) {
  if (n <= 0) return 0;
  if (nbits <= 0 || nbits > 256) return (int)cudaErrorInvalidValue;
  Exponent e = *reinterpret_cast<const Exponent*>(exponent);
  FieldConst c = *reinterpret_cast<const FieldConst*>(consts);
  const int threads = n < 256 ? 32 : 256;
  long long blocks = (n + threads - 1) / threads;
  k_mont_pow<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)a, (int32_t*)out, n, e, nbits, c);
  return (int)cudaGetLastError();
}
