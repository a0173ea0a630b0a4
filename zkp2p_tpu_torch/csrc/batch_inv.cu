// K15: batch inversion, one block-local inversion a block (affine.cuh).
//   zk_batch_inverse   out[i] = x[i]^-1 over Fq or Fr (deg 1) or Fq2 (deg 2,
//                      by the norm route); 0 -> 0
//   zk_jac_to_affine   Jacobian (X, Y, Z) -> affine (X / Z^2, Y / Z^3) over
//                      Fq (deg 1) or Fq2 (deg 2); Z = 0 -> the (0, 0) sentinel
//
// Replaces, on the batch-affine arm, the Pallas kernel mont_pow of the
// reference (zkp2p_tpu/ops/pallas_mont.py: mont_pow, the Fermat inversion
// that JPrimeField.inv_fused runs on the total of each batch inversion,
// zkp2p_tpu/ops/msm_affine.py: batch_inverse) together with the mont_mul
// launches of that batch inversion's prefix and suffix products and of the
// normalisation around it (jac_to_affine_batch), which the reference leaves
// to XLA around mont_mul.  The port's K5 (mont_pow.cu) stays the comparator
// for one inversion.
//
// Each block of 256 threads takes 1,024 consecutive elements, four a
// thread (coalesced: element k * 256 + t of the block is thread t's k-th):
// each thread's running products, a product tree over the threads in
// shared memory, one inversion of the root by one thread (fe_inv, a binary
// extended Euclid), the inverses down the tree and back along each
// thread's products.  So a launch does ceil(n / 1,024) inversions side by
// side, where the reference runs one grid-wide prefix product, one
// inversion and one suffix product; the inverse of each nonzero element is
// unique, so the limbs are the same.  What bounds it on an H100: at batch
// 1 (the comparison with K5) the inversion's latency, one thread's chain
// of adds and shifts; at the table chunks (millions of elements) the
// inversions, during which one thread in 256 works: with one value a
// thread they held zk_batch_inverse at 15x its bound at the narrow
// table's 5.5M elements (3.95 ms; 1.64 ms at four values a thread, on an
// H100 80GB HBM3 at 700 W), so each thread brings four.  Beside them the
// 32-bit multiplies of the products (about 3 an element) and of the
// normalisation (4 an element over Fq, 12 over Fq2).  Each element is
// read twice (the second read mostly from L2) and written once.
#include "affine.cuh"

// Values a thread: a block of 256 threads inverts 1,024 elements with one
// inversion.
static constexpr int kPer = 4;

template <class E>
__global__ void __launch_bounds__(256)
k_batch_inverse(const int32_t* __restrict__ x, int32_t* __restrict__ out, long long n, FieldConst c, InvConst ic) {
  extern __shared__ __align__(16) unsigned char smem[];
  Fe* tree = reinterpret_cast<Fe*>(smem);
  const E* tag = nullptr;
  const long long base = (long long)blockIdx.x * blockDim.x * kPer + threadIdx.x;
  Fe v[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const long long i = base + (long long)k * blockDim.x;
    v[k] = i < n ? inv_key(f_load(tag, x, i), c) : fe_zero();
  }
  block_inverse_many(v, tree, c, ic);
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const long long i = base + (long long)k * blockDim.x;
    if (i < n) f_store(out, i, inv_apply(f_load(tag, x, i), v[k], c));
  }
}

template <class E>
__global__ void __launch_bounds__(256)
k_jac_to_affine(const int32_t* __restrict__ X, const int32_t* __restrict__ Y, const int32_t* __restrict__ Z,
                int32_t* __restrict__ ox, int32_t* __restrict__ oy, long long n, FieldConst c, InvConst ic) {
  extern __shared__ __align__(16) unsigned char smem[];
  Fe* tree = reinterpret_cast<Fe*>(smem);
  const E* tag = nullptr;
  const long long base = (long long)blockIdx.x * blockDim.x * kPer + threadIdx.x;
  Fe v[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const long long i = base + (long long)k * blockDim.x;
    v[k] = i < n ? inv_key(f_load(tag, Z, i), c) : fe_zero();
  }
  block_inverse_many(v, tree, c, ic);
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const long long i = base + (long long)k * blockDim.x;
    if (i >= n) continue;
    const E z = f_load(tag, Z, i);
    if (f_is_zero(z)) {
      f_store(ox, i, f_zero(z));
      f_store(oy, i, f_zero(z));
      continue;
    }
    const E zinv = inv_apply(z, v[k], c);
    const E zi2 = f_mul(zinv, zinv, c);
    f_store(ox, i, f_mul(f_load(tag, X, i), zi2, c));
    f_store(oy, i, f_mul(f_load(tag, Y, i), f_mul(zi2, zinv, c), c));
  }
}

static const int kThreads = 256;

extern "C" {

int zk_batch_inverse(const void* x, void* out, long long n, int deg, const void* consts, const void* r3,
                     void* stream) {
  if (n <= 0) return 0;
  if (deg != 1 && deg != 2) return (int)cudaErrorInvalidValue;
  FieldConst c = *reinterpret_cast<const FieldConst*>(consts);
  InvConst ic = *reinterpret_cast<const InvConst*>(r3);
  const unsigned blocks = (unsigned)((n + kThreads * kPer - 1) / (kThreads * kPer));
  const size_t smem = tree_bytes(kThreads);
  if (deg == 1)
    k_batch_inverse<Fe><<<blocks, kThreads, smem, (cudaStream_t)stream>>>((const int32_t*)x, (int32_t*)out, n, c, ic);
  else
    k_batch_inverse<Fe2><<<blocks, kThreads, smem, (cudaStream_t)stream>>>((const int32_t*)x, (int32_t*)out, n, c, ic);
  return (int)cudaGetLastError();
}

int zk_jac_to_affine(const void* X, const void* Y, const void* Z, void* ox, void* oy, long long n, int deg,
                     const void* consts, const void* r3, void* stream) {
  if (n <= 0) return 0;
  if (deg != 1 && deg != 2) return (int)cudaErrorInvalidValue;
  FieldConst c = *reinterpret_cast<const FieldConst*>(consts);
  InvConst ic = *reinterpret_cast<const InvConst*>(r3);
  const unsigned blocks = (unsigned)((n + kThreads * kPer - 1) / (kThreads * kPer));
  const size_t smem = tree_bytes(kThreads);
  if (deg == 1)
    k_jac_to_affine<Fe><<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
        (const int32_t*)X, (const int32_t*)Y, (const int32_t*)Z, (int32_t*)ox, (int32_t*)oy, n, c, ic);
  else
    k_jac_to_affine<Fe2><<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
        (const int32_t*)X, (const int32_t*)Y, (const int32_t*)Z, (int32_t*)ox, (int32_t*)oy, n, c, ic);
  return (int)cudaGetLastError();
}

}  // extern "C"
