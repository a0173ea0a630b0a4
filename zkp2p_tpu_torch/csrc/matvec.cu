// K13 zk_fr_matvec: the sparse matrix-vector product of the QAP over BN254
// Fr, out[i] = sum_j coeff[j] * w[wire[j]] mod r over the nonzeros j of row
// i, for a matrix in compressed sparse rows (CSR): row i holds nonzeros
// offsets[i] .. offsets[i+1]-1.  Coefficients and the witness are int32
// 16-bit limbs in Montgomery form, so each product (mont.cuh's fe_mul) is
// the Montgomery form of coeff * w, and so is the row's sum.
//
// Replaces, on the witness side of the proof, the Pallas kernel mont_mul
// of the reference (zkp2p_tpu/ops/pallas_mont.py:201) over the gathered
// nonzeros together with the segment sum behind it
// (zkp2p_tpu/field/jfield.py:431, lazy_segment_sum_mod: a uint32
// segment_sum of the limbs, a carry pass and a Montgomery reduction of
// the 19-limb sums).  Here nothing leaves the thread between the gather
// and the stored row: one thread a row keeps its sum in registers, adding
// each product with one conditional subtract (fe_add).  Every value is
// canonical and every operation exact, so the sum equals the reference's
// reduction of the exact integer sum, bit for bit, in any order of the
// nonzeros.
//
// What bounds it on an H100: the bytes.  Each nonzero reads its
// coefficient (64 B), its wire id and the gathered witness value (64 B),
// against one product (264 32-bit multiplies); each row writes 64 B.
// A row of fan-in k costs one thread k dependent products: the QAP's rows
// hold a few nonzeros each, and a long row only costs time.
#include "mont.cuh"

__global__ void __launch_bounds__(256)
k_fr_matvec(const int32_t* __restrict__ coeff, const int32_t* __restrict__ wire,
            const long long* __restrict__ offsets, const int32_t* __restrict__ w,
            int32_t* __restrict__ out, long long rows, FieldConst c) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows) return;
  const long long j1 = offsets[i + 1];
  Fe acc = fe_zero();
  for (long long j = offsets[i]; j < j1; ++j) {
    const Fe x = fe_load(coeff + j * 16);
    const Fe y = fe_load(w + (long long)__ldg(wire + j) * 16);
    acc = fe_add(acc, fe_mul(x, y, c), c);
  }
  fe_store(out + i * 16, acc);
}

extern "C" {

// coeff (nnz, 16), wire (nnz,) int32, offsets (rows + 1,) int64 from 0 to
// nnz, w (n_wires, 16), out (rows, 16); out must not overlap w.
int zk_fr_matvec(const void* coeff, const void* wire, const void* offsets, const void* w, void* out,
                 long long rows, const void* consts, void* stream) {
  if (rows <= 0) return 0;
  FieldConst c = *reinterpret_cast<const FieldConst*>(consts);
  const int threads = 256;
  const long long blocks = (rows + threads - 1) / threads;
  k_fr_matvec<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)coeff, (const int32_t*)wire, (const long long*)offsets, (const int32_t*)w,
      (int32_t*)out, rows, c);
  return (int)cudaGetLastError();
}

}  // extern "C"
