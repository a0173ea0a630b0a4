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
// A batch of witnesses sharing the matrix (the batch prover's chunk, w
// (B, n_wires, 16), out (B, rows, 16)) is one launch: the thread of row i
// walks the row's nonzeros once for each group of G witnesses, reading a
// nonzero's coefficient and wire id once per group and adding its product
// with each witness's value into that witness's accumulator, G of them in
// registers.  A batch runs with G = MATVEC_GROUP: the batch prover's chunk
// of 4 is one group, so the matrix is read once per chunk, and a larger
// batch re-reads a row (a few nonzeros) once per further group.  One
// witness runs with G = 1, the unbatched kernel with its own registers:
// four accumulators took 80 registers and 8 bytes of spill on an H100
// (sm_90a, nvcc 12.9), one took 64 and none.
//
// What bounds it on an H100: the bytes.  Each nonzero reads its
// coefficient (64 B), its wire id and the gathered witness values (64 B a
// witness), against one product a witness (264 32-bit multiplies); each
// row writes 64 B a witness.  A row of fan-in k costs one thread k
// dependent products a witness: the QAP's rows hold a few nonzeros each,
// and a long row only costs time.
#include "mont.cuh"

constexpr int MATVEC_GROUP = 4;

template <int G>
__global__ void __launch_bounds__(256)
k_fr_matvec(const int32_t* __restrict__ coeff, const int32_t* __restrict__ wire,
            const long long* __restrict__ offsets, const int32_t* __restrict__ w,
            int32_t* __restrict__ out, long long rows, long long n_wires, int batch, FieldConst c) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows) return;
  const long long j0 = offsets[i];
  const long long j1 = offsets[i + 1];
  for (int b0 = 0; b0 < batch; b0 += G) {
    const int nb = batch - b0 < G ? batch - b0 : G;
    const int32_t* wb = w + (long long)b0 * n_wires * 16;
    Fe acc[G];
#pragma unroll
    for (int k = 0; k < G; ++k) acc[k] = fe_zero();
    for (long long j = j0; j < j1; ++j) {
      const Fe x = fe_load(coeff + j * 16);
      const long long at = (long long)__ldg(wire + j) * 16;
#pragma unroll
      for (int k = 0; k < G; ++k) {
        if (k < nb) acc[k] = fe_add(acc[k], fe_mul(x, fe_load(wb + k * n_wires * 16 + at), c), c);
      }
    }
#pragma unroll
    for (int k = 0; k < G; ++k) {
      if (k < nb) fe_store(out + ((long long)(b0 + k) * rows + i) * 16, acc[k]);
    }
  }
}

extern "C" {

// coeff (nnz, 16), wire (nnz,) int32, offsets (rows + 1,) int64 from 0 to
// nnz, w (batch, n_wires, 16), out (batch, rows, 16); out must not overlap w.
int zk_fr_matvec(const void* coeff, const void* wire, const void* offsets, const void* w, void* out,
                 long long rows, long long n_wires, int batch, const void* consts, void* stream) {
  if (rows <= 0 || batch <= 0) return 0;
  FieldConst c = *reinterpret_cast<const FieldConst*>(consts);
  const int threads = 256;
  const long long blocks = (rows + threads - 1) / threads;
  if (batch == 1) {
    k_fr_matvec<1><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)coeff, (const int32_t*)wire, (const long long*)offsets, (const int32_t*)w,
        (int32_t*)out, rows, n_wires, batch, c);
  } else {
    k_fr_matvec<MATVEC_GROUP><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)coeff, (const int32_t*)wire, (const long long*)offsets, (const int32_t*)w,
        (int32_t*)out, rows, n_wires, batch, c);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
