// K1: batched Montgomery product out[i] = a[i] * b[i] * 2^-256 mod N.
//
// Replaces the Pallas kernel mont_mul of the reference
// (zkp2p_tpu/ops/pallas_mont.py: entry mont_mul, body _kernel, math
// _mont_mul_math), which runs the SOS product on (16, TILE) limb tiles in
// VMEM.  Here one thread computes one product in registers with 8 x 32-bit
// CIOS (mont.cuh); N and -N^-1 come in as a by-value parameter block, so
// one kernel serves Fr and Fq.
//
// What bounds it on an H100: integer multiply throughput (about 136
// 32x32->64 multiply-adds per product against 128 bytes read and 64
// written), and at large batch the bytes moved, since limbs cross the
// boundary as 16 int32 (twice the packed size).  A redesign that packs
// limbs at the boundary, or moves the carry chains onto wider multiply
// paths, is later work; so are wgmma- or TMA-style layouts.
//
// Broadcast operands (a Montgomery constant against a batch) read with a
// stride of 0 elements.
#include "mont.cuh"

__global__ void __launch_bounds__(256)
k_mont_mul(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
           int32_t* __restrict__ out, long long n, int sa, int sb, FieldConst c) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Fe x = fe_load(a + i * sa * 16);
  Fe y = fe_load(b + i * sb * 16);
  fe_store(out + i * 16, fe_mul(x, y, c));
}

extern "C" int zk_mont_mul(const void* a, const void* b, void* out, long long n,
                           int sa, int sb, const void* consts, void* stream) {
  if (n <= 0) return 0;
  FieldConst c = *reinterpret_cast<const FieldConst*>(consts);
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  k_mont_mul<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)a, (const int32_t*)b, (int32_t*)out, n, sa, sb, c);
  return (int)cudaGetLastError();
}
