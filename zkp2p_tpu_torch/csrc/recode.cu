// K14 zk_signed_recode: standard-form scalars (n, 16) int32 16-bit limbs ->
// signed base-2^w digits, most significant first: mags (n, 256/w) int32 in
// [0, 2^(w-1)] and negs (n, 256/w) bytes (0 or 1).  Read as planes (the
// wrapper's view, digit axis first) that is the layout the reference's
// recode gives and the MSM kernels read: plane p of scalar i at
// i * 256/w + p.
//
// No Pallas counterpart: the reference recodes in XLA
// (zkp2p_tpu/ops/msm.py:129, signed_digit_planes_from_limbs), a
// Kogge-Stone pass over bool planes of every digit of every scalar, and so
// did the port's plain torch version.  Here one thread recodes one scalar
// serially, least significant digit first, with the carry in a register:
// e = d + carry, neg = e > 2^(w-1), mag = neg ? 2^w - e : e, carry = neg.
// That is the Kogge-Stone pass's recurrence (a digit above half generates
// a carry, a digit equal to half propagates one), so the planes are the
// same, including (mag 0, neg 1) where a digit 2^w - 1 takes a carry in.
// The last carry is dropped: the top digit absorbs it because Fr scalars
// are below 2^254, as in the reference.
//
// What bounds it on an H100: the bytes written, 5 a digit against 64 read
// a scalar.  A thread's own digits are 256/w adjacent words, so writing
// them straight from the thread would scatter each warp store over 32
// rows.  A block of RECODE_THREADS scalars instead stages its digits in
// shared memory (a row a scalar, padded by one word so that the threads'
// column writes fall in distinct banks) and the whole block then writes
// its contiguous stretch of mags, and then of negs, with consecutive
// threads on consecutive addresses.
#include <cstdint>
#include <cuda_runtime.h>

constexpr int RECODE_THREADS = 128;

template <int W>
__global__ void __launch_bounds__(RECODE_THREADS)
k_signed_recode(const int32_t* __restrict__ limbs, int32_t* __restrict__ mags, uint8_t* __restrict__ negs,
                long long n) {
  constexpr int PER_LIMB = 16 / W;
  constexpr int N_DIGITS = 256 / W;
  constexpr int LD = N_DIGITS + 1;
  constexpr uint32_t MASK = (1u << W) - 1u;
  constexpr uint32_t HALF = 1u << (W - 1);
  constexpr uint32_t FULL = 1u << W;
  __shared__ uint32_t sm[RECODE_THREADS * LD];
  const int t = threadIdx.x;
  const long long i0 = (long long)blockIdx.x * RECODE_THREADS;
  const int rows = (int)(n - i0 < RECODE_THREADS ? n - i0 : RECODE_THREADS);
  unsigned long long neg = 0;  // bit p: plane p negated
  if (t < rows) {
    const int4* q = reinterpret_cast<const int4*>(limbs + (i0 + t) * 16);
    uint32_t carry = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int4 v = __ldg(q + k);
      const uint32_t l[4] = {(uint32_t)v.x, (uint32_t)v.y, (uint32_t)v.z, (uint32_t)v.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int s = 0; s < PER_LIMB; ++s) {
          const int p = N_DIGITS - 1 - ((4 * k + u) * PER_LIMB + s);  // digits run least significant first
          const uint32_t e = ((l[u] >> (s * W)) & MASK) + carry;
          carry = e > HALF ? 1u : 0u;
          sm[t * LD + p] = carry ? FULL - e : e;
          neg |= (unsigned long long)carry << p;
        }
      }
    }
  }
  __syncthreads();
  const int count = rows * N_DIGITS;
  int32_t* mo = mags + i0 * N_DIGITS;
  for (int e = t; e < count; e += RECODE_THREADS) mo[e] = (int32_t)sm[(e / N_DIGITS) * LD + e % N_DIGITS];
  __syncthreads();
  if (t < rows) {
#pragma unroll
    for (int p = 0; p < N_DIGITS; ++p) sm[t * LD + p] = (uint32_t)(neg >> p) & 1u;
  }
  __syncthreads();
  uint8_t* no = negs + i0 * N_DIGITS;
  for (int e = t; e < count; e += RECODE_THREADS) no[e] = (uint8_t)sm[(e / N_DIGITS) * LD + e % N_DIGITS];
}

extern "C" {

// limbs (n, 16) 16-byte aligned, mags (n, 256/window) int32, negs (n,
// 256/window) bytes; window 4 (the witness's and the windowed h MSM's
// planes) or 16 (the bucket h MSM's).
int zk_signed_recode(const void* limbs, void* mags, void* negs, long long n, int window, void* stream) {
  if (n <= 0) return 0;
  const int threads = RECODE_THREADS;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  const int32_t* in = (const int32_t*)limbs;
  int32_t* m = (int32_t*)mags;
  uint8_t* g = (uint8_t*)negs;
  switch (window) {
    case 4: k_signed_recode<4><<<blocks, threads, 0, s>>>(in, m, g, n); break;
    case 16: k_signed_recode<16><<<blocks, threads, 0, s>>>(in, m, g, n); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
