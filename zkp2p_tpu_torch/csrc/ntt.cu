// K12 zk_fr_ntt_pass: one pass of a radix-2 DIT NTT over BN254 Fr, the k
// consecutive butterfly stages s0 .. s0+k-1 in one launch, over every row
// of a (rows, m, 16) batch (m = 2^log_m, int32 16-bit limbs, Montgomery
// form).  Stage s pairs, for each index i0 with bit s clear, x[i0] and
// x[i0 | 2^s] under the twiddle tw[pos << (log_m - 1 - s)], pos = i0 mod
// 2^s: b = x[i0 | 2^s] * tw, x[i0] = a + b, x[i0 | 2^s] = a - b.
//
// Replaces, on the H ladder, the Pallas kernel mont_mul of the reference
// (zkp2p_tpu/ops/pallas_mont.py:201) together with the stage body it runs
// in (zkp2p_tpu/ops/ntt.py:94-97, _ntt_core: the twiddle product, then
// add, sub and a concatenate in XLA, one stage at a time over the whole
// array).  The input permutation (x[..., perm, :]) and the scalings
// around the transforms (intt's 1/m, coset_shift's g^i) fold into the
// first pass's loads.
//
// What bounds it on an H100: the Fr products.  A transform of 2^23 is
// 23 x 2^22 products of 264 32-bit multiplies; the ladder's six (three
// rows through an iNTT and an NTT) and its scale/coset factor are about
// 6.0 x 10^8 products, some 10 ms at 132 SMs x 64 multiplies x 1.98 GHz,
// where its 18 row passes move 2 x 512 MiB each, about 6 ms at 3.35
// TB/s.  The stage-at-a-time ladder moved the whole array through device
// memory several times a stage.
//
// The design: a block owns one closed butterfly group of the pass, the
// 2^k elements whose indices agree outside bits [s0, s0+k).  It loads
// them into dynamic shared memory as 8 x 32-bit words (32 B an element,
// word-major so that neighbouring elements sit in neighbouring banks),
// runs the k stages there with a barrier between stages (mont.cuh's
// fe_mul, fe_add, fe_sub), and writes the group back once.  So a
// transform of 2^23 is three passes of 8, 8 and 7 stages instead of 23
// round trips.  The first pass reads x at bit-reversed addresses
// (__brev) and may multiply each element by factor[src] (a per-element
// table, stride 1) or by one constant (stride 0) as it loads.  Every
// value is a canonical Fr element and each operation is exact, so any
// grouping of the stages into passes, and the factor applied at the load,
// give the limbs of the stage-at-a-time ladder bit for bit.
//
// A later pass may run in place (out == in): a block reads only its own
// group, and reads all of it before it writes.  The data loads therefore
// go through the coherent path, not __ldg.
#include "mont.cuh"

// 2^11 elements x 32 B = 64 KB of shared memory a block
constexpr int MAX_PASS_LOG = 11;

__device__ __forceinline__ Fe fe_load_coherent(const int32_t* p) {
  const int4* q = reinterpret_cast<const int4*>(p);
  Fe r;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    int4 v = q[k];
    r.w[2 * k] = (uint32_t)v.x | ((uint32_t)v.y << 16);
    r.w[2 * k + 1] = (uint32_t)v.z | ((uint32_t)v.w << 16);
  }
  return r;
}

// element t of a group of 2^k, word-major: word w at sm[(w << k) + t]
__device__ __forceinline__ Fe sm_get(const uint32_t* sm, int k, int t) {
  Fe r;
#pragma unroll
  for (int w = 0; w < 8; ++w) r.w[w] = sm[(w << k) + t];
  return r;
}

__device__ __forceinline__ void sm_put(uint32_t* sm, int k, int t, const Fe& a) {
#pragma unroll
  for (int w = 0; w < 8; ++w) sm[(w << k) + t] = a.w[w];
}

// grid (m >> k groups, rows); group g: low = g mod 2^s0, high = g >> s0;
// its element t is x[low | t << s0 | high << (s0 + k)].
__global__ void __launch_bounds__(256)
k_fr_ntt_pass(const int32_t* in, int32_t* out, const int32_t* __restrict__ tw, const int32_t* __restrict__ factor,
              int log_m, int s0, int k, int bitrev, int fstride, FieldConst c) {
  extern __shared__ uint32_t sm[];
  const long long g = blockIdx.x;
  const long long low = g & ((1LL << s0) - 1);
  const long long high = g >> s0;
  const long long base = (long long)blockIdx.y << log_m;
  const int n = 1 << k;

  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    const long long idx = low | ((long long)t << s0) | (high << (s0 + k));
    const long long src = (bitrev && log_m) ? (long long)(__brev((unsigned)idx) >> (32 - log_m)) : idx;
    Fe x = fe_load_coherent(in + (base + src) * 16);
    if (factor) x = fe_mul(x, fe_load(factor + src * fstride * 16), c);
    sm_put(sm, k, t, x);
  }
  __syncthreads();

  for (int ls = 0; ls < k; ++ls) {
    const int s = s0 + ls;
    const int half = 1 << ls;
    for (int b = threadIdx.x; b < (n >> 1); b += blockDim.x) {
      const int j = b & (half - 1);
      const int t0 = ((b >> ls) << (ls + 1)) | j;
      const int t1 = t0 | half;
      const long long pos = low | ((long long)j << s0);
      const Fe w = fe_load(tw + (pos << (log_m - 1 - s)) * 16);
      const Fe u = sm_get(sm, k, t0);
      const Fe v = fe_mul(sm_get(sm, k, t1), w, c);
      sm_put(sm, k, t0, fe_add(u, v, c));
      sm_put(sm, k, t1, fe_sub(u, v, c));
    }
    __syncthreads();
  }

  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    const long long idx = low | ((long long)t << s0) | (high << (s0 + k));
    fe_store(out + (base + idx) * 16, sm_get(sm, k, t));
  }
}

extern "C" {

// in, out (rows, 2^log_m, 16); tw (max(2^(log_m-1), 1), 16); factor null,
// (16,) with fstride 0 or (2^log_m, 16) with fstride 1; out may equal in
// unless bitrev.  rows <= 65535, 0 <= k <= MAX_PASS_LOG, s0 + k <= log_m.
int zk_fr_ntt_pass(const void* in, void* out, const void* tw, const void* factor, long long rows, int log_m,
                   int s0, int k, int bitrev, int fstride, const void* consts, void* stream) {
  if (rows <= 0) return 0;
  if (rows > 65535 || k < 0 || k > MAX_PASS_LOG || s0 < 0 || s0 + k > log_m || log_m > 28)
    return (int)cudaErrorInvalidValue;
  FieldConst c = *reinterpret_cast<const FieldConst*>(consts);
  const int smem = 32 << k;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(k_fr_ntt_pass, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int threads = k <= 6 ? 32 : (k >= 9 ? 256 : 1 << (k - 1));
  const dim3 grid((unsigned)(1LL << (log_m - k)), (unsigned)rows);
  k_fr_ntt_pass<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)in, (int32_t*)out, (const int32_t*)tw, (const int32_t*)factor, log_m, s0, k, bitrev, fstride,
      c);
  return (int)cudaGetLastError();
}

}  // extern "C"
