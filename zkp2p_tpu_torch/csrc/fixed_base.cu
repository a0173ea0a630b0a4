// K17: a batch of fixed-base scalar multiplications k_i * G, written once
// over the field type and instantiated for G1 (Fq) and G2 (Fq2).
//
// Replaces the reference's native C++ fixed-base batches
// (csrc/zkp2p_native.cpp: g1_fixed_base_batch_mont,
// g2_fixed_base_batch_mont), which its trusted setup runs for every query
// point of the key.  A comb over 32 windows of 8 bits, as the reference's,
// with signed digits: the scalar's standard-form bytes, least significant
// first, recoded on the fly to digits in [-127, 128] (a byte plus the
// carry above 128 becomes byte + carry - 256 and carries one into the next
// byte; K14's rule, ops/msm.py: signed_digit_planes_from_limbs).  The top
// window absorbs the last carry: Fr < 2^254, so its byte is at most 0x30.
// One mixed addition of the table entry 2^(8w) * |d| * G, its y negated
// (0 - y) for a negative digit, for each nonzero digit d of window w.  The
// table holds the 32 x 128 affine multiples in Montgomery form (row
// w * 128 + |d| - 1; 512 KB for G1, 1 MB for G2), built once per base on
// the host.  The additions are point.cuh's mixed add, which handles
// P + P, P + (-P) and an accumulator at infinity, so every scalar in
// [0, r) is exact.
//
// The output is Jacobian (Z = 0 for the scalar 0); K15's jac_to_affine
// normalises it to the key's affine limbs.  The point is unique, so the
// limbs equal the reference's whatever the digits and the order of the
// additions.  ops/cuda_fixed_base.py's fixed_base_plain runs the same
// digits in the same order, so the Jacobian limbs equal it bit for bit.
//
// What bounds it: 32-bit multiplies, 11 Montgomery products (Fq2: 3
// each) a mixed addition, one addition a nonzero digit (about 32 a
// scalar).  The design for that:
// - every product is mont_cc.cuh's, in PTX carry chains;
// - a block walks the 32 windows in lockstep over its scalars, so that
//   each window's 128 rows (16 KB of limbs for G1, 32 KB for G2) are
//   staged once into shared memory by cp.async, double-buffered: window
//   w + 1 loads while window w adds.  Every table read of an addition
//   comes from shared memory, at each use in the formula (the addend is
//   an accessor, as K8/K9's), so the addend takes no registers;
// - one scalar a thread, FbGeom's threads a block (the launch bounds).
//   On an NVIDIA H100 80GB HBM3 (700 W; tools/kernel_variants.py, the
//   setup's launches: 19,825,624 G1 scalars, 1,603,487 G2) G1 took
//   205.3 ms at 512 threads a block (127 registers, 16 warps an SM),
//   228-229 at 256, 251 at 128; G2 99.7 ms at 128 threads (247
//   registers, no spill), 99.5 at 256, 127.7 at 64, and 71.7 at 128
//   threads with 3 blocks an SM, which ptxas fits in 168 registers with
//   1.2 KB of spill: left out, the G2 instantiation keeps no spill.
//   With fe_mul in place of the PTX product: G1 224.4, G2 102.4 ms.
#include "mont_cc.cuh"
#include "point.cuh"

constexpr int FB_WINDOWS = 32;
constexpr int FB_ROWS = 128;  // |d| = 1..128 a window

// threads a block and blocks an SM (the launch bounds), by field
template <class E>
struct FbGeom;
template <>
struct FbGeom<Fe> {
  static constexpr int threads = 512, min_blocks = 1;
};
template <>
struct FbGeom<Fe2> {
  static constexpr int threads = 128, min_blocks = 1;
};

__device__ __forceinline__ void fb_cp_async16(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void fb_cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// wait until at most one committed group is still in flight
__device__ __forceinline__ void fb_cp_async_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

// one element from shared memory, 4 (Fe) or 8 (Fe2) int4 of 16-bit limbs
__device__ __forceinline__ Fe fb_load_shared(const Fe*, const int4* q) {
  Fe r;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    int4 v = q[k];
    r.w[2 * k] = (uint32_t)v.x | ((uint32_t)v.y << 16);
    r.w[2 * k + 1] = (uint32_t)v.z | ((uint32_t)v.w << 16);
  }
  return r;
}
__device__ __forceinline__ Fe2 fb_load_shared(const Fe2*, const int4* q) {
  const Fe* tag = nullptr;
  return Fe2{fb_load_shared(tag, q), fb_load_shared(tag, q + 4)};
}

// The addend of one addition: the staged row (x, y) read from shared
// memory at each use, y negated for a negative digit; from_affine's Z is
// one (no row is at infinity).
template <class E>
struct FbEntry {
  const int4* x;
  const int4* y;
  bool neg;
  const FieldConst& c;
  __device__ __forceinline__ E qx() const { return fb_load_shared((const E*)nullptr, x); }
  __device__ __forceinline__ E qy() const {
    E v = fb_load_shared((const E*)nullptr, y);
    return neg ? f_sub(f_zero(v), v, c) : v;
  }
  __device__ __forceinline__ E qz() const { return f_one(E{}, c); }
};

// Shared memory: [2 buffers][x, y][FB_ROWS rows][ROW int4].
template <class E>
__global__ void __launch_bounds__(FbGeom<E>::threads, FbGeom<E>::min_blocks)
k_fixed_base(const int32_t* __restrict__ tx, const int32_t* __restrict__ ty, const int32_t* __restrict__ scalars,
             int32_t* __restrict__ ox, int32_t* __restrict__ oy, int32_t* __restrict__ oz, long long n,
             FieldConst c) {
  extern __shared__ int4 fb_smem[];
  constexpr int T = FbGeom<E>::threads;
  constexpr int ROW = (int)sizeof(E) / 8;  // int4 of one coordinate of a row: 4 (Fq), 8 (Fq2)
  constexpr int COORD = FB_ROWS * ROW;     // int4 of one coordinate of a window
  constexpr int STAGE = 2 * COORD;         // int4 of a buffer
  const int4* gx = reinterpret_cast<const int4*>(tx);
  const int4* gy = reinterpret_cast<const int4*>(ty);

  auto prefetch = [&](int w, int buf) {
    int4* dst = fb_smem + buf * STAGE;
    const long long src = (long long)w * COORD;
    for (int j = threadIdx.x; j < STAGE; j += T) fb_cp_async16(dst + j, j < COORD ? gx + src + j : gy + src + j - COORD);
  };

  const long long i = (long long)blockIdx.x * T + threadIdx.x;
  Fe k = i < n ? fe_load(scalars + i * 16) : fe_zero();  // 8 words of the standard form
  uint32_t carry = 0;
  const E zero = f_zero(E{});
  Jac<E> acc{zero, zero, zero};

  prefetch(0, 0);
  fb_cp_async_commit();
#pragma unroll 1
  for (int w = 0; w < FB_WINDOWS; ++w) {
    if (w + 1 < FB_WINDOWS) prefetch(w + 1, (w + 1) & 1);
    fb_cp_async_commit();  // an empty group on the last window keeps the count
    fb_cp_async_wait_one();
    __syncthreads();
    const uint32_t e = (k.w[0] & 0xFFu) + carry;  // window w's byte: k shifts down a byte a window
#pragma unroll
    for (int j = 0; j < 7; ++j) k.w[j] = __funnelshift_r(k.w[j], k.w[j + 1], 8);
    k.w[7] >>= 8;
    const bool neg = e > FB_ROWS;
    const uint32_t mag = neg ? 2 * FB_ROWS - e : e;
    carry = neg;
    if (mag) {
      const int4* row = fb_smem + (w & 1) * STAGE + (mag - 1) * ROW;
      FbEntry<E> q{row, row + COORD, neg, c};
      acc = pt_add_mixed_q<MulCC>(acc, q, c);
    }
    __syncthreads();  // buffer w & 1 is refilled by the next window's prefetch
  }
  if (i < n) {
    f_store(ox, i, acc.x);
    f_store(oy, i, acc.y);
    f_store(oz, i, acc.z);
  }
}

template <class E>
static int launch_fixed_base(const void* tx, const void* ty, const void* scalars, void* ox, void* oy, void* oz,
                             long long n, const void* consts, void* stream) {
  if (n <= 0) return 0;
  constexpr int T = FbGeom<E>::threads;
  const int smem = 2 * 2 * FB_ROWS * (int)sizeof(E) * 2;  // 2 buffers x (x, y) x rows x 16-bit limbs in int32
  cudaError_t err = cudaFuncSetAttribute(k_fixed_base<E>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  FieldConst c = *reinterpret_cast<const FieldConst*>(consts);
  k_fixed_base<E><<<(unsigned)((n + T - 1) / T), T, smem, (cudaStream_t)stream>>>(
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
