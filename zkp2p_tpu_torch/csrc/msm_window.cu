// K6-K9: the signed-window MSM accumulate, as two kernels for a chunk of
// T lane steps (ops/msm.py, _accumulate_chunked), for G1 and for G2:
//   K6 zk_g1_window_table       the multiples 1P..nP of T x lanes G1 bases
//   K7 zk_g1_window_accumulate  acc[d, l] += (+-)table[t, |digit|-1, l]
//                               for the chunk's T steps, over Fq
//   K8 zk_g2_window_table       K6 over Fq2
//   K9 zk_g2_window_accumulate  K7 over Fq2
//
// Replaces, on the windowed path, the Pallas kernels g1_add_mixed and
// g2_add_mixed (the multiples table) and g1_add and g2_add (the
// accumulate) of the reference (zkp2p_tpu/ops/pallas_curve.py), which
// its lax.scan over lane steps (zkp2p_tpu/ops/msm.py, msm_windowed_signed:
// table_step and the accumulate body) launches once per step: n-1
// chained mixed adds for the table, one gather of the signed entries and
// one add over (n_digits, lanes).  The point math is point.cuh's, the
// same formulas and case selects as K2/K3, and the order of the adds of
// each (d, l) is the scan's, so the partials equal the reference's bit
// for bit.
//
// K6: one thread per base keeps its chain in registers (from_affine, then
// n-1 mixed adds) and writes each multiple once, (T, n, lanes, 16) per
// coordinate.  One launch covers the chunk's T x lanes bases, where the
// step loop launched K3 n-1 times at `lanes` threads a step.  Bound by
// 32-bit multiplies (11 products a mixed add); the table it writes is the
// chunk budget of ops/cuda_msm_window.py, so bytes are not its bound.
//
// K7: one thread owns acc[d, l] in registers across the chunk's T steps
// and writes it back once, where the step loop read and wrote it through
// device memory every step beside a gathered (n_digits, lanes) selection.
// A block covers all digit rows of LB lanes (blockDim = LB x n_digits);
// each step it stages the n multiples of its lanes in shared memory with
// cp.async, double-buffered, so that step t+1's entries load while step t
// adds.  A negative digit negates Y as 0 - y (fe_sub: -0 = 0); a zero
// digit adds nothing, which is what K2 returns for an addend at infinity.
// Bound by 32-bit multiplies: 16 Montgomery products an add; in practice
// by their latency (see the launch bounds below).
//
// A batch of B witnesses against one key (the batch prover's chunk) is
// one launch of K7 or K9: the partials gain a leading batch axis (B,
// n_digits, lanes), the digit planes a batch axis read at its stride, and
// gridDim.y runs over the batch.  The chunk's table is built once (one K6
// or K8 launch) and read by all B; a block's work, registers and shared
// staging are those of the unbatched kernel, which is B = 1.
//
// K8/K9 are K6/K7 over Fq2 (3 Montgomery products an Fq2 product): a
// Jacobian point is 48 words, and K2 over Fq2 already takes 255
// registers and spills.  So neither holds its addend: the base of K8's
// chain and the table entry of K9's add are read from device memory (L1)
// at each use in the formula (pt_add_mixed_q, pt_add over an addend
// type), and only the accumulator stays in registers.  K9 has no shared
// staging: each (d, l) thread loads the one entry its digit selects, 384
// bytes an add, about 0.4 GB a narrow chunk against ~0.7 ms of multiplies
// at the operation bound; one thread per (digit, lane) in 128-thread
// blocks, whatever n_digits is.
#include "point.cuh"

// ------------------------------------------------------------------- K6

__global__ void __launch_bounds__(128)
k_g1_window_table(const int32_t* __restrict__ bx, const int32_t* __restrict__ by, int32_t* __restrict__ ox,
                  int32_t* __restrict__ oy, int32_t* __restrict__ oz, long long n, int lanes, int n_table,
                  FieldConst c) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  long long t = i / lanes;
  long long l = i - t * lanes;
  Fe x = fe_load(bx + i * 16);
  Fe y = fe_load(by + i * 16);
  Jac<Fe> e{x, y, (fe_is_zero(x) && fe_is_zero(y)) ? fe_zero() : fe_one(c)};
  long long o = t * n_table * lanes + l;
  for (int k = 0; k < n_table; ++k) {
    if (k) e = pt_add_mixed(e, x, y, c);
    long long at = (o + (long long)k * lanes) * 16;
    fe_store(ox + at, e.x);
    fe_store(oy + at, e.y);
    fe_store(oz + at, e.z);
  }
}

// ------------------------------------------------------------------- K7

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// wait until at most one committed group is still in flight
__device__ __forceinline__ void cp_async_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

// one element from shared memory: 4 x int4 of 16-bit limbs
__device__ __forceinline__ Fe fe_load_shared(const int4* q) {
  Fe r;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    int4 v = q[k];
    r.w[2 * k] = (uint32_t)v.x | ((uint32_t)v.y << 16);
    r.w[2 * k + 1] = (uint32_t)v.z | ((uint32_t)v.w << 16);
  }
  return r;
}

// The digit planes are read in place at any strides: the prover's come
// digit-minor (a lane's digits adjacent), which a warp of 16 digit rows
// then reads as one coalesced segment.
struct Planes {
  const int32_t* mags;  // (n_digits, batch, steps, lanes) magnitudes in [0, n_table]
  const uint8_t* negs;  // the same shape, 1 where the digit is negative
  long long mag_sd, mag_sb, mag_ss, mag_sl;  // digit, batch, step and lane strides
  long long neg_sd, neg_sb, neg_ss, neg_sl;
};

// Four blocks an SM: at most 128 registers, with a small spill (chip_smoke
// logs ptxas's counts).  The add is a chain of dependent multiply-adds,
// so warps in flight count for more than the spill: on an H100 this ran
// the msm_h chunk faster than the unconstrained registers (2 blocks an
// SM), 3 blocks, or 5-8 blocks with their larger spills.
// Shared memory: [2 buffers][3 coordinates][n_table][LB lanes][4 x int4].
// blockIdx.y is the witness of the batch: acc and out at its offset, the
// planes at its stride; the table is the batch's.
__global__ void __launch_bounds__(128, 4)
k_g1_window_accumulate(const int32_t* __restrict__ ax, const int32_t* __restrict__ ay,
                       const int32_t* __restrict__ az, const int32_t* __restrict__ tx,
                       const int32_t* __restrict__ ty, const int32_t* __restrict__ tz, Planes pl,
                       int32_t* __restrict__ ox, int32_t* __restrict__ oy, int32_t* __restrict__ oz, int lanes,
                       int lanes_per_block, int n_table, int steps, long long s0, FieldConst c) {
  extern __shared__ int4 smem[];
  const int LB = lanes_per_block;
  const int lb = threadIdx.x % LB;
  const int d = threadIdx.x / LB;
  const int l0 = blockIdx.x * LB;
  const int l = l0 + lb;
  const bool active = l < lanes;
  const int stage = 3 * n_table * LB * 4;  // int4 per buffer
  const long long b = blockIdx.y;
  const long long b_off = b * (blockDim.x / LB) * lanes * 16;  // blockDim.x / LB digit rows
  ax += b_off, ay += b_off, az += b_off, ox += b_off, oy += b_off, oz += b_off;

  auto prefetch = [&](int t, int buf) {
    int4* dst = smem + buf * stage;
    for (int j = threadIdx.x; j < stage; j += blockDim.x) {
      int q = j & 3;
      int r = j >> 2;
      int lj = r % LB;
      r /= LB;
      int k = r % n_table;
      int coord = r / n_table;
      if (l0 + lj >= lanes) continue;  // the ragged edge: no thread reads it
      const int32_t* base = coord == 0 ? tx : (coord == 1 ? ty : tz);
      cp_async16(dst + j, base + (((long long)t * n_table + k) * lanes + l0 + lj) * 16 + q * 4);
    }
  };

  const long long at = ((long long)d * lanes + l) * 16;
  Jac<Fe> acc;
  if (active) acc = Jac<Fe>{fe_load(ax + at), fe_load(ay + at), fe_load(az + at)};
  const int32_t* mag_p = pl.mags + d * pl.mag_sd + b * pl.mag_sb + s0 * pl.mag_ss + l * pl.mag_sl;
  const uint8_t* neg_p = pl.negs + d * pl.neg_sd + b * pl.neg_sb + s0 * pl.neg_ss + l * pl.neg_sl;

  prefetch(0, 0);
  cp_async_commit();
  for (int t = 0; t < steps; ++t) {
    int mag = 0;
    bool neg = false;
    if (active) {
      mag = __ldg(mag_p + t * pl.mag_ss);
      neg = __ldg(neg_p + t * pl.neg_ss) != 0;
    }
    if (t + 1 < steps) prefetch(t + 1, (t + 1) & 1);
    cp_async_commit();  // an empty group on the last step keeps the count
    cp_async_wait_one();
    __syncthreads();
    if (active && mag) {
      const int4* e = smem + (t & 1) * stage + ((mag - 1) * LB + lb) * 4;
      const int coord = n_table * LB * 4;
      Jac<Fe> q{fe_load_shared(e), fe_load_shared(e + coord), fe_load_shared(e + 2 * coord)};
      if (neg) q.y = fe_sub(fe_zero(), q.y, c);
      acc = pt_add(acc, q, c);
    }
    __syncthreads();  // buffer t & 1 is refilled by the next step's prefetch
  }
  if (active) {
    fe_store(ox + at, acc.x);
    fe_store(oy + at, acc.y);
    fe_store(oz + at, acc.z);
  }
}

// ------------------------------------------------------------- K8, K9

// K8's addend: the affine base (x, y) of the thread's chain; qz() is
// from_affine's Z, which the infinity flag fixes once for the chain.
struct G2Base {
  const int32_t* x;
  const int32_t* y;
  bool inf;
  const FieldConst& c;
  __device__ __forceinline__ Fe2 qx() const { return fe2_load_each(x); }
  __device__ __forceinline__ Fe2 qy() const { return fe2_load_each(y); }
  __device__ __forceinline__ Fe2 qz() const { return inf ? Fe2{fe_zero(), fe_zero()} : Fe2{fe_one(c), fe_zero()}; }
};

// K9's addend: the table entry a digit selects, Y negated component-wise
// as 0 - y for a negative digit (fe_sub: -0 = 0), as K7 negates it.
struct G2Entry {
  const int32_t* x;
  const int32_t* y;
  const int32_t* z;
  bool neg;
  const FieldConst& c;
  __device__ __forceinline__ Fe2 qx() const { return fe2_load_each(x); }
  __device__ __forceinline__ Fe2 qy() const {
    Fe2 v = fe2_load_each(y);
    return neg ? f_sub(f_zero(v), v, c) : v;
  }
  __device__ __forceinline__ Fe2 qz() const { return fe2_load_each(z); }
};

// bases (n = T x lanes, 2, 16) x2 -> table (T, n_table, lanes, 2, 16) x3
__global__ void __launch_bounds__(128)
k_g2_window_table(const int32_t* __restrict__ bx, const int32_t* __restrict__ by, int32_t* __restrict__ ox,
                  int32_t* __restrict__ oy, int32_t* __restrict__ oz, long long n, int lanes, int n_table,
                  FieldConst c) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  long long t = i / lanes;
  long long l = i - t * lanes;
  const Fe2* tag = nullptr;
  Jac<Fe2> e{f_load(tag, bx, i), f_load(tag, by, i), f_zero(Fe2{})};
  const bool inf = f_is_zero(e.x) && f_is_zero(e.y);
  if (!inf) e.z = f_one(e.z, c);
  const G2Base base{bx + i * 32, by + i * 32, inf, c};
  long long o = t * n_table * lanes + l;
  for (int k = 0; k < n_table; ++k) {
    if (k) e = pt_add_mixed_q(e, base, c);
    long long at = o + (long long)k * lanes;
    f_store(ox, at, e.x);
    f_store(oy, at, e.y);
    f_store(oz, at, e.z);
  }
}

// One thread per (d, l), lane-major (i = d * lanes + l), in 128-thread
// blocks; blockIdx.y is the witness of the batch.  Launch bounds (128,
// 2): 255 registers, 544 / 584 bytes of spill stores / loads (ptxas).  On an H100 80GB HBM3 (700 W) at the b2
// narrow chunk (3 planes x 4,096 lanes x 85 steps, 928,150 adds) it ran
// 8.35 ms, 9.0 ns an add; bounds (128, 1), (128, 3) (168 registers, 1.5
// KB of spill) and (128, 4) (128 registers, 2.9 KB) ran 8.33, 8.57 and
// 8.71 ms, and the addend held in registers instead of read at each use
// 8.31-8.73 ms.  So the spill is not what bounds it: 12,288 threads are
// one warp per SM sub-partition, and the add's chain of dependent
// multiplies runs at its latency.  At the b2 wide chunk (64 x 572 x 17,
// 286 blocks) 3.49 ms; (128, 3) fits all blocks in one wave there (2.62
// ms) but is slower on the narrow chunk, which holds 5 of the 6 launches.
__global__ void __launch_bounds__(128, 2)
k_g2_window_accumulate(const int32_t* __restrict__ ax, const int32_t* __restrict__ ay,
                       const int32_t* __restrict__ az, const int32_t* __restrict__ tx,
                       const int32_t* __restrict__ ty, const int32_t* __restrict__ tz, Planes pl,
                       int32_t* __restrict__ ox, int32_t* __restrict__ oy, int32_t* __restrict__ oz, int n_digits,
                       int lanes, int n_table, int steps, long long s0, FieldConst c) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)n_digits * lanes) return;
  const int d = (int)(i / lanes);
  const int l = (int)(i - (long long)d * lanes);
  const long long b = blockIdx.y;
  const long long b_off = b * n_digits * lanes * 32;
  ax += b_off, ay += b_off, az += b_off, ox += b_off, oy += b_off, oz += b_off;
  const Fe2* tag = nullptr;
  Jac<Fe2> acc{f_load(tag, ax, i), f_load(tag, ay, i), f_load(tag, az, i)};
  const int32_t* mag_p = pl.mags + d * pl.mag_sd + b * pl.mag_sb + s0 * pl.mag_ss + l * pl.mag_sl;
  const uint8_t* neg_p = pl.negs + d * pl.neg_sd + b * pl.neg_sb + s0 * pl.neg_ss + l * pl.neg_sl;
  for (int t = 0; t < steps; ++t) {
    const int mag = __ldg(mag_p + t * pl.mag_ss);
    if (!mag) continue;
    const long long at = (((long long)t * n_table + mag - 1) * lanes + l) * 32;
    const G2Entry q{tx + at, ty + at, tz + at, __ldg(neg_p + t * pl.neg_ss) != 0, c};
    acc = pt_add(acc, q, c);
  }
  f_store(ox, i, acc.x);
  f_store(oy, i, acc.y);
  f_store(oz, i, acc.z);
}

extern "C" {

int zk_g1_window_table(const void* bx, const void* by, void* ox, void* oy, void* oz, long long n, int lanes,
                       int n_table, const void* consts, void* stream) {
  if (n <= 0) return 0;
  FieldConst c = *reinterpret_cast<const FieldConst*>(consts);
  k_g1_window_table<<<(unsigned)((n + 127) / 128), 128, 0, (cudaStream_t)stream>>>(
      (const int32_t*)bx, (const int32_t*)by, (int32_t*)ox, (int32_t*)oy, (int32_t*)oz, n, lanes, n_table, c);
  return (int)cudaGetLastError();
}

// acc (batch, n_digits, lanes, 16) x3 in, out the same; table (steps,
// n_table, lanes, 16) x3; the planes (n_digits, batch, steps, lanes) at the
// given strides, read at steps s0 .. s0 + steps - 1.  lanes_per_block x
// n_digits <= 128 threads and lanes_per_block x n_table <= 128 (shared
// memory <= 48 KB) are the caller's to keep.
int zk_g1_window_accumulate(const void* ax, const void* ay, const void* az, const void* tx, const void* ty,
                            const void* tz, const void* mags, const void* negs, void* ox, void* oy, void* oz,
                            int batch, int n_digits, int lanes, int lanes_per_block, int n_table, int steps,
                            long long s0, long long mag_sd, long long mag_sb, long long mag_ss, long long mag_sl,
                            long long neg_sd, long long neg_sb, long long neg_ss, long long neg_sl,
                            const void* consts, void* stream) {
  if (batch <= 0 || n_digits <= 0 || lanes <= 0 || steps <= 0) return 0;
  FieldConst c = *reinterpret_cast<const FieldConst*>(consts);
  Planes pl{(const int32_t*)mags, (const uint8_t*)negs, mag_sd, mag_sb, mag_ss, mag_sl,
            neg_sd, neg_sb, neg_ss, neg_sl};
  dim3 grid((unsigned)((lanes + lanes_per_block - 1) / lanes_per_block), (unsigned)batch);
  size_t smem = (size_t)2 * 3 * n_table * lanes_per_block * 64;
  k_g1_window_accumulate<<<grid, lanes_per_block * n_digits, smem, (cudaStream_t)stream>>>(
      (const int32_t*)ax, (const int32_t*)ay, (const int32_t*)az, (const int32_t*)tx, (const int32_t*)ty,
      (const int32_t*)tz, pl, (int32_t*)ox, (int32_t*)oy, (int32_t*)oz, lanes, lanes_per_block, n_table, steps,
      s0, c);
  return (int)cudaGetLastError();
}

int zk_g2_window_table(const void* bx, const void* by, void* ox, void* oy, void* oz, long long n, int lanes,
                       int n_table, const void* consts, void* stream) {
  if (n <= 0) return 0;
  FieldConst c = *reinterpret_cast<const FieldConst*>(consts);
  k_g2_window_table<<<(unsigned)((n + 127) / 128), 128, 0, (cudaStream_t)stream>>>(
      (const int32_t*)bx, (const int32_t*)by, (int32_t*)ox, (int32_t*)oy, (int32_t*)oz, n, lanes, n_table, c);
  return (int)cudaGetLastError();
}

// acc (batch, n_digits, lanes, 2, 16) x3 in, out the same; table (steps,
// n_table, lanes, 2, 16) x3; the planes as zk_g1_window_accumulate's.
int zk_g2_window_accumulate(const void* ax, const void* ay, const void* az, const void* tx, const void* ty,
                            const void* tz, const void* mags, const void* negs, void* ox, void* oy, void* oz,
                            int batch, int n_digits, int lanes, int n_table, int steps, long long s0,
                            long long mag_sd, long long mag_sb, long long mag_ss, long long mag_sl,
                            long long neg_sd, long long neg_sb, long long neg_ss, long long neg_sl,
                            const void* consts, void* stream) {
  if (batch <= 0 || n_digits <= 0 || lanes <= 0 || steps <= 0) return 0;
  FieldConst c = *reinterpret_cast<const FieldConst*>(consts);
  Planes pl{(const int32_t*)mags, (const uint8_t*)negs, mag_sd, mag_sb, mag_ss, mag_sl,
            neg_sd, neg_sb, neg_ss, neg_sl};
  long long n = (long long)n_digits * lanes;
  dim3 grid((unsigned)((n + 127) / 128), (unsigned)batch);
  k_g2_window_accumulate<<<grid, 128, 0, (cudaStream_t)stream>>>(
      (const int32_t*)ax, (const int32_t*)ay, (const int32_t*)az, (const int32_t*)tx, (const int32_t*)ty,
      (const int32_t*)tz, pl, (int32_t*)ox, (int32_t*)oy, (int32_t*)oz, n_digits, lanes, n_table, steps, s0, c);
  return (int)cudaGetLastError();
}

}  // extern "C"
