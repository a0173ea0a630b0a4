// K16: the complete affine add with its batch inversion inside, for G1
// (Fq) and G2 (Fq2):
//   zk_g{1,2}_affine_add         out = a + b for two (x, y, inf) triples of
//                                rows x inner elements, each operand at its
//                                own row stride (a strided view, or a
//                                broadcast row at stride 0)
//   zk_g{1,2}_affine_accumulate  the batch-affine windowed MSM's steps:
//                                acc[d, l] += (+-)table[t, |digit| - 1, l]
//                                for the chunk's T steps, in affine
//
// Replaces, on the batch-affine arm, the reference's affine add: plain XLA
// around the Pallas kernel mont_mul (zkp2p_tpu/ops/pallas_mont.py:
// mont_mul) in zkp2p_tpu/ops/msm_affine.py (affine_add_complete; the
// accumulate body of msm_windowed_affine's lax.scan) and in
// zkp2p_tpu/ops/msm_bucket.py (affine_prefix_incl, the bucket differences,
// affine_tree_reduce), each add one grid-wide batch inversion (K5 on its
// total) and some 20 launches of mont_mul.  Here an add is one launch: each
// thread takes four elements, the block inverts their denominators
// together (affine.cuh: block_inverse_many), and phase 2 reads the
// operands again and completes the adds.
// The four exceptional cases and the (0, 0) sentinel are the reference's;
// every value is canonical, so the limbs are the plain route's.
//
// The accumulate keeps each (digit, lane) accumulator in registers across
// the chunk's T steps, as K7/K9 do (msm_window.cu): a step is one gather of
// the digit's affine table entry (Y negated for a negative digit, 0 - y),
// one block inversion and one apply, not a launch.  The digit planes are
// read in place at their strides (K7's lesson: copying them cost 0.39 s a
// proof).  The steps of one MSM depend on each other (a step's
// denominators are the last step's sums), so what bounds a chunk on an
// H100 is the chain of one step: the tree's log2(blockDim) levels each way
// and one inversion by one thread of the block, some tens of microseconds,
// against a few microseconds of multiplies a step for all the lanes.  The
// add over millions of elements (the bucket MSM's levels) is bound by the
// inversions, one thread of the block busy during each, so its threads
// take four elements each (one inversion a 1,024 for G1, 512 for G2);
// beside them the 32-bit multiplies: about 3 products an element in the
// batch inversion, 3-4 in the apply.
//
// G1 blocks are 256 threads (one inversion for 256 lanes), G2 blocks 128:
// an Fq2 accumulator and addend are 64 words, and K9 already needs 255
// registers for its Jacobian add.
#include "affine.cuh"

// An operand of the add: element e = r * inner + g of the flat batch at
// x + (r * rs + g) * elem words, its flag at inf + r * inf_rs + g.
struct AffIn {
  const int32_t* x;
  const int32_t* y;
  const uint8_t* inf;
  long long rs, inf_rs;
};

template <class E>
__device__ __forceinline__ Aff<E> aff_load(const AffIn& p, long long r, long long g) {
  const E* tag = nullptr;
  const long long i = r * p.rs + g;
  return Aff<E>{f_load(tag, p.x, i), f_load(tag, p.y, i), p.inf[r * p.inf_rs + g] != 0};
}

// Values a thread of the add: one inversion for 4 x blockDim.x elements.
static constexpr int kPer = 4;

template <class E>
__global__ void __launch_bounds__(256)
k_affine_add(AffIn a, AffIn b, int32_t* __restrict__ ox, int32_t* __restrict__ oy, uint8_t* __restrict__ oinf,
             long long n, long long inner, FieldConst c, InvConst ic) {
  extern __shared__ __align__(16) unsigned char smem[];
  Fe* tree = reinterpret_cast<Fe*>(smem);
  const long long base = (long long)blockIdx.x * blockDim.x * kPer + threadIdx.x;
  Fe v[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const long long i = base + (long long)k * blockDim.x;
    v[k] = fe_zero();
    if (i < n) {
      const long long r = i / inner, g = i - r * inner;
      AddCase kc;
      v[k] = inv_key(aff_den(aff_load<E>(a, r, g), aff_load<E>(b, r, g), kc, c), c);
    }
  }
  block_inverse_many(v, tree, c, ic);
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const long long i = base + (long long)k * blockDim.x;
    if (i >= n) continue;
    const long long r = i / inner, g = i - r * inner;
    const Aff<E> p = aff_load<E>(a, r, g), q = aff_load<E>(b, r, g);  // again: from L1/L2
    AddCase kc;
    const E den = aff_den(p, q, kc, c);
    const Aff<E> s = aff_apply(p, q, inv_apply(den, v[k], c), kc, c);
    f_store(ox, i, s.x);
    f_store(oy, i, s.y);
    oinf[i] = s.inf;
  }
}

// The digit planes, read in place: (n_digits, steps, lanes) at any strides.
struct Planes {
  const int32_t* mags;  // magnitudes in [0, n_table]
  const uint8_t* negs;  // 1 where the digit is negative
  long long mag_sd, mag_ss, mag_sl;
  long long neg_sd, neg_ss, neg_sl;
};

// acc (n_digits, lanes) in and out; the chunk's affine table (T, n_table,
// lanes), entry k = (k+1)P, (0, 0) where the base is at infinity; one
// thread per (d, l), i = d * lanes + l.
template <class E, int kThreads>
__global__ void __launch_bounds__(kThreads)
k_affine_accumulate(const int32_t* __restrict__ ax, const int32_t* __restrict__ ay, const uint8_t* __restrict__ ainf,
                    const int32_t* __restrict__ tx, const int32_t* __restrict__ ty, Planes pl,
                    int32_t* __restrict__ ox, int32_t* __restrict__ oy, uint8_t* __restrict__ oinf, int n_digits,
                    int lanes, int n_table, int steps, long long s0, FieldConst c, InvConst ic) {
  extern __shared__ __align__(16) unsigned char smem[];
  Fe* tree = reinterpret_cast<Fe*>(smem);
  const E* tag = nullptr;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = i < (long long)n_digits * lanes;
  const int d = active ? (int)(i / lanes) : 0;
  const int l = active ? (int)(i - (long long)d * lanes) : 0;
  Aff<E> acc{f_zero(E{}), f_zero(E{}), true};
  if (active) acc = Aff<E>{f_load(tag, ax, i), f_load(tag, ay, i), ainf[i] != 0};
  const int32_t* mag_p = pl.mags + d * pl.mag_sd + s0 * pl.mag_ss + l * pl.mag_sl;
  const uint8_t* neg_p = pl.negs + d * pl.neg_sd + s0 * pl.neg_ss + l * pl.neg_sl;
  for (int t = 0; t < steps; ++t) {
    Aff<E> q{f_zero(E{}), f_zero(E{}), true};
    AddCase k{false, false};
    E den = f_one(E{}, c);
    if (active) {
      const int mag = __ldg(mag_p + t * pl.mag_ss);
      if (mag) {
        const long long at = ((long long)t * n_table + mag - 1) * lanes + l;
        q.x = f_load(tag, tx, at);
        q.y = f_load(tag, ty, at);
        if (__ldg(neg_p + t * pl.neg_ss)) q.y = f_sub(f_zero(q.y), q.y, c);
        q.inf = f_is_zero(q.x) && f_is_zero(q.y);
      }
      den = aff_den(acc, q, k, c);
    }
    const E dinv = block_inverse(den, tree, c, ic);
    if (active) acc = aff_apply(acc, q, dinv, k, c);
  }
  if (active) {
    f_store(ox, i, acc.x);
    f_store(oy, i, acc.y);
    oinf[i] = acc.inf;
  }
}

template <class E, int kThreads>
static int launch_add(const void* ax, const void* ay, const void* ainf, long long a_rs, long long ainf_rs,
                      const void* bx, const void* by, const void* binf, long long b_rs, long long binf_rs, void* ox,
                      void* oy, void* oinf, long long rows, long long inner, const void* consts, const void* r3,
                      void* stream) {
  const long long n = rows * inner;
  if (n <= 0) return 0;
  FieldConst c = *reinterpret_cast<const FieldConst*>(consts);
  InvConst ic = *reinterpret_cast<const InvConst*>(r3);
  AffIn a{(const int32_t*)ax, (const int32_t*)ay, (const uint8_t*)ainf, a_rs, ainf_rs};
  AffIn b{(const int32_t*)bx, (const int32_t*)by, (const uint8_t*)binf, b_rs, binf_rs};
  k_affine_add<E><<<(unsigned)((n + kThreads * kPer - 1) / (kThreads * kPer)), kThreads, tree_bytes(kThreads),
                    (cudaStream_t)stream>>>(a, b, (int32_t*)ox, (int32_t*)oy, (uint8_t*)oinf, n, inner, c, ic);
  return (int)cudaGetLastError();
}

template <class E, int kThreads>
static int launch_accumulate(const void* ax, const void* ay, const void* ainf, const void* tx, const void* ty,
                             const void* mags, const void* negs, void* ox, void* oy, void* oinf, int n_digits,
                             int lanes, int n_table, int steps, long long s0, long long mag_sd, long long mag_ss,
                             long long mag_sl, long long neg_sd, long long neg_ss, long long neg_sl,
                             const void* consts, const void* r3, void* stream) {
  if (n_digits <= 0 || lanes <= 0 || steps <= 0) return 0;
  FieldConst c = *reinterpret_cast<const FieldConst*>(consts);
  InvConst ic = *reinterpret_cast<const InvConst*>(r3);
  Planes pl{(const int32_t*)mags, (const uint8_t*)negs, mag_sd, mag_ss, mag_sl, neg_sd, neg_ss, neg_sl};
  const long long n = (long long)n_digits * lanes;
  k_affine_accumulate<E, kThreads><<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, tree_bytes(kThreads),
                                     (cudaStream_t)stream>>>(
      (const int32_t*)ax, (const int32_t*)ay, (const uint8_t*)ainf, (const int32_t*)tx, (const int32_t*)ty, pl,
      (int32_t*)ox, (int32_t*)oy, (uint8_t*)oinf, n_digits, lanes, n_table, steps, s0, c, ic);
  return (int)cudaGetLastError();
}

extern "C" {

// a, b: x, y limbs and inf flags with row strides (elements); out
// contiguous (rows, inner)
int zk_g1_affine_add(const void* ax, const void* ay, const void* ainf, long long a_rs, long long ainf_rs,
                     const void* bx, const void* by, const void* binf, long long b_rs, long long binf_rs, void* ox,
                     void* oy, void* oinf, long long rows, long long inner, const void* consts, const void* r3,
                     void* stream) {
  return launch_add<Fe, 256>(ax, ay, ainf, a_rs, ainf_rs, bx, by, binf, b_rs, binf_rs, ox, oy, oinf, rows, inner,
                             consts, r3, stream);
}

int zk_g2_affine_add(const void* ax, const void* ay, const void* ainf, long long a_rs, long long ainf_rs,
                     const void* bx, const void* by, const void* binf, long long b_rs, long long binf_rs, void* ox,
                     void* oy, void* oinf, long long rows, long long inner, const void* consts, const void* r3,
                     void* stream) {
  return launch_add<Fe2, 128>(ax, ay, ainf, a_rs, ainf_rs, bx, by, binf, b_rs, binf_rs, ox, oy, oinf, rows, inner,
                              consts, r3, stream);
}

// acc (n_digits, lanes) x, y, inf in; out the same; table (steps, n_table,
// lanes) x, y affine; the planes (n_digits, steps_total, lanes) at the
// given strides, read at steps s0 .. s0 + steps - 1.
int zk_g1_affine_accumulate(const void* ax, const void* ay, const void* ainf, const void* tx, const void* ty,
                            const void* mags, const void* negs, void* ox, void* oy, void* oinf, int n_digits,
                            int lanes, int n_table, int steps, long long s0, long long mag_sd, long long mag_ss,
                            long long mag_sl, long long neg_sd, long long neg_ss, long long neg_sl,
                            const void* consts, const void* r3, void* stream) {
  return launch_accumulate<Fe, 256>(ax, ay, ainf, tx, ty, mags, negs, ox, oy, oinf, n_digits, lanes, n_table, steps,
                                    s0, mag_sd, mag_ss, mag_sl, neg_sd, neg_ss, neg_sl, consts, r3, stream);
}

int zk_g2_affine_accumulate(const void* ax, const void* ay, const void* ainf, const void* tx, const void* ty,
                            const void* mags, const void* negs, void* ox, void* oy, void* oinf, int n_digits,
                            int lanes, int n_table, int steps, long long s0, long long mag_sd, long long mag_ss,
                            long long mag_sl, long long neg_sd, long long neg_ss, long long neg_sl,
                            const void* consts, const void* r3, void* stream) {
  return launch_accumulate<Fe2, 128>(ax, ay, ainf, tx, ty, mags, negs, ox, oy, oinf, n_digits, lanes, n_table, steps,
                                     s0, mag_sd, mag_ss, mag_sl, neg_sd, neg_ss, neg_sl, consts, r3, stream);
}

}  // extern "C"
